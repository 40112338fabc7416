"""Manifests: one wav path a line, offsets and limits, SNR ranges (copies of
``cruse_tpu/data/manifest.py``'s functions, made here because importing that
module runs ``cruse_tpu/data/__init__.py``, which imports the JAX mixer)."""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Sequence


def load_manifest(path: str) -> List[str]:
    """One file path per line; blank lines are skipped."""
    p = os.path.abspath(os.path.expanduser(path))
    with open(p) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def offset_and_limit(items: Sequence, offset: int = 0, limit: int | None = None):
    items = list(items)[offset:]
    if limit:
        items = items[:limit]
    return items


def parse_snr_range(snr_range) -> List[int]:
    """[low, high] -> the integers from low to high; raises on a malformed range."""
    if len(snr_range) != 2:
        raise ValueError(f"The range of snr should be [low, high], not {snr_range}")
    low, high = snr_range
    if low > high:
        raise ValueError(f"The low snr should not be larger than high snr: {snr_range}")
    return list(range(int(low), int(high) + 1))


def write_manifest(paths: Sequence[str], out_path: str) -> None:
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        for p in paths:
            f.write(f"{p}\n")
