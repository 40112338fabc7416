"""Manifests: one wav path a line (counterpart of ``load_manifest`` in
``cruse_tpu/data/manifest.py``, copied here because importing that module
runs ``cruse_tpu/data/__init__.py``, which imports the JAX mixer)."""
from __future__ import annotations

import os
from typing import List


def load_manifest(path: str) -> List[str]:
    """One file path per line; blank lines are skipped."""
    p = os.path.abspath(os.path.expanduser(path))
    with open(p) as f:
        return [line.rstrip("\n") for line in f if line.strip()]
