"""Feature helpers of the port (counterpart of parts of
``cruse_tpu/dsp/features.py``): ``overlap_cat``, the stitch of
``BatchInferencer.enhance_long``."""
from __future__ import annotations

from typing import Sequence

import torch


def overlap_cat(chunks: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Stitch 50 %-overlapping chunks of one length along ``dim``, averaging
    the halves that two neighbours share."""
    pieces = []
    for i, chunk in enumerate(chunks):
        half = chunk.shape[dim] // 2
        first, last = chunk.narrow(dim, 0, half), chunk.narrow(dim, half, chunk.shape[dim] - half)
        if i == 0:
            pieces += [first, last]
        else:
            pieces[-1] = (pieces[-1] + first) / 2.0
            pieces.append(last)
    return torch.cat(pieces, dim=dim)
