"""Feature helpers of the port (counterpart of parts of
``cruse_tpu/dsp/features.py``): ``overlap_cat``, the stitch of
``BatchInferencer.enhance_long``, and ``frame_vad``, the SDNR loss's voice
activity."""
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


def frame_vad(mag: torch.Tensor, threshold_db: float = -60.0) -> torch.Tensor:
    """Per-frame binary voice activity of a magnitude spectrogram
    ``[..., T, F]``: a frame is active when its energy is within
    ``threshold_db`` of the utterance's loudest frame. Returns ``[..., T, 1]``."""
    frame_energy = (mag ** 2).sum(dim=-1)
    peak = frame_energy.amax(dim=-1, keepdim=True)
    db = 10.0 * torch.log10(frame_energy / (peak + 1e-12) + 1e-12)
    return (db > threshold_db).to(mag.dtype)[..., None]
