"""Feature helpers of the port (counterpart of parts of
``cruse_tpu/dsp/features.py``): ``overlap_cat``, the stitch of
``BatchInferencer.enhance_long``, ``frame_vad``, the SDNR loss's voice
activity, and ``drop_band``, FullSubNet's frequency subsampling."""
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


def drop_band(x: torch.Tensor, num_groups: int = 2) -> torch.Tensor:
    """FullSubNet's frequency subsampling: ``[B, C, F, T] -> [B, C, F //
    num_groups, T]``, batch rows g, g + n, ... keeping bins g, g + n, ...
    (n = ``num_groups``), the groups stacked in order; F is first cut to a
    multiple of n. Needs B > n."""
    batch_size, _, num_freqs, _ = x.shape
    if batch_size <= num_groups:
        raise ValueError(f"batch {batch_size} must exceed num_groups={num_groups}")
    if num_groups <= 1:
        return x
    x = x[:, :, : num_freqs - num_freqs % num_groups]
    return torch.cat([x[g::num_groups, :, g::num_groups] for g in range(num_groups)], dim=0)
