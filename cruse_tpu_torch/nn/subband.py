"""FullSubNet's sub-band ops (counterpart of ``cruse_tpu/nn/subband.py``):
the frequency unfold and the three-group complexity trick.

The sub-band window is one gather with a precomputed reflect-index table
(``_reflect_indices``, numpy, kept as an index tensor per device for eager
calls), not a
padded ``F.unfold``: torch's ``reflect`` padding refuses a pad of F bins or
more, while the table reflects once at each edge whatever the width, as the
JAX package's does. Layout is time-major ``[B, T, F(, S)]``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _reflect_indices(num_freqs: int, num_neighbors: int) -> np.ndarray:
    """``[F, 2n+1]`` gather table: row f holds the reflect-padded
    neighbourhood f-n .. f+n (the edge bins are not repeated)."""
    offsets = np.arange(-num_neighbors, num_neighbors + 1)
    idx = np.arange(num_freqs)[:, None] + offsets[None, :]
    idx = np.abs(idx)  # reflect at 0
    over = idx > num_freqs - 1
    idx[over] = 2 * (num_freqs - 1) - idx[over]  # reflect at F-1
    return idx


def _gather_table(num_freqs: int, num_neighbors: int) -> np.ndarray:
    """The table as the JAX package's gather reads it, flat: where a window is
    wider than one reflection covers (n >= F), a negative index counts from
    the end and the rest are clamped to [0, F - 1]."""
    idx = _reflect_indices(num_freqs, num_neighbors)
    return np.clip(np.where(idx < 0, idx + num_freqs, idx), 0, num_freqs - 1).reshape(-1)


@functools.lru_cache(maxsize=None)
def _index_tensor(num_freqs: int, num_neighbors: int, device: torch.device) -> torch.Tensor:
    """``_gather_table`` as an index tensor on ``device``, made once (eager
    calls only: see ``freq_unfold``)."""
    return torch.from_numpy(_gather_table(num_freqs, num_neighbors)).to(device)


def freq_unfold(x: torch.Tensor, num_neighbors: int) -> torch.Tensor:
    """``[..., F] -> [..., F, 2n+1]`` (``[..., F, 1]`` for n < 1): unit f holds
    bins f-n .. f+n, reflect-padded at both edges. Under a trace
    (``torch.export``) the table is made anew, a constant of the program, and
    the eager cache is neither read nor written: a cached tensor made inside
    a trace would be the trace's fake tensor."""
    if num_neighbors < 1:
        return x[..., None]
    num_freqs = x.shape[-1]
    if torch.compiler.is_compiling():
        idx = torch.from_numpy(_gather_table(num_freqs, num_neighbors)).to(x.device)
    else:
        idx = _index_tensor(num_freqs, num_neighbors, x.device)
    return x.index_select(-1, idx).reshape(*x.shape[:-1], num_freqs, 2 * num_neighbors + 1)


def reduce_complexity_separately(sub_band: torch.Tensor, full_band: torch.Tensor,
                                 num_groups: int = 3) -> torch.Tensor:
    """FullSubNet's sub-band training trick: each of ``num_groups`` batch
    slices trains on every ``num_groups``-th bin, the offset rotating by
    group, the reflect-padded first and last bins skipped; the sub-band units
    and the full-band output are concatenated on the tap axis.

    ``sub_band [B, T, F, S1]``, ``full_band [B, T, F, S2]``, B divisible by
    ``num_groups`` -> ``[B, T, F', S1 + S2]``, F' the smallest group's bin count.
    """
    b, _, f = sub_band.shape[:3]
    if b % num_groups:
        raise ValueError(f"batch {b} must divide into {num_groups} groups")
    sub_b = b // num_groups
    n_sel = min(len(range(g + 1, f - 1, num_groups)) for g in range(num_groups))
    cat = torch.cat([sub_band, full_band], dim=-1)
    picked = []
    for g in range(num_groups):
        freq_idx = torch.arange(g + 1, f - 1, num_groups, device=cat.device)[:n_sel]
        picked.append(cat[g * sub_b : (g + 1) * sub_b, :, freq_idx])
    return torch.cat(picked, dim=0)
