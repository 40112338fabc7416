"""Scale-invariant SNR loss in the time domain (counterpart of
``cruse_tpu/losses/sisnr.py``: the projection form, no DC removal, 10 log10)."""
from __future__ import annotations

import torch


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1, keepdim=True)


def si_snr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean SI-SNR in dB over the batch (higher is better); est, ref
    ``[..., L]``. The projection of est onto ref is the target."""
    target = _dot_last(est, ref) / (_dot_last(ref, ref) + eps) * ref
    noise = est - target
    snr = 10.0 * torch.log10(_dot_last(target, target) / (_dot_last(noise, noise) + eps) + eps)
    return snr.mean()


def si_snr_loss(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Negative SI-SNR (to minimise)."""
    return -si_snr(est, ref, eps)
