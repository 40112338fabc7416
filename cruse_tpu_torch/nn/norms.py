"""Streaming and cumulative input normalizations of the FullSubNet and
DeepFilterNet families (counterpart of ``cruse_tpu/nn/norms.py``), time-major
layout ``[..., T, F]``.

Every function takes ``[..., T, F]`` and normalizes each frame over the last
(frequency) axis unless its doc says otherwise. The cumulative variants are
one ``cumsum`` over time; the ``_carry`` variants also return their running
sums and count, so that chunked calls continue where the last one stopped.
The EMA variants walk the frames in order (the JAX package's ``lax.scan``).
The dtypes are the JAX package's: a cumulative norm's entry count is a
float of the input's dtype, exact up to 2^24 entries.
"""
from __future__ import annotations

import math

import torch

EPSILON = 1e-10


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / (the mean over every axis but the first + 1e-5)."""
    mu = x.mean(dim=tuple(range(1, x.dim())), keepdim=True)
    return x / (mu + 1e-5)


def _entry_counts(n_freqs: int, t: int, like: torch.Tensor) -> torch.Tensor:
    """F, 2F, ..., tF in the dtype of ``like`` (the running count of entries)."""
    return torch.arange(n_freqs, n_freqs * t + 1, n_freqs, dtype=like.dtype, device=like.device)


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x_t / mean(x_{<=t}), the running mean over every bin of frames 0..t."""
    n_freqs, t = x.shape[-1], x.shape[-2]
    cum_mean = torch.cumsum(x.sum(dim=-1), dim=-1) / _entry_counts(n_freqs, t, x)
    return x / (cum_mean[..., None] + EPSILON)


def cumulative_laplace_norm_carry(x: torch.Tensor, carry=None):
    """``cumulative_laplace_norm`` with a carry: returns ``(y, (running sum
    [...], running count [...]))``, shaped like the leading axes, so that a
    call on the next chunk continues the running mean. ``carry=None`` starts
    from zero."""
    n_freqs, t = x.shape[-1], x.shape[-2]
    if carry is None:
        prev_sum = prev_count = x.new_zeros(x.shape[:-2])
    else:
        prev_sum, prev_count = carry
    cum_sum = prev_sum[..., None] + torch.cumsum(x.sum(dim=-1), dim=-1)
    counts = prev_count[..., None] + _entry_counts(n_freqs, t, x)
    y = x / ((cum_sum / counts)[..., None] + EPSILON)
    return y, (cum_sum[..., -1], counts[..., -1])


def offline_gaussian_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - mu) / (std + 1e-5) over every axis but the first, with the
    unbiased std (n - 1, at least 1)."""
    axes = tuple(range(1, x.dim()))
    mu = x.mean(dim=axes, keepdim=True)
    n = math.prod(x.shape[a] for a in axes)
    var = torch.square(x - mu).sum(dim=axes, keepdim=True) / max(n - 1, 1)
    return (x - mu) / (torch.sqrt(var) + 1e-5)


def _cumulative_moments(x, cum_sum, cum_pow, counts):
    cum_mean = cum_sum / counts
    cum_var = (cum_pow - 2.0 * cum_mean * cum_sum) / counts + torch.square(cum_mean)
    return (x - cum_mean[..., None]) / torch.sqrt(cum_var + EPSILON)[..., None]


def cumulative_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """(x_t - mean(x_{<=t})) / std(x_{<=t}), running over every bin of frames 0..t."""
    n_freqs, t = x.shape[-1], x.shape[-2]
    cum_sum = torch.cumsum(x.sum(dim=-1), dim=-1)
    cum_pow = torch.cumsum(torch.square(x).sum(dim=-1), dim=-1)
    return _cumulative_moments(x, cum_sum, cum_pow, _entry_counts(n_freqs, t, x))


def cumulative_layer_norm_carry(x: torch.Tensor, carry=None):
    """``cumulative_layer_norm`` with a carry: returns ``(y, (running sum,
    running power sum, running count))``, each shaped like the leading axes."""
    n_freqs, t = x.shape[-1], x.shape[-2]
    if carry is None:
        prev_sum = prev_pow = prev_count = x.new_zeros(x.shape[:-2])
    else:
        prev_sum, prev_pow, prev_count = carry
    cum_sum = prev_sum[..., None] + torch.cumsum(x.sum(dim=-1), dim=-1)
    cum_pow = prev_pow[..., None] + torch.cumsum(torch.square(x).sum(dim=-1), dim=-1)
    counts = prev_count[..., None] + _entry_counts(n_freqs, t, x)
    y = _cumulative_moments(x, cum_sum, cum_pow, counts)
    return y, (cum_sum[..., -1], cum_pow[..., -1], counts[..., -1])


def _warmup_alphas(t_total: int, alpha: float, like: torch.Tensor) -> torch.Tensor:
    """min((t - 1) / (t + 1), alpha) for t = 0..T-1: -1 at t = 0, which
    doubles the first frame's mean (the reference's warm-up, kept)."""
    idx = torch.arange(t_total, dtype=like.dtype, device=like.device)
    return torch.clamp((idx - 1.0) / (idx + 1.0), max=alpha)


def _ema(alphas: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """mu_t = a_t mu_{t-1} + (1 - a_t) m_t from mu_{-1} = 0, over the last axis
    of ``drive`` [..., T]."""
    mu = torch.zeros_like(drive[..., 0])
    out = []
    for t in range(drive.shape[-1]):
        mu = alphas[t] * mu + (1.0 - alphas[t]) * drive[..., t]
        out.append(mu)
    return torch.stack(out, dim=-1)


def forgetting_norm(x: torch.Tensor, sample_length: int) -> torch.Tensor:
    """x_t / mu_t, mu the per-frame mean's EMA with decay (L - 1) / (L + 1)
    after the warm-up of ``_warmup_alphas``."""
    alpha = (sample_length - 1) / (sample_length + 1)
    mu = _ema(_warmup_alphas(x.shape[-2], alpha, x), x.mean(dim=-1))
    return x / (mu[..., None] + EPSILON)


def sband_forgetting_norm(x: torch.Tensor, sample_length: int) -> torch.Tensor:
    """``forgetting_norm``, but from frame ``sample_length`` on the EMA follows
    the bin F // 2 - 1 instead of the frame's mean, at the full decay."""
    alpha = (sample_length - 1) / (sample_length + 1)
    t_total, n_freqs = x.shape[-2], x.shape[-1]
    warm = torch.arange(t_total, device=x.device) < sample_length
    alphas = torch.where(warm, _warmup_alphas(t_total, alpha, x), alpha)
    drive = torch.where(warm, x.mean(dim=-1), x[..., n_freqs // 2 - 1])
    mu = _ema(alphas, drive)
    return x / (mu[..., None] + EPSILON)


def hybrid_norm(x: torch.Tensor, sample_length: int = 192) -> torch.Tensor:
    """The forgetting norm's EMA for the first ``sample_length`` frames, the
    cumulative mean after them."""
    t_total, n_freqs = x.shape[-2], x.shape[-1]
    alpha = (sample_length - 1) / (sample_length + 1)
    ema_mu = _ema(_warmup_alphas(t_total, alpha, x), x.mean(dim=-1))
    cum_mean = torch.cumsum(x.sum(dim=-1), dim=-1) / _entry_counts(n_freqs, t_total, x)
    mu = torch.where(torch.arange(t_total, device=x.device) < sample_length, ema_mu, cum_mean)
    return x / (mu[..., None] + EPSILON)


def get_norm_alpha(sr: int = 16000, hop: int = 160, tau: float = 1.0) -> float:
    """The EMA decay of a time constant of ``tau`` seconds at one hop a frame."""
    return math.exp(-(hop / sr) / tau)


def exponential_unit_norm(mag: torch.Tensor, alpha: float, state: torch.Tensor | None = None,
                          eps: float = 1e-14):
    """DeepFilterNet's per-bin unit norm: s_t = alpha s_{t-1} + (1 - alpha)
    |x_t|, y_t = x_t / sqrt(s_t + eps). ``mag [..., T, F]``, ``state [..., F]``
    (default: linspace(1e-3, 1e-4) over the bins). Returns ``(y, s_T)``."""
    t_total, n_freqs = mag.shape[-2], mag.shape[-1]
    if state is None:
        init = torch.linspace(1e-3, 1e-4, n_freqs, dtype=mag.dtype, device=mag.device)
        state = init.expand(*mag.shape[:-2], n_freqs)
    s, out = state, []
    for t in range(t_total):
        s = alpha * s + (1.0 - alpha) * mag[..., t, :]
        out.append(s)
    return mag / torch.sqrt(torch.stack(out, dim=-2) + eps), s


NORM_REGISTRY = {
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
    "offline_gaussian_norm": offline_gaussian_norm,
    "cumulative_layer_norm": cumulative_layer_norm,
    "forgetting_norm": forgetting_norm,
    "sband_forgetting_norm": sband_forgetting_norm,
    "hybrid_norm": hybrid_norm,
}


def norm_wrapper(norm_type: str):
    """The norm of that name; an unknown name raises ``NotImplementedError``."""
    if norm_type not in NORM_REGISTRY:
        raise NotImplementedError(f"unknown norm {norm_type!r}; choose from {sorted(NORM_REGISTRY)}")
    return NORM_REGISTRY[norm_type]
