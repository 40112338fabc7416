"""Deep filtering: complex multi-frame filters applied to the STFT
(counterpart of ``cruse_tpu/models/deep_filter.py``).

Each tap is a shift of the spectrum multiplied into an accumulator; on the
card the whole sum is one launch of the hand-written kernel
(``ops.deep_filter_kernel.deep_filter``). Both tap layouts are here: the
reference's symmetric one (time offsets in [-t, t]) and the causal,
DeepFilterNet-style one (time offsets in [0, 2t], past only).

``deep_filter_apply_tm``, the reference's T-minor apply for MTFAA's
coefficient head, has no counterpart: the port's MTFAA computes its
coefficients T-major, in the ``[B, T, F, K, 2]`` layout the kernel takes.
"""
from __future__ import annotations

import torch
from torch import nn

from cruse_tpu_torch.ops.deep_filter_kernel import _shift2d, deep_filter, tap_offsets  # noqa: F401


def deep_filter_apply(spec_r, spec_i, coef_r, coef_i, t_dim: int, f_dim: int,
                      causal: bool = False):
    """The JAX package's signature: spec_* [B, T, F], coef_* [B, T, F, K]
    with K = (2t+1)(2f+1) taps in ``tap_offsets`` order. Returns
    (out_r, out_i) [B, T, F], out[t, f] = sum_k coef[t, f, k] *
    spec[t - dt_k, f - df_k] (complex)."""
    out = deep_filter(torch.complex(spec_r, spec_i), torch.stack([coef_r, coef_i], dim=-1),
                      t_dim, f_dim, causal)
    return out.real, out.imag


class DeepFilterHead(nn.Module):
    """Predict complex multi-frame filter coefficients from features and
    apply them to the noisy spectrum: (features [B, T, D], spec complex
    [B, T, F]) -> enhanced complex [B, T, F]. The coefficient head
    (``coef_head``, the flax Dense's name) is a Linear to F * K * 2; the
    coefficients are divided by the tap count, as DeepFilterNet does."""

    def __init__(self, in_features: int, t_dim: int = 1, f_dim: int = 2, causal: bool = True,
                 num_freqs: int = 161, generator: torch.Generator | None = None):
        super().__init__()
        self.t_dim, self.f_dim, self.causal, self.num_freqs = t_dim, f_dim, causal, num_freqs
        self.coef_head = nn.Linear(in_features, num_freqs * self.num_taps * 2)
        lecun_normal_(self.coef_head, generator or torch.Generator().manual_seed(0))

    @property
    def num_taps(self) -> int:
        return (2 * self.t_dim + 1) * (2 * self.f_dim + 1)

    def forward(self, features: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
        k = self.num_taps
        coefs = self.coef_head(features).reshape(*features.shape[:-1], self.num_freqs, k, 2) / k
        return deep_filter(spec, coefs, self.t_dim, self.f_dim, self.causal)


def lecun_normal_(linear: nn.Linear, generator: torch.Generator) -> None:
    """Seeded lecun-normal weight (std fan_in^-1/2) and zero bias."""
    with torch.no_grad():
        w = linear.weight
        w.copy_(torch.randn(w.shape, generator=generator) * w.shape[1] ** -0.5)
        linear.bias.zero_()
