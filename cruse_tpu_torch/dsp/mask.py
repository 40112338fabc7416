"""Masks (counterpart of parts of ``cruse_tpu/dsp/mask.py``): the post-filters
``postfilter_sin`` and ``envelope_postfilter``, plain functions on tensors
applied to a [0, 1] magnitude mask before it multiplies the noisy spectrum,
the compressed complex ideal ratio mask of the ``cirm`` loss, and
``decompress_cirm`` and ``complex_mul``, which apply a model's compressed
cIRM (FullSubNet) to the noisy spectrum."""
from __future__ import annotations

import math

import torch


def postfilter_sin(mask: torch.Tensor, beta: float = 0.02) -> torch.Tensor:
    """RNNoise-style sin sharpening of a [0, 1] gain:
    g' = (1 + beta) g / (1 + beta (g / (g sin(pi g / 2)))^2)."""
    g_sin = mask * torch.sin(math.pi * mask / 2.0)
    ratio = torch.where(g_sin > 0, mask / torch.clamp(g_sin, min=1e-8), 1.0)
    return (1.0 + beta) * mask / (1.0 + beta * torch.square(ratio))


def envelope_postfilter(gain: torch.Tensor, tau: float = 0.02) -> torch.Tensor:
    """Envelope post-filter for IRM-style gains: softens small gains to
    reduce musical noise."""
    g_hat = gain * torch.sin(torch.clamp(math.pi * gain / 2.0, 0.0, math.pi / 2.0))
    ratio = torch.where(g_hat > 1e-8, gain / torch.clamp(g_hat, min=1e-8), 1.0)
    return (1.0 + tau) * gain / (1.0 + tau * torch.square(ratio))


EPSILON = 1e-8


def build_complex_ideal_ratio_mask(noisy: torch.Tensor, clean: torch.Tensor):
    """The cIRM from complex spectra: (real, imag) compressed masks."""
    denom = noisy.real ** 2 + noisy.imag ** 2 + EPSILON
    mask_r = (noisy.real * clean.real + noisy.imag * clean.imag) / denom
    mask_i = (noisy.real * clean.imag - noisy.imag * clean.real) / denom
    return compress_cirm(mask_r), compress_cirm(mask_i)


def compress_cirm(mask: torch.Tensor, k: float = 10.0, c: float = 0.1) -> torch.Tensor:
    """Compress (-inf, inf) -> (-K, K) by a scaled tanh; values at or below
    -100 are taken as -100."""
    mask = torch.where(mask <= -100.0, -100.0, mask)
    return k * (1.0 - torch.exp(-c * mask)) / (1.0 + torch.exp(-c * mask))


def decompress_cirm(mask: torch.Tensor, k: float = 10.0, limit: float = 9.9) -> torch.Tensor:
    """The inverse of ``compress_cirm``, the input clamped to [-limit, limit]."""
    mask = torch.clamp(mask, -limit, limit)
    return -k * torch.log((k - mask) / (k + mask))


def complex_mul(noisy_r, noisy_i, mask_r, mask_i):
    """(a + bi)(c + di), split into its real and imaginary parts."""
    return noisy_r * mask_r - noisy_i * mask_i, noisy_r * mask_i + noisy_i * mask_r
