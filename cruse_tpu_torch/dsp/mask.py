"""Mask post-filters (counterpart of ``postfilter_sin`` and
``envelope_postfilter`` in ``cruse_tpu/dsp/mask.py``): plain functions on
tensors, applied to a [0, 1] magnitude mask before it multiplies the noisy
spectrum."""
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
