"""Causal conv block (counterpart of ``cruse_tpu/nn/conv.py::CausalConv2d``).

Activations are NCHW ``[B, C, T, F]``. Only what CRUSE uses is here: a
(kt, kf) conv with stride in frequency, BatchNorm (``BatchNorm2d``: eval mode
uses the running statistics, training mode the batch's and moves the running
ones as flax does; eps 1e-5) and an activation.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training mode matches flax's ``nn.BatchNorm(
    momentum=0.9)``: it normalises by the batch's mean and biased variance (as
    torch does) and moves the running statistics by ``0.9 * running + 0.1 *
    batch`` with the **biased** variance, where torch's own module takes the
    unbiased one. Eval mode, the parameters and the state-dict keys
    (``num_batches_tracked`` included) are torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class CausalConv2d(nn.Module):
    """Conv over an explicitly extended input ``x_ext [B, C, T+kt-1, F]``:
    output frame t sees extended frames t..t+kt-1, i.e. the current frame
    and kt-1 past ones. The caller supplies the causal context (zeros for a
    fresh utterance, the carried history when streaming), so the batch and
    streaming paths run the same code. Frequency is padded by kf//2 on each
    side and strided by ``fstride``."""

    def __init__(self, in_channels: int, features: int, kernel_size: Tuple[int, int] = (2, 3),
                 fstride: int = 1, norm: bool = True,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = torch.relu):
        super().__init__()
        kt, kf = kernel_size
        self.conv = nn.Conv2d(in_channels, features, (kt, kf), stride=(1, fstride),
                              padding=(0, kf // 2))
        self.bn = BatchNorm2d(features, eps=1e-5) if norm else None
        self.act = act

    def forward(self, x_ext: torch.Tensor) -> torch.Tensor:
        x = self.conv(x_ext)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x
