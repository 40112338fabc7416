"""DFSMN: deep feedforward sequential memory network (counterpart of
``cruse_tpu/models/dfsmn.py``), benchmark config 4's frame-by-frame
low-latency enhancement model.

A block: 1x1 in-projection -> depthwise dilated *left* (past) memory conv,
causally padded -> depthwise *right* (look-ahead) conv -> memory residual
``out + left + right`` -> with the previous block's memory output ``hidden``
the skip ``hidden + relu(out_p) * skip_weight`` -> 1x1 out-projection. The
net: a ReLU input projection, ``num_blocks`` blocks chained through their
memory outputs, and a sigmoid mask head over the bins.

Layout is time-major ``[B, T, D]``. The memory convs are depthwise 1-D
cross-correlations over T (PyTorch's ``conv1d`` with ``groups=D``, as the
JAX package's ``lax.conv_general_dilated``; there is no TPU kernel for them).
The parameters keep the flax shapes where the math reads them: the memory
kernels ``left_kernel [left_frames + 1, 1, D]`` and ``right_kernel
[right_frames, 1, D]`` (tap 0 first) and the 0-d ``skip_weight``; the 1x1
projections are ``Linear`` layers. The weight bridge maps the flax tree onto
them (``utils/weights.py::dense_state_dict_from_flax``).

Streaming: with ``right_frames == 0`` the net is causal and carries, per
block, the last ``left_frames * left_dilation`` frames of the memory conv's
input; a call with ``state=None`` returns that context too, so a following
chunk continues from it. A look-ahead block reads future frames and refuses a
carried state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _depthwise_time_conv(x: torch.Tensor, kernel: torch.Tensor, dilation: int) -> torch.Tensor:
    """x ``[B, T, D]``, kernel ``[K, 1, D]`` (the flax HIO layout) -> ``[B, T - (K-1) dilation, D]``:
    ``y[t, d] = sum_k kernel[k, 0, d] x[t + k dilation, d]`` (valid, no flip)."""
    y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), dilation=dilation, groups=x.shape[-1])
    return y.transpose(1, 2)


def _linear(generator: torch.Generator, cin: int, cout: int) -> nn.Linear:
    """A ``Linear`` with a seeded lecun-normal weight and a zero bias, as flax's Dense."""
    layer = nn.Linear(cin, cout)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(cout, cin, generator=generator) * cin ** -0.5)
        layer.bias.zero_()
    return layer


class DfsmnBlock(nn.Module):
    """One memory block: ``x [B, T, I]`` -> ``(out [B, T, O], out_p [B, T, H],
    new_left_ctx [B, left_frames * left_dilation, H] or None)``. ``skip``
    gives the block the skip weight that a ``hidden`` input needs (every block
    of the net but the first)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, left_frames: int = 1,
                 left_dilation: int = 1, right_frames: int = 1, right_dilation: int = 1,
                 skip: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.left_frames, self.left_dilation = left_frames, left_dilation
        self.right_frames, self.right_dilation = right_frames, right_dilation
        self.in_conv = _linear(gen, input_dim, hidden_dim)
        if left_frames > 0:
            self.left_kernel = nn.Parameter(torch.randn(left_frames + 1, 1, hidden_dim, generator=gen) * 0.05)
        if right_frames > 0:
            self.right_kernel = nn.Parameter(torch.randn(right_frames, 1, hidden_dim, generator=gen) * 0.05)
        if skip:
            self.skip_weight = nn.Parameter(torch.zeros(()))
        self.out_conv = _linear(gen, hidden_dim, output_dim)

    @property
    def context(self) -> int:
        """Frames of left context a stream carries."""
        return self.left_frames * self.left_dilation

    def forward(self, x: torch.Tensor, hidden: torch.Tensor | None = None,
                left_ctx: torch.Tensor | None = None):
        if left_ctx is not None and self.right_frames > 0:
            raise ValueError("a look-ahead DFSMN block (right_frames > 0) reads future frames and "
                             "cannot stream with a carried left context")
        out = self.in_conv(x)
        out_p, new_ctx = out, left_ctx
        if self.left_frames > 0:
            ext = F.pad(out, (0, 0, self.context, 0)) if left_ctx is None else torch.cat([left_ctx, out], dim=1)
            new_ctx = ext[:, ext.shape[1] - self.context :]
            out_p = out_p + _depthwise_time_conv(ext, self.left_kernel, self.left_dilation)
        if self.right_frames > 0:
            # skip the current frame, look ahead right_frames * right_dilation frames
            ext = F.pad(out, (0, 0, 0, self.right_frames * self.right_dilation))[:, self.right_dilation :]
            out_p = out_p + _depthwise_time_conv(ext, self.right_kernel, self.right_dilation)
        if hidden is not None:
            if not hasattr(self, "skip_weight"):
                raise ValueError("this block was built without a skip weight (skip=False): "
                                 "it takes no hidden input")
            out_p = hidden + torch.relu(out_p) * self.skip_weight
        return self.out_conv(out_p), out_p, new_ctx


@dataclasses.dataclass(frozen=True)
class DfsmnConfig:
    """The JAX ``DfsmnNet``'s fields (``[model.args]`` of ``configs/tiny_dfsmn.toml``)."""

    in_freq: int = 161
    hidden_dim: int = 256
    num_blocks: int = 6
    left_frames: int = 2
    left_dilation: int = 1
    right_frames: int = 0
    right_dilation: int = 1


class DfsmnNet(nn.Module):
    """Compressed magnitude ``[B, T, F]`` -> ``(mask [B, T, F], state)``: the
    state is a tuple of each block's left context ``[B, left_frames *
    left_dilation, hidden_dim]``. Causal by default (``right_frames=0``), for
    frame-by-frame streaming."""

    def __init__(self, config: DfsmnConfig = DfsmnConfig(), generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
        gen = generator or torch.Generator().manual_seed(0)
        self.proj_in = _linear(gen, cfg.in_freq, cfg.hidden_dim)
        for i in range(cfg.num_blocks):
            setattr(self, f"block_{i}", DfsmnBlock(
                cfg.hidden_dim, cfg.hidden_dim, cfg.hidden_dim, cfg.left_frames, cfg.left_dilation,
                cfg.right_frames, cfg.right_dilation, skip=i > 0, generator=gen))
        self.mask_head = _linear(gen, cfg.hidden_dim, cfg.in_freq)

    def compress(self, mag: torch.Tensor) -> torch.Tensor:
        return torch.clamp(mag, min=1e-12) ** 0.3

    def forward(self, feat: torch.Tensor, state: Optional[Tuple[torch.Tensor, ...]] = None,
                train: bool = False):
        """``train`` changes nothing (the net has no BatchNorm or dropout)."""
        cfg = self.config
        if state is not None and len(state) != cfg.num_blocks:
            raise ValueError(f"state must hold {cfg.num_blocks} left contexts, got {len(state)}")
        x = torch.relu(self.proj_in(feat))
        hidden, new_state = None, []
        for i in range(cfg.num_blocks):
            x, hidden, ctx = getattr(self, f"block_{i}")(x, hidden, None if state is None else state[i])
            if ctx is None:  # no left memory: an empty context
                ctx = x.new_zeros((x.shape[0], 0, cfg.hidden_dim))
            new_state.append(ctx)
        return torch.sigmoid(self.mask_head(x)), tuple(new_state)

    def init_state(self, batch_size: int, device: torch.device | str = "cpu") -> Tuple[torch.Tensor, ...]:
        """Fresh streaming state: zero left contexts."""
        cfg = self.config
        pad = cfg.left_frames * cfg.left_dilation
        return tuple(torch.zeros(batch_size, pad, cfg.hidden_dim, device=device)
                     for _ in range(cfg.num_blocks))

