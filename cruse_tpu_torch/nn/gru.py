"""Grouped GRU layers and the plain GRU (counterpart of ``cruse_tpu/nn/gru.py``).

The input projection for all timesteps and all groups is one einsum; the
recurrence over time runs in ``ops.gru_kernel.gru_sequence``, which is the
CUDA kernel for tensors on the card and a plain loop on the CPU. Gate order
and equations match ``torch.nn.GRU`` (r, z, n). Parameters keep the JAX
layouts (``w_ih [G, 3H, I]``, ``w_hh [G, 3H, H]``, ``b_* [G, 3H]``), so the
weight bridge copies them as they are. Every layer takes and returns its
hidden state, so a call with T=1 is a streaming step.
"""
from __future__ import annotations

import torch
from torch import nn

from cruse_tpu_torch.ops.gru_kernel import gru_sequence
from cruse_tpu_torch.ops.gru_kernel import gru_sequence_reference as gru_scan  # noqa: F401
# ``gru_scan`` is the plain recurrence, the counterpart of cruse_tpu's lax.scan


class GroupedGRULayer(nn.Module):
    """G independent GRUs over feature slices, outputs concatenated.

    Input [B, T, I] (I divisible by groups) -> output [B, T, H], each group
    mapping I/G -> H/G. ``recurrence`` is the function that runs the
    recurrence (``gru_sequence``); the plain version may be put in its place
    to check the kernel against it.
    """

    def __init__(self, input_size: int, hidden_size: int, groups: int = 1):
        super().__init__()
        if input_size % groups or hidden_size % groups:
            raise ValueError(f"sizes {input_size}, {hidden_size} not divisible by {groups} groups")
        self.groups = groups
        self.input_size = input_size // groups
        self.hidden_size = hidden_size // groups
        g, i, h = groups, self.input_size, self.hidden_size
        self.w_ih = nn.Parameter(torch.zeros(g, 3 * h, i))
        self.w_hh = nn.Parameter(torch.zeros(g, 3 * h, h))
        self.b_ih = nn.Parameter(torch.zeros(g, 3 * h))
        self.b_hh = nn.Parameter(torch.zeros(g, 3 * h))
        self.recurrence = gru_sequence

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = self.hidden_size ** -0.5
        with torch.no_grad():
            for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    def init_state(self, batch_size: int, device=None, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(batch_size, self.groups, self.hidden_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, h0: torch.Tensor | None = None):
        b, t, _ = x.shape
        if h0 is None:
            h0 = self.init_state(b, x.device, x.dtype)
        xg = x.reshape(b, t, self.groups, self.input_size)
        x_proj = (torch.einsum("btgi,gki->btgk", xg, self.w_ih) + self.b_ih).contiguous()
        y, h_last = self.recurrence(x_proj, h0.contiguous(), self.w_hh, self.b_hh)
        return y.reshape(b, t, self.groups * self.hidden_size), h_last


class GRU(nn.Module):
    """The plain single-layer GRU (``torch.nn.GRU``'s equations): a
    ``GroupedGRULayer`` of one group under ``layer``, as the JAX package's
    ``GRU`` holds its weights under ``layer``. Input ``[B, T, I]``, state
    ``h0 [B, H]`` -> ``(y [B, T, H], h_last [B, H])``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.layer = GroupedGRULayer(input_size, hidden_size, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor, h0: torch.Tensor | None = None):
        y, h_last = self.layer(x, None if h0 is None else h0[:, None, :])
        return y, h_last[:, 0, :]


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[..., G*H] concat layout -> interleaved layout (index h*G + g)."""
    *lead, f = x.shape
    return x.reshape(*lead, groups, f // groups).transpose(-1, -2).reshape(*lead, f)


class GGRUBottleneck(nn.Module):
    """CRUSE bottleneck: two grouped-GRU banks, LayerNorm after each, and
    channel-shuffle mixing between them. Input [B, T, D]; returns
    (y [B, T, D], (h1, h2)) with each state [B, G, D/G]."""

    def __init__(self, dim: int, groups: int = 2):
        super().__init__()
        self.groups = groups
        self.bank1 = GroupedGRULayer(dim, dim, groups)
        self.bank2 = GroupedGRULayer(dim, dim, groups)
        self.ln1 = nn.LayerNorm(dim, eps=1e-5)
        self.ln2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, state=None):
        h1, h2 = (None, None) if state is None else state
        out, h1n = self.bank1(x, h1)
        out = self.ln1(channel_shuffle(out, self.groups))
        out, h2n = self.bank2(out, h2)
        return self.ln2(out), (h1n, h2n)
