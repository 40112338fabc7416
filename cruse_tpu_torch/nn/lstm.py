"""The LSTM of BSRNN (counterpart of ``cruse_tpu/nn/lstm.py``): torch's gate
math (i, f, g, o), batch-first, optionally bidirectional.

``LSTM`` runs ``torch.nn.LSTM``, which on the card is cuDNN's RNN (the JAX
LSTM is a ``lax.scan``, not a Pallas kernel, so the port has no kernel of its
own here). Its weights are ``nn.LSTM``'s flat ones (``rnn.weight_ih_l0``,
``rnn.weight_hh_l0``, ``rnn.bias_ih_l0``, ``rnn.bias_hh_l0`` and their
``_reverse`` set), in the JAX leaves' layouts (``w_ih [4H, I]``, ``w_hh
[4H, H]``, ``b_* [4H]``), which the weight bridge renames. The state keeps
the JAX layout, ``(h, c)`` each ``[B, dirs, H]``; ``nn.LSTM``'s ``[dirs, B,
H]`` is transposed at the boundary.

``lstm_scan`` is the plain recurrence, a loop over time, which the tests and
the on-card check hold the module against (``LSTM.plain = True`` runs it
on the module's own weights); no entry point takes it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

_WEIGHTS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def lstm_scan(x_proj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor, reverse: bool = False):
    """x_proj: [B, T, 4H] (the input projection with b_ih applied); h0, c0
    [B, H]; w_hh [4H, H]. Returns (y [B, T, H], (h, c)); ``reverse`` walks
    the frames last to first, and y keeps their order."""
    h, c = h0, c0
    steps = range(x_proj.shape[1] - 1, -1, -1) if reverse else range(x_proj.shape[1])
    ys = [None] * x_proj.shape[1]
    for t in steps:
        gates = x_proj[:, t] + h @ w_hh.T + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys, dim=1), (h, c)


class LSTM(nn.Module):
    """Single-layer LSTM, batch-first: ``x [B, T, I]``, ``state (h, c)`` each
    ``[B, dirs, H]`` or None (zeros) -> ``(y [B, T, dirs·H], (h, c))``, the
    directions' outputs concatenated forward first."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.dirs = 2 if bidirectional else 1
        self.rnn = nn.LSTM(input_size, hidden_size, batch_first=True, bidirectional=bidirectional)
        self.plain = False  # True: lstm_scan on the same weights (checks only)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Uniform in ±1/√H, as both packages initialise the LSTM."""
        bound = self.hidden_size ** -0.5
        with torch.no_grad():
            for p in self.rnn.parameters():
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)

    def weights(self, direction: int):
        """(w_ih, w_hh, b_ih, b_hh) of one direction."""
        sfx = "_l0" + ("_reverse" if direction else "")
        return tuple(getattr(self.rnn, name + sfx) for name in _WEIGHTS)

    def forward(self, x: torch.Tensor, state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        b = x.shape[0]
        if state is None:
            h0 = c0 = x.new_zeros(b, self.dirs, self.hidden_size)
        else:
            h0, c0 = state
        if not self.plain:
            y, (hn, cn) = self.rnn(x, (h0.transpose(0, 1).contiguous(), c0.transpose(0, 1).contiguous()))
            return y, (hn.transpose(0, 1), cn.transpose(0, 1))
        outs, hs, cs = [], [], []
        for d in range(self.dirs):
            w_ih, w_hh, b_ih, b_hh = self.weights(d)
            y, (h, c) = lstm_scan(x @ w_ih.T + b_ih, h0[:, d], c0[:, d], w_hh, b_hh, reverse=d == 1)
            outs.append(y)
            hs.append(h)
            cs.append(c)
        return torch.cat(outs, dim=-1), (torch.stack(hs, dim=1), torch.stack(cs, dim=1))
