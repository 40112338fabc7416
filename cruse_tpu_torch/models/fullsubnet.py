"""FullSubNet: a full-band and a sub-band recurrent stage with a cIRM output
(counterpart of ``cruse_tpu/models/fullsubnet.py``).

- Full band: the normalized magnitude -> ``fb_layers`` stacked GRUs over
  time -> a Dense to F bins and a ReLU.
- Sub band: each bin's unit is its ``freq_unfold`` neighbourhood of the
  *un-normalized* magnitude with the full-band output of that bin appended;
  the F units of every utterance are folded into the batch (``[B·F, T,
  S+1]``), normalized per unit, and run through ONE stack of
  ``sb_layers`` GRUs that all bins share -> a Dense to the compressed cIRM
  (real, imaginary) of the bin.

Every recurrence is ``nn/gru.py::GRU``, so on the card the grouped-GRU
kernels run it at G = 1 (``ops/gru_kernel.py::gru_sequence``); at the
published widths the full band (H = 512) runs route A, the resident kernel
at a 16-block cluster (8 rows a block), and the sub band (H = 384, B·F rows)
route B, the row-tiled kernel (``forward_plan``); under a gradient their
backwards take the same two routes (``backward_plan``).

Streaming: the GRU states thread through ``state`` (``fb_i [B, H_fb]``,
``sb_i [B·F, H_sb]``); with ``norm="cumulative_laplace_norm"`` the norms'
running (sum, count) carry too (``norm_mag`` of ``[B]`` leaves, ``norm_units``
of ``[B·F]``), so a call on the next chunk continues the last one. The
offline norms read the whole utterance and cannot stream. Training: the
``fullsubnet`` forward adapter (``train/step.py``) decompresses the cIRM and
multiplies the noisy spectrum with it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cruse_tpu_torch.models.dfsmn import _linear
from cruse_tpu_torch.nn.gru import GRU
from cruse_tpu_torch.nn.norms import cumulative_laplace_norm_carry, norm_wrapper
from cruse_tpu_torch.nn.subband import freq_unfold


@dataclasses.dataclass(frozen=True)
class FullSubNetConfig:
    num_freqs: int = 257
    num_neighbors: int = 15
    fb_hidden: int = 512
    fb_layers: int = 2
    sb_hidden: int = 384
    sb_layers: int = 2
    norm: str = "offline_laplace_norm"
    look_ahead: int = 0  # output delay in frames (FullSubNet uses 2 offline)


class FullSubNet(nn.Module):
    """Magnitude ``[B, T, F]`` -> ``(compressed cIRM [B, T, F, 2], state)``.
    The weights are made from ``generator``: the GRUs uniform in ±1/√H, the
    Dense layers lecun-normal with zero biases, as flax initialises them."""

    def __init__(self, config: FullSubNetConfig = FullSubNetConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
        gen = generator or torch.Generator().manual_seed(0)
        width = cfg.num_freqs
        for li in range(cfg.fb_layers):
            setattr(self, f"fb_gru_{li}", GRU(width, cfg.fb_hidden))
            width = cfg.fb_hidden
        self.fb_out = _linear(gen, width, cfg.num_freqs)
        width = (2 * cfg.num_neighbors + 1 if cfg.num_neighbors >= 1 else 1) + 1
        for li in range(cfg.sb_layers):
            setattr(self, f"sb_gru_{li}", GRU(width, cfg.sb_hidden))
            width = cfg.sb_hidden
        self.sb_out = _linear(gen, width, 2)
        for m in self.modules():
            if isinstance(m, GRU):
                m.reset_parameters(gen)

    def compress(self, mag: torch.Tensor) -> torch.Tensor:
        """The identity: the norms inside the model normalize the magnitude."""
        return mag

    def forward(self, mag: torch.Tensor, state: Optional[dict] = None, train: bool = False):
        """``train`` changes nothing (the net has no BatchNorm or dropout)."""
        cfg = self.config
        b, t, f = mag.shape
        if f != cfg.num_freqs:
            raise ValueError(f"{f} bins in, the model takes num_freqs={cfg.num_freqs}")
        st = state or {}
        new_state: dict = {}
        if cfg.norm == "cumulative_laplace_norm":
            def norm_with(key):
                def norm(x):
                    y, new_state[key] = cumulative_laplace_norm_carry(x, st.get(key))
                    return y
                return norm

            norm_mag, norm_units = norm_with("norm_mag"), norm_with("norm_units")
        else:
            norm_mag = norm_units = norm_wrapper(cfg.norm)

        fb = norm_mag(mag)
        for li in range(cfg.fb_layers):
            fb, new_state[f"fb_{li}"] = getattr(self, f"fb_gru_{li}")(fb, st.get(f"fb_{li}"))
        fb = torch.relu(self.fb_out(fb))  # [B, T, F]

        units = torch.cat([freq_unfold(mag, cfg.num_neighbors), fb[..., None]], dim=-1)  # [B, T, F, S+1]
        sb = norm_units(units.transpose(1, 2).reshape(b * f, t, -1))  # [B·F, T, S+1], a unit a row
        for li in range(cfg.sb_layers):
            sb, new_state[f"sb_{li}"] = getattr(self, f"sb_gru_{li}")(sb, st.get(f"sb_{li}"))
        cirm = self.sb_out(sb).reshape(b, f, t, 2).transpose(1, 2)  # [B, T, F, 2]
        if cfg.look_ahead > 0:
            cirm = F.pad(cirm, (0, 0, 0, 0, 0, cfg.look_ahead))[:, cfg.look_ahead :]
        # in init_state's order, so that a state's leaves line up with a fresh one's
        return cirm, {key: new_state[key] for key in self.state_keys()}

    def state_keys(self) -> list:
        """The streaming state's keys in order: the GRUs', then the norms'."""
        cfg = self.config
        keys = [f"fb_{li}" for li in range(cfg.fb_layers)] + [f"sb_{li}" for li in range(cfg.sb_layers)]
        return keys + (["norm_mag", "norm_units"] if cfg.norm == "cumulative_laplace_norm" else [])

    def init_state(self, batch_size: int, device: torch.device | str = "cpu") -> dict:
        """Fresh streaming state: zero GRU states and, with the cumulative
        norm, zero running sums and counts."""
        cfg = self.config
        units = batch_size * cfg.num_freqs
        st = {f"fb_{li}": torch.zeros(batch_size, cfg.fb_hidden, device=device) for li in range(cfg.fb_layers)}
        st.update({f"sb_{li}": torch.zeros(units, cfg.sb_hidden, device=device) for li in range(cfg.sb_layers)})
        if cfg.norm == "cumulative_laplace_norm":
            st["norm_mag"] = (torch.zeros(batch_size, device=device), torch.zeros(batch_size, device=device))
            st["norm_units"] = (torch.zeros(units, device=device), torch.zeros(units, device=device))
        return st
