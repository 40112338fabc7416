"""CRUSE: causal conv U-Net encoder/decoder + grouped-GRU bottleneck
(counterpart of ``cruse_tpu/models/cruse.py``).

- encoder: L levels of causal Conv2d (kernel (2,3), freq stride 2) + BN + ReLU
- per-level 1x3 conv skip connections (no bias)
- bottleneck: two grouped-GRU banks with LayerNorm + interleave mixing
- decoder: skip-add -> causal ConvTranspose2d (or nearest upsample + conv)
  + BN + ReLU per level; the last level emits a 1-channel mask (no norm)

The public layout is the JAX package's: features and masks are ``[B, T, F]``.
Inside, activations are NCHW ``[B, C, T, F]``; the bottleneck flattens
(F', C) f-major, as the JAX model does. Each conv level consumes an
explicitly extended input (kt-1 past frames prepended), and the returned
state carries those frames and the GRU states, so calling with carried state
continues an utterance exactly.

Submodule names follow the flax parameter names (``enc_0``, ``skip_0``,
``ggru.bank1``, ``dec_0`` ...) so that ``utils.weights`` maps one onto the
other by path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cruse_tpu_torch.nn.conv import BatchNorm2d, CausalConv2d
from cruse_tpu_torch.nn.gru import GGRUBottleneck, GroupedGRULayer


@dataclasses.dataclass(frozen=True)
class CruseConfig:
    in_freq: int = 161  # n_fft//2 + 1 for the 320-pt STFT
    channels: Tuple[int, ...] = (8, 16, 32, 64)
    kernel: Tuple[int, int] = (2, 3)
    fstride: int = 2
    rnn_groups: int = 4
    skip_convs: bool = True
    decoder_mode: str = "transposed"  # "transposed" | "upsample"
    mask_activation: str = "sigmoid"  # "sigmoid" | "relu" | "none"
    feature_compression: str = "pow"  # "pow" | "log1p" | "none"
    compression_exponent: float = 0.3
    emit_features: bool = False  # also return the bottleneck output (CRUSE+DF's tap)

    @property
    def num_levels(self) -> int:
        return len(self.channels)

    def freq_sizes(self) -> Tuple[int, ...]:
        """Frequency-axis sizes after each encoder level."""
        sizes = [self.in_freq]
        f = self.in_freq
        kf = self.kernel[1]
        for _ in self.channels:
            f = (f + 2 * (kf // 2) - kf) // self.fstride + 1
            sizes.append(f)
        return tuple(sizes)

    @property
    def bottleneck_dim(self) -> int:
        return self.freq_sizes()[-1] * self.channels[-1]


def compress_mag(mag: torch.Tensor, cfg: CruseConfig) -> torch.Tensor:
    """Feature compression of a magnitude spectrum."""
    if cfg.feature_compression == "pow":
        return torch.pow(torch.clamp(mag, min=1e-12), cfg.compression_exponent)
    if cfg.feature_compression == "log1p":
        return torch.log1p(mag)
    return mag


def cruse_init_state(c: CruseConfig, batch_size: int, device=None, dtype=torch.float32):
    """Fresh state: (encoder histories, (h1, h2), decoder histories).

    Histories are NCHW ``[B, C_in, kt-1, F]`` per level; GRU states
    ``[B, G, D/G]`` per bank."""
    ctx = c.kernel[0] - 1
    fs = c.freq_sizes()
    in_chs = [1] + list(c.channels[:-1])
    conv_hist = tuple(torch.zeros(batch_size, in_chs[li], ctx, fs[li], device=device, dtype=dtype)
                      for li in range(c.num_levels))
    g_shape = (batch_size, c.rnn_groups, c.bottleneck_dim // c.rnn_groups)
    gru_state = (torch.zeros(g_shape, device=device, dtype=dtype),
                 torch.zeros(g_shape, device=device, dtype=dtype))
    dec_in_chs = list(c.channels[::-1])
    dec_hist = tuple(
        torch.zeros(batch_size, dec_in_chs[li], ctx, fs[c.num_levels - li], device=device,
                    dtype=dtype)
        for li in range(c.num_levels))
    return conv_hist, gru_state, dec_hist


class CausalConvTranspose2dTimeMajor(nn.Module):
    """ConvTranspose over an explicitly extended input ``[B, C, T+kt-1, F]``:
    output frame t uses extended frames t..t+kt-1 (the causal trim of a VALID
    transposed conv). Frequency behaves like ConvTranspose2d with padding
    kf//2."""

    def __init__(self, in_channels: int, features: int, kernel: Tuple[int, int] = (2, 3),
                 fstride: int = 2, norm: bool = True, act=torch.relu):
        super().__init__()
        kt, kf = kernel
        self.kt = kt
        self.conv = nn.ConvTranspose2d(in_channels, features, (kt, kf), stride=(1, fstride),
                                       padding=(0, kf // 2))
        self.bn = BatchNorm2d(features, eps=1e-5) if norm else None
        self.act = act

    def forward(self, x_ext: torch.Tensor) -> torch.Tensor:
        t_out = x_ext.shape[2] - (self.kt - 1)
        x = self.conv(x_ext)[:, :, self.kt - 1 : self.kt - 1 + t_out]
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class CruseNet(nn.Module):
    """Mask-estimating CRUSE network: compressed magnitude ``[B, T, F]`` ->
    (mask ``[B, T, F]``, state), or ((mask, y), state) with
    ``emit_features``, y being the bottleneck output ``[B, T, D]``."""

    def __init__(self, config: CruseConfig = CruseConfig(), generator: torch.Generator | None = None):
        super().__init__()
        c = self.config = config
        if c.decoder_mode not in ("transposed", "upsample"):
            raise ValueError(f"unknown decoder_mode {c.decoder_mode!r}")
        if c.mask_activation not in ("sigmoid", "relu", "none"):
            raise ValueError(f"unknown mask_activation {c.mask_activation!r}")
        kt, kf = c.kernel
        chs = [1] + list(c.channels)
        for li, ch in enumerate(c.channels):
            self.add_module(f"enc_{li}", CausalConv2d(chs[li], ch, c.kernel, c.fstride))
            if c.skip_convs:
                self.add_module(f"skip_{li}", nn.Conv2d(ch, ch, (1, 3), padding=(0, 1), bias=False))
        self.ggru = GGRUBottleneck(c.bottleneck_dim, c.rnn_groups)
        dec_in = list(c.channels[::-1])
        dec_out = list(c.channels[:-1][::-1]) + [1]
        for li, ch in enumerate(dec_out):
            is_last = li == len(dec_out) - 1
            if c.decoder_mode == "upsample":
                self.add_module(f"dec_{li}_conv", nn.Conv2d(dec_in[li], ch, (kt, 3)))
                if not is_last:
                    self.add_module(f"dec_{li}_bn", BatchNorm2d(ch, eps=1e-5))
            else:
                self.add_module(f"dec_{li}", CausalConvTranspose2dTimeMajor(
                    dec_in[li], ch, c.kernel, c.fstride, norm=not is_last,
                    act=None if is_last else torch.relu))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation: conv kernels lecun-normal, conv biases 0,
        norms identity with fresh statistics, GRUs uniform(+-1/sqrt(H))."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    w = m.weight
                    fan_in = w.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1] * w[0, 0].numel()
                    w.copy_(torch.randn(w.shape, generator=generator) * fan_in ** -0.5)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                    m.reset_parameters()
                elif isinstance(m, GroupedGRULayer):
                    m.reset_parameters(generator)

    def compress(self, mag: torch.Tensor) -> torch.Tensor:
        return compress_mag(mag, self.config)

    def forward(self, feat: torch.Tensor, state=None, train: bool = False):
        """feat: [B, T, F] compressed magnitude. Returns (mask [B, T, F], state),
        or ((mask, y [B, T, D]), state) with ``emit_features``.

        state: None for a fresh utterance, else the tuple returned by the
        previous call (conv histories + GRU states), to continue it.
        train: the training forward (BatchNorm on the batch's statistics,
        which it records in place); it must agree with the module's mode.
        """
        c = self.config
        if train != self.training:
            raise ValueError(f"train={train} but the module is in "
                             f"{'training' if self.training else 'eval'} mode: call "
                             f"{'.train()' if train else '.eval()'} first (BatchNorm follows the mode)")
        if feat.shape[-1] != c.in_freq:
            raise ValueError(f"feat has {feat.shape[-1]} bins, the model {c.in_freq}")
        kt = c.kernel[0]
        ctx = kt - 1
        streaming = state is not None
        if state is None:
            conv_hist_in, gru_state, dec_hist_in = None, None, None
        else:
            conv_hist_in, gru_state, dec_hist_in = state
        conv_hist_out, dec_hist_out = [], []

        def extend(x, hist):
            # prepend the carried context, or ctx zero frames for a fresh utterance
            return torch.cat([hist, x], dim=2) if streaming else F.pad(x, (0, 0, ctx, 0))

        x = feat[:, None]  # [B, 1, T, F]
        skips = []
        for li in range(c.num_levels):
            x_ext = extend(x, conv_hist_in[li] if streaming else None)
            conv_hist_out.append(x_ext[:, :, x_ext.shape[2] - ctx :])
            x = getattr(self, f"enc_{li}")(x_ext)
            skips.append(getattr(self, f"skip_{li}")(x) if c.skip_convs else x)

        b, ch_last, t, f_bottleneck = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(b, t, f_bottleneck * ch_last)  # f-major (F', C)
        y, gru_state = self.ggru(flat, gru_state)
        x = y.reshape(b, t, f_bottleneck, ch_last).permute(0, 3, 1, 2)

        for li in range(c.num_levels):
            level = c.num_levels - 1 - li
            x = x + skips[level]
            x_ext = extend(x, dec_hist_in[li] if streaming else None)
            dec_hist_out.append(x_ext[:, :, x_ext.shape[2] - ctx :])
            if c.decoder_mode == "upsample":
                # nearest-neighbour freq upsample + causal conv
                target_f = c.freq_sizes()[level]
                x_up = x_ext.repeat_interleave(c.fstride, dim=3)[..., :target_f]
                x = getattr(self, f"dec_{li}_conv")(F.pad(x_up, (1, 1)))
                if li < c.num_levels - 1:
                    x = torch.relu(getattr(self, f"dec_{li}_bn")(x))
            else:
                x = getattr(self, f"dec_{li}")(x_ext)

        mask = x[:, 0]
        if c.mask_activation == "sigmoid":
            mask = torch.sigmoid(mask)
        elif c.mask_activation == "relu":
            mask = torch.relu(mask)
        new_state = (tuple(conv_hist_out), gru_state, tuple(dec_hist_out))
        if c.emit_features:
            return (mask, y), new_state  # y: the bottleneck output after ln2
        return mask, new_state


def enhance_spectrum(model: CruseNet, spec: torch.Tensor, state=None):
    """Apply the model to a complex spectrum [B, T, F]: returns (enhanced
    spec, mask, state)."""
    mag = spec.abs()
    mask, state = model(model.compress(mag), state)
    return spec * mask.to(mag.dtype), mask, state
