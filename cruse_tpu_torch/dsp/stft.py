"""STFT / iSTFT on ``torch.stft`` / ``torch.istft`` (counterpart of
``cruse_tpu/dsp/stft.py``; cuFFT on the card).

Semantics are the JAX package's, which it pins to torch's: centred reflect
padding, periodic windows zero-padded (centred) to ``n_fft`` when
``win_length < n_fft``, one-sided spectra, and iSTFT normalised by the
overlap-added squared window. With an explicit ``length`` the iSTFT keeps
the partial-envelope tail and zero-pads past the last frame.

Spectra are time-major ``[B, T, F]`` complex, waveforms ``[B, L]``.
"""
from __future__ import annotations

import dataclasses

import torch

from cruse_tpu_torch.dsp.windows import get_window


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """Static STFT geometry."""

    n_fft: int = 512
    hop_length: int = 256
    win_length: int | None = None
    window: str = "hann"
    center: bool = True

    def __post_init__(self):
        if self.win_length is None:
            object.__setattr__(self, "win_length", self.n_fft)
        if not (0 < self.win_length <= self.n_fft and self.hop_length > 0):
            raise ValueError(f"bad STFT geometry {self}")

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1


def _window(cfg: StftConfig, device) -> torch.Tensor:
    return torch.from_numpy(get_window(cfg.window, cfg.win_length, periodic=True)).to(device)


def stft(y: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Waveform [B, L] (or [L]) -> complex spectrum [B, T, F]."""
    spec = torch.stft(y, cfg.n_fft, cfg.hop_length, cfg.win_length, window=_window(cfg, y.device),
                      center=cfg.center, pad_mode="reflect", return_complex=True)
    return spec.transpose(-1, -2)


def istft(spec, cfg: StftConfig, length: int | None = None) -> torch.Tensor:
    """Complex spectrum [B, T, F], or a (real, imag) pair, -> waveform [B, L]."""
    if isinstance(spec, (tuple, list)):
        spec = torch.complex(*spec)
    return torch.istft(spec.transpose(-1, -2), cfg.n_fft, cfg.hop_length, cfg.win_length,
                       window=_window(cfg, spec.device), center=cfg.center, length=length)


def istft_mag_phase(mag, phase, cfg: StftConfig, length: int | None = None) -> torch.Tensor:
    """iSTFT from magnitude and phase."""
    return istft((mag * torch.cos(phase), mag * torch.sin(phase)), cfg, length)


def mag_phase(spec: torch.Tensor):
    """Split a complex spectrum into (magnitude, phase)."""
    return spec.abs(), spec.angle()
