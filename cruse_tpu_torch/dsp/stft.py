"""STFT / iSTFT (counterpart of ``cruse_tpu/dsp/stft.py``; cuFFT on the card).

Semantics are the JAX package's, which it pins to torch's: centred reflect
padding, periodic windows zero-padded (centred) to ``n_fft`` when
``win_length < n_fft``, one-sided spectra, and iSTFT normalised by the
overlap-added squared window. With an explicit ``length`` the iSTFT keeps
the partial-envelope tail and zero-pads past the last frame.

``center=True`` goes through ``torch.stft`` / ``torch.istft``. The iSTFT with
``center=False`` (the streaming contract) is the JAX package's own: a
windowed inverse DFT per frame, overlap-add, and division by the
overlap-added squared window where it exceeds 1e-11 (1 elsewhere);
``torch.istft`` refuses such an envelope when it touches zero, as a Hann
window's first sample does.

The numpy helpers ``_padded_window``, ``_analysis_kernel``,
``_synthesis_kernel`` and ``_ola_envelope`` are the JAX package's windowed
DFT bases and envelope, which the streaming step multiplies by per frame.

Spectra are time-major ``[B, T, F]`` complex, waveforms ``[B, L]``;
``mc_stft`` takes multi-channel waveforms ``[B, C, L]`` to ``[B, C, T, F]``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

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


def _padded_window(cfg: StftConfig) -> np.ndarray:
    """Window zero-padded (centred) to n_fft, like torch.stft; float64."""
    w = get_window(cfg.window, cfg.win_length, periodic=True)
    if cfg.win_length < cfg.n_fft:
        left = (cfg.n_fft - cfg.win_length) // 2
        w = np.pad(w, (left, cfg.n_fft - cfg.win_length - left))
    return w.astype(np.float64)


@functools.lru_cache(maxsize=None)
def _analysis_kernel(cfg: StftConfig) -> np.ndarray:
    """Windowed forward DFT basis [2F, N] (real rows, then imaginary)."""
    n, f = cfg.n_fft, cfg.num_bins
    ang = -2.0 * np.pi * np.outer(np.arange(f), np.arange(n)) / n
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=0)
    return (basis * _padded_window(cfg)[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _synthesis_kernel(cfg: StftConfig) -> np.ndarray:
    """Windowed inverse DFT basis [2F, N]: frame[n] = sum_f fold_f / N *
    (Re X_f cos(2 pi f n / N) - Im X_f sin(.)), fold 2 except at DC and
    Nyquist, times the synthesis window."""
    n, f = cfg.n_fft, cfg.num_bins
    fold = np.full((f, 1), 2.0)
    fold[0] = 1.0
    if n % 2 == 0:
        fold[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(np.arange(f), np.arange(n)) / n
    basis = np.concatenate([fold * np.cos(ang) / n, -fold * np.sin(ang) / n], axis=0)
    return (basis * _padded_window(cfg)[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ola_envelope(cfg: StftConfig, num_frames: int) -> np.ndarray:
    """Overlap-added squared window over num_frames frames, 1 where it is
    not above 1e-11 (samples no window covers)."""
    n, hop = cfg.n_fft, cfg.hop_length
    w2 = _padded_window(cfg) ** 2
    env = np.zeros(n + hop * (num_frames - 1))
    for t in range(num_frames):
        env[t * hop : t * hop + n] += w2
    return np.where(env > 1e-11, env, 1.0).astype(np.float32)


def _window(cfg: StftConfig, device) -> torch.Tensor:
    return torch.from_numpy(get_window(cfg.window, cfg.win_length, periodic=True)).to(device)


def stft(y: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Waveform [B, L] (or [L]) -> complex spectrum [B, T, F]."""
    spec = torch.stft(y, cfg.n_fft, cfg.hop_length, cfg.win_length, window=_window(cfg, y.device),
                      center=cfg.center, pad_mode="reflect", return_complex=True)
    return spec.transpose(-1, -2)


def _istft_uncentred(spec: torch.Tensor, cfg: StftConfig, length: int | None) -> torch.Tensor:
    """The JAX package's iSTFT for center=False (cruse_tpu/dsp/stft.py:215)."""
    n, hop = cfg.n_fft, cfg.hop_length
    num_frames = spec.shape[-2]
    basis = torch.from_numpy(_synthesis_kernel(cfg)).to(spec.device)
    ri = torch.cat([spec.real, spec.imag], dim=-1)  # [B, T, 2F]
    frames = ri @ basis  # [B, T, N] windowed synthesis frames
    total = n + hop * (num_frames - 1)
    y = F.fold(frames.transpose(1, 2), output_size=(1, total), kernel_size=(1, n),
               stride=(1, hop))[:, 0, 0]  # overlap-add
    y = y / torch.from_numpy(_ola_envelope(cfg, num_frames)).to(y.device)
    if length is None or length == total:
        return y
    return y[:, :length] if length < total else F.pad(y, (0, length - total))


def istft(spec, cfg: StftConfig, length: int | None = None) -> torch.Tensor:
    """Complex spectrum [B, T, F], or a (real, imag) pair, -> waveform [B, L]."""
    if isinstance(spec, (tuple, list)):
        spec = torch.complex(*spec)
    if not cfg.center:
        return _istft_uncentred(spec, cfg, length)
    return torch.istft(spec.transpose(-1, -2), cfg.n_fft, cfg.hop_length, cfg.win_length,
                       window=_window(cfg, spec.device), center=cfg.center, length=length)


def istft_mag_phase(mag, phase, cfg: StftConfig, length: int | None = None) -> torch.Tensor:
    """iSTFT from magnitude and phase."""
    return istft((mag * torch.cos(phase), mag * torch.sin(phase)), cfg, length)


def mc_stft(y: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Multi-channel STFT: ``[B, C, L] -> [B, C, T, F]``, the channels folded
    into the batch."""
    if y.dim() != 3:
        raise ValueError(f"mc_stft takes [B, C, L], got {tuple(y.shape)}")
    b, c, n = y.shape
    spec = stft(y.reshape(b * c, n), cfg)
    return spec.reshape(b, c, *spec.shape[1:])


def mag_phase(spec: torch.Tensor):
    """Split a complex spectrum into (magnitude, phase)."""
    return spec.abs(), spec.angle()
