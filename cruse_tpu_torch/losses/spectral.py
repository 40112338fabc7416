"""Spectral-domain losses (counterpart of ``cruse_tpu/losses/spectral.py``).

Complex spectra are ``[B, T, F]`` (time-major), complex, or stacked real and
imaginary parts ``[B, T, F, 2]``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cruse_tpu_torch.dsp.features import frame_vad
from cruse_tpu_torch.dsp.stft import StftConfig, stft


class _StableAngle(torch.autograd.Function):
    """atan2 whose gradient divides by the squared radius clamped to 1e-10
    (the JAX package's custom JVP), so that it stays finite at r -> 0."""

    @staticmethod
    def forward(ctx, real, imag):
        ctx.save_for_backward(real, imag)
        return torch.atan2(imag, real)

    @staticmethod
    def backward(ctx, grad):
        real, imag = ctx.saved_tensors
        r2 = torch.clamp(real ** 2 + imag ** 2, min=1e-10)
        return -imag * grad / r2, real * grad / r2


def stable_angle(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """atan2(imag, real) with a zero-safe gradient."""
    return _StableAngle.apply(real, imag)


def _split_ri(spec: torch.Tensor):
    """Complex ``[B, T, F]`` or stacked ``[B, T, F, 2]`` -> (re, im)."""
    if spec.is_complex():
        return spec.real, spec.imag
    if spec.shape[-1] != 2:
        raise ValueError(f"a real spectrum must be [..., 2] (re, im), got {tuple(spec.shape)}")
    return spec[..., 0], spec[..., 1]


def rmse_loss(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean absolute error of the real and imaginary parts, normalised by
    B*T*F."""
    re_e, im_e = _split_ri(est)
    re_r, im_r = _split_ri(ref)
    err = (re_e - re_r).abs() + (im_e - im_r).abs()
    return err.sum() / err.numel()


def compressed_spectral_loss(est: torch.Tensor, ref: torch.Tensor, c: float = 0.3,
                             beta: float = 0.3, eps: float = 1e-8) -> torch.Tensor:
    """Power-law compressed magnitude MSE blended with the MSE of the
    compressed complex spectra, each with its own phase (sums, not means)::

        (1 - beta) * sum((|S|^c - |S^|^c)^2)
        + beta * sum(| |S^|^c e^{j phi_s^} - |S|^c e^{j phi_s} |^2)
    """
    re_e, im_e = _split_ri(est)
    re_r, im_r = _split_ri(ref)
    mag_e = torch.sqrt(re_e ** 2 + im_e ** 2 + eps)
    mag_r = torch.sqrt(re_r ** 2 + im_r ** 2 + eps)
    comp_e, comp_r = mag_e ** c, mag_r ** c
    scale_e, scale_r = comp_e / mag_e, comp_r / mag_r  # unit phase times compressed magnitude
    dr = scale_e * re_e - scale_r * re_r
    di = scale_e * im_e - scale_r * im_r
    loss_mag = ((comp_r - comp_e) ** 2).sum()
    loss_cplx = (dr ** 2 + di ** 2).sum()
    return (1.0 - beta) * loss_mag + beta * loss_cplx


def weighted_male_loss(est: torch.Tensor, ref: torch.Tensor, noisy: torch.Tensor, alpha: float = 2.0,
                       beta: float = 1.0, gamma: float = 1.0, eps: float = 1e-8) -> torch.Tensor:
    """WO-MALE: the mean absolute log-magnitude error weighted by
    ``exp(alpha / (beta + IAM^gamma))``."""
    re_e, im_e = _split_ri(est)
    re_r, im_r = _split_ri(ref)
    re_n, im_n = _split_ri(noisy)
    mag_e = torch.sqrt(re_e ** 2 + im_e ** 2 + eps)
    mag_r = torch.sqrt(re_r ** 2 + im_r ** 2 + eps)
    mag_n = torch.sqrt(re_n ** 2 + im_n ** 2 + eps)
    iam = (mag_r / (mag_n + eps)) ** gamma
    weight = torch.exp(alpha / (beta + iam))
    loss = weight * (torch.log10(mag_e + 1.0) - torch.log10(mag_r + 1.0)).abs()
    return loss.sum() / loss.numel()


def sdnr_loss(clean_spec: torch.Tensor, gain: torch.Tensor, noise_spec: torch.Tensor, snr_db: torch.Tensor,
              beta_db: float = 20.0, vad_threshold_db: float = -60.0) -> torch.Tensor:
    """SNR-weighted speech-distortion plus noise-suppression loss.

    ``clean_spec``, ``noise_spec``: complex ``[B, T, F]``; ``gain``: a
    ``[B, T, F]`` mask in [0, 1]; ``snr_db``: ``[B]``. ``alpha = snr / (snr +
    beta)`` in linear power weighs the speech term (VAD-gated clean frames)
    against the suppressed noise energy."""
    clean_mag = clean_spec.abs()
    l_noise = ((noise_spec.abs() * gain) ** 2).sum(dim=(-2, -1)).mean()
    s_sa = frame_vad(clean_mag, vad_threshold_db) * clean_mag
    l_speech = ((s_sa - gain * s_sa) ** 2).sum(dim=(-2, -1)).mean()
    snr_lin = 10.0 ** (snr_db / 10.0)
    beta_lin = 10.0 ** (beta_db / 10.0)
    alpha = (snr_lin / (snr_lin + beta_lin)).mean()
    return alpha * l_speech + (1.0 - alpha) * l_noise


@dataclasses.dataclass(frozen=True)
class MultiResSpectralConfig:
    n_ffts: Tuple[int, ...] = (512, 1024, 2048)
    gamma: float = 0.3  # magnitude compression
    factor_magnitude: float = 1.0
    factor_complex: float = 1.0


def multi_res_spectral_loss(est_wav: torch.Tensor, ref_wav: torch.Tensor,
                            cfg: MultiResSpectralConfig = MultiResSpectralConfig()) -> torch.Tensor:
    """Multi-resolution compressed spectral loss on waveforms: for each FFT
    size (hop n_fft / 4, Hann), the MSE of |X|^gamma plus the MSE of the
    compressed complex spectra."""
    total = 0.0
    for n_fft in cfg.n_ffts:
        scfg = StftConfig(n_fft=n_fft, hop_length=n_fft // 4)
        s_e, s_r = stft(est_wav, scfg), stft(ref_wav, scfg)
        mag_e, mag_r = s_e.abs(), s_r.abs()
        comp_e, comp_r = (mag_e + 1e-12) ** cfg.gamma, (mag_r + 1e-12) ** cfg.gamma
        total = total + cfg.factor_magnitude * ((comp_e - comp_r) ** 2).mean()
        if cfg.factor_complex > 0:
            d = comp_e / (mag_e + 1e-12) * s_e - comp_r / (mag_r + 1e-12) * s_r
            total = total + cfg.factor_complex * (d.abs() ** 2).mean()
    return total


def cirm_mse_loss(enhanced_ri: torch.Tensor, noisy_ri: torch.Tensor, clean_ri: torch.Tensor) -> torch.Tensor:
    """The MSE between the compressed complex ratio mask that the enhanced
    spectrum implies (enhanced / noisy) and the compressed ideal one; all
    three are ``[..., F, 2]`` RI spectra."""
    from cruse_tpu_torch.dsp.mask import build_complex_ideal_ratio_mask, compress_cirm

    nr, ni = noisy_ri[..., 0], noisy_ri[..., 1]
    er, ei = enhanced_ri[..., 0], enhanced_ri[..., 1]
    denom = nr ** 2 + ni ** 2 + 1e-8
    pred_r = compress_cirm((nr * er + ni * ei) / denom)
    pred_i = compress_cirm((nr * ei - ni * er) / denom)
    ideal_r, ideal_i = build_complex_ideal_ratio_mask(torch.complex(nr, ni),
                                                      torch.complex(clean_ri[..., 0], clean_ri[..., 1]))
    return ((pred_r - ideal_r) ** 2 + (pred_i - ideal_i) ** 2).mean()
