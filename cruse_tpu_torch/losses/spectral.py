"""Compressed spectral loss (counterpart of
``cruse_tpu/losses/spectral.py::compressed_spectral_loss``)."""
from __future__ import annotations

import torch


def _split_ri(spec: torch.Tensor):
    """Complex ``[B, T, F]`` or stacked ``[B, T, F, 2]`` -> (re, im)."""
    if spec.is_complex():
        return spec.real, spec.imag
    if spec.shape[-1] != 2:
        raise ValueError(f"a real spectrum must be [..., 2] (re, im), got {tuple(spec.shape)}")
    return spec[..., 0], spec[..., 1]


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
