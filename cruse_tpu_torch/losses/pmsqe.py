"""PMSQE: a differentiable PESQ-structured perceptual loss (counterpart of
``cruse_tpu/losses/pmsqe.py``).

PESQ's perceptual model -- Bark-band powers, Zwicker loudness, masked
symmetric and asymmetric disturbance -- as a per-frame loss on the training
spectra (Martin-Donas et al., 2018). The Bark tables are built in float64
numpy, as the JAX package builds them, then cached as float32 tensors per
(n_fft, sr, nb, device). Each signal's level alignment is a constant of the
graph (``detach``), so the loss trains the spectral shape, not the gain.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

TARGET_POWER = 1.0e7  # PESQ's internal level
SL = 0.08  # Zwicker specific-loudness constant (sone/Bark)
ALPHA_SYM = 0.1  # PESQ's disturbance weights (P.862 sec. 10.3.4; PMSQE eq. 9)
ALPHA_ASYM = 0.0309


def _bark(f_hz):
    return 7.0 * np.arcsinh(np.asarray(f_hz, np.float64) / 650.0)


@functools.lru_cache(maxsize=None)
def pmsqe_tables_np(n_fft: int, sr: int, nb: int | None = None):
    """Bark integration matrix [NB, F], band widths [NB] (Bark), Terhardt
    thresholds [NB] (internal intensity), all float64, and the intensity
    scale, for the rfft bins of an ``n_fft`` transform at ``sr``."""
    if nb is None:
        nb = 49 if sr >= 16000 else 42
    f_low = 50.0 if sr >= 16000 else 100.0
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    edges_bark = np.linspace(_bark(f_low), _bark(sr / 2.0), nb + 1)
    z = _bark(freqs)
    mat = np.zeros((nb, len(freqs)))
    for i in range(nb):
        sel = (z >= edges_bark[i]) & (z < edges_bark[i + 1])
        if not sel.any():
            sel = np.zeros_like(z, bool)
            sel[np.argmin(np.abs(z - 0.5 * (edges_bark[i] + edges_bark[i + 1])))] = True
        mat[i, sel] = 1.0
    widths = np.diff(edges_bark)
    centers_hz = 650.0 * np.sinh(0.5 * (edges_bark[:-1] + edges_bark[1:]) / 7.0)
    khz = np.maximum(centers_hz / 1000.0, 0.02)
    tq_db = 3.64 * khz ** -0.8 - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2) + 1e-3 * khz ** 4
    thresh = 10.0 ** (np.clip(tq_db, -10.0, 96.0) / 10.0)
    intensity_scale = 10.0 ** (79.0 / 10.0) / (TARGET_POWER * n_fft / 4.0)
    return mat, widths, thresh, float(intensity_scale)


@functools.lru_cache(maxsize=None)
def pmsqe_tables(n_fft: int, sr: int, nb: int | None, device: torch.device):
    """``pmsqe_tables_np`` as float32 tensors on ``device``."""
    mat, widths, thresh, scale = pmsqe_tables_np(n_fft, sr, nb)
    return (*(torch.from_numpy(a.astype(np.float32)).to(device) for a in (mat, widths, thresh)), scale)


def _loudness(bands: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Zwicker specific loudness per Bark band; zero at or below threshold."""
    ratio = bands / thresh
    loud = SL * (thresh / 0.5) ** 0.23 * ((0.5 + 0.5 * torch.clamp(ratio, min=0.0)) ** 0.23 - 1.0)
    return torch.where(ratio > 1.0, loud, 0.0)


def pmsqe_loss(est_ri: torch.Tensor, ref_ri: torch.Tensor, sr: int = 16000, nb: int | None = None) -> torch.Tensor:
    """Mean per-frame PESQ disturbance between RI spectra ``[..., T, F, 2]``
    (F = n_fft / 2 + 1): the mean over frames and batch of ``ALPHA_SYM *
    D_sym + ALPHA_ASYM * D_asym``."""
    n_fft = 2 * (est_ri.shape[-2] - 1)
    mat, widths, thresh, iscale = pmsqe_tables(n_fft, sr, nb, est_ri.device)

    def power(ri):
        return ri[..., 0].float() ** 2 + ri[..., 1].float() ** 2

    def align(p):  # each signal to PESQ's internal level, a constant of the graph
        mean_pow = p.sum(dim=-1).mean(dim=-1, keepdim=True)
        return (TARGET_POWER * n_fft / (mean_pow + 1e-10)).detach()[..., None]

    p_est, p_ref = power(est_ri), power(ref_ri)
    b_ref = (p_ref * align(p_ref)) @ mat.T * iscale  # [..., T, NB]
    b_est = (p_est * align(p_est)) @ mat.T * iscale

    # per-frame partial gain compensation of the degraded signal toward the reference
    e_ref = (b_ref * widths).sum(dim=-1, keepdim=True)
    e_est = (b_est * widths).sum(dim=-1, keepdim=True)
    b_deg = b_est * torch.clamp((e_ref + 5e3) / (e_est + 5e3), 3e-4, 5.0)

    l_ref, l_deg = _loudness(b_ref, thresh), _loudness(b_deg, thresh)
    # symmetric disturbance with the 0.25 * min masking dead zone
    d = torch.clamp((l_deg - l_ref).abs() - 0.25 * torch.minimum(l_deg, l_ref), min=0.0)
    w = widths / widths.sum()
    d_sym = torch.sqrt((w * d ** 2).sum(dim=-1) + 1e-12) - 1e-6  # exactly 0 at no disturbance
    # asymmetric disturbance: added energy hurts more than removed; zero below 3, capped at 12
    r = ((b_deg + 50.0) / (b_ref + 50.0)) ** 1.2
    r = torch.where(r < 3.0, 0.0, torch.clamp(r, max=12.0))
    d_asym = (w * d * r).sum(dim=-1)
    return (ALPHA_SYM * d_sym + ALPHA_ASYM * d_asym).mean()
