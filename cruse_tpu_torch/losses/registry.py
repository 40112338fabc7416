"""Loss registry: name -> callable (counterpart of
``cruse_tpu/losses/registry.py``), with the reference's mode names and the
framework's own."""
from __future__ import annotations

from cruse_tpu_torch.losses.pmsqe import pmsqe_loss
from cruse_tpu_torch.losses.sisnr import si_snr_loss, si_snr_zero_mean
from cruse_tpu_torch.losses.spectral import (cirm_mse_loss, compressed_spectral_loss, multi_res_spectral_loss,
                                             rmse_loss, sdnr_loss, weighted_male_loss)


def _neg_si_snr_zero_mean(est, ref, **kw):
    return -si_snr_zero_mean(est, ref)


def _cirm(est, ref, noisy=None, **kw):
    if noisy is None:
        raise TypeError(
            "the 'cirm' loss needs the noisy RI spectrum: call as "
            "get_loss('cirm')(est, ref, noisy=noisy_ri), or select it via "
            "loss_weights in the train step (which passes it)")
    return cirm_mse_loss(est, noisy, ref)


LOSS_REGISTRY = {
    # the reference's mode names
    "SI-SNR": lambda est, ref, **kw: si_snr_loss(est, ref),
    "MSE": lambda est, ref, **kw: rmse_loss(est, ref),
    "C_MSE": lambda est, ref, **kw: compressed_spectral_loss(ref, est),
    "WO_MALE": lambda est, ref, noisy=None, **kw: weighted_male_loss(est, ref, noisy),
    "SDNR": sdnr_loss,
    # the framework's names
    "si_snr": lambda est, ref, **kw: si_snr_loss(est, ref),
    "si_snr_zero_mean": _neg_si_snr_zero_mean,
    "compressed_spectral": lambda est, ref, **kw: compressed_spectral_loss(ref, est),
    "multi_res_spectral": lambda est, ref, **kw: multi_res_spectral_loss(est, ref),
    "cirm": _cirm,  # needs (enhanced, clean, noisy=) RI spectra
    "pmsqe": lambda est, ref, sr=16000, **kw: pmsqe_loss(est, ref, sr=sr),
}


def get_loss(name: str):
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name]
