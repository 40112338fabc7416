"""A copy of ``cruse_tpu/metrics/sisdr.py`` for the port (numpy and scipy only;
the port imports nothing of the JAX package).

SI-SDR / SDR (numpy host metrics; the train losses live in ``losses/``).

SI-SDR follows train_base/metrics.py:60-82: optimal scaling projection,
10*log10 energy ratio.
"""
from __future__ import annotations

import numpy as np


def si_sdr(reference, estimation, sr=None):
    """Scale-invariant signal-to-distortion ratio (dB). Arrays [..., L]."""
    reference = np.asarray(reference, np.float64)
    estimation = np.asarray(estimation, np.float64)
    eps = np.finfo(np.float64).eps
    ref_energy = np.sum(reference**2, axis=-1, keepdims=True) + eps
    scale = np.sum(reference * estimation, axis=-1, keepdims=True) / ref_energy
    projection = scale * reference
    noise = estimation - projection
    ratio = np.sum(projection**2, axis=-1) / (np.sum(noise**2, axis=-1) + eps)
    return float(np.mean(10.0 * np.log10(ratio + eps)))


def sdr(reference, estimation, sr=None):
    """Plain SDR (no optimal scaling)."""
    reference = np.asarray(reference, np.float64)
    estimation = np.asarray(estimation, np.float64)
    eps = np.finfo(np.float64).eps
    noise = estimation - reference
    ratio = np.sum(reference**2, axis=-1) / (np.sum(noise**2, axis=-1) + eps)
    return float(np.mean(10.0 * np.log10(ratio + eps)))
