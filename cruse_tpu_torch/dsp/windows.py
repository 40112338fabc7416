"""Analysis windows, computed with numpy (a copy of ``cruse_tpu/dsp/windows.py``,
which is numpy-only; the port must not import ``cruse_tpu.dsp``, whose
package imports jax).

Conventions match ``torch.hann_window``/``torch.hamming_window`` with
``periodic=True`` so that waveform parity tests against the torch reference
(reference: train_base/acoustics/feature.py:27,58) hold to float32 precision.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _window_np(name: str, length: int, periodic: bool) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    # periodic windows divide by `length`, symmetric by `length - 1`
    denom = length if periodic else max(length - 1, 1)
    if name == "hann":
        w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    elif name == "sqrt_hann":
        w = np.sqrt(0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom)))
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)
    elif name in ("rect", "ones", "boxcar"):
        w = np.ones(length, dtype=np.float64)
    else:
        raise ValueError(f"Unknown window: {name!r}")
    return w.astype(np.float32)


def get_window(name: str, length: int, periodic: bool = True) -> np.ndarray:
    """Return a float32 numpy window of `length` samples.

    Returned as numpy (not jnp) so callers can fold it into precomputed
    DFT/filterbank matrices that become XLA constants.
    """
    return _window_np(name, int(length), bool(periodic))
