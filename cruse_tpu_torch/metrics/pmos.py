"""A copy of ``cruse_tpu/metrics/pmos.py`` for the port (numpy and scipy only;
the port imports nothing of the JAX package).

PMOS: perceptual MOS proxy with the P.862 (PESQ) processing structure.

The reference consumed PESQ through the external `pesq` package
(train_base/metrics.py:89-108); that package is not in this image and the
exact ITU-T P.862 band tables/constants are not reproducible here, so this
module implements the *structure* of the algorithm with standard constants
and calibrates the output to the familiar [1.0, 4.64] MOS-LQO range:

1. level alignment on a 350-3250 Hz band estimate
2. envelope cross-correlation time alignment
3. 32 ms Hann frames -> power spectra -> Bark-warped band energies
4. Zwicker-law loudness transform per band
5. asymmetric disturbance (additive distortions weighted harder than
   omissions), frequency (L2-ish) and time (L6/L2) aggregation
6. monotone map to MOS

Registered as "PMOS" -- intentionally NOT labeled WB_PESQ: scores correlate
with PESQ-style quality orderings (tested: monotone in SNR, sensitive to
nonlinear distortion, top score for identity) but are not ITU-compliant
values. When the real `pesq` package is present the registry prefers it.
"""
from __future__ import annotations

import functools

import numpy as np
from scipy import signal as sps

SR = 16000
FRAME = 512  # 32 ms
HOP = 256
N_BARK = 49


def _bark(f_hz: np.ndarray) -> np.ndarray:
    """Traunmueller-style bark warping (standard approximation)."""
    return 26.81 * f_hz / (1960.0 + f_hz) - 0.53


@functools.lru_cache(maxsize=None)
def _bark_bands():
    """[N_BARK, FRAME//2+1] rectangular bark-band matrix + band widths."""
    freqs = np.fft.rfftfreq(FRAME, 1.0 / SR)
    z = _bark(freqs)
    edges = np.linspace(z[1], _bark(np.asarray([SR / 2.0]))[0], N_BARK + 1)
    mat = np.zeros((N_BARK, len(freqs)))
    for i in range(N_BARK):
        sel = (z >= edges[i]) & (z < edges[i + 1])
        if sel.any():
            mat[i, sel] = 1.0 / sel.sum()
    widths = np.diff(edges)
    return mat.astype(np.float64), widths


def _level_align(x: np.ndarray) -> np.ndarray:
    """Scale so the 350-3250 Hz band power hits a fixed target."""
    sos = sps.butter(4, [350, 3250], btype="bandpass", fs=SR, output="sos")
    band = sps.sosfilt(sos, x)
    p = np.mean(band**2) + 1e-20
    return x * np.sqrt(1e4 / p)


def _time_align(ref: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Envelope cross-correlation alignment of deg to ref (crude + integer)."""
    def env(x):
        n = len(x) // 64
        e = np.abs(x[: n * 64]).reshape(n, 64).mean(axis=1)
        return np.log(e + 1e-10)

    er, ed = env(ref), env(deg)
    n = min(len(er), len(ed))
    corr = sps.fftconvolve(er[:n] - er.mean(), (ed[:n] - ed.mean())[::-1])
    delay = (np.argmax(corr) - (n - 1)) * 64
    if delay > 0:
        deg = np.concatenate([np.zeros(delay), deg])[: len(deg)]
    elif delay < 0:
        deg = np.concatenate([deg[-delay:], np.zeros(-delay)])
    return deg


def _frames(x: np.ndarray) -> np.ndarray:
    n = (len(x) - FRAME) // HOP + 1
    if n <= 0:
        return np.zeros((0, FRAME))
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx]


def _bark_loudness(x: np.ndarray):
    """Per-frame bark-band Zwicker loudness [T, N_BARK] + frame energies."""
    win = np.hanning(FRAME)
    fr = _frames(x) * win
    pow_spec = np.abs(np.fft.rfft(fr, axis=1)) ** 2 / FRAME
    mat, _ = _bark_bands()
    bands = pow_spec @ mat.T  # [T, B]
    # hearing threshold ~ constant proxy per band (flat floor)
    p0 = 1e-2
    loud = (2.0 * (bands / p0 + 1.0) ** 0.23 - 2.0) * (p0**0.23)
    frame_e = pow_spec.sum(axis=1)
    return loud, frame_e


def pmos(reference, estimation, sr: int = 16000) -> float:
    """Perceptual MOS proxy in ~[1.0, 4.64]; higher is better."""
    ref = np.asarray(reference, np.float64).ravel()
    deg = np.asarray(estimation, np.float64).ravel()
    if sr != SR:
        from math import gcd

        g = gcd(SR, int(sr))
        ref = sps.resample_poly(ref, SR // g, int(sr) // g)
        deg = sps.resample_poly(deg, SR // g, int(sr) // g)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < 2 * FRAME:
        return 1.0

    ref = _level_align(ref)
    deg = _level_align(deg)
    deg = _time_align(ref, deg)

    l_ref, e_ref = _bark_loudness(ref)
    l_deg, e_deg = _bark_loudness(deg)
    t = min(len(l_ref), len(l_deg))
    l_ref, l_deg = l_ref[:t], l_deg[:t]
    e_ref = e_ref[:t]

    # speech-active frames of the reference drive the score
    act = e_ref > (e_ref.max() * 10 ** (-45 / 10) + 1e-12)
    if act.sum() < 4:
        return 1.0
    l_ref, l_deg = l_ref[act], l_deg[act]

    # symmetric disturbance with a small masking deadzone
    dead = 0.25 * np.minimum(l_ref, l_deg)
    d = np.maximum(np.abs(l_deg - l_ref) - dead, 0.0)
    # asymmetry: added energy (additive noise/artifacts) weighted harder
    ratio = (l_deg + 1e-6) / (l_ref + 1e-6)
    asym_w = np.clip(ratio**1.2, 0.0, 12.0)
    d_asym = d * np.where(ratio > 1.0, asym_w, 0.0)

    _, widths = _bark_bands()
    w = widths / widths.sum()
    # frequency aggregation: weighted L3 (sym), L1 (asym)
    d_frame = (np.sum((d**3) * w, axis=1)) ** (1.0 / 3.0)
    a_frame = np.sum(d_asym * w, axis=1)
    # time aggregation: L6 over 320 ms sub-intervals then L2 (P.862 shape)
    def agg(frame_vals, p1=6.0, p2=2.0, blk=20):
        nb = max(len(frame_vals) // blk, 1)
        v = frame_vals[: nb * blk].reshape(nb, -1)
        per = (np.mean(v**p1, axis=1)) ** (1.0 / p1)
        return (np.mean(per**p2)) ** (1.0 / p2)

    d_sym = agg(d_frame)
    d_asy = agg(a_frame)

    # saturating map calibrated so white-noise degradations land near the
    # familiar PESQ anchor points (~3.8 @ 30 dB SNR, ~2.9 @ 20, ~2.0 @ 10,
    # ~1.5 @ 0); identity scores 4.64
    total = d_sym + 0.1 * d_asy
    raw = 1.0 + 3.64 / (1.0 + (total / 6.67) ** 1.63)
    return float(np.clip(raw, 1.0, 4.64))
