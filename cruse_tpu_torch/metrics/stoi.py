"""A copy of ``cruse_tpu/metrics/stoi.py`` for the port (numpy and scipy only;
the port imports nothing of the JAX package).

STOI -- short-time objective intelligibility (Taal et al., 2011).

Native numpy implementation (the `pystoi` package is not in the image; the
reference consumed it as an external dep, train_base/metrics.py:85-86).
Algorithm: resample to 10 kHz, drop silent frames, 512-pt STFT of 256-sample
hann frames, 15 one-third-octave bands from 150 Hz, 30-frame segments,
clipped per-band correlation, averaged.
"""
from __future__ import annotations

import functools

import numpy as np

FS = 10000  # internal sample rate
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30  # segment length in frames
BETA = -15.0  # clipping SDR bound
DYN_RANGE = 40.0  # silent-frame dynamic range


@functools.lru_cache(maxsize=None)
def _thirdoct():
    """One-third octave band matrix [NUMBAND, NFFT//2+1] + center freqs."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUMBAND)
    cf = 2.0 ** (k / 3.0) * MINFREQ
    freq_low = cf * 2 ** (-1.0 / 6)
    freq_high = cf * 2 ** (1.0 / 6)
    obm = np.zeros((NUMBAND, len(f)))
    for i in range(NUMBAND):
        lo = np.argmin((f - freq_low[i]) ** 2)
        hi = np.argmin((f - freq_high[i]) ** 2)
        obm[i, lo:hi] = 1.0
    return obm, cf


def _resample_10k(x, sr):
    if sr == FS:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(FS, int(sr))
    return resample_poly(x, FS // g, int(sr) // g)


def _frames(x):
    hop = N_FRAME // 2
    n = (len(x) - N_FRAME) // hop + 1
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(N_FRAME)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _remove_silent_frames(x, y):
    """Drop frames whose clean energy is > DYN_RANGE dB below the peak, then
    overlap-add the survivors back to signals."""
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frames(x) * w
    yf = _frames(y) * w
    if len(xf) == 0:
        return x, y
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    hop = N_FRAME // 2
    n_out = (len(xf) - 1) * hop + N_FRAME if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    norm = np.zeros(n_out)
    for i in range(len(xf)):
        s = i * hop
        xs[s : s + N_FRAME] += xf[i]
        ys[s : s + N_FRAME] += yf[i]
        norm[s : s + N_FRAME] += w**2
    norm = np.where(norm > 1e-12, norm, 1.0)
    return xs / norm * 1.0, ys / norm * 1.0


def _stft_mag(x):
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frames(x) * w
    return np.abs(np.fft.rfft(frames, NFFT, axis=1))  # [T, F]


def stoi(reference, estimation, sr: int = 16000, extended: bool = False) -> float:
    """STOI in [~0, 1]; higher = more intelligible.

    reference/estimation: 1-D arrays at sample rate `sr`.
    """
    x = _resample_10k(np.asarray(reference, np.float64).ravel(), sr)
    y = _resample_10k(np.asarray(estimation, np.float64).ravel(), sr)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    x, y = _remove_silent_frames(x, y)

    x_spec = _stft_mag(x)
    y_spec = _stft_mag(y)
    if len(x_spec) < N:
        return 1e-5
    obm, _ = _thirdoct()
    # band envelopes [T, J]
    xb = np.sqrt((x_spec**2) @ obm.T)
    yb = np.sqrt((y_spec**2) @ obm.T)

    if extended:
        # ESTOI: per-segment row/column normalized correlation
        scores = []
        for m in range(N, len(xb) + 1):
            seg_x = xb[m - N : m].T  # [J, N]
            seg_y = yb[m - N : m].T
            seg_x = seg_x - seg_x.mean(axis=1, keepdims=True)
            seg_x = seg_x / (np.linalg.norm(seg_x, axis=1, keepdims=True) + 1e-12)
            seg_y = seg_y - seg_y.mean(axis=1, keepdims=True)
            seg_y = seg_y / (np.linalg.norm(seg_y, axis=1, keepdims=True) + 1e-12)
            seg_x = seg_x - seg_x.mean(axis=0, keepdims=True)
            seg_x = seg_x / (np.linalg.norm(seg_x, axis=0, keepdims=True) + 1e-12)
            seg_y = seg_y - seg_y.mean(axis=0, keepdims=True)
            seg_y = seg_y / (np.linalg.norm(seg_y, axis=0, keepdims=True) + 1e-12)
            scores.append(np.sum(seg_x * seg_y) / NUMBAND)
        return float(np.mean(scores))

    # classic STOI with clipping
    c = 10 ** (-BETA / 20.0)
    scores = []
    for m in range(N, len(xb) + 1):
        seg_x = xb[m - N : m]  # [N, J]
        seg_y = yb[m - N : m]
        alpha = np.linalg.norm(seg_x, axis=0, keepdims=True) / (
            np.linalg.norm(seg_y, axis=0, keepdims=True) + 1e-12
        )
        seg_y_scaled = seg_y * alpha
        seg_y_clipped = np.minimum(seg_y_scaled, seg_x * (1 + c))
        xm = seg_x - seg_x.mean(axis=0, keepdims=True)
        ym = seg_y_clipped - seg_y_clipped.mean(axis=0, keepdims=True)
        corr = np.sum(xm * ym, axis=0) / (
            np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12
        )
        scores.append(np.mean(corr))
    return float(np.mean(scores))


def estoi(reference, estimation, sr: int = 16000) -> float:
    return stoi(reference, estimation, sr, extended=True)
