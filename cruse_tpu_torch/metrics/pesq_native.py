"""A copy of ``cruse_tpu/metrics/pesq_native.py`` for the port (numpy and scipy only;
the port imports nothing of the JAX package).

Native PESQ (wideband P.862.2 + narrowband P.862): the full ITU-T
processing pipeline in numpy.

The reference bound PESQ to the external ``pesq`` package
(train_base/metrics.py:89-108). That package (and ITU's licensed reference
tables) is not in this image, so this module implements the COMPLETE P.862 /
P.862.2 processing chain natively so the composite best-model score
``(STOI + (WB_PESQ + 0.5) / 5) / 2`` (base_trainer.py:370-376) is computable
with no external dependency — and, since round 3, NB_PESQ as well
(metrics.py:100-108 registered it via the external package only):

 1. level alignment: both signals scaled to 10^7 average band power over the
    350-3250 Hz speech band
 2. input filter: WB mode — IIR high-pass at 100 Hz (the P.862.2 prefilter
    role, no IRS receive weighting); NB mode — an IRS-receive-weighting
    approximation (bandpass ~300-3100 Hz, the telephone-handset
    characteristic P.862 applies before the perceptual model)
 3. time alignment: log-envelope cross-correlation (crude) + waveform
    cross-correlation refinement (fine), one global delay
 4. perceptual model: 32 ms Hann frames at 50% overlap -> power spectra ->
    Bark bands (49 wideband / 42 narrowband) -> partial frequency
    compensation of the reference (the linear-filter compensation, clipped
    [0.01, 100]) -> short-term gain compensation of the degraded signal
    (clipped [3e-4, 5], first-order smoothed) -> Zwicker-law loudness above
    the absolute hearing threshold
 5. disturbance: loudness difference shrunk by the 0.25*min masking
    deadzone; asymmetric disturbance weighted by the Bark-spectral ratio
    ((deg+50)/(ref+50))^1.2, zeroed below 3, capped at 12
 6. aggregation: width-weighted L2 (symmetric) / L1 (asymmetric) across
    bands; ((E_frame+1e5)/1e7)^0.04-weighted L6 over 320 ms intervals then
    L2 over intervals across time
 7. raw score 4.5 - f(0.1*D_sym + 0.0309*D_asym); WB maps through the
    P.862.2 wideband logistic 0.999 + 4.0/(1 + exp(-1.3669 x + 3.8224)),
    NB through the P.862.1 logistic 0.999 + 4.004/(1 + exp(-1.4945 x +
    4.6607)); f is a calibrated compressive map (see divergence notes)

Documented divergence from ITU compliance (P.862 conformance requires the
standard's licensed data tables, absent from this image):
 - Bark band edges/widths come from the Schroeder warping 7*asinh(f/650)
   with uniform Bark spacing, and the absolute hearing threshold from the
   Terhardt analytic approximation, instead of the ITU tables they
   approximate
 - the NB IRS receive weighting is a butterworth band-pass approximation of
   the IRS curve, not the tabulated FIR
 - time alignment estimates one global delay (no per-utterance splitting /
   bad-interval realignment) -- correct for enhancement outputs, which are
   sample-aligned by construction
 - the internal loudness scale is pinned by a single calibration constant
   (below) chosen so white-noise degradations land on the familiar WB-PESQ
   SNR anchors; scores track PESQ orderings but are not certified P.862
Scores are deterministic and monotone in distortion (tested); treat small
absolute offsets vs the ITU binary as expected, and run
``tools/validate_pesq.py`` on any host that has the ``pesq`` package to
print the per-condition deltas and rank correlation vs the ITU binary.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
from scipy import signal as sps

TARGET_POWER = 1.0e7  # P.862 level-alignment target (350-3250 Hz band)
SL = 0.08  # Zwicker specific-loudness constant (sone/Bark)


@dataclasses.dataclass(frozen=True)
class _Mode:
    sr: int
    frame: int  # 32 ms
    hop: int
    nb: int  # number of Bark bands
    f_low: float  # lowest band edge (Hz)
    logistic: tuple  # (slope, offset, span) of the MOS-LQO map
    mos_max: float

    @property
    def intensity_scale(self) -> float:
        # pins "level-aligned active speech" to the absolute-threshold scale
        # (calibrated on white-noise SNR anchors; see module docstring)
        return 10.0 ** (79.0 / 10.0) / (TARGET_POWER * self.frame / 4.0)


# P.862.2 wideband (16 kHz) and P.862 narrowband (8 kHz) modes; the NB
# logistic is the P.862.1 raw-score -> MOS-LQO mapping.
WB = _Mode(sr=16000, frame=512, hop=256, nb=49, f_low=50.0,
           logistic=(-1.3669, 3.8224, 4.0), mos_max=4.644)
NBM = _Mode(sr=8000, frame=256, hop=128, nb=42, f_low=100.0,
            logistic=(-1.4945, 4.6607, 4.004), mos_max=4.549)


def _bark(f_hz):
    return 7.0 * np.arcsinh(np.asarray(f_hz, np.float64) / 650.0)


@functools.lru_cache(maxsize=None)
def _band_tables(mode: _Mode):
    """(band matrix [NB, F_bins], widths [NB] in Bark, thresholds [NB])."""
    freqs = np.fft.rfftfreq(mode.frame, 1.0 / mode.sr)
    edges_bark = np.linspace(_bark(mode.f_low), _bark(mode.sr / 2.0), mode.nb + 1)
    z = _bark(freqs)
    mat = np.zeros((mode.nb, len(freqs)))
    for i in range(mode.nb):
        sel = (z >= edges_bark[i]) & (z < edges_bark[i + 1])
        if not sel.any():  # narrow low bands: take the nearest bin
            sel = np.zeros_like(z, bool)
            sel[np.argmin(np.abs(z - 0.5 * (edges_bark[i] + edges_bark[i + 1])))] = True
        mat[i, sel] = 1.0
    widths = np.diff(edges_bark)
    centers_bark = 0.5 * (edges_bark[:-1] + edges_bark[1:])
    centers_hz = 650.0 * np.sinh(centers_bark / 7.0)
    # Terhardt threshold-in-quiet (dB SPL) -> intensity
    khz = np.maximum(centers_hz / 1000.0, 0.02)
    tq_db = (
        3.64 * khz**-0.8
        - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
        + 1e-3 * khz**4
    )
    thresh = 10.0 ** (np.clip(tq_db, -10.0, 96.0) / 10.0)
    return mat, widths, thresh


def _level_align(x, mode: _Mode):
    hi = min(3250.0, 0.45 * mode.sr)
    sos = sps.butter(4, [350, hi], btype="bandpass", fs=mode.sr, output="sos")
    band = sps.sosfilt(sos, x)
    p = np.mean(band**2) + 1e-20
    return x * np.sqrt(TARGET_POWER / p)


def _input_filter(x, mode: _Mode):
    """WB: P.862.2 high-pass at 100 Hz (no IRS weighting). NB: IRS receive
    weighting approximation (telephone band-pass ~300-3100 Hz)."""
    if mode is WB:
        sos = sps.butter(2, 100.0, btype="highpass", fs=mode.sr, output="sos")
    else:
        sos = sps.butter(2, [310.0, 3100.0], btype="bandpass", fs=mode.sr,
                         output="sos")
    return sps.sosfilt(sos, x)


def _time_align(ref, deg, mode: _Mode):
    """Crude log-envelope alignment + fine waveform refinement (one global
    delay; P.862's utterance splitting is unnecessary for sample-aligned
    enhancement outputs)."""

    def env(x):
        n = len(x) // 64
        e = np.abs(x[: n * 64]).reshape(n, 64).mean(axis=1)
        return np.log(e + 1e-10)

    er, ed = env(ref), env(deg)
    n = min(len(er), len(ed))
    corr = sps.fftconvolve(er[:n] - er.mean(), (ed[:n] - ed.mean())[::-1])
    delay = (np.argmax(corr) - (n - 1)) * 64
    # fine: waveform correlation in a +-64-sample window around the estimate
    lo, hi = delay - 64, delay + 64
    m = min(len(ref), len(deg))
    best, best_v = delay, -np.inf
    seg = slice(mode.frame, min(m, mode.sr * 4))  # bounded work
    r = ref[seg]
    for d in range(lo, hi + 1):
        s = np.roll(deg[:m], d)[seg]
        v = float(np.dot(r, s))
        if v > best_v:
            best_v, best = v, d
    if best > 0:
        deg = np.concatenate([np.zeros(best), deg])[: len(deg)]
    elif best < 0:
        deg = np.concatenate([deg[-best:], np.zeros(-best)])
    return deg


def _bark_powers(x, mode: _Mode):
    """[T, NB] Bark band powers (internal intensity units) + frame energies."""
    n = (len(x) - mode.frame) // mode.hop + 1
    if n <= 0:
        return np.zeros((0, mode.nb)), np.zeros((0,))
    idx = np.arange(mode.frame)[None, :] + mode.hop * np.arange(n)[:, None]
    fr = x[idx] * np.hanning(mode.frame)
    pow_spec = np.abs(np.fft.rfft(fr, axis=1)) ** 2
    mat, _, _ = _band_tables(mode)
    bands = pow_spec @ mat.T * mode.intensity_scale
    return bands, pow_spec.sum(axis=1) * mode.intensity_scale


def _loudness(bands, thresh):
    """Zwicker specific loudness per band; zero below threshold."""
    ratio = bands / thresh[None, :]
    loud = SL * (thresh[None, :] / 0.5) ** 0.23 * ((0.5 + 0.5 * ratio) ** 0.23 - 1.0)
    return np.where(ratio > 1.0, loud, 0.0)


def _lpq_time(frame_vals, h, p1=6.0, p2=2.0, blk=20):
    """h-weighted L6 over 320 ms intervals, then L2 over intervals."""
    nb = max(len(frame_vals) // blk, 1)
    v = frame_vals[: nb * blk].reshape(nb, -1)
    w = h[: nb * blk].reshape(nb, -1)
    per = (np.sum(w * v**p1, axis=1) / (np.sum(w, axis=1) + 1e-12)) ** (1.0 / p1)
    return float(np.mean(per**p2) ** (1.0 / p2))


def _pesq_pipeline(reference, estimation, sr: int, mode: _Mode) -> float:
    ref = np.asarray(reference, np.float64).ravel()
    deg = np.asarray(estimation, np.float64).ravel()
    if sr != mode.sr:
        from math import gcd

        g = gcd(mode.sr, int(sr))
        ref = sps.resample_poly(ref, mode.sr // g, int(sr) // g)
        deg = sps.resample_poly(deg, mode.sr // g, int(sr) // g)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < 2 * mode.frame:
        return 1.0

    ref = _input_filter(_level_align(ref, mode), mode)
    deg = _input_filter(_level_align(deg, mode), mode)
    deg = _time_align(ref, deg, mode)

    b_ref, e_ref = _bark_powers(ref, mode)
    b_deg, e_deg = _bark_powers(deg, mode)
    t = min(len(b_ref), len(b_deg))
    b_ref, b_deg, e_ref, e_deg = b_ref[:t], b_deg[:t], e_ref[:t], e_deg[:t]
    if t < 4:
        return 1.0
    _, widths, thresh = _band_tables(mode)

    # speech-active frames of the reference drive everything downstream
    act = e_ref > (e_ref.max() * 10 ** (-45 / 10) + 1e-12)
    if act.sum() < 4:
        return 1.0

    # partial frequency compensation: undo time-invariant linear filtering by
    # scaling the REFERENCE bands toward the degraded average (clipped)
    avg_ref = b_ref[act].mean(axis=0)
    avg_deg = b_deg[act].mean(axis=0)
    # PARTIAL compensation: ^0.2 of the clipped ratio -- severe spectral
    # shaping must still cost quality (full compensation would hide it)
    fcomp = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0) ** 0.2
    b_ref_c = b_ref * fcomp[None, :]

    # short-term gain compensation of the DEGRADED signal: audible power
    # ratio, first-order smoothed, clipped
    aud_ref = np.sum(np.where(b_ref_c > thresh, b_ref_c, 0.0), axis=1)
    aud_deg = np.sum(np.where(b_deg > thresh, b_deg, 0.0), axis=1)
    g_inst = (aud_ref + 5e3) / (aud_deg + 5e3)
    g = np.empty_like(g_inst)
    prev = 1.0
    for i in range(t):  # first-order IIR; t is small (frames)
        prev = 0.8 * prev + 0.2 * g_inst[i]
        g[i] = prev
    b_deg_c = b_deg * np.clip(g, 3e-4, 5.0)[:, None]

    l_ref = _loudness(b_ref_c, thresh)[act]
    l_deg = _loudness(b_deg_c, thresh)[act]

    # masked disturbance: shrink the loudness difference by 0.25*min
    m = 0.25 * np.minimum(l_ref, l_deg)
    diff = l_deg - l_ref
    d = np.sign(diff) * np.maximum(np.abs(diff) - m, 0.0)

    # asymmetry factor from the Bark power ratio
    r = ((b_deg_c[act] + 50.0) / (b_ref_c[act] + 50.0)) ** 1.2
    r = np.where(r < 3.0, 0.0, np.minimum(r, 12.0))
    d_asym = d * r

    w = widths / widths.sum()
    d_frame = np.sqrt(np.sum(w * d**2, axis=1))  # width-weighted L2
    d_frame = np.minimum(d_frame, 45.0)
    a_frame = np.sum(w * np.abs(d_asym), axis=1)  # width-weighted L1
    a_frame = np.minimum(a_frame, 45.0)
    h = ((e_ref[act] + 1e5) / 1e7) ** 0.04

    d_sym = _lpq_time(d_frame, h)
    d_asy = _lpq_time(a_frame, h)

    # P.862 combination 0.1*D + 0.0309*DA, then a calibrated compressive map
    # (a * total^b) that matches the ITU response curve's anchor behavior on
    # this module's analytic band/threshold tables (divergence notes above)
    total = 0.1 * d_sym + 0.0309 * d_asy
    raw = 4.5 - 2.13 * total**0.62
    slope, off, span = mode.logistic
    mos = 0.999 + span / (1.0 + np.exp(slope * raw + off))
    return float(np.clip(mos, 1.0, mode.mos_max))


def wb_pesq_native(reference, estimation, sr: int = 16000) -> float:
    """Native wideband PESQ MOS-LQO in [1.0, ~4.64]; higher is better."""
    return _pesq_pipeline(reference, estimation, sr, WB)


def nb_pesq_native(reference, estimation, sr: int = 16000) -> float:
    """Native narrowband PESQ MOS-LQO in [1.0, ~4.55]: P.862 at 8 kHz with
    the IRS-receive-weighting approximation and the P.862.1 raw-score ->
    MOS-LQO logistic. Inputs at any rate are resampled to 8 kHz."""
    return _pesq_pipeline(reference, estimation, sr, NBM)
