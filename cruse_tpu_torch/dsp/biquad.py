"""RBJ-cookbook biquad EQ and IIR filtering in PyTorch (counterpart of
``cruse_tpu/dsp/biquad.py``).

``biquad_coeffs`` gives the six kinds' normalised ``(b, a)`` for tensors of
centre frequency, gain and Q (float32, as the JAX package computes them).
``lfilter`` runs the transposed direct-form II recurrence

    z_t = M z_{t-1} + v x_t,   y_t = b0 x_t + z1_{t-1},
    M = [[-a1, 1], [-a2, 0]],  v = [b1 - a1 b0, b2 - a2 b0]

as a log-depth doubling scan over the affine pairs ``(M, u_t = v x_t)``
(``method="doubling"``, the default; the JAX package's
``lax.associative_scan`` form): after the pass at offset d, U_t holds
sum_{j<2d} M^j u_{t-j}, by U_t += M^d U_{t-d}, then M^d is squared. Since M is
one matrix a row, a pass is four multiply-adds an element, and ceil(log2 L)
passes (16 at L = 48,000) give z_t for every t. The doubling scan runs in
float64 and returns x's dtype: in float32 a parallel form loses what the
sequential one keeps where the poles sit near z = 1 (a 40 Hz low shelf at +12
dB: the JAX package's float32 associative form misses the float64 result by
1.2e-2 of max|y|, its sequential form by 9e-5). ``method="scan"`` is the
sequential recurrence in x's dtype, the reference. Plain torch ops on the
batch's device: the JAX package runs this outside any Pallas kernel too.

``random_eq_chain`` is split into its draws (``draw_eq``: the kind, a
log-uniform frequency, the gain, Q; from an explicit ``torch.Generator``) and
the deterministic ``eq_chain_from_draws``, so that a test can inject the JAX
package's draws. Draws are made per row of the signal's batch dimensions.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

FILTER_KINDS = ("high_shelf", "high_pass", "low_shelf", "low_pass", "peaking_eq", "notch")

# log-uniform centre-frequency ranges per kind
FILTER_FREQ_RANGES = {
    "high_shelf": (1000.0, 4000.0),
    "high_pass": (40.0, 400.0),
    "low_shelf": (40.0, 1000.0),
    "low_pass": (3000.0, 8000.0),
    "peaking_eq": (40.0, 4000.0),
    "notch": (40.0, 4000.0),
}
GAIN_RANGE_DB = (-15.0, 15.0)
Q_RANGE = (0.5, 1.5)


def _shelf(center_freq, gain_db, q, sr, high: bool):
    w0 = 2.0 * math.pi * center_freq / sr
    amp = 10.0 ** (gain_db / 40.0)
    alpha = torch.sin(w0) / 2.0 / q
    cosw = torch.cos(w0)
    sq = 2.0 * torch.sqrt(amp) * alpha
    sgn = 1.0 if high else -1.0
    b0 = amp * ((amp + 1) + sgn * (amp - 1) * cosw + sq)
    b1 = -2.0 * sgn * amp * ((amp - 1) + sgn * (amp + 1) * cosw)
    b2 = amp * ((amp + 1) + sgn * (amp - 1) * cosw - sq)
    a0 = (amp + 1) - sgn * (amp - 1) * cosw + sq
    a1 = -2.0 * sgn * ((amp - 1) - sgn * (amp + 1) * cosw)
    a2 = (amp + 1) - sgn * (amp - 1) * cosw - sq
    return torch.stack([b0, b1, b2], -1), torch.stack([a0, a1, a2], -1)


def _pass(center_freq, gain_db, q, sr, high: bool):
    w0 = 2.0 * math.pi * center_freq / sr
    alpha = torch.sin(w0) / 2.0 / q
    cosw = torch.cos(w0)
    if high:
        b0 = (1 + cosw) / 2.0
        b1 = -(1 + cosw)
    else:
        b0 = (1 - cosw) / 2.0
        b1 = 1 - cosw
    return torch.stack([b0, b1, b0], -1), torch.stack([1 + alpha, -2 * cosw, 1 - alpha], -1)


def _peaking(center_freq, gain_db, q, sr):
    w0 = 2.0 * math.pi * center_freq / sr
    amp = 10.0 ** (gain_db / 40.0)
    alpha = torch.sin(w0) / 2.0 / q
    cosw = torch.cos(w0)
    b = torch.stack([1 + alpha * amp, -2 * cosw, 1 - alpha * amp], -1)
    a = torch.stack([1 + alpha / amp, -2 * cosw, 1 - alpha / amp], -1)
    return b, a


def _notch(center_freq, gain_db, q, sr):
    w0 = 2.0 * math.pi * center_freq / sr
    alpha = torch.sin(w0) / 2.0 / q
    cosw = torch.cos(w0)
    one = torch.ones_like(w0)
    return torch.stack([one, -2 * cosw, one], -1), torch.stack([1 + alpha, -2 * cosw, 1 - alpha], -1)


def biquad_coeffs(kind: str, center_freq, gain_db, q, sr):
    """(b [..., 3], a [..., 3]) normalised so a0 == 1, float32; the arguments
    are numbers or tensors of one broadcast shape."""
    center_freq, gain_db, q = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32) for v in (center_freq, gain_db, q)))
    if kind == "high_shelf":
        b, a = _shelf(center_freq, gain_db, q, sr, high=True)
    elif kind == "low_shelf":
        b, a = _shelf(center_freq, gain_db, q, sr, high=False)
    elif kind == "high_pass":
        b, a = _pass(center_freq, gain_db, q, sr, high=True)
    elif kind == "low_pass":
        b, a = _pass(center_freq, gain_db, q, sr, high=False)
    elif kind == "peaking_eq":
        b, a = _peaking(center_freq, gain_db, q, sr)
    elif kind == "notch":
        b, a = _notch(center_freq, gain_db, q, sr)
    else:
        raise ValueError(f"unknown biquad kind {kind!r}")
    return b / a[..., :1], a / a[..., :1]


def lfilter(x: torch.Tensor, b, a, method: str = "doubling") -> torch.Tensor:
    """IIR filter along the last axis, transposed direct-form II.

    x: [..., L]; b, a: [3] or [..., 3], broadcastable against x's batch
    dimensions. ``method="doubling"`` is the log-depth scan (module
    docstring), ``method="scan"`` the sequential recurrence."""
    batch = x.shape[:-1]
    b = torch.broadcast_to(torch.as_tensor(b, dtype=x.dtype, device=x.device), batch + (3,))
    a = torch.broadcast_to(torch.as_tensor(a, dtype=x.dtype, device=x.device), batch + (3,))
    b0, b1, b2 = b.unbind(-1)
    a1, a2 = a[..., 1], a[..., 2]
    length = x.shape[-1]

    if method == "scan":
        z1, z2 = torch.zeros(batch, dtype=x.dtype, device=x.device), torch.zeros(
            batch, dtype=x.dtype, device=x.device)
        out = []
        for xt in x.unbind(-1):
            yt = b0 * xt + z1
            z1, z2 = b1 * xt - a1 * yt + z2, b2 * xt - a2 * yt
            out.append(yt)
        return torch.stack(out, -1)
    if method != "doubling":
        raise ValueError(f"unknown lfilter method {method!r} (doubling, scan)")

    dtype, x = x.dtype, x.double()
    b0, b1, b2, a1, a2 = (c.double() for c in (b0, b1, b2, a1, a2))
    u1 = (b1 - a1 * b0)[..., None] * x
    u2 = (b2 - a2 * b0)[..., None] * x
    # P = M^d, one 2x2 matrix a row: [[p11, p12], [p21, p22]]
    p11, p12, p21, p22 = (-a1)[..., None], torch.ones_like(a1)[..., None], (-a2)[..., None], \
        torch.zeros_like(a1)[..., None]
    d = 1
    while d < length:
        lo1, lo2 = u1[..., :-d], u2[..., :-d]
        u1 = torch.cat([u1[..., :d], u1[..., d:] + p11 * lo1 + p12 * lo2], -1)
        u2 = torch.cat([u2[..., :d], u2[..., d:] + p21 * lo1 + p22 * lo2], -1)
        p11, p12, p21, p22 = (p11 * p11 + p12 * p21, p11 * p12 + p12 * p22,
                              p21 * p11 + p22 * p21, p21 * p12 + p22 * p22)
        d *= 2
    # y_t needs z1_{t-1}: shift right with a zero first
    return (b0[..., None] * x + F.pad(u1, (1, 0))[..., :length]).to(dtype)


def sos_chain(x: torch.Tensor, b_stack, a_stack) -> torch.Tensor:
    """S cascaded biquad sections, each an ``lfilter``. b_stack, a_stack:
    [S, ..., 3], each section's coefficients broadcastable against x's batch
    dimensions."""
    y = x
    for b, a in zip(torch.as_tensor(b_stack), torch.as_tensor(a_stack)):
        y = lfilter(y, b, a)
    return y


@dataclasses.dataclass
class EqDraws:
    """The draws of a random EQ chain, [..., S] each (S sections): the kind's
    index into FILTER_KINDS, the uniform u of the log-uniform frequency
    (the same u for every kind's range), the gain in dB and Q."""

    kind: torch.Tensor
    u: torch.Tensor
    gain_db: torch.Tensor
    q: torch.Tensor


def draw_eq(generator: torch.Generator, shape, num_filters: int = 3) -> EqDraws:
    """Draws of ``num_filters`` sections for a batch of ``shape``, on the
    generator's device."""
    shape = tuple(shape) + (num_filters,)
    device = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)

    return EqDraws(kind=torch.randint(0, len(FILTER_KINDS), shape, generator=generator, device=device),
                   u=torch.rand(shape, generator=generator, device=device),
                   gain_db=uniform(*GAIN_RANGE_DB), q=uniform(*Q_RANGE))


def eq_chain_coeffs(draws: EqDraws, sr: float = 16000.0):
    """(b, a) [S, ..., 3] of the chain the draws describe."""
    device = draws.u.device
    lo = torch.log(torch.tensor([FILTER_FREQ_RANGES[k][0] for k in FILTER_KINDS], device=device))
    hi = torch.log(torch.tensor([FILTER_FREQ_RANGES[k][1] for k in FILTER_KINDS], device=device))
    u = draws.u.float()[..., None]
    freq = torch.exp(lo + u * (hi - lo))  # [..., S, K]: each kind's log-uniform frequency
    coeffs = [biquad_coeffs(kind, freq[..., k], draws.gain_db, draws.q, sr)
              for k, kind in enumerate(FILTER_KINDS)]
    index = draws.kind[..., None, None].expand(*draws.kind.shape, 1, 3)
    b = torch.stack([c[0] for c in coeffs], -2).gather(-2, index)[..., 0, :]  # [..., S, 3]
    a = torch.stack([c[1] for c in coeffs], -2).gather(-2, index)[..., 0, :]
    return b.movedim(-2, 0), a.movedim(-2, 0)


def eq_chain_from_draws(x: torch.Tensor, draws: EqDraws, sr: float = 16000.0) -> torch.Tensor:
    """x [..., L] through the chain of biquads the draws describe ([..., S])."""
    b, a = eq_chain_coeffs(draws, sr)
    return sos_chain(x, b.to(x.dtype), a.to(x.dtype))


def random_eq_chain(x: torch.Tensor, generator: torch.Generator, num_filters: int = 3,
                    sr: float = 16000.0) -> torch.Tensor:
    """A chain of ``num_filters`` randomly chosen biquads (log-uniform centre
    frequency in the kind's range, gain ~ U(-15, 15) dB, Q ~ U(0.5, 1.5)),
    one chain a row of x's batch dimensions."""
    return eq_chain_from_draws(x, draw_eq(generator, x.shape[:-1], num_filters), sr)


def hp_filter(x: torch.Tensor, generator: torch.Generator | None = None, sr: float = 16000.0,
              center_freq: float = 150.0) -> torch.Tensor:
    """Fixed-frequency high-pass; Q ~ U(0.5, 1.5) from ``generator``, else 1."""
    q = 1.0 if generator is None else float(
        Q_RANGE[0] + (Q_RANGE[1] - Q_RANGE[0]) * torch.rand((), generator=generator, device=generator.device))
    b, a = biquad_coeffs("high_pass", center_freq, 0.0, q, sr)
    return lfilter(x, b.to(x.device), a.to(x.device))
