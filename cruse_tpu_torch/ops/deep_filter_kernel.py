"""Complex multi-frame deep filter and its backward: the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``cruse_tpu/ops/deep_filter_kernel.py::deep_filter_pallas``
(and of the shift-MAC ``cruse_tpu/models/deep_filter.py::deep_filter_apply``
it is held to). For each time-frequency bin, with the taps in
``tap_offsets`` order::

    out[t, f] = sum_k coef[t, f, k] * spec[t - dt_k, f - df_k]     (complex)

and zero fill outside the spectrum. One generalisation serves streaming: an
optional ``history [B, 2*t_dim, F]`` of the frames before the first, oldest
first, which a causal read at ``t - dt < 0`` takes instead of zero.

The backward (which the JAX package takes by autodiff of the shift-MAC; it
has no TPU kernel), with ``g = dL/dRe(out) + i dL/dIm(out)``::

    dcoef[t, f, k]  = g[t, f] * conj(spec[t - dt_k, f - df_k])
    dspec[tau, phi] = sum_k g[tau + dt_k, phi + df_k] * conj(coef[tau + dt_k, phi + df_k, k])

Layouts (the model's own, so nothing is transposed on entry): ``spec``
complex64 ``[B, T, F]`` whose bins are contiguous (rows may be strided, as
the low-bin slice of a wider spectrum is); ``coefs`` float32
``[B, T, F, K, 2]`` (re, im last), contiguous; ``history`` complex64 with
contiguous frames and bins (the batch may be strided); the result is
complex64 ``[B, T, F]``.

``deep_filter`` runs the plain version for tensors on the CPU and launches the
hand-written kernel (``csrc/deep_filter.cu``) for tensors on a CUDA device;
on a CUDA device it launches or raises. Where a gradient is wanted it goes
through a ``torch.autograd.Function`` whose backward is ``deep_filter_bwd``:
the backward kernel on a CUDA device, ``deep_filter_backward_reference`` on
the CPU. A gradient through a history raises: no path trains through the
streaming form. ``deep_filter.launches`` and ``deep_filter_bwd.launches``
count kernel launches. The forward is the custom op
``torch.ops.cruse_tpu_torch.deep_filter`` (``deep_filter_op``), so that
``torch.export`` can trace a model that runs it. Its implementation runs the
plain version on CPU tensors and the launch at ``df_plan``'s tile on CUDA
tensors; its fake implementation gives the output's shape. A block of either
kernel owns one batch row, a span of frames and a range of bins
(``df_plan``) and walks down its frames;
``deep_filter_bwd_walk_reference`` is the backward's walk in PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cruse_tpu_torch.ops import _build


def tap_offsets(t_dim: int, f_dim: int, causal: bool = False):
    """Tap layout: time offsets in [-t, t] (or [0, 2t] past-only when causal),
    freq offsets in [-f, f]; time outer, frequency inner."""
    t_range = range(0, 2 * t_dim + 1) if causal else range(-t_dim, t_dim + 1)
    return [(dt, df) for dt in t_range for df in range(-f_dim, f_dim + 1)]


def _shift2d(x: torch.Tensor, dt: int, df: int) -> torch.Tensor:
    """Shift [B, T, F] by (dt, df) with zero fill: out[t, f] = x[t-dt, f-df]."""
    _, t, f = x.shape
    out = x
    if dt > 0:
        out = F.pad(out, (0, 0, dt, 0))[:, :t]
    elif dt < 0:
        out = F.pad(out, (0, 0, 0, -dt))[:, -dt:]
    if df > 0:
        out = F.pad(out, (df, 0))[:, :, :f]
    elif df < 0:
        out = F.pad(out, (0, -df))[:, :, -df:]
    return out


def deep_filter_reference(spec, coefs, t_dim: int, f_dim: int, causal: bool = True,
                          history=None):
    """The plain PyTorch shift-MAC (``cruse_tpu/models/deep_filter.py:48-76``),
    with the history rule: the history frames are prepended, the sum is
    shifted over both, and the last T frames are kept."""
    t = spec.shape[1]
    if history is not None:
        spec = torch.cat([history, spec], dim=1)
    spec_r, spec_i = spec.real, spec.imag
    out_r = torch.zeros_like(spec_r[:, -t:])
    out_i = torch.zeros_like(out_r)
    for k, (dt, df) in enumerate(tap_offsets(t_dim, f_dim, causal)):
        sr = _shift2d(spec_r, dt, df)[:, -t:]
        si = _shift2d(spec_i, dt, df)[:, -t:]
        cr = coefs[..., k, 0]
        ci = coefs[..., k, 1]
        out_r = out_r + sr * cr - si * ci
        out_i = out_i + sr * ci + si * cr
    return torch.complex(out_r, out_i)


def deep_filter_backward_reference(grad, spec, coefs, t_dim: int, f_dim: int, causal: bool = True):
    """The plain PyTorch backward (the module doc's two formulas):
    ``(dspec complex64 [B, T, F], dcoefs float32 [B, T, F, K, 2])`` from the
    gradient ``grad`` complex64 ``[B, T, F]`` of the output."""
    gr, gi = grad.real, grad.imag
    sr, si = spec.real, spec.imag
    dcoefs = []
    dr = torch.zeros_like(gr)
    di = torch.zeros_like(gr)
    for k, (dt, df) in enumerate(tap_offsets(t_dim, f_dim, causal)):
        ssr, ssi = _shift2d(sr, dt, df), _shift2d(si, dt, df)  # spec[t - dt, f - df]
        dcoefs.append(torch.stack([gr * ssr + gi * ssi, gi * ssr - gr * ssi], dim=-1))
        cr, ci = coefs[..., k, 0], coefs[..., k, 1]
        dr = dr + _shift2d(gr * cr + gi * ci, -dt, -df)  # (g conj c)[tau + dt, phi + df]
        di = di + _shift2d(gi * cr - gr * ci, -dt, -df)
    return torch.complex(dr, di), torch.stack(dcoefs, dim=-2)


# ---------------- the kernels' plan ----------------

SMS = 132  # an H100's SMs
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024  # shared memory of an SM, and what each block reserves of it
MAX_SMEM = 227 * 1024  # shared memory a block can take
DF_RING = 3  # coefficient (and gradient) ring slots (kRing)
DF_MAX_THREADS = 1024
DF_REGISTERS = 64  # registers a thread at most (__launch_bounds__(1024))
DF_CHUNK_CHOICES = 4  # bin counts a backward plan weighs, from the fewest chunks that fit
# frames of a forward block: DF_RING - 1, so all of a block's rows are in flight from its start (in
# ops/df_timing.py's sweep on an H100, the fastest span at config 5b and within 0.6 % of it at config 3;
# spans of 8 to 13 ran 2-11 % slower)
DF_FORWARD_SPAN = DF_RING - 1


class DfPlan(NamedTuple):
    span: int  # frames a block owns
    bins: int  # bins a block owns
    threads: int  # threads a block: one a bin, rounded up to a warp
    spans: int  # spans a batch row: ceil(T / span)
    chunks: int  # bin ranges a frame: ceil(F / bins)
    blocks: int  # B x spans x chunks
    smem: int  # shared memory of one block, bytes
    blocks_per_sm: int  # what the shared memory, threads and registers let an SM hold


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def num_taps(t_dim: int, f_dim: int) -> int:
    return (2 * t_dim + 1) * (2 * f_dim + 1)


def df_threads(bins: int) -> int:
    return -(-bins // 32) * 32


def df_smem_bytes(bins: int, t_dim: int, f_dim: int, backward: bool = False) -> int:
    """Shared memory of a block (``fwd_smem_bytes`` / ``bwd_smem_bytes`` in the
    source). Forward: DF_RING coefficient slots of ``bins`` bins and a
    spectrum ring of 2 t_dim + DF_RING rows of bins + 2 f_dim. Backward: the
    coefficient slots with the bin halo, one slot of dcoefs, DF_RING gradient
    rows, the spectrum ring and 2 t_dim + 1 running dspec sums a thread."""
    two_k, width = 2 * num_taps(t_dim, f_dim), bins + 2 * f_dim
    if not backward:
        return 4 * DF_RING * _up4(bins * two_k + 8) + 8 * (2 * t_dim + DF_RING) * width
    return (4 * (DF_RING * _up4(width * two_k + 8) + _up4(bins * two_k + 8))
            + 8 * ((2 * DF_RING + 2 * t_dim) * width + (2 * t_dim + 1) * df_threads(bins)))


def df_blocks_per_sm(threads: int, smem: int) -> int:
    """Blocks an SM holds: by its shared memory (each block also reserving
    BLOCK_RESERVED), its 2,048 threads, its 65,536 registers at DF_REGISTERS a
    thread, and 32 blocks at most."""
    return max(0, min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // threads,
                      65536 // (DF_REGISTERS * threads), 32))


def df_tile_cost(b: int, t: int, f: int, t_dim: int, f_dim: int, span: int, bins: int) -> float:
    """What a backward plan costs, relatively: the bytes its blocks move from
    and to device memory (every row a block stages, so the spans' 2 t_dim
    frames and the ranges' 2 f_dim bins of halo count twice) times the time
    the last wave of blocks takes as if it were full (waves rounded up over
    waves, a wave being ``blocks_per_sm`` blocks on each of SMS SMs)."""
    k = num_taps(t_dim, f_dim)
    spans, chunks = -(-t // span), -(-f // bins)
    threads, smem = df_threads(bins), df_smem_bytes(bins, t_dim, f_dim, backward=True)
    waves = b * spans * chunks / (SMS * df_blocks_per_sm(threads, smem))
    walked = t + spans * 2 * t_dim  # g, coefficient and spectrum rows staged
    staged = f + chunks * 2 * f_dim  # bins of a staged row
    nbytes = b * (walked * staged * (8 * k + 16) + t * f * (8 * k + 8))
    return nbytes * math.ceil(waves) / waves


def _bin_choices(f: int, t_dim: int, f_dim: int, backward: bool) -> list:
    """Bins a block may own: ceil(F / chunks) for the fewest chunks whose block
    fits (DF_MAX_THREADS threads, MAX_SMEM bytes) and the next few, even
    where F is split so that every range starts 16-byte aligned."""
    choices = []
    for chunks in range(1, f + 1):
        bins = -(-f // chunks)
        bins += bins % 2 if chunks > 1 and bins < f else 0
        if (df_threads(bins) <= DF_MAX_THREADS and df_smem_bytes(bins, t_dim, f_dim, backward) <= MAX_SMEM
                and bins not in choices):
            choices.append(bins)
            if len(choices) == DF_CHUNK_CHOICES:
                break
    return choices


def _make_plan(b, t, f, t_dim, f_dim, span, bins, backward) -> DfPlan:
    threads, smem = df_threads(bins), df_smem_bytes(bins, t_dim, f_dim, backward)
    spans, chunks = -(-t // span), -(-f // bins)
    return DfPlan(span, bins, threads, spans, chunks, b * spans * chunks, smem,
                  df_blocks_per_sm(threads, smem))


@functools.lru_cache(maxsize=None)
def df_plan(b: int, t: int, f: int, t_dim: int, f_dim: int, causal: bool = True, history: bool = False,
            backward: bool = False, span: int | None = None, bins: int | None = None) -> DfPlan:
    """The tile of ``deep_filter_kernel`` (or, ``backward``, of
    ``deep_filter_bwd_kernel``) for a spectrum ``[b, t, f]``: the span of
    frames and the range of bins a block owns. The forward's span is
    DF_FORWARD_SPAN frames over the fewest ranges of bins that fit; the
    backward's, of least ``df_tile_cost`` among every span ceil(T / n) and
    the ``_bin_choices``, the fewer blocks on a tie. ``span`` (1..T) and
    ``bins`` (1..F, within DF_MAX_THREADS threads and MAX_SMEM bytes) fix a
    side; a plan the kernel would refuse raises. The tap layout (``causal``)
    and a history change no size; a backward with a history raises."""
    if min(b, t, f) < 1 or t_dim < 0 or f_dim < 0:
        raise ValueError(f"a deep_filter plan needs B, T, F >= 1 and t_dim, f_dim >= 0, got "
                         f"{(b, t, f, t_dim, f_dim)}")
    if history and (backward or not causal):
        raise ValueError("a history of past frames goes with the causal forward only")
    if span is not None and not 1 <= span <= t:
        raise ValueError(f"a deep_filter block takes 1 to {t} frames at T={t}, got {span}")
    if bins is not None:
        smem = df_smem_bytes(bins, t_dim, f_dim, backward) if bins >= 1 else 0
        if not (1 <= bins <= f and df_threads(bins) <= DF_MAX_THREADS and smem <= MAX_SMEM):
            raise ValueError(f"a deep_filter block takes 1 to {f} bins within {DF_MAX_THREADS} threads and "
                             f"{MAX_SMEM} B of shared memory, got {bins} ({smem} B)")
    bin_choices = [bins] if bins is not None else _bin_choices(f, t_dim, f_dim, backward)
    if not bin_choices:
        raise ValueError(f"no range of bins fits a deep_filter block at F={f}, t_dim={t_dim}, f_dim={f_dim}")
    if not backward:
        return _make_plan(b, t, f, t_dim, f_dim, span or min(t, DF_FORWARD_SPAN), bin_choices[0], backward)
    span_choices = [span] if span is not None else sorted({-(-t // n) for n in range(1, t + 1)})
    best = min(((s, nb) for s in span_choices for nb in bin_choices),
               key=lambda sb: (df_tile_cost(b, t, f, t_dim, f_dim, *sb), -sb[0] * sb[1]))
    return _make_plan(b, t, f, t_dim, f_dim, *best, backward)


def df_walk(t: int, span: int, t_dim: int, causal: bool = True, backward: bool = False) -> list:
    """Each span's ``(t0, nt, first, last)``: the frames it owns, [t0, t0 +
    nt), and the frames its walk stages, [first, last] (rows outside [0, T)
    read as zeros). Forward: the spectrum frames its taps read, t0 - dt_max
    .. t0 + nt - 1 - dt_min. Backward: the g and coefficient frames whose
    taps reach its dspec, t0 + dt_min .. t0 + nt - 1 + dt_max."""
    dt_min = 0 if causal else -t_dim
    dt_max = dt_min + 2 * t_dim
    rows = []
    for t0 in range(0, t, span):
        nt = min(span, t - t0)
        if backward:
            rows.append((t0, nt, t0 + dt_min, t0 + nt - 1 + dt_max))
        else:
            rows.append((t0, nt, t0 - dt_max, t0 + nt - 1 - dt_min))
    return rows


def deep_filter_bwd_walk_reference(grad, spec, coefs, t_dim: int, f_dim: int, causal: bool, plan: DfPlan):
    """``deep_filter_bwd`` computed block by block as ``deep_filter_bwd_kernel``
    walks: a block (a span [t0, t0 + nt) x a range of bins) steps over the
    frames u of ``df_walk``, with its g and coefficient rows u staged f_dim
    bins past each side of its range (zeros outside the spectrum); it takes
    dcoef of its own frames u, and adds row u's part of dspec[u - dt] into
    2 t_dim + 1 running sums, storing dspec[u - dt_max] once every part is in
    (where that frame is its own). Outputs start NaN, so a value no block
    stores shows."""
    b, t, f = spec.shape
    taps = tap_offsets(t_dim, f_dim, causal)
    dt_max = taps[-1][0]
    pt, pf = 4 * t_dim, f_dim  # zeros around the spectrum, g and the coefficients
    g_pad = F.pad(torch.view_as_real(grad), (0, 0, pf, pf, pt, pt))
    s_pad = F.pad(torch.view_as_real(spec), (0, 0, pf, pf, pt, pt))
    c_pad = F.pad(coefs, (0, 0, 0, 0, pf, pf, pt, pt))
    dspec = torch.full((b, t, f, 2), float("nan"), dtype=grad.real.dtype, device=grad.device)
    dcoefs = torch.full_like(coefs, float("nan"))
    ring = 2 * t_dim + 1

    def cplx(x):
        return torch.complex(x[..., 0], x[..., 1])

    for t0, nt, first, last in df_walk(t, plan.span, t_dim, causal, backward=True):
        for f0 in range(0, f, plan.bins):
            nf = min(plan.bins, f - f0)
            sums = [torch.zeros((b, nf), dtype=grad.dtype, device=grad.device) for _ in range(ring)]
            for u in range(first, last + 1):
                g = cplx(g_pad[:, u + pt, f0 : f0 + nf + 2 * pf])  # bins f0 - f_dim ..
                c = c_pad[:, u + pt, f0 : f0 + nf + 2 * pf]
                for k, (dt, df) in enumerate(taps):
                    part = g[:, pf + df : pf + df + nf] * cplx(c[:, pf + df : pf + df + nf, k]).conj()
                    sums[(u - dt - t0) % ring] += part
                done = u - dt_max
                if t0 <= done < t0 + nt:
                    dspec[:, done, f0 : f0 + nf] = torch.view_as_real(sums[(done - t0) % ring])
                sums[(done - t0) % ring] = torch.zeros_like(sums[0])
                if t0 <= u < t0 + nt:
                    for k, (dt, df) in enumerate(taps):
                        s = cplx(s_pad[:, u - dt + pt, f0 - df + pf : f0 - df + pf + nf])
                        dcoefs[:, u, f0 : f0 + nf, k] = torch.view_as_real(g[:, pf : pf + nf] * s.conj())
    return torch.view_as_complex(dspec), dcoefs


# ---------------- the kernels' wrappers ----------------


def _check(spec, coefs, t_dim, f_dim, causal, history, grad=None):
    if t_dim < 0 or f_dim < 0:
        raise ValueError(f"t_dim and f_dim must be >= 0, got {t_dim}, {f_dim}")
    if spec.dim() != 3 or spec.dtype != torch.complex64:
        raise ValueError(f"spec must be complex64 [B, T, F], got {spec.dtype} {tuple(spec.shape)}")
    b, t, f = spec.shape
    if min(b, t, f) < 1:
        raise ValueError(f"spec {tuple(spec.shape)}: need B, T, F >= 1")
    k = num_taps(t_dim, f_dim)
    if tuple(coefs.shape) != (b, t, f, k, 2) or coefs.dtype != torch.float32:
        raise ValueError(f"coefs must be float32 {(b, t, f, k, 2)} for spec {tuple(spec.shape)} "
                         f"and {k} taps, got {coefs.dtype} {tuple(coefs.shape)}")
    if history is not None:
        if not causal:
            raise ValueError("a history of past frames needs the causal tap layout")
        if tuple(history.shape) != (b, 2 * t_dim, f) or history.dtype != torch.complex64:
            raise ValueError(f"history must be complex64 {(b, 2 * t_dim, f)}, "
                             f"got {history.dtype} {tuple(history.shape)}")
    if grad is not None and (tuple(grad.shape) != (b, t, f) or grad.dtype != torch.complex64):
        raise ValueError(f"grad must be complex64 {(b, t, f)}, got {grad.dtype} {tuple(grad.shape)}")
    for name, tensor in (("coefs", coefs), ("history", history), ("grad", grad)):
        if tensor is not None and tensor.device != spec.device:
            raise ValueError(f"{name} is on {tensor.device}, spec on {spec.device}")
    if spec.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deep_filter runs on cpu or cuda tensors, got {spec.device}")


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load_library("deep_filter")
    fwd, bwd, info = lib.deep_filter_f32, lib.deep_filter_bwd_f32, lib.deep_filter_info
    pointer, stride = ctypes.c_void_p, ctypes.c_longlong
    fwd.argtypes = [pointer, stride, stride, pointer, stride, pointer, pointer] + [ctypes.c_int] * 8 + [pointer]
    bwd.argtypes = [pointer, pointer, stride, stride, pointer, pointer, pointer] + [ctypes.c_int] * 8 + [pointer]
    info.argtypes = [ctypes.c_int] * 4 + [pointer]
    fwd.restype = bwd.restype = info.restype = ctypes.c_int
    return fwd, bwd, info


def df_vector_floats(coefs, dcoefs=None) -> int:
    """The copy width (floats) the C entry picks: the widest of 4, 2 that the
    coefficients' base allows (forward: a row's ragged ends take 8-byte
    copies), and, given ``dcoefs`` (backward), that its base and the row
    length allow too; else 1."""
    row = coefs.shape[2] * coefs.shape[3] * 2 if dcoefs is not None else 4
    for v in (4, 2):
        if all(x.data_ptr() % (4 * v) == 0 for x in (coefs, dcoefs) if x is not None) and row % v == 0:
            return v
    return 1


def df_kernel_info(backward: bool, vec: int, smem: int, threads: int) -> dict:
    """The forward or backward kernel's instance with ``vec`` floats a copy (1,
    2 or 4) on the current CUDA device: registers and local (spill) bytes a
    thread, blocks an SM at ``smem`` bytes and ``threads`` a block, threads."""
    info = (ctypes.c_int * 4)()
    err = _kernels()[2](int(backward), vec, smem, threads, info)
    if err != 0:
        raise RuntimeError(f"deep_filter_info failed with CUDA error {err} (backward={backward}, vec={vec})")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "threads"), info))


def launch_df_fwd(spec, coefs, t_dim: int, f_dim: int, causal: bool, history, plan: DfPlan, out) -> None:
    """The forward kernel on CUDA tensors at a given plan, into ``out``
    (complex64 [B, T, F], contiguous); counted in ``deep_filter.launches``."""
    if spec.stride(-1) != 1:
        raise ValueError(f"spec bins must be contiguous, strides {spec.stride()}")
    if history is not None and history.stride()[1:] != (history.shape[2], 1):
        raise ValueError(f"history frames and bins must be contiguous, strides {history.stride()}")
    if not (coefs.is_contiguous() and out.is_contiguous()):
        raise ValueError("coefs and out must be contiguous")
    b, t, f = spec.shape
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    with torch.cuda.device(spec.device):
        err = _kernels()[0](spec.data_ptr(), spec.stride(0), spec.stride(1),
                            None if history is None else history.data_ptr(),
                            0 if history is None else history.stride(0), coefs.data_ptr(), out.data_ptr(),
                            b, t, f, t_dim, f_dim, int(causal), plan.span, plan.bins, stream)
    if err != 0:
        raise RuntimeError(f"deep_filter kernel launch failed with CUDA error {err} "
                           f"(B={b}, T={t}, F={f}, t_dim={t_dim}, f_dim={f_dim}, plan {plan})")
    deep_filter.launches += 1


def launch_df_bwd(grad, spec, coefs, t_dim: int, f_dim: int, causal: bool, plan: DfPlan, dspec, dcoefs) -> None:
    """The backward kernel on CUDA tensors at a given plan, into ``dspec``
    (complex64 [B, T, F]) and ``dcoefs`` (float32 [B, T, F, K, 2]), both
    contiguous; counted in ``deep_filter_bwd.launches``."""
    if spec.stride(-1) != 1:
        raise ValueError(f"spec bins must be contiguous, strides {spec.stride()}")
    for name, x in (("grad", grad), ("coefs", coefs), ("dspec", dspec), ("dcoefs", dcoefs)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {x.stride()}")
    b, t, f = spec.shape
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    with torch.cuda.device(spec.device):
        err = _kernels()[1](grad.data_ptr(), spec.data_ptr(), spec.stride(0), spec.stride(1), coefs.data_ptr(),
                            dspec.data_ptr(), dcoefs.data_ptr(), b, t, f, t_dim, f_dim, int(causal), plan.span,
                            plan.bins, stream)
    if err != 0:
        raise RuntimeError(f"deep_filter backward launch failed with CUDA error {err} "
                           f"(B={b}, T={t}, F={f}, t_dim={t_dim}, f_dim={f_dim}, plan {plan})")
    deep_filter_bwd.launches += 1


def _runs_plain(spec) -> bool:
    """The plain versions run for CPU tensors only; CUDA tensors launch the kernels."""
    return spec.device.type == "cpu"


def _forward_impl(spec: torch.Tensor, coefs: torch.Tensor, t_dim: int, f_dim: int, causal: bool,
                  history: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward on tensors with storage: the plain version on CPU tensors,
    on CUDA tensors the kernel at ``df_plan``'s tile (it launches or raises)."""
    if _runs_plain(spec):
        return deep_filter_reference(spec, coefs, t_dim, f_dim, causal, history).contiguous()
    b, t, f = spec.shape
    out = torch.empty((b, t, f), dtype=torch.complex64, device=spec.device)
    launch_df_fwd(spec, coefs, t_dim, f_dim, causal, history,
                  df_plan(b, t, f, t_dim, f_dim, causal, history is not None), out)
    return out


# the forward as the traceable op torch.ops.cruse_tpu_torch.deep_filter
deep_filter_op = torch.library.custom_op("cruse_tpu_torch::deep_filter", _forward_impl, mutates_args=(),
                                         device_types=("cpu", "cuda"))


@deep_filter_op.register_fake
def _deep_filter_fake(spec, coefs, t_dim, f_dim, causal, history):
    """Shapes only, for tracing (``torch.export``) on tensors without storage."""
    return spec.new_empty(spec.shape, dtype=torch.complex64)


def _forward(spec, coefs, t_dim, f_dim, causal, history):
    return torch.ops.cruse_tpu_torch.deep_filter(spec, coefs, t_dim, f_dim, causal, history)


def deep_filter_bwd(grad, spec, coefs, t_dim: int, f_dim: int, causal: bool = True):
    """The backward alone: ``(dspec complex64 [B, T, F], dcoefs float32 [B, T,
    F, K, 2])`` from the gradient ``grad`` of the output (see the module doc)."""
    _check(spec, coefs, t_dim, f_dim, causal, None, grad)
    # the kernels read the stored values: a lazily conjugated tensor is conjugated here
    grad, spec = grad.resolve_conj(), spec.resolve_conj()
    if _runs_plain(spec):
        return deep_filter_backward_reference(grad, spec, coefs, t_dim, f_dim, causal)
    b, t, f = spec.shape
    dspec = torch.empty((b, t, f), dtype=torch.complex64, device=spec.device)
    dcoefs = torch.empty(coefs.shape, dtype=torch.float32, device=spec.device)
    launch_df_bwd(grad, spec, coefs, t_dim, f_dim, causal, df_plan(b, t, f, t_dim, f_dim, causal, backward=True),
                  dspec, dcoefs)
    return dspec, dcoefs


class _DeepFilter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, coefs, t_dim, f_dim, causal):
        ctx.save_for_backward(spec, coefs)
        ctx.taps = (t_dim, f_dim, causal)
        return _forward(spec, coefs, t_dim, f_dim, causal, None)

    @staticmethod
    def backward(ctx, grad):
        spec, coefs = ctx.saved_tensors
        dspec, dcoefs = deep_filter_bwd(grad.resolve_conj().contiguous(), spec, coefs, *ctx.taps)
        return (dspec if ctx.needs_input_grad[0] else None, dcoefs if ctx.needs_input_grad[1] else None,
                None, None, None)


def deep_filter(spec, coefs, t_dim: int, f_dim: int, causal: bool = True, history=None):
    """Apply per-bin complex multi-frame filters (see the module doc);
    differentiable in ``spec`` and ``coefs`` where no history is given."""
    if history is not None and history.shape[1] == 0:
        history = None  # t_dim == 0: no past frame is ever read
    _check(spec, coefs, t_dim, f_dim, causal, history)
    # the kernels read the stored values: a lazily conjugated tensor is conjugated here
    spec = spec.resolve_conj()
    history = None if history is None else history.resolve_conj()
    inputs = (spec, coefs) if history is None else (spec, coefs, history)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        if history is not None:
            raise ValueError("deep_filter has no backward through a history of past frames; "
                             "run the streaming form under torch.no_grad() or torch.inference_mode()")
        return _DeepFilter.apply(spec, coefs, t_dim, f_dim, causal)
    return _forward(spec, coefs, t_dim, f_dim, causal, history)


deep_filter.launches = 0
deep_filter_bwd.launches = 0
