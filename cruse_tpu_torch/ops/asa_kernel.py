"""Temporal attention of MTFAA's ASA, forward and backward: the CUDA kernels'
wrappers and their plain versions.

Counterpart of ``cruse_tpu/ops/asa_kernel.py::flash_tattn_tm`` (with its
``custom_vjp``) and ``xla_tattn_tm``. T-minor: q, k ``[BF, c, T]``, v
``[BF, C, T]`` float32 -> out ``[BF, C, T]``::

    out[:, t] = sum_s softmax_s(q[:, t] . k[:, s] / sqrt(c)) v[:, s]

over the keys query t sees: ``t - window < s <= t`` when causal with a
window, ``s <= t`` when causal without one, and every key when
``causal=False`` (the window is then unused). The reference's flash path is
causal whatever it is given; this one is not.

``flash_tattn_tm`` runs the plain version for tensors on the CPU (its
autograd is the plain backward) and launches the hand-written kernels for
tensors on a CUDA device; on a CUDA device it launches or raises. Without a
gradient to compute it is the op ``torch.ops.cruse_tpu_torch.tattn_fwd``
(``_forward_impl``, which ``torch.export`` traces into a saved program): one
launch of the forward kernel
(``csrc/tattn.cu``, flash-style: no T x T tensor; a warp walks the 32-key
tiles of its own 32 queries' band with a base-2 online softmax, which
``tattn_band_tiles`` and ``tattn_online_reference`` spell out in PyTorch).
With one, the forward also writes each query's logsumexp ``[BF, T]``, and
the backward computes ``D = sum_C dO * O`` in PyTorch and launches
``tattn_dq`` and ``tattn_dkv`` (``csrc/tattn_bwd.cu``), which recompute the probabilities from the
logsumexp; the scale 1/sqrt(c) is applied once to dq and dk inside them. The
dq kernel walks exactly as the forward does (a warp of 32 queries over the
key tiles of ``tattn_band_tiles``; ``tattn_dq_walk_reference`` in PyTorch).
The dk/dv kernel walks with the roles swapped: a warp holds 32 keys and
visits the 32-query tiles of their band, which ``tattn_key_tiles`` and
``tattn_dkv_walk_reference`` spell out in PyTorch. The backward is causal
only: ``causal=False`` under a gradient raises.
``flash_tattn_tm.launches``, ``tattn_dq.launches`` and
``tattn_dkv.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from cruse_tpu_torch.ops import _build

MAX_QK_CHANNELS = 16  # c of q and k (the source's widest CQ instance)
MAX_V_CHANNELS = 48  # C of v (the widest CV instance)
# the forward kernel's walk (csrc/tattn.cu): keys a tile, keys whose logits a
# thread holds at once, queries a warp (one a lane)
KEY_TILE, HALF_TILE, WARP_QUERIES = 32, 16, 32
# the dk/dv kernel's walk (csrc/tattn_bwd.cu): queries a tile, keys a warp (one a lane);
# the dq kernel's is the forward's
QUERY_TILE, WARP_KEYS = 32, 32
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def band_mask(t: int, window: Optional[int], device) -> torch.Tensor:
    """bool [T, T]: True where query t (row) sees key s (column), ``s <= t`` and,
    with a window, ``s > t - window``."""
    ti = torch.arange(t, device=device)
    mask = ti[:, None] >= ti[None, :]
    return mask if window is None else mask & (ti[None, :] > ti[:, None] - window)


def tattn_reference(q, k, v, window: Optional[int] = None, causal: bool = True):
    """The plain PyTorch attention: the full [BF, T, T] logits, masked,
    softmax over the keys (``cruse_tpu/models/mtfaa.py``'s einsum path)."""
    c, t = q.shape[1], q.shape[2]
    logits = torch.einsum("bct,bcs->bts", q, k) * (1.0 / math.sqrt(c))
    if causal:
        logits = logits.masked_fill(~band_mask(t, window, q.device), -1e9)
    return torch.einsum("bts,bcs->bct", torch.softmax(logits, dim=-1), v)


def tattn_band_tiles(q0: int, nq: int, t: int, window: Optional[int] = None, causal: bool = True,
                     key_tile: int = KEY_TILE) -> list:
    """The key tiles that the queries ``[q0, q0 + nq)`` (those below ``t``)
    see, in order: ``[(first key, masked), ...]``. A tile is masked when some
    key of it lies outside some live query's band (or past ``t``); every
    other tile lies inside every query's band. With ``nq = WARP_QUERIES``,
    the walk of a warp of the forward kernel, whose index arithmetic
    (``csrc/tattn.cu``, ``tile_masked``) this is."""
    q_hi = min(q0 + nq, t) - 1
    s_lo, s_hi = 0, t - 1
    if causal:
        s_hi = q_hi
        if window is not None:
            s_lo = max(0, q0 - window + 1)
    tiles = []
    for s0 in range(s_lo // key_tile * key_tile, s_hi + 1, key_tile):
        if causal:
            masked = s0 + key_tile - 1 > q0 or (window is not None and s0 < q_hi - window + 1)
        else:
            masked = s0 + key_tile > t
        tiles.append((s0, masked))
    return tiles


def tattn_online_reference(q, k, v, window: Optional[int] = None, causal: bool = True,
                           queries_per_warp: int = WARP_QUERIES):
    """The forward kernel's walk in PyTorch: ``(out, lse)``. For each warp of
    ``queries_per_warp`` queries, the tiles of ``tattn_band_tiles`` in halves of
    ``HALF_TILE`` keys, a base-2 online softmax (log2(e)/sqrt(c) folded into
    q, the accumulators rescaled where a half tile raises the running max,
    masked keys -inf against a running max that starts at -1e30), and the
    natural-log logsumexp ``ln 2 * (m2 + log2 l)``. No card or JAX path calls
    it; the CPU tests hold it against the reference."""
    bf, c, t = q.shape
    q2 = q * (LOG2E / math.sqrt(c))
    out = torch.empty_like(v)
    lse = torch.empty((bf, t), dtype=q.dtype, device=q.device)
    for q0 in range(0, t, queries_per_warp):
        tq = torch.arange(q0, min(q0 + queries_per_warp, t), device=q.device)
        qw = q2[:, :, tq]
        m = torch.full((bf, len(tq)), -1e30, dtype=q.dtype, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((bf, v.shape[1], len(tq)), dtype=v.dtype, device=v.device)
        for s0, masked in tattn_band_tiles(q0, queries_per_warp, t, window, causal):
            for h0 in range(s0, min(s0 + KEY_TILE, t), HALF_TILE):
                keys = torch.arange(h0, min(h0 + HALF_TILE, t), device=q.device)  # keys past t add 0
                s = torch.einsum("bcn,bcs->bns", qw, k[:, :, keys])
                if masked and causal:
                    ok = keys[None, :] <= tq[:, None]
                    if window is not None:
                        ok = ok & (keys[None, :] > tq[:, None] - window)
                    s = s.masked_fill(~ok, -math.inf)
                top = s.amax(dim=-1)
                rises = top > m
                corr = torch.where(rises, torch.exp2(m - top), torch.ones_like(m))
                m = torch.where(rises, top, m)
                p = torch.exp2(s - m[..., None])
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[:, None] + torch.einsum("bns,bcs->bcn", p, v[:, :, keys])
        out[:, :, tq] = acc / l[:, None]
        lse[:, tq] = LN2 * (m + torch.log2(l))
    return out, lse


def _check(q, k, v, window):
    if q.dim() != 3 or q.dtype != torch.float32:
        raise ValueError(f"q must be float32 [BF, c, T], got {q.dtype} {tuple(q.shape)}")
    bf, c, t = q.shape
    if min(bf, c, t) < 1:
        raise ValueError(f"q {tuple(q.shape)}: need BF, c, T >= 1")
    if tuple(k.shape) != (bf, c, t) or k.dtype != torch.float32:
        raise ValueError(f"k must be float32 {(bf, c, t)}, got {k.dtype} {tuple(k.shape)}")
    if v.dim() != 3 or (v.shape[0], v.shape[2]) != (bf, t) or v.dtype != torch.float32:
        raise ValueError(f"v must be float32 [{bf}, C, {t}], got {v.dtype} {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, tensor in (("k", k), ("v", v)):
        if tensor.device != q.device:
            raise ValueError(f"{name} is on {tensor.device}, q on {q.device}")


def _check_bwd(q, k, v, dout, lse, dd, window):
    _check(q, k, v, window)
    bf, _, t = q.shape
    if dout.shape != v.shape or dout.dtype != torch.float32:
        raise ValueError(f"dout must be float32 {tuple(v.shape)}, got {dout.dtype} {tuple(dout.shape)}")
    for name, tensor in (("lse", lse), ("dd", dd)):
        if tuple(tensor.shape) != (bf, t) or tensor.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(bf, t)}, got {tensor.dtype} "
                             f"{tuple(tensor.shape)}")
    for name, tensor in (("dout", dout), ("lse", lse), ("dd", dd)):
        if tensor.device != q.device:
            raise ValueError(f"{name} is on {tensor.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the attention backward runs on cpu or cuda tensors, got {q.device}")


def tattn_bwd_reference(q, k, v, dout, window: Optional[int] = None):
    """The plain PyTorch backward of the causal attention, with the full
    [BF, T, T] probabilities: ``(dq, dk, dv)``."""
    c, t = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(c)
    logits = (torch.einsum("bct,bcs->bts", q, k) * scale).masked_fill(
        ~band_mask(t, window, q.device), -1e9)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bts,bct->bcs", p, dout)
    dp = torch.einsum("bct,bcs->bts", dout, v)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))  # sum_s p dp = sum_C dO . O
    return (torch.einsum("bts,bcs->bct", ds, k) * scale,
            torch.einsum("bts,bct->bcs", ds, q) * scale, dv)


def tattn_dq_walk_reference(q, k, v, dout, lse, dd, window: Optional[int] = None):
    """The dq kernel's walk in PyTorch: dq from the forward's logsumexp
    ``lse`` and ``dd = sum_C dout * out``. For each warp of ``WARP_QUERIES``
    queries, the key tiles of ``tattn_band_tiles``, with log2(e) / sqrt(c)
    folded into q, ``p = exp2(q' . k - lse log2 e)``, masked pairs set to 0
    in the flagged tiles only, ``ds = p (dout . v - dd)``, and 1 / sqrt(c)
    applied to dq at the end. No card or JAX path calls it; the CPU tests
    hold it against JAX."""
    bf, c, t = q.shape
    q2 = q * (LOG2E / math.sqrt(c))
    dq = torch.empty_like(q)
    for q0 in range(0, t, WARP_QUERIES):
        tq = torch.arange(q0, min(q0 + WARP_QUERIES, t), device=q.device)
        qw, gw = q2[:, :, tq], dout[:, :, tq]
        dqw = torch.zeros_like(qw)
        for s0, masked in tattn_band_tiles(q0, WARP_QUERIES, t, window):
            keys = torch.arange(s0, min(s0 + KEY_TILE, t), device=q.device)  # keys past t add 0
            kt = k[:, :, keys]
            p = torch.exp2(torch.einsum("bcn,bcs->bns", qw, kt) - lse[:, tq, None] * LOG2E)
            if masked:
                ok = keys[None, :] <= tq[:, None]
                if window is not None:
                    ok = ok & (keys[None, :] > tq[:, None] - window)
                p = torch.where(ok, p, torch.zeros_like(p))
            ds = p * (torch.einsum("bcn,bcs->bns", gw, v[:, :, keys]) - dd[:, tq, None])
            dqw = dqw + torch.einsum("bns,bcs->bcn", ds, kt)
        dq[:, :, tq] = dqw / math.sqrt(c)
    return dq


def tattn_key_tiles(s0: int, nk: int, t: int, window: Optional[int] = None) -> list:
    """The query tiles that see the keys ``[s0, s0 + nk)`` (those below ``t``),
    in order: ``[(first query, masked), ...]``, from the tile that holds
    ``s0`` to the one that holds the last live key + ``window`` - 1 (``t`` - 1
    without a window). A tile is masked when, and only when, it holds a pair
    outside the band of some live key: a query before the key, or ``window``
    or more after it. Queries past ``t`` form no pair (the kernel reads them as
    zeros, which add nothing). With ``nk = WARP_KEYS``, the walk of a warp of
    the dk/dv kernel, whose index arithmetic (``csrc/tattn_bwd.cu``,
    ``tile_masked``) this is."""
    s_hi = min(s0 + nk, t) - 1
    t_hi = t - 1 if window is None else min(t - 1, s_hi + window - 1)
    return [(t0, t0 < s_hi or (window is not None and min(t0 + QUERY_TILE, t) - 1 >= s0 + window))
            for t0 in range(s0 // QUERY_TILE * QUERY_TILE, t_hi + 1, QUERY_TILE)]


def tattn_dkv_walk_reference(q, k, v, dout, lse, dd, window: Optional[int] = None):
    """The dk/dv kernel's walk in PyTorch: ``(dk, dv)`` from the forward's
    logsumexp ``lse`` and ``dd = sum_C dout * out``. For each warp of
    ``WARP_KEYS`` keys, the tiles of ``tattn_key_tiles``, with log2(e) /
    sqrt(c) folded into k, ``p = exp2(q . k' - lse log2 e)``, masked pairs
    set to 0 in the flagged tiles only, and 1 / sqrt(c) applied to dk at the
    end. No card or JAX path calls it; the CPU tests hold it against JAX."""
    bf, c, t = q.shape
    k2 = k * (LOG2E / math.sqrt(c))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for s0 in range(0, t, WARP_KEYS):
        ts = torch.arange(s0, min(s0 + WARP_KEYS, t), device=q.device)
        kw, vw = k2[:, :, ts], v[:, :, ts]
        dkw, dvw = torch.zeros_like(kw), torch.zeros_like(vw)
        for t0, masked in tattn_key_tiles(s0, WARP_KEYS, t, window):
            tq = torch.arange(t0, min(t0 + QUERY_TILE, t), device=q.device)
            qt, gt = q[:, :, tq], dout[:, :, tq]
            p = torch.exp2(torch.einsum("bcn,bcm->bnm", kw, qt) - lse[:, None, tq] * LOG2E)
            if masked:
                ok = tq[None, :] >= ts[:, None]
                if window is not None:
                    ok = ok & (tq[None, :] < ts[:, None] + window)
                p = torch.where(ok, p, torch.zeros_like(p))
            ds = p * (torch.einsum("bcn,bcm->bnm", vw, gt) - dd[:, None, tq])
            dvw = dvw + torch.einsum("bnm,bcm->bcn", p, gt)
            dkw = dkw + torch.einsum("bnm,bcm->bcn", ds, qt)
        dk[:, :, ts] = dkw / math.sqrt(c)
        dv[:, :, ts] = dvw
    return dk, dv


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load_library("tattn")
    fwd, info = lib.tattn_fwd_f32, lib.tattn_fwd_info
    bwd = _build.load_library("tattn_bwd")
    dq, dkv, dkv_info, dq_info = bwd.tattn_dq_f32, bwd.tattn_dkv_f32, bwd.tattn_dkv_info, bwd.tattn_dq_info
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    info.argtypes = dkv_info.argtypes = dq_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (fwd, dq, dkv, info, dkv_info, dq_info):
        fn.restype = ctypes.c_int
    return fwd, dq, dkv, info, dkv_info, dq_info


def _instance_info(entry: int, what: str, c: int, cv: int, per_warp: str) -> dict:
    info = (ctypes.c_int * 6)()
    err = _kernels()[entry](c, cv, info)
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err} (c={c}, C={cv})")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "threads", "smem_bytes", per_warp), info))


def tattn_fwd_info(c: int, cv: int) -> dict:
    """The forward kernel's instance for head widths (c, C) on the current
    CUDA device: registers and local (spill) bytes a thread, blocks an SM,
    threads a block, shared memory a block (bytes), queries a warp."""
    return _instance_info(3, "tattn_fwd_info", c, cv, "warp_queries")


def tattn_dkv_info(c: int, cv: int) -> dict:
    """The dk/dv kernel's instance for head widths (c, C) on the current CUDA
    device, as ``tattn_fwd_info`` (keys a warp in place of queries)."""
    return _instance_info(4, "tattn_dkv_info", c, cv, "warp_keys")


def tattn_dq_info(c: int, cv: int) -> dict:
    """The dq kernel's instance for head widths (c, C) on the current CUDA
    device, as ``tattn_fwd_info``."""
    return _instance_info(5, "tattn_dq_info", c, cv, "warp_queries")


def _check_launch(what, **tensors):
    """What the kernels need of their operands (q and v among them)."""
    for name, tensor in tensors.items():
        if not tensor.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous, strides {tensor.stride()}")
    bf, c, cv = tensors["q"].shape[0], tensors["q"].shape[1], tensors["v"].shape[1]
    if c > MAX_QK_CHANNELS or cv > MAX_V_CHANNELS:
        raise ValueError(f"the attention kernels take c <= {MAX_QK_CHANNELS} and "
                         f"C <= {MAX_V_CHANNELS}, got c={c}, C={cv}")
    if bf > 65535:
        raise ValueError(f"BF={bf} > 65535, the kernels' grid limit")


def _raise_on(err, what, q, v, window):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err} (BF={q.shape[0]}, "
                           f"c={q.shape[1]}, C={v.shape[1]}, T={q.shape[2]}, window={window})")


def _launch_fwd(q, k, v, window, causal, with_lse: bool):
    """One launch of the forward kernel: ``(out, lse or None)``."""
    _check_launch("flash_tattn_tm", q=q, k=k, v=v)
    bf, c, t = q.shape
    out = torch.empty_like(v)
    lse = torch.empty((bf, t), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            lse.data_ptr() if with_lse else None, bf, c, v.shape[1], t,
                            0 if window is None else int(window), int(causal), stream)
    _raise_on(err, f"tattn forward (causal={causal})", q, v, window)
    flash_tattn_tm.launches += 1
    return out, lse


def tattn_dq(q, k, v, dout, lse, dd, window: Optional[int] = None):
    """dq ``[BF, c, T]`` of the causal attention from the output's gradient
    ``dout``, the forward's logsumexp ``lse`` and ``dd = sum_C dout * out``
    (both ``[BF, T]``). On the CPU the plain version (``lse``, ``dd`` unused)."""
    _check_bwd(q, k, v, dout, lse, dd, window)
    if q.device.type == "cpu":
        return tattn_bwd_reference(q, k, v, dout, window)[0]
    dq = torch.empty_like(q)
    _launch_dq(q, k, v, dout, lse, dd, window, dq)
    return dq


def tattn_dkv(q, k, v, dout, lse, dd, window: Optional[int] = None):
    """``(dk [BF, c, T], dv [BF, C, T])`` of the causal attention; arguments
    as ``tattn_dq``."""
    _check_bwd(q, k, v, dout, lse, dd, window)
    if q.device.type == "cpu":
        return tattn_bwd_reference(q, k, v, dout, window)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_dkv(q, k, v, dout, lse, dd, window, dk, dv)
    return dk, dv


def _check_grads(q, **grads):
    """Each gradient is float32 of its operand's shape, on q's device (``{name: (grad, operand)}``)."""
    for name, (grad, like) in grads.items():
        if grad.shape != like.shape or grad.dtype != torch.float32 or grad.device != q.device:
            raise ValueError(f"{name} must be float32 {tuple(like.shape)} on {q.device}, got "
                             f"{grad.dtype} {tuple(grad.shape)} on {grad.device}")


def _launch_dq(q, k, v, dout, lse, dd, window, dq):
    """One launch of the dq kernel on CUDA tensors, into ``dq`` (``tattn_dq``'s;
    ``chip_smoke.py`` passes a NaN-filled one, so an element no lane writes
    shows); counted in ``tattn_dq.launches``."""
    _check_launch("tattn_dq", q=q, k=k, v=v, dout=dout, lse=lse, dd=dd, dq=dq)
    _check_grads(q, dq=(dq, q))
    bf, c, t = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), bf, c, v.shape[1], t,
                            0 if window is None else int(window), stream)
    _raise_on(err, "tattn_dq", q, v, window)
    tattn_dq.launches += 1


def _launch_dkv(q, k, v, dout, lse, dd, window, dk, dv):
    """One launch of the dk/dv kernel on CUDA tensors, into ``dk`` and ``dv``
    (``tattn_dkv``'s; ``chip_smoke.py`` passes NaN-filled ones, so an
    element no lane writes shows); counted in ``tattn_dkv.launches``."""
    _check_launch("tattn_dkv", q=q, k=k, v=v, dout=dout, lse=lse, dd=dd, dk=dk, dv=dv)
    _check_grads(q, dk=(dk, k), dv=(dv, v))
    bf, c, t = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernels()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), bf, c,
                            v.shape[1], t, 0 if window is None else int(window), stream)
    _raise_on(err, "tattn_dkv", q, v, window)
    tattn_dkv.launches += 1


class _FlashTattn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = _launch_fwd(q, k, v, window, True, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dd = (dout * out).sum(dim=1)
        dq = tattn_dq(q, k, v, dout, lse, dd, ctx.window)
        dk, dv = tattn_dkv(q, k, v, dout, lse, dd, ctx.window)
        return dq, dk, dv, None


def _forward_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
                  causal: bool) -> torch.Tensor:
    """The forward without a gradient on tensors with storage: the plain
    version on CPU tensors, one launch of the forward kernel (no logsumexp)
    on CUDA tensors (it launches or raises)."""
    if q.device.type == "cpu":
        return tattn_reference(q, k, v, window, causal).contiguous()
    return _launch_fwd(q, k, v, window, causal, with_lse=False)[0]


# the forward as the traceable op torch.ops.cruse_tpu_torch.tattn_fwd
tattn_fwd_op = torch.library.custom_op("cruse_tpu_torch::tattn_fwd", _forward_impl, mutates_args=(),
                                       device_types=("cpu", "cuda"))


@tattn_fwd_op.register_fake
def _tattn_fwd_fake(q, k, v, window, causal):
    """Shapes only, for tracing (``torch.export``) on tensors without storage."""
    return torch.empty_like(v, memory_format=torch.contiguous_format)


def _forward(q, k, v, window, causal):
    return torch.ops.cruse_tpu_torch.tattn_fwd(q, k, v, window, causal)


def flash_tattn_tm(q, k, v, window: Optional[int] = None, causal: bool = True):
    """Temporal attention, T-minor, differentiable when causal (see the module
    doc). Without a gradient it is the op ``torch.ops.cruse_tpu_torch.tattn_fwd``."""
    _check(q, k, v, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_tattn_tm runs on cpu or cuda tensors, got {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if q.device.type == "cpu":  # the plain version's autograd
            return tattn_reference(q, k, v, window, causal)
        if not causal:
            raise NotImplementedError("the non-causal attention kernel has no backward (the "
                                      "models train causally); run it without a gradient")
        return _FlashTattn.apply(q, k, v, window)
    return _forward(q, k, v, None if window is None else int(window), causal)


flash_tattn_tm.launches = 0
tattn_dq.launches = 0
tattn_dkv.launches = 0
