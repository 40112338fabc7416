"""(3, 3) time-dilated causal depthwise stencil of MTFAA's TFCM block, with its
backward: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``cruse_tpu/ops/dw_kernel.py`` (``dw_causal_tm``,
``dw_taps_reference``). T-minor: ``x_ext [B, K, C, T + 2d]`` (the input
already extended by 2d frames before t = 0 by the caller), ``wd [3, 3, C]``
float32 -> ``[B, K, C, T]``::

    y[b, k, c, t] = sum_{it, jf} wd[it, jf, c] * x_ext[b, k + jf - 1, c, t + it * d]

with bands outside ``[0, K)`` read as zero. The backward is the same stencil
with both weight axes flipped on the gradient (zero outside its own extent)
and, in the same pass, the nine tap sums ``dwd[it, jf, c]`` over B, K, T.

``dw_stencil_fwd`` and ``dw_stencil_bwd`` run the plain versions for tensors
on the CPU and launch the hand-written kernels (``csrc/dw_stencil.cu``) for
tensors on a CUDA device; on a CUDA device they launch or raise. Each counts
its calls that launched (``.launches``). Neither pads anything: the kernels
bound their indices. A block of either kernel owns a tile, one channel of one
batch item, ``kb`` bands and ``tt`` frames (of y forward, of dx backward;
``dw_plan``), and walks down its bands with the rows staged in shared memory
through a ``cp.async`` ring. ``dw_walk_reference`` is that walk in PyTorch.
The backward is two launches: the tiles, each writing its nine f32 tap sums
into ``part [C, 9, tiles]`` (``dw_partials_reference``), then a kernel that
adds each channel's tiles in float64 in a fixed order
(``dw_finish_reference``), so the tap sums do not vary from run to run.
``dw_causal_tm`` is the differentiable function built from the two.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cruse_tpu_torch.ops import _build


def dw_taps_reference(x_ext: torch.Tensor, wd: torch.Tensor, d: int) -> torch.Tensor:
    """The plain PyTorch stencil: nine shifted multiply-adds over the input
    zero-padded by one band at each edge (``TFCMBlock``'s inner loop)."""
    k, t = x_ext.shape[1], x_ext.shape[-1] - 2 * d
    xp = F.pad(x_ext, (0, 0, 0, 0, 1, 1))
    acc = None
    for it in range(3):  # causal time taps at offsets -2d, -d, 0
        for jf in range(3):  # symmetric band taps
            term = xp[:, jf : jf + k, :, it * d : it * d + t] * wd[it, jf][:, None]
            acc = term if acc is None else acc + term
    return acc


def dw_bwd_reference(g: torch.Tensor, x_ext: torch.Tensor, wd: torch.Tensor, d: int):
    """The plain PyTorch backward: ``dx`` = the flipped stencil on the gradient
    padded by one band and 2d frames on each side, ``dwd`` = the nine tap sums."""
    k, t = g.shape[1], g.shape[-1]
    gp = F.pad(g, (2 * d, 2 * d, 0, 0, 1, 1))
    xp = F.pad(x_ext, (0, 0, 0, 0, 1, 1))
    dx, taps = None, []
    for it in range(3):
        for jf in range(3):
            term = gp[:, jf : jf + k, :, it * d : it * d + t + 2 * d] * wd[2 - it, 2 - jf][:, None]
            dx = term if dx is None else dx + term
            taps.append((xp[:, jf : jf + k, :, it * d : it * d + t] * g).sum(dim=(0, 1, 3)))
    return dx, torch.stack(taps).reshape(3, 3, -1)


def _check(x_ext, wd, d, g=None):
    if not isinstance(d, int) or d < 1:
        raise ValueError(f"d must be a positive int, got {d!r}")
    if x_ext.dim() != 4 or x_ext.dtype != torch.float32:
        raise ValueError(f"x_ext must be float32 [B, K, C, T + 2d], got {x_ext.dtype} "
                         f"{tuple(x_ext.shape)}")
    b, k, c, t_ext = x_ext.shape
    if min(b, k, c) < 1 or t_ext - 2 * d < 1:
        raise ValueError(f"x_ext {tuple(x_ext.shape)} with d={d}: need B, K, C >= 1 and T >= 1")
    if tuple(wd.shape) != (3, 3, c) or wd.dtype != torch.float32:
        raise ValueError(f"wd must be float32 {(3, 3, c)}, got {wd.dtype} {tuple(wd.shape)}")
    if g is not None and (tuple(g.shape) != (b, k, c, t_ext - 2 * d) or g.dtype != torch.float32):
        raise ValueError(f"g must be float32 {(b, k, c, t_ext - 2 * d)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    for name, tensor in (("wd", wd), ("g", g)):
        if tensor is not None and tensor.device != x_ext.device:
            raise ValueError(f"{name} is on {tensor.device}, x_ext on {x_ext.device}")


DW_MAX_SPAN = {False: 640, True: 768}  # frames of a tile at most, forward and backward: 128 threads x 5, x 6
DW_RING = 4  # shared-memory slots of a block's ring (kRing)
DW_BANDS = (32, 16, 8, 4, 2, 1)  # band groups dw_plan weighs
SMS = 132  # an H100's SMs
DW_BLOCKS_PER_SM = {False: 8, True: 5}  # forward, backward: at 64 and 96 registers a thread (H100, measured)
DW_MIN_BLOCKS = 3 * SMS  # blocks a launch needs, where the shape allows: three an SM keep the rows in flight


class DwPlan(NamedTuple):
    kb: int  # bands of a tile
    tt: int  # frames of a tile: of y (forward) or of dx (backward)
    tiles: int  # tiles a channel: B x ceil(K / kb) x ceil(frames / tt)
    smem: int  # shared memory of one block, bytes


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def dw_row_floats(span: int, d: int) -> int:
    """Floats of a staged row (``row_floats`` in the source): one run of
    span + 2d frames, or three runs of span frames where d > span, each with
    6 floats of slack for the copy width's rounding."""
    return _up4(span + 2 * d + 6) if d <= span else 3 * _up4(span + 6)


def dw_smem_bytes(span: int, d: int, backward: bool = False) -> int:
    """Shared memory of a block: DW_RING slots of a row (of x forward; of g
    and the tile's own frames of x backward)."""
    return 4 * DW_RING * (dw_row_floats(span, d) + (span + 4 if backward else 0))


def dw_tile_cost(b: int, k: int, c: int, spans: int, kb: int, backward: bool = False) -> float:
    """What a band group costs, relatively: the rows a tile reads over its
    own (kb + 2 halo bands over kb) times the time the last wave of blocks
    takes as if full (waves rounded up over waves, a wave being
    DW_BLOCKS_PER_SM blocks on each of SMS SMs)."""
    waves = b * c * -(-k // kb) * spans / (SMS * DW_BLOCKS_PER_SM[backward])
    return (kb + 2) / kb * math.ceil(waves) / waves


@functools.lru_cache(maxsize=None)
def dw_plan(b: int, k: int, c: int, t: int, d: int, backward: bool = False, kb: int | None = None,
            tt: int | None = None) -> DwPlan:
    """The tile of ``dw_fwd_kernel`` (or ``dw_bwd_kernel``) for x_ext ``[b, k,
    c, t + 2d]``: frames of y (t) or of dx (t + 2d) cut into the fewest spans
    of at most DW_MAX_SPAN[backward] frames, each a multiple of 4, and the band group
    of ``DW_BANDS`` (at most K) of least ``dw_tile_cost`` among those that
    leave DW_MIN_BLOCKS blocks (all, where none does), the larger on a tie.
    ``kb`` (1..K) / ``tt`` (a multiple of 4, 4..DW_MAX_SPAN[backward]) fix a side."""
    frames, most = (t + 2 * d if backward else t), DW_MAX_SPAN[backward]
    if kb is not None and not 1 <= kb <= k:
        raise ValueError(f"a dw_stencil tile takes 1 to {k} bands at K={k}, got {kb}")
    if tt is not None and not (4 <= tt <= most and tt % 4 == 0):
        raise ValueError(f"a dw_stencil tile takes a multiple of 4 frames up to {most}, got {tt}")
    if tt is None:
        spans = -(-frames // most)
        tt = _up4(-(-frames // spans))
    spans = -(-frames // tt)
    if kb is None:
        kbs = sorted({min(g, k) for g in DW_BANDS}, reverse=True)
        kbs = [g for g in kbs if b * c * -(-k // g) * spans >= DW_MIN_BLOCKS] or kbs
        kb = min(kbs, key=lambda g: (dw_tile_cost(b, k, c, spans, g, backward), -g))
    return DwPlan(kb, tt, b * -(-k // kb) * spans, dw_smem_bytes(tt, d, backward))


def dw_walk_reference(x_ext: torch.Tensor, wd: torch.Tensor, d: int, plan: DwPlan,
                      g: torch.Tensor | None = None) -> torch.Tensor:
    """y (``g`` None) or dx computed tile by tile as a block of the forward or
    backward kernel does: it walks down rows k0 - 1 .. k0 + kb of its tile
    (halo bands outside [0, K) zero), reads each row's three time taps over
    its span (x_ext at t + it d; g at u - it d, zero outside [0, T)), and
    keeps two running sums a frame, finishing band q - 1 at row q."""
    b, k, c, t_ext = x_ext.shape
    t = t_ext - 2 * d
    if g is None:
        src, frames, sign, origin, jfs = x_ext, t, 1, 0, (2, 1, 0)
    else:
        src, frames, sign, origin, jfs = F.pad(g, (2 * d, 2 * d)), t_ext, -1, 2 * d, (0, 1, 2)
    out = x_ext.new_full((b, k, c, frames), float("nan"))
    w = [[wd[it, jf][:, None] for jf in range(3)] for it in range(3)]
    for k0 in range(0, k, plan.kb):
        nb = min(plan.kb, k - k0)
        for f0 in range(0, frames, plan.tt):
            nf = min(plan.tt, frames - f0)
            run, nxt = x_ext.new_zeros((b, c, nf)), x_ext.new_zeros((b, c, nf))  # bands q, q + 1
            for s in range(nb + 2):
                q = k0 - 1 + s
                starts = [origin + f0 + sign * it * d for it in range(3)]
                v = ([src[:, q, :, a : a + nf] for a in starts] if 0 <= q < k
                     else [x_ext.new_zeros((b, c, nf))] * 3)
                done, a_jf, b_jf = jfs
                finished = run + sum(w[it][done] * v[it] for it in range(3))
                if s >= 2:
                    out[:, q - 1, :, f0 : f0 + nf] = finished
                run = nxt + sum(w[it][a_jf] * v[it] for it in range(3))
                nxt = sum(w[it][b_jf] * v[it] for it in range(3))
    return out


def dw_partials_reference(g: torch.Tensor, x_ext: torch.Tensor, d: int, plan: DwPlan) -> torch.Tensor:
    """The plain version of ``dw_bwd_kernel``'s sums: ``part [C, 9, tiles]``,
    each tile's nine tap sums in float32, taken as the kernel takes them, over
    the tile's own points (k, u) of x_ext with the g neighbours ``g[k + 1 - jf,
    u - it d]`` (zero outside the tensor), tap it * 3 + jf."""
    b, k, c, t_ext = x_ext.shape
    gp = F.pad(g, (2 * d, 2 * d, 0, 0, 1, 1))
    terms = [x_ext * gp[:, 2 - jf : 2 - jf + k, :, (2 - it) * d : (2 - it) * d + t_ext]
             for it in range(3) for jf in range(3)]
    nk, nt = -(-k // plan.kb), -(-t_ext // plan.tt)
    pad = (0, nt * plan.tt - t_ext, 0, 0, 0, nk * plan.kb - k)
    tiled = [F.pad(term, pad).reshape(b, nk, plan.kb, c, nt, plan.tt).sum(dim=(2, 5)) for term in terms]
    return torch.stack(tiled).permute(3, 0, 1, 2, 4).reshape(c, 9, plan.tiles)


def dw_finish_reference(part: torch.Tensor) -> torch.Tensor:
    """The plain version of ``dw_finish_kernel``: ``part [C, 9, tiles]`` ->
    ``dwd [3, 3, C]``, each channel's tiles added in float64."""
    return part.sum(dim=2, dtype=torch.float64).float().t().reshape(3, 3, -1)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load_library("dw_stencil")
    fwd, bwd, info = lib.dw_stencil_fwd_f32, lib.dw_stencil_bwd_f32, lib.dw_stencil_info
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = info.restype = ctypes.c_int
    return fwd, bwd, info


def dw_kernel_info(backward: bool, vec: int, smem_bytes: int) -> dict:
    """The forward or backward kernel's instance with ``vec`` floats a copy
    (1, 2 or 4) on the current CUDA device: registers and local (spill) bytes
    a thread, blocks an SM at ``smem_bytes`` of shared memory, threads a block."""
    info = (ctypes.c_int * 4)()
    err = _kernels()[2](int(backward), vec, smem_bytes, info)
    if err != 0:
        raise RuntimeError(f"dw_stencil_info failed with CUDA error {err} (backward={backward}, vec={vec})")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "threads"), info))


def _need_contiguous(**tensors):
    for name, tensor in tensors.items():
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {tensor.stride()}")


def dw_stencil_fwd(x_ext: torch.Tensor, wd: torch.Tensor, d: int) -> torch.Tensor:
    """The stencil's forward alone (no autograd): see the module doc."""
    _check(x_ext, wd, d)
    if x_ext.device.type == "cpu":
        return dw_taps_reference(x_ext, wd, d)
    if x_ext.device.type != "cuda":
        raise ValueError(f"dw_stencil_fwd runs on cpu or cuda tensors, got {x_ext.device}")
    b, k, c, t_ext = x_ext.shape
    y = torch.empty((b, k, c, t_ext - 2 * d), dtype=torch.float32, device=x_ext.device)
    launch_dw_fwd(x_ext, wd, d, dw_plan(b, k, c, t_ext - 2 * d, d), y)
    return y


def launch_dw_fwd(x_ext, wd, d: int, plan: DwPlan, y) -> None:
    """The forward kernel on CUDA tensors at a given tile, into ``y``; counted
    in ``dw_stencil_fwd.launches``."""
    _need_contiguous(x_ext=x_ext, wd=wd, y=y)
    b, k, c, t_ext = x_ext.shape
    t = t_ext - 2 * d
    stream = torch.cuda.current_stream(x_ext.device).cuda_stream
    with torch.cuda.device(x_ext.device):
        err = _kernels()[0](x_ext.data_ptr(), wd.data_ptr(), y.data_ptr(), b, k, c, t, d, plan.kb, plan.tt,
                            stream)
    if err != 0:
        raise RuntimeError(f"dw_stencil forward launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t}, d={d}, plan {plan})")
    dw_stencil_fwd.launches += 1


def dw_stencil_bwd(g: torch.Tensor, x_ext: torch.Tensor, wd: torch.Tensor, d: int):
    """The stencil's backward alone: ``(dx [B, K, C, T + 2d], dwd [3, 3, C])``
    from the gradient ``g [B, K, C, T]`` of its output."""
    _check(x_ext, wd, d, g)
    if x_ext.device.type == "cpu":
        return dw_bwd_reference(g, x_ext, wd, d)
    if x_ext.device.type != "cuda":
        raise ValueError(f"dw_stencil_bwd runs on cpu or cuda tensors, got {x_ext.device}")
    b, k, c, t_ext = x_ext.shape
    plan = dw_plan(b, k, c, t_ext - 2 * d, d, backward=True)
    dx, part, dwd = dw_bwd_buffers(x_ext, plan)
    launch_dw_bwd(g, x_ext, wd, d, plan, dx, part, dwd)
    return dx, dwd


def dw_bwd_buffers(x_ext, plan: DwPlan):
    """Uninitialised ``(dx, part [C, 9, tiles], dwd [3, 3, C])`` for ``launch_dw_bwd``."""
    c = x_ext.shape[2]
    return torch.empty_like(x_ext), x_ext.new_empty((c, 9, plan.tiles)), x_ext.new_empty((3, 3, c))


def launch_dw_bwd(g, x_ext, wd, d: int, plan: DwPlan, dx, part, dwd) -> None:
    """The backward's two kernels on CUDA tensors at a given tile, into
    ``dw_bwd_buffers``; counted in ``dw_stencil_bwd.launches``."""
    _need_contiguous(g=g, x_ext=x_ext, wd=wd, dx=dx, part=part, dwd=dwd)
    b, k, c, t_ext = x_ext.shape
    t = t_ext - 2 * d
    stream = torch.cuda.current_stream(x_ext.device).cuda_stream
    with torch.cuda.device(x_ext.device):
        err = _kernels()[1](g.data_ptr(), x_ext.data_ptr(), wd.data_ptr(), dx.data_ptr(), part.data_ptr(),
                            dwd.data_ptr(), b, k, c, t, d, plan.kb, plan.tt, stream)
    if err != 0:
        raise RuntimeError(f"dw_stencil backward launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t}, d={d}, plan {plan})")
    dw_stencil_bwd.launches += 1


dw_stencil_fwd.launches = 0
dw_stencil_bwd.launches = 0


class _DwCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_ext, wd, d):
        ctx.save_for_backward(x_ext, wd)
        ctx.d = d
        return dw_stencil_fwd(x_ext, wd, d)

    @staticmethod
    def backward(ctx, g):
        x_ext, wd = ctx.saved_tensors
        dx, dwd = dw_stencil_bwd(g.contiguous(), x_ext, wd, ctx.d)
        return dx, dwd, None


def dw_causal_tm(x_ext: torch.Tensor, wd: torch.Tensor, d: int) -> torch.Tensor:
    """The differentiable stencil, ``x_ext [B, K, C, T + 2d]``, ``wd [3, 3, C]``
    -> ``[B, K, C, T]``: forward ``dw_stencil_fwd``, backward
    ``dw_stencil_bwd`` (on the CPU, their plain versions)."""
    return _DwCausal.apply(x_ext, wd, d)
