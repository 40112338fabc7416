"""Backward of one train-mode TFCM block, phases A (``tail_bwd``) and B
(``mid_bwd``): the CUDA kernels' wrappers and their plain versions.

Counterpart of ``cruse_tpu/ops/tfcm_bwd_kernels.py``. The block and its
three-phase backward are described in ``ops/tfcm_train.py``; the two
BatchNorms' global means cut the backward into phases, and each of these
functions is one pass over ``[B, K, C, T]`` float32 tensors (T-minor) that
also takes every per-channel sum of its phase.

``tail_bwd(dh2a, h2, m2, v2, g2, be2, a2, eps)`` -> ``(dh2n, dgamma2 [C],
dbeta2 [C], da2 [])``: PReLU2 and the affine half of BN2 backward, from
``dh2a = g @ w2^T`` and the block's second pre-norm activation ``h2`` with its
batch statistics.

``mid_bwd(dh2, h1, wd, m1, v1, g1, be1, a1, d, eps)`` -> ``(dh1n, dwd
[3, 3, C], dgamma1 [C], dbeta1 [C], da1 [], dbd [C])``: the depthwise
stencil's backward on the BN2-applied gradient ``dh2``, with BN1 and PReLU1
recomputed from ``h1``. Unlike the reference, which takes the gradient padded
by a band and 2d frames on each side, this takes ``dh2 [B, K, C, T]`` as it
is: the kernel bounds its indices, so nothing is padded, any dilation runs,
and T need not fill a tile. The stencil's input is PReLU1's output extended
by 2d true zeros before t = 0 and a zero band at each edge.

Both run the plain versions for tensors on the CPU and launch the
hand-written kernels (``csrc/tfcm_bwd.cu``) for tensors on a CUDA device; on a
CUDA device they launch or raise. Each counts its calls that launched
(``.launches``). The PReLU slopes are read on the device (0-d tensors):
nothing here waits for the card.

``tail_bwd`` launches one kernel a row (b, k, c) and adds the rows' f32 sums
per channel in float64 with PyTorch. ``mid_bwd`` makes two launches and no
other device work: ``mid_tile_kernel`` over tiles of one channel, ``kb`` bands
and ``tt`` frames (``mid_plan``), each tile's 13 f32 sums into ``part [C,
13, tiles]``, then ``mid_finish_kernel``, which adds each channel's tiles in
float64 in a fixed order and writes the five sums. So neither's sums vary
from run to run. ``mid_partials_reference`` and ``mid_finish_reference`` are
the plain versions of those two steps.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.dw_kernel import _need_contiguous
from cruse_tpu_torch.ops.tfcm_kernel import BLOCK_RESERVED_SMEM, SM_SMEM_BYTES, SMEM_BYTES


def _bn_prelu(h, mean, inv, gamma, beta, slope):
    """(xhat, hn, prelu(hn)) of ``h [B, K, C, T]``: each product and sum
    rounded on its own, the order the kernels keep."""
    xh = (h - mean[:, None]) * inv[:, None]
    hn = xh * gamma[:, None] + beta[:, None]
    return xh, hn, torch.where(hn < 0, slope * hn, hn)


def tail_bwd_reference(dh2a, h2, m2, v2, g2, be2, a2, eps: float):
    """Phase A in plain PyTorch (``cruse_tpu/ops/tfcm_train.py:340-351``)."""
    xh, hn, _ = _bn_prelu(h2, m2, torch.rsqrt(v2 + eps), g2, be2, a2)
    neg = hn < 0
    dh2n = torch.where(neg, a2 * dh2a, dh2a)
    da2 = torch.where(neg, dh2a * hn, torch.zeros_like(hn)).sum()
    return dh2n, (dh2n * xh).sum(dim=(0, 1, 3)), dh2n.sum(dim=(0, 1, 3)), da2


def mid_bwd_reference(dh2, h1, wd, m1, v1, g1, be1, a1, d: int, eps: float):
    """Phase B in plain PyTorch (``cruse_tpu/ops/tfcm_train.py:362-394``)."""
    k, t = h1.shape[1], h1.shape[-1]
    gp = F.pad(dh2, (2 * d, 2 * d, 0, 0, 1, 1))
    xh, hn, h1a = _bn_prelu(h1, m1, torch.rsqrt(v1 + eps), g1, be1, a1)
    xp = F.pad(h1a, (2 * d, 0, 0, 0, 1, 1))  # true zeros before t = 0 and past the edge bands
    dxe, taps = None, []
    for it in range(3):
        for jf in range(3):
            term = gp[:, jf : jf + k, :, it * d : it * d + t + 2 * d] * wd[2 - it, 2 - jf][:, None]
            dxe = term if dxe is None else dxe + term
            taps.append((xp[:, jf : jf + k, :, it * d : it * d + t] * dh2).sum(dim=(0, 1, 3)))
    dh1a = dxe[..., 2 * d :]
    neg = hn < 0
    dh1n = torch.where(neg, a1 * dh1a, dh1a)
    da1 = torch.where(neg, dh1a * hn, torch.zeros_like(hn)).sum()
    return (dh1n, torch.stack(taps).reshape(3, 3, -1), (dh1n * xh).sum(dim=(0, 1, 3)),
            dh1n.sum(dim=(0, 1, 3)), da1, dh2.sum(dim=(0, 1, 3)))


MID_SUMS = 13  # a tile's sums: 9 taps (it * 3 + jf), dgamma1, dbeta1, da1, dbd
MID_BANDS = (8, 4, 2, 1)  # band groups mid_plan tries, the largest first (kMaxBands = 8 in the source)
MIN_BLOCKS_PER_SM = 4  # the tiles are chosen for


class MidPlan(NamedTuple):
    kb: int  # bands of a tile
    tt: int  # frames of a tile
    tiles: int  # tiles a channel: B x ceil(K / kb) x ceil(T / tt)
    smem: int  # shared memory of one tile block, bytes


def mid_smem_bytes(kb: int, tt: int, t: int, d: int) -> int:
    """Shared memory of one tile block (``mid_smem_bytes`` in the source): dh2
    of kb + 2 bands over ``min(tt + 2d, T)`` frames, h1 of kb bands over tt."""
    return 4 * ((kb + 2) * min(tt + 2 * d, t) + kb * tt)


@functools.lru_cache(maxsize=None)
def mid_plan(b: int, k: int, c: int, t: int, d: int, kb: int | None = None,
             tt: int | None = None) -> MidPlan:
    """The tile of ``mid_tile_kernel`` for dh2, h1 ``[b, k, c, t]`` at dilation
    d: the whole of T (tt = T) and the largest band group of ``MID_BANDS`` (at
    most K) at which MIN_BLOCKS_PER_SM blocks fit an SM's shared memory, so
    that a band's halo is read as seldom as that allows; where no group does at
    tt = T, tt shrinks by 32 frames at a time, and where nothing fits, one block
    an SM takes all its shared memory. ``kb`` (at most 8) / ``tt`` fix a side."""
    if kb is not None and not 1 <= kb <= min(k, MID_BANDS[0]):
        raise ValueError(f"a mid_bwd tile takes 1 to {min(k, MID_BANDS[0])} bands at K={k}, got {kb}")
    if tt is not None and not 1 <= tt <= t:
        raise ValueError(f"a mid_bwd tile takes 1 to {t} frames at T={t}, got {tt}")
    budget = SM_SMEM_BYTES // MIN_BLOCKS_PER_SM - BLOCK_RESERVED_SMEM
    kbs = [kb] if kb else sorted({min(g, k) for g in MID_BANDS}, reverse=True)
    tts = [tt] if tt else [t] + list(range((t - 1) // 32 * 32, 0, -32))
    for limit in (budget, SMEM_BYTES):
        for frames in tts:
            for bands in kbs:
                smem = mid_smem_bytes(bands, frames, t, d)
                if smem <= limit:
                    return MidPlan(bands, frames, b * -(-k // bands) * -(-t // frames), smem)
    raise ValueError(f"no mid_bwd tile fits {SMEM_BYTES} bytes of shared memory at K={k}, T={t}, "
                     f"d={d} (kb={kb}, tt={tt})")


def mid_partials_reference(dh2, h1, wd, m1, v1, g1, be1, a1, d: int, eps: float, plan: MidPlan):
    """The plain version of ``mid_tile_kernel``'s sums: ``part [C, 13, tiles]``,
    each tile's 9 tap sums, dgamma1, dbeta1, da1 and dbd in float32, taken as
    the kernel takes them, over the tile's own points (k, t) with the dh2
    neighbours ``dh2[k + 1 - jf, t + (2 - it) d]`` (zero outside the tensor)."""
    b, k, c, t = h1.shape
    kb, tt = plan.kb, plan.tt
    gp = F.pad(dh2, (0, 2 * d, 0, 0, 1, 1))  # zeros past the last frame and the edge bands
    xh, hn, ha = _bn_prelu(h1, m1, torch.rsqrt(v1 + eps), g1, be1, a1)
    dh1a = torch.zeros_like(h1)
    terms = []
    for it in range(3):
        for jf in range(3):
            nb = gp[:, 2 - jf : 2 - jf + k, :, (2 - it) * d : (2 - it) * d + t]
            dh1a = dh1a + wd[it, jf][:, None] * nb
            terms.append(ha * nb)
    neg = hn < 0
    dh1n = torch.where(neg, a1 * dh1a, dh1a)
    terms += [dh1n * xh, dh1n, torch.where(neg, dh1a * hn, torch.zeros_like(hn)), dh2]
    nk, nt = -(-k // kb), -(-t // tt)
    pad = (0, nt * tt - t, 0, 0, 0, nk * kb - k)
    tiled = [F.pad(term, pad).reshape(b, nk, kb, c, nt, tt).sum(dim=(2, 5)) for term in terms]
    return torch.stack(tiled).permute(3, 0, 1, 2, 4).reshape(c, MID_SUMS, plan.tiles)


def mid_finish_reference(part):
    """The plain version of ``mid_finish_kernel``: ``part [C, 13, tiles]`` ->
    ``(dwd [3, 3, C], dgamma1, dbeta1, da1 [], dbd)``, each channel's tiles
    added in float64, da1 over all channels too."""
    sums = part.sum(dim=2, dtype=torch.float64)
    return (sums[:, :9].t().reshape(3, 3, -1).float(), sums[:, 9].float(), sums[:, 10].float(),
            sums[:, 11].sum().float(), sums[:, 12].float())


def _check(what, grad, h, per_channel, slope, wd=None, d=None):
    if h.dim() != 4 or h.dtype != torch.float32 or min(h.shape) < 1:
        raise ValueError(f"{what}: the activation must be float32 [B, K, C, T] with every "
                         f"extent >= 1, got {h.dtype} {tuple(h.shape)}")
    c = h.shape[2]
    if grad.shape != h.shape or grad.dtype != torch.float32:
        raise ValueError(f"{what}: the gradient must be float32 {tuple(h.shape)}, "
                         f"got {grad.dtype} {tuple(grad.shape)}")
    for name, tensor in per_channel.items():
        if tuple(tensor.shape) != (c,) or tensor.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 [{c}], got {tensor.dtype} "
                             f"{tuple(tensor.shape)}")
    if slope.numel() != 1 or slope.dtype != torch.float32:
        raise ValueError(f"{what}: the PReLU slope must be one float32 value, got "
                         f"{slope.dtype} {tuple(slope.shape)}")
    if wd is not None and (tuple(wd.shape) != (3, 3, c) or wd.dtype != torch.float32):
        raise ValueError(f"{what}: wd must be float32 {(3, 3, c)}, got {wd.dtype} {tuple(wd.shape)}")
    if d is not None and (not isinstance(d, int) or d < 1):
        raise ValueError(f"{what}: d must be a positive int, got {d!r}")
    for name, tensor in (("the gradient", grad), ("the slope", slope), ("wd", wd),
                         *per_channel.items()):
        if tensor is not None and tensor.device != h.device:
            raise ValueError(f"{what}: {name} is on {tensor.device}, the activation on {h.device}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {h.device}")


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load_library("tfcm_bwd")
    tail, mid, info = lib.tfcm_tail_bwd_f32, lib.tfcm_mid_bwd_f32, lib.tfcm_mid_tile_info
    tail.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    mid.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    tail.restype = mid.restype = info.restype = ctypes.c_int
    return tail, mid, info


def mid_kernel_info(smem_bytes: int) -> dict:
    """``mid_tile_kernel`` on the current CUDA device: registers and local
    (spill) bytes a thread, blocks an SM at ``smem_bytes`` of shared memory,
    threads a block."""
    info = (ctypes.c_int * 4)()
    err = _kernels()[2](smem_bytes, info)
    if err != 0:
        raise RuntimeError(f"tfcm_mid_tile_info failed with CUDA error {err} ({smem_bytes} B)")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "threads"), info))


def _row_sums(part: torch.Tensor, columns: int) -> torch.Tensor:
    """part [B * K, C, columns + unused] of per-row f32 sums -> [columns, C]."""
    return part[..., :columns].sum(dim=0, dtype=torch.float64).float().t()


def tail_bwd(dh2a, h2, m2, v2, g2, be2, a2, eps: float):
    """Phase A of the TFCM backward (see the module doc)."""
    _check("tail_bwd", dh2a, h2, {"m2": m2, "v2": v2, "g2": g2, "be2": be2}, a2)
    if h2.device.type == "cpu":
        return tail_bwd_reference(dh2a, h2, m2, v2, g2, be2, a2, eps)
    _need_contiguous(dh2a=dh2a, h2=h2)
    b, k, c, t = h2.shape
    stats = torch.stack([m2, torch.rsqrt(v2 + eps), g2, be2])
    dh2n = torch.empty_like(h2)
    part = torch.empty((b * k, c, 4), dtype=torch.float32, device=h2.device)
    stream = torch.cuda.current_stream(h2.device).cuda_stream
    with torch.cuda.device(h2.device):
        err = _kernels()[0](dh2a.data_ptr(), h2.data_ptr(), stats.data_ptr(), a2.data_ptr(),
                            dh2n.data_ptr(), part.data_ptr(), b, k, c, t, stream)
    if err != 0:
        raise RuntimeError(f"tail_bwd kernel launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t})")
    tail_bwd.launches += 1
    sums = _row_sums(part, 3)
    return dh2n, sums[0], sums[1], sums[2].sum()


def mid_bwd(dh2, h1, wd, m1, v1, g1, be1, a1, d: int, eps: float):
    """Phase B of the TFCM backward (see the module doc)."""
    _check("mid_bwd", dh2, h1, {"m1": m1, "v1": v1, "g1": g1, "be1": be1}, a1, wd, d)
    if h1.device.type == "cpu":
        return mid_bwd_reference(dh2, h1, wd, m1, v1, g1, be1, a1, d, eps)
    b, k, c, t = h1.shape
    plan = mid_plan(b, k, c, t, d)
    dh1n, part, out = mid_buffers(h1, plan)
    launch_mid(dh2, h1, wd, m1, v1, g1, be1, a1, d, eps, plan, dh1n, part, out)
    return (dh1n, *mid_sums(out, c))


def mid_buffers(h1, plan: MidPlan):
    """Uninitialised ``(dh1n, part [C, 13, tiles], out [12 C + 1])`` for ``launch_mid``."""
    c = h1.shape[2]
    return (torch.empty_like(h1), h1.new_empty((c, MID_SUMS, plan.tiles)), h1.new_empty(12 * c + 1))


def mid_sums(out, c: int):
    """``out [12 C + 1]`` -> views ``(dwd [3, 3, C], dgamma1, dbeta1, da1 [], dbd)``."""
    return (out[: 9 * c].view(3, 3, c), out[9 * c : 10 * c], out[10 * c : 11 * c], out[12 * c],
            out[11 * c : 12 * c])


def launch_mid(dh2, h1, wd, m1, v1, g1, be1, a1, d: int, eps: float, plan: MidPlan, dh1n, part, out):
    """The two kernels of ``mid_bwd`` on CUDA tensors at a given tile, into
    ``mid_buffers``; counted in ``mid_bwd.launches``."""
    _need_contiguous(dh2=dh2, h1=h1, wd=wd, m1=m1, v1=v1, g1=g1, be1=be1, dh1n=dh1n, part=part, out=out)
    b, k, c, t = h1.shape
    stream = torch.cuda.current_stream(h1.device).cuda_stream
    with torch.cuda.device(h1.device):
        err = _kernels()[1](dh2.data_ptr(), h1.data_ptr(), wd.data_ptr(), m1.data_ptr(), v1.data_ptr(),
                            g1.data_ptr(), be1.data_ptr(), a1.data_ptr(), eps, dh1n.data_ptr(),
                            part.data_ptr(), out.data_ptr(), b, k, c, t, d, plan.kb, plan.tt, stream)
    if err != 0:
        raise RuntimeError(f"mid_bwd kernel launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t}, d={d}, plan {plan})")
    mid_bwd.launches += 1


tail_bwd.launches = 0
mid_bwd.launches = 0
