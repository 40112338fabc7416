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
CUDA device they launch or raise. Each counts its launches (``.launches``).
The sums are f32 partial sums per row (b, k, c), added per channel afterwards
in float64, so they do not vary from run to run. The PReLU slopes are read on
the device (0-d tensors): nothing here waits for the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.dw_kernel import _need_contiguous


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
    tail, mid = lib.tfcm_tail_bwd_f32, lib.tfcm_mid_bwd_f32
    tail.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    mid.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    tail.restype = mid.restype = ctypes.c_int
    return tail, mid


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
    _need_contiguous(dh2=dh2, h1=h1, wd=wd)
    b, k, c, t = h1.shape
    stats = torch.stack([m1, torch.rsqrt(v1 + eps), g1, be1])
    dh1n = torch.empty_like(h1)
    part = torch.empty((b * k, c, 16), dtype=torch.float32, device=h1.device)
    stream = torch.cuda.current_stream(h1.device).cuda_stream
    with torch.cuda.device(h1.device):
        err = _kernels()[1](dh2.data_ptr(), h1.data_ptr(), wd.data_ptr(), stats.data_ptr(),
                            a1.data_ptr(), dh1n.data_ptr(), part.data_ptr(), b, k, c, t, d, stream)
    if err != 0:
        raise RuntimeError(f"mid_bwd kernel launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t}, d={d})")
    mid_bwd.launches += 1
    sums = _row_sums(part, 13)
    return dh1n, sums[:9].reshape(3, 3, c), sums[9], sums[10], sums[11].sum(), sums[12]


tail_bwd.launches = 0
mid_bwd.launches = 0
