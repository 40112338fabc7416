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
its launches (``.launches``). Neither pads anything: the kernels bound their
indices. The tap sums are f32 partial sums per row (b, k, c), added per
channel afterwards in float64, so they do not vary from run to run.
``dw_causal_tm`` is the differentiable function built from the two.
"""
from __future__ import annotations

import ctypes
import functools

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


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load_library("dw_stencil")
    fwd, bwd = lib.dw_stencil_fwd_f32, lib.dw_stencil_bwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


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
    _need_contiguous(x_ext=x_ext, wd=wd)
    b, k, c, t_ext = x_ext.shape
    t = t_ext - 2 * d
    y = torch.empty((b, k, c, t), dtype=torch.float32, device=x_ext.device)
    stream = torch.cuda.current_stream(x_ext.device).cuda_stream
    with torch.cuda.device(x_ext.device):
        err = _kernels()[0](x_ext.data_ptr(), wd.data_ptr(), y.data_ptr(), b, k, c, t, d, stream)
    if err != 0:
        raise RuntimeError(f"dw_stencil forward launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t}, d={d})")
    dw_stencil_fwd.launches += 1
    return y


def dw_stencil_bwd(g: torch.Tensor, x_ext: torch.Tensor, wd: torch.Tensor, d: int):
    """The stencil's backward alone: ``(dx [B, K, C, T + 2d], dwd [3, 3, C])``
    from the gradient ``g [B, K, C, T]`` of its output."""
    _check(x_ext, wd, d, g)
    if x_ext.device.type == "cpu":
        return dw_bwd_reference(g, x_ext, wd, d)
    if x_ext.device.type != "cuda":
        raise ValueError(f"dw_stencil_bwd runs on cpu or cuda tensors, got {x_ext.device}")
    _need_contiguous(g=g, x_ext=x_ext, wd=wd)
    b, k, c, t_ext = x_ext.shape
    dx = torch.empty_like(x_ext)
    part = torch.empty((b * k, c, 9), dtype=torch.float32, device=x_ext.device)
    stream = torch.cuda.current_stream(x_ext.device).cuda_stream
    with torch.cuda.device(x_ext.device):
        err = _kernels()[1](g.data_ptr(), x_ext.data_ptr(), wd.data_ptr(), dx.data_ptr(),
                            part.data_ptr(), b, k, c, t_ext - 2 * d, d, stream)
    if err != 0:
        raise RuntimeError(f"dw_stencil backward launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t_ext - 2 * d}, d={d})")
    dw_stencil_bwd.launches += 1
    dwd = part.sum(dim=0, dtype=torch.float64).float()  # [C, 9]
    return dx, dwd.t().reshape(3, 3, c)


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
