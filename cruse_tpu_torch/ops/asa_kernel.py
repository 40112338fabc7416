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
gradient to compute it is one launch of the forward kernel
(``csrc/tattn.cu``, flash-style: no T x T tensor). With one, the forward also
writes each query's logsumexp ``[BF, T]``, and the backward computes
``D = sum_C dO * O`` in PyTorch and launches ``tattn_dq`` and ``tattn_dkv``
(``csrc/tattn_bwd.cu``), which recompute the probabilities from the
logsumexp; the scale 1/sqrt(c) is applied once to dq and dk inside them. The
backward is causal only: ``causal=False`` under a gradient raises.
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


@functools.lru_cache(maxsize=None)
def _kernels():
    fwd = _build.load_library("tattn").tattn_fwd_f32
    bwd = _build.load_library("tattn_bwd")
    dq, dkv = bwd.tattn_dq_f32, bwd.tattn_dkv_f32
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = dq.restype = dkv.restype = ctypes.c_int
    return fwd, dq, dkv


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
    _check_launch("tattn_dq", q=q, k=k, v=v, dout=dout, lse=lse, dd=dd)
    bf, c, t = q.shape
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), bf, c, v.shape[1], t,
                            0 if window is None else int(window), stream)
    _raise_on(err, "tattn_dq", q, v, window)
    tattn_dq.launches += 1
    return dq


def tattn_dkv(q, k, v, dout, lse, dd, window: Optional[int] = None):
    """``(dk [BF, c, T], dv [BF, C, T])`` of the causal attention; arguments
    as ``tattn_dq``."""
    _check_bwd(q, k, v, dout, lse, dd, window)
    if q.device.type == "cpu":
        return tattn_bwd_reference(q, k, v, dout, window)[1:]
    _check_launch("tattn_dkv", q=q, k=k, v=v, dout=dout, lse=lse, dd=dd)
    bf, c, t = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernels()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), bf, c,
                            v.shape[1], t, 0 if window is None else int(window), stream)
    _raise_on(err, "tattn_dkv", q, v, window)
    tattn_dkv.launches += 1
    return dk, dv


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


def flash_tattn_tm(q, k, v, window: Optional[int] = None, causal: bool = True):
    """Temporal attention, T-minor, differentiable when causal (see the module doc)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return tattn_reference(q, k, v, window, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_tattn_tm runs on cpu or cuda tensors, got {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if not causal:
            raise NotImplementedError("the non-causal attention kernel has no backward (the "
                                      "models train causally); run it without a gradient")
        return _FlashTattn.apply(q, k, v, window)
    return _launch_fwd(q, k, v, window, causal, with_lse=False)[0]


flash_tattn_tm.launches = 0
tattn_dq.launches = 0
tattn_dkv.launches = 0
