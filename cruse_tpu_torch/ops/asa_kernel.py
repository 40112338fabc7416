"""Temporal attention of MTFAA's ASA, forward: the CUDA kernel's wrapper and
its plain version.

Counterpart of ``cruse_tpu/ops/asa_kernel.py::flash_tattn_tm`` (forward) and
``xla_tattn_tm``. T-minor: q, k ``[BF, c, T]``, v ``[BF, C, T]`` float32 ->
out ``[BF, C, T]``::

    out[:, t] = sum_s softmax_s(q[:, t] . k[:, s] / sqrt(c)) v[:, s]

over the keys query t sees: ``t - window < s <= t`` when causal with a
window, ``s <= t`` when causal without one, and every key when
``causal=False`` (the window is then unused). The reference's flash path is
causal whatever it is given; this one is not.

``flash_tattn_tm`` runs the plain version for tensors on the CPU and launches
the hand-written kernel (``csrc/tattn.cu``, flash-style: no T x T tensor) for
tensors on a CUDA device; on a CUDA device it launches or raises.
``flash_tattn_tm.launches`` counts kernel launches. The kernel has no
backward (training comes with the MTFAA training slice): it raises when a
gradient is requested.
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


def tattn_reference(q, k, v, window: Optional[int] = None, causal: bool = True):
    """The plain PyTorch attention: the full [BF, T, T] logits, masked,
    softmax over the keys (``cruse_tpu/models/mtfaa.py``'s einsum path)."""
    c, t = q.shape[1], q.shape[2]
    logits = torch.einsum("bct,bcs->bts", q, k) * (1.0 / math.sqrt(c))
    if causal:
        ti = torch.arange(t, device=q.device)
        mask = ti[:, None] >= ti[None, :]
        if window is not None:
            mask = mask & (ti[None, :] > ti[:, None] - window)
        logits = logits.masked_fill(~mask, -1e9)
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


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("tattn").tattn_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, window, causal):
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("the CUDA attention kernel has no backward; "
                           "run it under torch.no_grad() or torch.inference_mode()")
    bf, c, t = q.shape
    cv = v.shape[1]
    if c > MAX_QK_CHANNELS or cv > MAX_V_CHANNELS:
        raise ValueError(f"the attention kernel takes c <= {MAX_QK_CHANNELS} and "
                         f"C <= {MAX_V_CHANNELS}, got c={c}, C={cv}")
    if bf > 65535:
        raise ValueError(f"BF={bf} > 65535, the kernel's grid limit")
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bf, c, cv, t,
                        0 if window is None else int(window), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"tattn kernel launch failed with CUDA error {err} "
                           f"(BF={bf}, c={c}, C={cv}, T={t}, window={window}, causal={causal})")
    flash_tattn_tm.launches += 1
    return out


def flash_tattn_tm(q, k, v, window: Optional[int] = None, causal: bool = True):
    """Temporal attention, T-minor (see the module doc)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return tattn_reference(q, k, v, window, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, window, causal)
    raise ValueError(f"flash_tattn_tm runs on cpu or cuda tensors, got {q.device}")


flash_tattn_tm.launches = 0
