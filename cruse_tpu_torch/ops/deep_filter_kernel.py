"""Complex multi-frame deep filter: the CUDA kernel's wrapper and its plain version.

Counterpart of ``cruse_tpu/ops/deep_filter_kernel.py::deep_filter_pallas``
(and of the shift-MAC ``cruse_tpu/models/deep_filter.py::deep_filter_apply``
it is held to). For each time-frequency bin, with the taps in
``tap_offsets`` order::

    out[t, f] = sum_k coef[t, f, k] * spec[t - dt_k, f - df_k]     (complex)

and zero fill outside the spectrum. One generalisation serves streaming: an
optional ``history [B, 2*t_dim, F]`` of the frames before the first, oldest
first, which a causal read at ``t - dt < 0`` takes instead of zero.

Layouts (the model's own, so nothing is transposed on entry): ``spec``
complex64 ``[B, T, F]`` whose bins are contiguous (rows may be strided, as
the low-bin slice of a wider spectrum is); ``coefs`` float32
``[B, T, F, K, 2]`` (re, im last), contiguous; ``history`` complex64 with
contiguous frames and bins (the batch may be strided); the result is
complex64 ``[B, T, F]``.

``deep_filter`` runs the plain version for tensors on the CPU and launches the
hand-written kernel (``csrc/deep_filter.cu``) for tensors on a CUDA device;
on a CUDA device it launches or raises. ``deep_filter.launches`` counts
kernel launches. The kernel has no backward: it raises when a gradient is
requested.
"""
from __future__ import annotations

import ctypes
import functools

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


def _check(spec, coefs, t_dim, f_dim, causal, history):
    if t_dim < 0 or f_dim < 0:
        raise ValueError(f"t_dim and f_dim must be >= 0, got {t_dim}, {f_dim}")
    if spec.dim() != 3 or spec.dtype != torch.complex64:
        raise ValueError(f"spec must be complex64 [B, T, F], got {spec.dtype} {tuple(spec.shape)}")
    b, t, f = spec.shape
    if min(b, t, f) < 1:
        raise ValueError(f"spec {tuple(spec.shape)}: need B, T, F >= 1")
    k = (2 * t_dim + 1) * (2 * f_dim + 1)
    if tuple(coefs.shape) != (b, t, f, k, 2) or coefs.dtype != torch.float32:
        raise ValueError(f"coefs must be float32 {(b, t, f, k, 2)} for spec {tuple(spec.shape)} "
                         f"and {k} taps, got {coefs.dtype} {tuple(coefs.shape)}")
    if history is not None:
        if not causal:
            raise ValueError("a history of past frames needs the causal tap layout")
        if tuple(history.shape) != (b, 2 * t_dim, f) or history.dtype != torch.complex64:
            raise ValueError(f"history must be complex64 {(b, 2 * t_dim, f)}, "
                             f"got {history.dtype} {tuple(history.shape)}")
    for name, tensor in (("coefs", coefs), ("history", history)):
        if tensor is not None and tensor.device != spec.device:
            raise ValueError(f"{name} is on {tensor.device}, spec on {spec.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("deep_filter").deep_filter_f32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(spec, coefs, t_dim, f_dim, causal, history):
    if spec.stride(-1) != 1:
        raise ValueError(f"spec bins must be contiguous, strides {spec.stride()}")
    if history is not None and history.stride()[1:] != (history.shape[2], 1):
        raise ValueError(f"history frames and bins must be contiguous, strides {history.stride()}")
    if not coefs.is_contiguous():
        raise ValueError("coefs must be contiguous")
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (spec, coefs, history)):
        raise RuntimeError("the CUDA deep_filter kernel has no backward; "
                           "run it under torch.no_grad() or torch.inference_mode()")
    b, t, f = spec.shape
    if b > 65535:
        raise ValueError(f"batch {b} > 65535, the kernel's grid limit")
    out = torch.empty((b, t, f), dtype=torch.complex64, device=spec.device)
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    with torch.cuda.device(spec.device):
        err = _kernel()(spec.data_ptr(), spec.stride(0), spec.stride(1),
                        None if history is None else history.data_ptr(),
                        0 if history is None else history.stride(0),
                        coefs.data_ptr(), out.data_ptr(), b, t, f, t_dim, f_dim, int(causal),
                        stream)
    if err != 0:
        raise RuntimeError(f"deep_filter kernel launch failed with CUDA error {err} "
                           f"(B={b}, T={t}, F={f}, t_dim={t_dim}, f_dim={f_dim})")
    deep_filter.launches += 1
    return out


def deep_filter(spec, coefs, t_dim: int, f_dim: int, causal: bool = True, history=None):
    """Apply per-bin complex multi-frame filters (see the module doc)."""
    if history is not None and history.shape[1] == 0:
        history = None  # t_dim == 0: no past frame is ever read
    _check(spec, coefs, t_dim, f_dim, causal, history)
    if spec.device.type == "cpu":
        return deep_filter_reference(spec, coefs, t_dim, f_dim, causal, history)
    if spec.device.type == "cuda":
        return _launch(spec, coefs, t_dim, f_dim, causal, history)
    raise ValueError(f"deep_filter runs on cpu or cuda tensors, got {spec.device}")


deep_filter.launches = 0
