"""Grouped-GRU recurrence: the CUDA kernel's wrapper and its plain version.

Counterpart of ``cruse_tpu/ops/gru_kernel.py::gru_sequence_pallas``, with its
signature and layouts: ``x_proj [B, T, G, 3H]`` (input projection already
applied), ``h0 [B, G, H]``, ``w_hh [G, 3H, H]``, ``b_hh [G, 3H]``; returns
``(y [B, T, G, H], h_last [B, G, H])`` in float32, torch gate order (r, z, n).

``gru_sequence`` runs the plain version for tensors on the CPU and launches
the hand-written kernel (``csrc/gru_sequence.cu``, one launch for all T
steps) for tensors on a CUDA device; on a CUDA device it launches or raises.
``gru_sequence.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from cruse_tpu_torch.ops import _build

MAX_HIDDEN = 512  # one thread per hidden unit (kMaxThreads in the source)
_WEIGHT_DTYPES = {None: "gru_sequence_f32", torch.float32: "gru_sequence_f32",
                  torch.bfloat16: "gru_sequence_bf16w"}


def gru_sequence_reference(x_proj, h0, w_hh, b_hh, weight_dtype=None):
    """The plain PyTorch recurrence: a Python loop over t.

    With ``weight_dtype=torch.bfloat16`` the recurrent weights and, each step,
    the state are rounded to bf16 before the product, which is then taken in
    float32 (a bf16 x bf16 product is exact in float32): the kernel's math.
    """
    hdim = h0.shape[-1]
    w = w_hh if weight_dtype is None else w_hh.to(weight_dtype).float()
    h = h0
    ys = []
    for t in range(x_proj.shape[1]):
        hq = h if weight_dtype is None else h.to(weight_dtype).float()
        hp = torch.einsum("bgh,gkh->bgk", hq, w) + b_hh
        xr, xz, xn = x_proj[:, t].split(hdim, dim=-1)
        hr, hz, hn = hp.split(hdim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _check_shapes(x_proj, h0, w_hh, b_hh, weight_dtype):
    if weight_dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be None, torch.float32 or torch.bfloat16, "
                         f"got {weight_dtype}")
    if x_proj.dim() != 4:
        raise ValueError(f"x_proj must be [B, T, G, 3H], got {tuple(x_proj.shape)}")
    b, t, g, h3 = x_proj.shape
    h = h3 // 3
    expected = {"h0": (b, g, h), "w_hh": (g, h3, h), "b_hh": (g, h3)}
    for name, tensor in (("h0", h0), ("w_hh", w_hh), ("b_hh", b_hh)):
        if tuple(tensor.shape) != expected[name]:
            raise ValueError(f"{name} must be {expected[name]} for x_proj "
                             f"{tuple(x_proj.shape)}, got {tuple(tensor.shape)}")
    if h3 % 3 or b < 1 or t < 1:
        raise ValueError(f"x_proj {tuple(x_proj.shape)}: need B, T >= 1 and 3H gates")


@functools.lru_cache(maxsize=None)
def _kernels() -> dict:
    """Build and load the library once and declare its entries' prototypes."""
    lib = _build.load_library("gru_sequence")
    kernels = {}
    for name in set(_WEIGHT_DTYPES.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kernels[name] = fn
    return kernels


def transposed_weight(w_hh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w_hh [G, 3H, H]`` as the kernel reads it, ``[G, H, 3H]`` in ``dtype``.

    The copy is kept on the weight tensor itself and made again only when
    the tensor's storage (``data_ptr``), its version counter (bumped by every
    in-place write, ``load_state_dict`` included) or the dtype changes, so a
    streaming step (T = 1) does not re-transpose the same weight on every
    hop. Inference tensors have no version counter and are not cached.
    """
    if w_hh.is_inference():
        return w_hh.transpose(1, 2).contiguous().to(dtype)
    key = (w_hh.data_ptr(), w_hh._version, dtype)
    cached = getattr(w_hh, "_gru_transposed", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, w_hh.transpose(1, 2).contiguous().to(dtype))
        w_hh._gru_transposed = cached
    return cached[1]


def _launch(x_proj, h0, w_hh, b_hh, weight_dtype):
    tensors = {"x_proj": x_proj, "h0": h0, "w_hh": w_hh, "b_hh": b_hh}
    device = x_proj.device
    for name, tensor in tensors.items():
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, x_proj on {device}")
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError("the CUDA gru_sequence kernel has no backward; "
                           "run it under torch.no_grad() or torch.inference_mode()")
    b, t, g, h3 = x_proj.shape
    h = h3 // 3
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden size per group {h} > {MAX_HIDDEN}, the kernel's limit")

    fn = _kernels()[_WEIGHT_DTYPES[weight_dtype]]
    w_t = transposed_weight(w_hh, weight_dtype or torch.float32)
    y = torch.empty((b, t, g, h), dtype=torch.float32, device=device)
    h_last = torch.empty((b, g, h), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(x_proj.data_ptr(), h0.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), b, t, g, h, stream)
    if err != 0:
        raise RuntimeError(f"gru_sequence kernel launch failed with CUDA error {err} "
                           f"(B={b}, T={t}, G={g}, H={h})")
    gru_sequence.launches += 1
    return y, h_last


def gru_sequence(x_proj, h0, w_hh, b_hh, weight_dtype=None):
    """Grouped GRU recurrence over the whole sequence (see the module doc).

    ``weight_dtype=torch.bfloat16`` holds the recurrent weights in bf16 with
    float32 accumulation, like ``gru_sequence_pallas(weight_dtype=bf16)``.
    """
    _check_shapes(x_proj, h0, w_hh, b_hh, weight_dtype)
    if x_proj.device.type == "cpu":
        return gru_sequence_reference(x_proj, h0, w_hh, b_hh, weight_dtype)
    if x_proj.device.type == "cuda":
        return _launch(x_proj, h0, w_hh, b_hh, weight_dtype)
    raise ValueError(f"gru_sequence runs on cpu or cuda tensors, got {x_proj.device}")


gru_sequence.launches = 0
