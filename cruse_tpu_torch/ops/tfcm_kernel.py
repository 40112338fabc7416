"""Eval-mode TFCM stack: the CUDA kernel's wrappers and their plain version.

Counterpart of ``cruse_tpu/ops/tfcm_kernel.py`` (``fused_tfcm_block_eval``,
``fused_tfcm_stack_eval``). One eval TFCM block, with both BatchNorms folded
into the neighbouring convs, is::

    p1 = prelu(x @ w1' + b1', a1)                  1x1 conv, BN1 folded
    p2 = prelu(dw(p1) + bd', a2)                   (3,3) depthwise, BN2 folded
    y  = p2 @ w2 + b2 + x                          1x1 conv + residual

where ``dw`` is causal and dilated by ``d`` in time (taps at t - 2d, t - d,
t in the order ``wd[0..2]``) and symmetric over one band in frequency. Before
t = 0 and past the edge bands it reads ZERO p1 (the reference pads p1, not x).
A stack runs the blocks with dilations ``(1, 2, 4, ...)`` one after another.

Layouts are the model's T-minor ones: x and the result ``[B, K, C, T]``
float32. The parameters arrive as one ``[L, P]`` float32 tensor from
``fold_eval_params`` (P = 2C^2 + 12C + 2 per layer: w1' [C, C] as
[in, out], b1' [C], wd' [3, 3, C], bd' [C], w2 [C, C], b2 [C], a1, a2).

``fused_tfcm_stack_eval`` and ``fused_tfcm_block_eval`` (the one-layer case
of the same kernel) run the plain version for tensors on the CPU and launch
the hand-written kernel (``csrc/tfcm_eval.cu``) for tensors on a CUDA device;
on a CUDA device they launch or raise. ``<fn>.launches`` counts kernel
launches. The kernel has no backward: it raises when a gradient is requested.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cruse_tpu_torch.ops import _build

KERNEL_CHANNELS = (4, 8, 12, 16, 24, 32, 48)  # the kernel's template instances
MAX_LAYERS = 8  # kMaxLayers in the source
SMEM_BYTES = 227 * 1024  # a Hopper block's shared memory (kMaxSmem in the source)
PARAM_KEYS = ("w1", "b1", "g1", "be1", "m1", "v1", "a1", "wd", "bd",
              "g2", "be2", "m2", "v2", "a2", "w2", "b2")


def params_per_layer(c: int) -> int:
    return 2 * c * c + 12 * c + 2


def fold_eval_params(block_params, eps: float = 1e-5) -> torch.Tensor:
    """Per-block parameter dicts (``PARAM_KEYS``: the block's weights, its
    BatchNorms' scale, bias, running mean and variance, its PReLU slopes) ->
    the ``[L, P]`` float32 tensor of folded parameters the kernel reads.

    The folding is ``cruse_tpu/ops/tfcm_kernel.py::_fold_eval_params``:
    ``s = g * rsqrt(v + eps)``, ``w1' = w1 * s1`` column-wise,
    ``b1' = (b1 - m1) * s1 + be1``, ``wd' = wd * s2``, ``bd' = (bd - m2) * s2 + be2``."""
    rows = []
    for p in block_params:
        f = {key: torch.as_tensor(p[key]).float() for key in PARAM_KEYS}
        s1 = f["g1"] * torch.rsqrt(f["v1"] + eps)
        s2 = f["g2"] * torch.rsqrt(f["v2"] + eps)
        rows.append(torch.cat([
            (f["w1"] * s1).reshape(-1), (f["b1"] - f["m1"]) * s1 + f["be1"],
            (f["wd"] * s2).reshape(-1), (f["bd"] - f["m2"]) * s2 + f["be2"],
            f["w2"].reshape(-1), f["b2"], f["a1"].reshape(1), f["a2"].reshape(1)]))
    return torch.stack(rows)


def _unfold_layer(row: torch.Tensor, c: int):
    """One row of ``fold_eval_params`` -> (w1, b1, wd, bd, w2, b2, a1, a2) views."""
    sizes = (c * c, c, 9 * c, c, c * c, c, 1, 1)
    w1, b1, wd, bd, w2, b2, a1, a2 = row.split(sizes)
    return w1.view(c, c), b1, wd.view(3, 3, c), bd, w2.view(c, c), b2, a1[0], a2[0]


def tfcm_stack_reference(x: torch.Tensor, params: torch.Tensor, dilations) -> torch.Tensor:
    """The plain PyTorch stack: ``TFCMBlock``'s eval math with the folded
    parameters, the depthwise conv as 9 shifted multiply-adds over p1
    zero-padded by 2d frames before t = 0 and one band at each edge."""
    _, k, c, t = x.shape
    for row, d in zip(params, dilations):
        w1, b1, wd, bd, w2, b2, a1, a2 = _unfold_layer(row, c)
        h1 = torch.matmul(w1.t(), x) + b1[:, None]  # 1x1 conv, [C, C] as [in, out]
        p1 = F.pad(torch.where(h1 >= 0, h1, a1 * h1), (2 * d, 0, 0, 0, 1, 1))
        z = bd[:, None]
        for it in range(3):  # causal time taps at offsets -2d, -d, 0
            for jf in range(3):  # symmetric band taps
                z = z + p1[:, jf : jf + k, :, it * d : it * d + t] * wd[it, jf][:, None]
        p2 = torch.where(z >= 0, z, a2 * z)
        x = torch.matmul(w2.t(), p2) + b2[:, None] + x
    return x


def _check(x, params, dilations):
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [B, K, C, T], got {x.dtype} {tuple(x.shape)}")
    if min(x.shape) < 1:
        raise ValueError(f"x {tuple(x.shape)}: need B, K, C, T >= 1")
    c = x.shape[2]
    if not dilations or any(int(d) < 1 for d in dilations):
        raise ValueError(f"dilations must be positive, got {tuple(dilations)}")
    want = (len(dilations), params_per_layer(c))
    if tuple(params.shape) != want or params.dtype != torch.float32:
        raise ValueError(f"params must be float32 {want} (fold_eval_params for C={c} and "
                         f"{len(dilations)} layers), got {params.dtype} {tuple(params.shape)}")
    if params.device != x.device:
        raise ValueError(f"params are on {params.device}, x on {x.device}")


@functools.lru_cache(maxsize=None)
def _tiles(k: int, c: int, t: int, dilations: tuple, t_chunk, k_chunk):
    """(band tile, time tile) of one block: the pair whose halo-extended tiles
    cover [K, T] with the fewest computed positions and fit shared memory
    (two [bands + 2L, C, frames + 2*sum(d)] f32 buffers and one layer's
    parameters); ``t_chunk`` / ``k_chunk`` fix a side."""
    n_l, halo = len(dilations), 2 * sum(dilations)
    max_positions = (SMEM_BYTES // 4 - params_per_layer(c)) // (2 * c)
    best = None
    for kt in ([k_chunk] if k_chunk else range(1, k + 1)):
        ke = kt + 2 * n_l
        tt_max = min(max_positions // ke - halo, t)
        if t_chunk:
            tt = t_chunk if t_chunk <= tt_max else 0
        else:
            tt = -(-t // -(-t // tt_max)) if tt_max >= 1 else 0  # balance the time tiles
        if tt < 1:
            continue
        cost = -(-k // kt) * -(-t // tt) * ke * (tt + halo)
        if best is None or cost < best[0]:
            best = (cost, kt, tt)
    if best is None:
        raise ValueError(f"no TFCM tile fits {SMEM_BYTES} bytes of shared memory at K={k}, C={c}, "
                         f"dilations {dilations} (t_chunk={t_chunk}, k_chunk={k_chunk})")
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("tfcm_eval").tfcm_eval_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, params, dilations, t_chunk, k_chunk):
    if not x.is_contiguous() or not params.is_contiguous():
        raise ValueError("x and params must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or params.requires_grad):
        raise RuntimeError("the CUDA TFCM kernel has no backward; "
                           "run it under torch.no_grad() or torch.inference_mode()")
    b, k, c, t = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"the TFCM kernel takes C in {KERNEL_CHANNELS}, got {c}")
    if len(dilations) > MAX_LAYERS:
        raise ValueError(f"the TFCM kernel takes at most {MAX_LAYERS} layers, got {len(dilations)}")
    kt, tt = _tiles(k, c, t, dilations, t_chunk, k_chunk)
    if b > 65535 or -(-k // kt) > 65535:
        raise ValueError(f"B={b} or {-(-k // kt)} band tiles > 65535, the kernel's grid limit")
    out = torch.empty_like(x)
    dils = (ctypes.c_int * len(dilations))(*dilations)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), params.data_ptr(), out.data_ptr(), b, k, c, t,
                        len(dilations), dils, kt, tt, stream)
    if err != 0:
        raise RuntimeError(f"tfcm_eval kernel launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t}, dilations={dilations}, tile {kt}x{tt})")
    return out


def _run(x, params, dilations, t_chunk, k_chunk, counter):
    dilations = tuple(int(d) for d in dilations)
    _check(x, params, dilations)
    if x.device.type == "cpu":
        return tfcm_stack_reference(x, params, dilations)
    if x.device.type == "cuda":
        out = _launch(x, params, dilations, t_chunk, k_chunk)
        counter.launches += 1
        return out
    raise ValueError(f"the TFCM kernels run on cpu or cuda tensors, got {x.device}")


def fused_tfcm_stack_eval(x, params, *, dilations, t_chunk: int | None = None,
                          k_chunk: int | None = None):
    """The eval TFCM stack, x [B, K, C, T] -> [B, K, C, T], params
    ``fold_eval_params(...)`` [L, P], one launch for all L blocks. ``t_chunk``
    and ``k_chunk`` fix the kernel's time and band tile (chosen otherwise)."""
    return _run(x, params, dilations, t_chunk, k_chunk, fused_tfcm_stack_eval)


def fused_tfcm_block_eval(x, params, *, dilation: int, t_chunk: int | None = None,
                          k_chunk: int | None = None):
    """One eval TFCM block, params [1, P]: the stack's one-layer case."""
    return _run(x, params, (dilation,), t_chunk, k_chunk, fused_tfcm_block_eval)


fused_tfcm_stack_eval.launches = 0
fused_tfcm_block_eval.launches = 0
