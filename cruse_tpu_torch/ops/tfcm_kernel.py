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

``fused_tfcm_stack_eval`` and ``fused_tfcm_block_eval`` (its one-layer case)
run the plain version for tensors on the CPU and the hand-written kernel
(``csrc/tfcm_eval.cu``: ``tfcm_layer_kernel``, one device launch a dilation
layer, x passing between layers through two ping-pong buffers, all L
launches made by one C call) for tensors on a CUDA device; on a CUDA device
they launch or raise. Without a gradient both go through the op
``torch.ops.cruse_tpu_torch.tfcm_eval`` (``_forward_impl``), which
``torch.export`` traces into a saved program. ``<fn>.launches`` counts the
calls that launched, one a stack or a block whatever L, in eager code and in
a program alike. The kernel has no backward: on a CUDA device it raises when
a gradient is requested (the CPU's plain version takes one).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cruse_tpu_torch.ops import _build

KERNEL_CHANNELS = (4, 8, 12, 16, 24, 32, 48)  # the kernel's template instances
SMEM_BYTES = 227 * 1024  # the most shared memory a Hopper block takes (kMaxSmem in the source)
SM_SMEM_BYTES = 228 * 1024  # an H100 SM's shared memory, shared by its blocks
BLOCK_RESERVED_SMEM = 1024  # the runtime's own shared memory a block
MIN_BLOCKS_PER_SM = 2  # the tiles are chosen for (kMinBlocks in the source)
NUM_SMS = 132  # an H100 SXM's SMs
KERNEL_THREADS = 128  # a block's threads (kThreads in the source)
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


def _blocking(c: int) -> tuple[int, int]:
    """(positions a thread owns, output-channel groups): ``Blocking<C>`` in
    the source."""
    return (8 if c <= 12 else 4), (2 if c >= 48 else 1)


def layer_smem_bytes(c: int, kt: int, tt: int, d: int) -> int:
    """Shared memory of one block of the layer kernel (``smem_bytes`` in the
    source): the layer's parameters, padded to 4 floats, and its p1 tile of
    ``ceil(kt / P) * P + 2`` bands x C x ``tt + 2d`` frames, plus 32 floats
    that a ragged warp may read past it."""
    p = _blocking(c)[0]
    bands = -(-kt // p) * p + 2
    return 4 * (-(-params_per_layer(c) // 4) * 4 + bands * c * (tt + 2 * d) + 32)


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of the layer kernel that an SM's shared memory holds."""
    return SM_SMEM_BYTES // (smem_bytes + BLOCK_RESERVED_SMEM)


def _block_cost(c: int, kt: int, tt: int, d: int) -> float:
    """Modelled time of one block: a warp's share of the block's units (warp
    tasks), each costed by its instructions a channel. Phase 1's unit (32P
    positions of the tile and its halo, CO outputs) does P x CO FMAs and
    P + CO loads a channel; phase 2's (P bands x 32 frames) 9P + P x CO FMAs
    and 3(P + 2) + 10 + CO loads. Measured on an H100, the kernel is bound by
    how fast each warp gets through its units, so a block takes as long as
    its busiest warp."""
    p, g = _blocking(c)
    co = c // g
    warps = KERNEL_THREADS // 32
    units1 = -(-((kt + 2) * (tt + 2 * d)) // (32 * p)) * g
    units2 = -(-kt // p) * -(-tt // 32) * g
    return c * (-(-units1 // warps) * (p * co + p + co)
                + -(-units2 // warps) * (9 * p + p * co + 3 * (p + 2) + 10 + co))


class LayerTile(NamedTuple):
    kt: int  # bands of a block's own positions
    tt: int  # frames of a block's own positions
    src: str  # the buffer the layer reads: "x", "out" or "scratch"
    dst: str  # the buffer it writes: "out" or "scratch", never src
    smem: int  # shared memory of one block, bytes


@functools.lru_cache(maxsize=None)
def _layer_plan(b: int, k: int, c: int, t: int, dilations: tuple, t_chunk, k_chunk) -> tuple:
    """One ``LayerTile`` per layer. The tile is chosen for the layer's own
    dilation: the (kt, tt), kt a multiple of the P bands a thread owns and tt
    of 32 frames (or K, T), that fits two blocks an SM and costs the least:
    waves of 132 SMs x two blocks, times the modelled time of a block
    (``_block_cost``); only where none fits two does one block an SM take all
    its shared memory.
    ``t_chunk`` / ``k_chunk`` fix a side. The buffers ping-pong so that the
    last layer writes ``out``: x -> out for one layer, x -> scratch -> out
    for two, x -> out -> scratch -> out for three, and so on."""
    p = _blocking(c)[0]
    n = len(dilations)
    plan = []
    for layer, d in enumerate(dilations):
        kts = [k_chunk] if k_chunk else sorted({min(m * p, k) for m in range(1, -(-k // p) + 1)})
        tts = [t_chunk] if t_chunk else sorted({min(m * 32, t) for m in range(1, -(-t // 32) + 1)})
        best = None
        for budget in (SM_SMEM_BYTES // MIN_BLOCKS_PER_SM - BLOCK_RESERVED_SMEM, SMEM_BYTES):
            for kt in kts:
                for tt in tts:
                    smem = layer_smem_bytes(c, kt, tt, d)
                    if smem > budget:
                        continue
                    slots = NUM_SMS * min(blocks_per_sm(smem), MIN_BLOCKS_PER_SM)
                    waves = -(-b * -(-k // kt) * -(-t // tt) // slots)
                    cost = waves * _block_cost(c, kt, tt, d)
                    if best is None or cost < best[0]:
                        best = (cost, kt, tt)
            if best is not None:
                break
        if best is None:
            raise ValueError(f"no TFCM tile fits {SMEM_BYTES} bytes of shared memory at K={k}, C={c}, "
                             f"d={d} (t_chunk={t_chunk}, k_chunk={k_chunk})")
        dst = "out" if (n - 1 - layer) % 2 == 0 else "scratch"
        src = "x" if layer == 0 else plan[-1].dst
        plan.append(LayerTile(best[1], best[2], src, dst, layer_smem_bytes(c, best[1], best[2], d)))
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load_library("tfcm_eval")
    lib.tfcm_eval_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    lib.tfcm_eval_f32.restype = ctypes.c_int
    lib.tfcm_layer_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tfcm_layer_info.restype = ctypes.c_int
    return lib


def layer_kernel_info(c: int, smem_bytes: int) -> dict:
    """The layer kernel's instance for C on the current CUDA device: registers
    and local (spill) bytes a thread, blocks an SM at ``smem_bytes`` of shared
    memory, threads a block."""
    info = (ctypes.c_int * 4)()
    err = _library().tfcm_layer_info(c, smem_bytes, info)
    if err != 0:
        raise RuntimeError(f"tfcm_layer_info failed with CUDA error {err} (C={c}, {smem_bytes} B)")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "threads"), info))


def _launch(x, params, dilations, t_chunk, k_chunk):
    if not x.is_contiguous() or not params.is_contiguous():
        raise ValueError("x and params must be contiguous")
    b, k, c, t = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"the TFCM kernel takes C in {KERNEL_CHANNELS}, got {c}")
    plan = _layer_plan(b, k, c, t, dilations, t_chunk, k_chunk)
    if b > 65535 or max(-(-k // tile.kt) for tile in plan) > 65535:
        raise ValueError(f"B={b} or the band tiles > 65535, the kernel's grid limit")
    n = len(plan)
    buffers = {"x": x, "out": torch.empty_like(x)}
    if n > 1:
        buffers["scratch"] = torch.empty_like(x)

    def array(kind, values):
        return (kind * n)(*values)

    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library().tfcm_eval_f32(
            array(ctypes.c_void_p, [buffers[tile.src].data_ptr() for tile in plan]), params.data_ptr(),
            array(ctypes.c_void_p, [buffers[tile.dst].data_ptr() for tile in plan]), b, k, c, t, n,
            array(ctypes.c_int, dilations), array(ctypes.c_int, [tile.kt for tile in plan]),
            array(ctypes.c_int, [tile.tt for tile in plan]), stream)
    if err != 0:
        raise RuntimeError(f"tfcm_eval kernel launch failed with CUDA error {err} "
                           f"(B={b}, K={k}, C={c}, T={t}, dilations={dilations}, plan {plan})")
    return buffers["out"]


def _forward_impl(x: torch.Tensor, params: torch.Tensor, dilations: list[int], t_chunk: Optional[int],
                  k_chunk: Optional[int], block: bool) -> torch.Tensor:
    """The stack on tensors with storage: the plain version on CPU tensors,
    on CUDA tensors the layer kernel at ``_layer_plan``'s tiles (it launches
    or raises), counted in ``fused_tfcm_block_eval.launches`` when ``block``,
    else in ``fused_tfcm_stack_eval.launches``."""
    dilations = tuple(int(d) for d in dilations)
    if x.device.type == "cpu":
        return tfcm_stack_reference(x, params, dilations).contiguous()
    out = _launch(x, params, dilations, t_chunk, k_chunk)
    (fused_tfcm_block_eval if block else fused_tfcm_stack_eval).launches += 1
    return out


# the stack (or a lone block) as the traceable op torch.ops.cruse_tpu_torch.tfcm_eval
tfcm_eval_op = torch.library.custom_op("cruse_tpu_torch::tfcm_eval", _forward_impl, mutates_args=(),
                                       device_types=("cpu", "cuda"))


@tfcm_eval_op.register_fake
def _tfcm_eval_fake(x, params, dilations, t_chunk, k_chunk, block):
    """Shapes only, for tracing (``torch.export``) on tensors without storage."""
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _forward(x, params, dilations, t_chunk, k_chunk, block):
    return torch.ops.cruse_tpu_torch.tfcm_eval(x, params, dilations, t_chunk, k_chunk, block)


def _run(x, params, dilations, t_chunk, k_chunk, block: bool):
    dilations = tuple(int(d) for d in dilations)
    _check(x, params, dilations)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the TFCM kernels run on cpu or cuda tensors, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or params.requires_grad):
        if x.device.type == "cpu":  # the plain version is differentiable
            return tfcm_stack_reference(x, params, dilations)
        raise RuntimeError("the CUDA TFCM kernel has no backward; "
                           "run it under torch.no_grad() or torch.inference_mode()")
    return _forward(x, params, list(dilations), t_chunk, k_chunk, block)


def fused_tfcm_stack_eval(x, params, *, dilations, t_chunk: int | None = None,
                          k_chunk: int | None = None):
    """The eval TFCM stack, x [B, K, C, T] -> [B, K, C, T], params
    ``fold_eval_params(...)`` [L, P]: on a CUDA device L launches of the
    layer kernel, one a block, counted as one call. ``t_chunk`` and
    ``k_chunk`` fix every layer's time and band tile (``_layer_plan``
    chooses them otherwise)."""
    return _run(x, params, dilations, t_chunk, k_chunk, block=False)


def fused_tfcm_block_eval(x, params, *, dilation: int, t_chunk: int | None = None,
                          k_chunk: int | None = None):
    """One eval TFCM block, params [1, P]: the stack's one-layer case (one
    launch of the layer kernel on a CUDA device)."""
    return _run(x, params, (dilation,), t_chunk, k_chunk, block=True)


fused_tfcm_stack_eval.launches = 0
fused_tfcm_block_eval.launches = 0
