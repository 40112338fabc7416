#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (cruse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA device (no JAX
needed). In order, and any failure exits non-zero:

1. prints the device and ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``cruse_tpu_torch/ops/csrc``, one nvcc per
   source, all started together (ptxas report);
3. holds both grouped-GRU kernels (the resident one, whose weights stay in a
   thread-block cluster's shared memory, and the streamed one) against the
   plain PyTorch version on the card at config-1 shapes (B=256, T=1001, G=4,
   H=176), at the streaming step's (T=1) and on ragged shapes (B=17: a row
   tile with one live row; H=177: an odd split of the units; H=200 and H=384:
   clusters of 4 and, with bf16 weights, 8; H=500: the streamed kernel alone):
   f32 within 1e-4, bf16 weights within 1e-3 (same bf16-rounded weights); and
   that ``gru_sequence`` takes the kernel ``resident_plan`` names;
4. drives config 1's path: full-width CRUSE from ``configs/cruse_base.toml``
   with seeded weights and seeded non-default BatchNorm statistics,
   ``BatchInferencer.run_batched`` on six synthetic noisy utterances of 2 to
   10 s in batches of 4; checks the outputs, that the resident GRU kernel
   launched twice per forward (one per bank), and that the enhanced waveforms
   agree with the same batch through the plain recurrence on the card within
   1e-4;
5. times both GRU kernels and the plain version with CUDA events at config 1's
   shape (f32 and bf16 weights) and both kernels at the T=1 shapes (B=256, 8,
   1), one B=256 x 10 s enhancement with the kernel and with the plain
   recurrence, and profiles that forward;
6. holds the deep-filter kernel against its plain version within 1e-5 at
   config 3's offline shape (B=64, T=1001, F=96, t=2, f=1, the low bins of a
   161-bin spectrum), the streaming hop's (B=256, T=1, with history), and
   ragged ones (T < 2*t_dim, a symmetric layout) and MTFAA's (B=16, T=626,
   all 257 bins, t=1, f=1);
7. drives config 3's streaming path: full-width CRUSE+DF (``CruseDfConfig()``,
   seeded weights and BatchNorm statistics), ``StreamingEnhancer.run`` on
   B=8 synthetic 4 s utterances; checks 2 GRU and 1 deep-filter launches per
   hop, the output's length and finiteness, the stream against the same
   stream through both plain versions and against the offline center=False
   path (``apply_cruse_df`` + iSTFT, through the kernels) past the first
   n_fft samples, each within 1e-4, and ``step_multi`` (k=4) against 4 steps;
8. drives config 3's offline path: ``BatchInferencer(type="auto").run_batched``
   with the same CRUSE+DF on the six utterances; checks 2 GRU and 1
   deep-filter launches per forward and the waveform against the plain
   versions within 1e-4;
9. times the deep-filter kernel and its plain version (B=256, T=1001, F=96,
   K=15: ms and GB/s), streaming B=256 x 10 s (999 hops) with the kernels
   and with the plain versions (x-realtime), and one hop at B=1; profiles
   B=256 streaming hops (kernels per hop, device time by kernel, the
   device's busy time and idle share);
10. holds the MTFAA kernels against their plain versions on the card: the
    eval TFCM stack at config 5b's four stage shapes (B=16, 10 s: [16,64,24,626],
    [16,32,32,626], [16,16,48,626], [16,128,4,626]) within 1e-4, the one-block
    case at d=1 and d=8 within 1e-5, ragged shapes (T=19 with a time tile of
    8, K not a multiple of the band tile, C=4), three layers, and six layers
    (config 5's depth) with T=50 < 2 x 32; the kernel runs one launch of
    ``tfcm_layer_kernel`` a layer; and the temporal attention forward at
    the three stage geometries (BF=1024/512/256, c=6/8/12, C=24/32/48, T=626)
    with window 126, without one, and non-causal, and at T < window, T off
    the 32-query warp, T = 1, 31 and 33, window 1 and 32, BF = 1, c = 3 with
    C = 12 and c = 16 with C = 48, within 1e-5, its logsumexp too (causal
    cases); tolerances scale with max(1, max|ref|);
11. drives config 5b's path: full-width MTFAA from
    ``configs/mtfaa_windowed.toml`` (seeded weights, BatchNorm statistics and
    PReLU slopes), ``BatchInferencer(type="auto").run_batched`` on the six
    utterances in batches of 4; checks 6 TFCM-stack, 3 attention and 1
    deep-filter launches per forward, the outputs, and the waveform against
    the same batch through all plain versions within 1e-4; then config 5
    (``MtfaaConfig()``, full-causal attention) at B=4 x 4 s the same way, and
    a lone ``TFCMBlock`` (one block launch);
12. times the TFCM stack at the four stage shapes and one block (ms, the
    bound, GB/s over the least bytes and over the design's bytes; for each
    layer its tile, buffers, shared memory a block, blocks an SM, registers
    and spills as the card reports them), the attention forward at stage 0
    with and without the window against its plain version, and at all three
    stages with and without it (``ops/tattn_timing.py``: the kernel alone from
    a profile, the wrapper, the bound, ``scaled_dot_product_attention`` with
    the band mask, and the instance's registers, spills and blocks an SM,
    checked to spill nothing and, from a trace that saw every call, to be one
    device launch a call), the deep filter at MTFAA's shape, and one
    B=16 x 10 s config-5b enhancement with the kernels and with the plain versions
    (x-realtime); profiles one B=16 forward (kernels per forward, device time
    by kernel, busy time and idle share) and checks that it shows 24
    ``tfcm_layer_kernel`` launches (6 stacks x 4 layers);
13. holds the training kernels against their plain versions on the card at
    config 5b's four stage shapes and d = 1, 2, 4, 8, and on ragged shapes
    (T=19, K=5, C=4 with d=8 > T/2; d=64): the depthwise stencil forward and
    backward, ``tail_bwd`` and ``mid_bwd`` (elementwise outputs within 1e-5,
    per-channel sums within 1e-4, both x max(1, max|ref|): f32 sums of up to
    641,024 terms); ``mid_bwd``'s two kernels also at the ragged shapes and at
    forced tiles (K not a multiple of the band tile, T not a multiple of the
    time tile, d >= the time tile, B = 1, T = 1500, d = 700) into
    outputs and per-tile partial sums filled with NaN first, the partials held
    against their plain version; and the attention backward (dq, dk/dv) at the three stage
    geometries with window 126 and without one, with T < window, T off the
    tile, T = 1, 31 and 33 (a last key block of one key), window 1 and 32,
    BF = 1, c = 3 with C = 12 and c = 16 with C = 48 (1e-5), through
    ``flash_tattn_tm`` under autograd (one launch of each kernel a call) and
    the dk/dv kernel again into dk and dv filled with NaN first, after a check
    that config 5b's three dk/dv instances spill nothing; then
    ``tfcm_block_train``'s six outputs and thirteen gradients against autograd
    through the plain block (gradients: relative 2e-3 or absolute 1e-3 of the
    largest gradient);
14. drives the training path: full-width config 5b, seeded weights, B=16 x 10 s
    of seeded noisy/clean pairs, 3 steps of ``make_train_step``; checks 24
    stencil-forward, 24 ``tail_bwd``, 24 ``mid_bwd``, 3 attention-forward, 3 dq
    and 3 dk/dv launches a step and no eval-kernel launch, finite losses and
    gradient norm, that parameters and BatchNorm statistics moved, and the
    first step's losses and BatchNorm statistics against the same model with
    every kernel swapped for its plain version, and its gradients against that
    plain step in float64 (a leaf passes within relative 2e-3, or 1e-3 of the
    largest gradient, or no further from float64 than three times the plain
    float32 step's worst leaf: the phase encoder's gradients carry about 1e-2
    of float32 rounding in either version); then the
    ``"pallas"`` route (24 stencil forwards and backwards a step) and config 5
    (full-causal attention) the same way at B=4 x 4 s, and that a step on a
    batch with a NaN leaves everything unchanged;
15. times every training kernel and its plain version at stage 0, ``tail_bwd``
    and ``mid_bwd`` at the four stage shapes and d = 1, 2, 4, 8
    (``ops/tfcm_bwd_timing.py``: the wrapper by CUDA events, the kernels
    alone and the device launches a call from a profile, the bound; for
    ``mid_bwd`` its tile, shared memory, blocks an SM, registers and spills,
    and a check of at most two launches a call) and a step's 24 launches of
    each against their summed bound, the library
    calls that compute a kernel's function (cuDNN's depthwise convolution and
    its backward, cuDNN's GRU per group, which also does the input
    projection), the attention's dk/dv and dq kernels at the three stage
    geometries with and without the window (``ops/tattn_timing.py``: the
    kernels alone from a profile, checked to be one device launch a call,
    the wrappers, the bound, the backward of ``scaled_dot_product_attention``
    with the band mask as the library call (its forward is timed in 12),
    the dk/dv instance's registers, spills and blocks an SM) and the plain
    dense backward at stage 0,
    one B=16 x 10 s train step with the kernels and with the plain versions,
    its peak memory, and profiles one step (``mid_bwd``'s device time a step,
    and a check that the step makes at least 96 device launches fewer than the
    6,270 it made with eight launches a ``mid_bwd`` call);
16. prints a JSON line of the kernels (each with its launches on the main
    paths, its error, its time, the plain version's, the least time the card
    could take for its bytes or its multiply-adds, and the library call's time
    where there is one), then ``{"ok": true, "device": ...}``.

TF32 is off for matmuls and convolutions throughout, so every comparison is
in full float32.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

import cruse_tpu_torch
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import CruseDfConfig, CruseDfNet, MtfaaConfig, MtfaaNet, build_from_config
from cruse_tpu_torch.models.cruse_df import apply_cruse_df
from cruse_tpu_torch.models.mtfaa import (
    AxialSelfAttention, BatchNormC, PReLUc, TFCM, TFCMBlock)
from cruse_tpu_torch.nn.gru import GroupedGRULayer
from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.asa_kernel import (
    _launch_dkv, _launch_dq, _launch_fwd, band_mask, flash_tattn_tm, tattn_bwd_reference, tattn_dkv, tattn_dkv_info,
    tattn_dq, tattn_dq_info, tattn_reference)
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter, deep_filter_reference
from cruse_tpu_torch.ops.dw_kernel import (
    DW_BLOCKS_PER_SM, dw_bwd_buffers, dw_bwd_reference, dw_causal_tm, dw_kernel_info, dw_partials_reference, dw_plan,
    dw_stencil_bwd, dw_stencil_fwd, dw_taps_reference, launch_dw_bwd, launch_dw_fwd)
from cruse_tpu_torch.ops.dw_timing import describe as describe_dw
from cruse_tpu_torch.ops.dw_timing import describe_step, dw_bound, time_dw
from cruse_tpu_torch.ops.gru_kernel import (
    MAX_HIDDEN, cluster_fit, gru_sequence, gru_sequence_reference, launch_resident, launch_streamed,
    resident_plan)
from cruse_tpu_torch.ops.tfcm_kernel import (
    PARAM_KEYS, _blocking, _layer_plan, fold_eval_params, fused_tfcm_block_eval, fused_tfcm_stack_eval,
    layer_kernel_info, tfcm_stack_reference)
from cruse_tpu_torch.ops.tfcm_bwd_kernels import (
    launch_mid, mid_buffers, mid_bwd, mid_bwd_reference, mid_kernel_info, mid_partials_reference, mid_plan,
    mid_sums, tail_bwd, tail_bwd_reference)
from cruse_tpu_torch.ops.tattn_timing import attn_inputs, time_tattn_bwd, time_tattn_fwd
from cruse_tpu_torch.ops.tattn_timing import describe as describe_tattn
from cruse_tpu_torch.ops.tfcm_bwd_timing import bound, describe, time_tfcm_bwd
from cruse_tpu_torch.ops.tfcm_train import PARAM_NAMES, tfcm_block_reference, tfcm_block_train
from cruse_tpu_torch.train.step import (
    StepConfig, init_train_state, make_loss_gradients, make_train_step)
from cruse_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNELS = ("gru_sequence", "deep_filter", "tfcm_eval", "tattn", "dw_stencil", "tfcm_bwd",
           "tattn_bwd")  # csrc/<name>.cu
CONFIG1_GRU = (256, 1001, 4, 176)  # B, T, G, H of config 1's bottleneck banks
STREAM_GRU = ((256, 1, 4, 176), (8, 1, 4, 176))  # config 3's streaming hop
RAGGED_GRU = ((3, 7, 4, 176), (3, 7, 3, 50))
# a row tile with one live row; an odd split of the units; clusters of 4 (f32) and of 8 (bf16
# weights; f32 takes the streamed kernel); a size only the streamed kernel takes
CLUSTER_GRU = ((17, 7, 4, 176), (3, 7, 2, 177), (5, 6, 2, 200), (3, 5, 2, 384), (3, 5, 2, 500))
STEP_GRU = ((256, 1, 4, 176), (8, 1, 4, 176), (1, 1, 4, 176))  # the T=1 shapes that are timed
# B, T, F, t_dim, f_dim, causal, spectrum bins (>= F: the low bins of a wider one), history
CONFIG3_DF = (256, 1001, 96, 2, 1, True, 161, False)
MTFAA_DF = (16, 626, 257, 1, 1, True, 257, False)  # config 5b, B=16 x 10 s: every bin, K=9
DF_SHAPES = ((64, 1001, 96, 2, 1, True, 161, False),  # config 3 offline
             (256, 1, 96, 2, 1, True, 161, True),  # config 3 streaming hop
             (3, 7, 24, 1, 1, True, 24, False),  # ragged
             (3, 3, 24, 2, 1, True, 24, True),  # T < 2 * t_dim, with history
             (3, 3, 24, 2, 1, True, 24, False),  # T < 2 * t_dim, zero fill
             (3, 9, 20, 1, 2, False, 20, False),  # symmetric layout
             MTFAA_DF)
F32_TOL, BF16_TOL, DF_TOL, WAV_TOL = 1e-4, 1e-3, 1e-5, 1e-4
SR = 16000
UTTERANCE_SAMPLES = (32017, 59123, 81611, 105777, 132941, 160000)  # 2 .. 10 s
BATCH = 4
STREAM_BATCH, STREAM_SECONDS = 8, 4
# config 5b at B=16 x 10 s (626 frames): the TFCM stacks' [B, K, C, T] and the
# temporal attention's (BF, c, C) per encoder stage
DILATIONS = (1, 2, 4, 8)
TFCM_STAGES = ((16, 64, 24, 626), (16, 32, 32, 626), (16, 16, 48, 626), (16, 128, 4, 626))
# B, K, C, T, dilations, time tile, band tile
TFCM_RAGGED = ((2, 10, 24, 19, DILATIONS, 8, None),  # tile 1's halo reaches before t=0
               (2, 13, 32, 100, DILATIONS, None, 4),  # K not a multiple of the band tile
               (3, 7, 4, 19, DILATIONS, 8, 3),  # C=4, both ragged
               (2, 5, 12, 9, (1, 2), None, None),
               (2, 16, 48, 45, (1, 2, 4), None, None),  # an odd number of layers
               (2, 24, 24, 50, (1, 2, 4, 8, 16, 32), None, None))  # 6 layers (config 5's), T < 2 x 32
ATTN_STAGES = ((1024, 6, 24), (512, 8, 32), (256, 12, 48))
WINDOW = 126
TFCM_TOL, TFCM_BLOCK_TOL, ATTN_TOL = 1e-4, 1e-5, 1e-5
MTFAA_BATCH, MTFAA_SECONDS = 16, 10
CAUSAL_BATCH, CAUSAL_SECONDS = 4, 4
# B, K, C, T, d of the training kernels' ragged cases: d > T/2, and a dilation past every limit
TRAIN_RAGGED = ((2, 5, 4, 19, 8), (1, 3, 4, 40, 64), (2, 7, 12, 131, 2))
# B, K, C, T, d, band tile, time tile of mid_bwd's tiling cases (None: as mid_plan picks)
MID_TILINGS = ((2, 13, 24, 100, 2, 4, None),  # K not a multiple of the band tile
               (2, 9, 32, 131, 2, None, 32),  # T not a multiple of the time tile
               (1, 6, 4, 100, 64, None, 32),  # d >= the time tile
               (1, 7, 48, 90, 40, 3, 32),  # d >= the time tile, both ragged
               (1, 16, 48, 626, 8, None, None),  # B = 1
               (1, 5, 8, 1500, 3, None, None),  # a long T: a smaller band group
               (1, 4, 4, 2000, 700, None, None))  # d = 700: a smaller band group again
# B, K, C, T, d, band tile, time tile (None: as dw_plan picks; both directions), and the floats by which
# the tensors start past a 16-byte boundary, of the stencil kernels' tiling cases
DW_TILINGS = ((2, 13, 24, 100, 2, 4, None, 0),  # K not a multiple of the band tile
              (2, 9, 32, 131, 2, None, 32, 0),  # T not a multiple of the time tile; odd T: 4-byte copies
              (1, 6, 4, 100, 64, None, 32, 0),  # d > the time tile: three runs a staged row
              (1, 7, 48, 90, 40, 3, 32, 0),  # d > the time tile, both ragged
              (2, 16, 24, 626, 1, 16, 320, 0),  # 16-byte copies, T off the time tile
              (2, 16, 24, 626, 1, 5, 320, 1),  # the same misaligned: 4-byte copies
              (1, 16, 48, 626, 8, None, None, 0),  # B = 1; the backward's 642 frames in two spans
              (1, 5, 8, 1500, 3, None, None, 0),  # a long T: three spans
              (1, 4, 4, 2000, 700, None, None, 0))  # d = 700
STACK_STAGES = (0, 0, 1, 1, 2, 3)  # the TFCM stage of each of a config-5b step's six stacks
ELEMENT_TOL, SUM_TOL = 1e-5, 1e-4  # x max(1, max|ref|)
GRAD_REL_TOL, GRAD_ABS_TOL = 2e-3, 1e-3  # a gradient leaf: relative, or of the largest gradient
GRAD_NOISE_FACTOR = 3.0  # or this many times the same leaf's own float32 rounding error (whole net only)
TRAIN_STEPS = 3
HAND_WRITTEN = frozenset((  # the __global__ functions of ops/csrc/*.cu, as a profile names them
    "gru_sequence_kernel", "gru_resident_kernel", "deep_filter_kernel", "tfcm_layer_kernel", "tattn_fwd_kernel",
    "tattn_dq_kernel", "tattn_dkv_kernel", "dw_fwd_kernel", "dw_bwd_kernel", "dw_finish_kernel",
    "tail_bwd_kernel", "mid_tile_kernel", "mid_finish_kernel"))
# launches one config-5b train step makes: 6 stacks x 4 blocks, 3 attentions
STEP_LAUNCHES = {"dw_stencil_fwd": 24, "dw_stencil_bwd": 0, "tail_bwd": 24, "mid_bwd": 24,
                 "tattn": 3, "tattn_dq": 3, "tattn_dkv": 3, "tfcm_stack": 0, "tfcm_block": 0,
                 "deep_filter": 0, "gru_sequence": 0}
# what the kernels line gives of each attention kernel's timed stage geometries (ops/tattn_timing.py's rows)
STAGE_KEYS = ("bf", "c", "C", "window", "kernel_ms", "wrapper_ms", "bound_ms", "library_ms")
# and of the stencil's timed stage shapes and dilations (ops/dw_timing.py's rows)
DW_STAGE_KEYS = ("shape", "d", "kernel_ms", "wrapper_ms", "bound_ms", "library_ms", "kb", "tt")
STEP_KERNELS_BEFORE = 6270  # device launches of a config-5b train step when a mid_bwd call made 8
MID_LAUNCHES_PER_CALL = 2  # mid_tile_kernel and mid_finish_kernel
DW_LAUNCHES_PER_CALL = {"forward": 1, "backward": 2}  # dw_fwd_kernel; dw_bwd_kernel and dw_finish_kernel


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"ok: {what}", flush=True)


def gru_inputs(b, t, g, h, device, seed):
    rng = np.random.default_rng(seed)
    bound = h ** -0.5  # the layers' own init range
    arrays = (rng.standard_normal((b, t, g, 3 * h)),
              rng.standard_normal((b, g, h)) * 0.5,
              rng.uniform(-bound, bound, (g, 3 * h, h)),
              rng.uniform(-bound, bound, (g, 3 * h)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_gru_kernel(device) -> float:
    """Both kernels (each where it takes the shape) vs the plain version on
    the card, and gru_sequence's choice between them; returns the largest f32
    error."""
    worst = 0.0
    for shape in (CONFIG1_GRU, *STREAM_GRU, *RAGGED_GRU, *CLUSTER_GRU):
        args = gru_inputs(*shape, device, SEED)
        for dtype, tol, what in ((None, F32_TOL, "f32"), (torch.bfloat16, BF16_TOL, "bf16 weights")):
            fit, plan = cluster_fit(shape[3], dtype), resident_plan(*shape, dtype)
            kernels = [("streamed", launch_streamed)] if shape[3] <= MAX_HIDDEN else []
            if fit is not None:
                kernels.append((f"resident (cluster of {fit[0]}, {fit[1]} units a block)", launch_resident))
            with torch.inference_mode():
                want = gru_sequence_reference(*args, weight_dtype=dtype)
                for name, kernel in kernels:
                    got = kernel(*args, weight_dtype=dtype)
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    require(all(bool(torch.isfinite(x).all()) for x in got) and err <= tol,
                            f"gru_sequence {what}, {name} kernel, {shape}: max-abs {err:.3g} <= {tol}")
                    if dtype is None:
                        worst = max(worst, err)
                before = gru_sequence.launches, gru_sequence.resident_launches
                got = gru_sequence(*args, weight_dtype=dtype)
                torch.cuda.synchronize()
                took = gru_sequence.launches - before[0], gru_sequence.resident_launches - before[1]
                require(took == (1, int(plan is not None)) and max_err(got, want) <= tol,
                        f"gru_sequence {what} {shape}: one launch, of the "
                        f"{'streamed' if plan is None else 'resident'} kernel as planned")
    return worst


def time_gru_kernels(device, smi) -> dict:
    """Both kernels and the plain version at config 1's shape (ms; f32 and
    bf16 weights), and both kernels at the T=1 shapes; prints them. The two
    kernels take turns (resident, streamed, streamed, resident) on one card."""
    times = {}
    args = gru_inputs(*CONFIG1_GRU, device, SEED + 1)
    b, t, g, h = CONFIG1_GRU
    with torch.inference_mode():
        for dtype, what in ((None, "f32"), (torch.bfloat16, "bf16 weights")):
            turns = [cuda_ms(lambda: kernel(*args, weight_dtype=dtype), reps=5)
                     for kernel in (launch_resident, launch_streamed, launch_streamed, launch_resident)]
            times[what] = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            fit = cluster_fit(h, dtype)
            print(f"gru_sequence B={b} T={t} G={g} H={h} {what} on {smi}: resident kernel (cluster of "
                  f"{fit[0]}, {fit[2]} B of shared memory a block) {turns[0]:.3f}, {turns[3]:.3f} ms; "
                  f"streamed kernel {turns[1]:.3f}, {turns[2]:.3f} ms")
        times["plain"] = cuda_ms(lambda: gru_sequence_reference(*args), reps=2)
        times["routed"] = cuda_ms(lambda: gru_sequence(*args), reps=5)
        print(f"gru_sequence B={b} T={t} G={g} H={h} f32 on {smi}: as routed {times['routed']:.3f} ms, "
              f"plain {times['plain']:.3f} ms "
              f"({'kernel faster' if times['routed'] < times['plain'] else 'KERNEL SLOWER'})")
        del args
        # one step: the wrapper's host time exceeds the kernel's, so CUDA events
        # around back-to-back launches would time the host; the kernel's own time
        # is read from a profile, the host's from the clock
        for shape in STEP_GRU:
            args = gru_inputs(*shape, device, SEED + 1)
            turns = [launch_us(lambda: kernel(*args), reps=100)
                     for kernel in (launch_resident, launch_streamed, launch_streamed, launch_resident)]
            times[shape] = (turns[0][0] + turns[3][0]) / 2e3, (turns[1][0] + turns[2][0]) / 2e3
            print(f"gru_sequence B={shape[0]} T=1 G={shape[2]} H={shape[3]} f32 on {smi}, kernel's device "
                  f"time (host time a call): resident kernel {turns[0][0]:.2f} ({turns[0][1]:.1f}), "
                  f"{turns[3][0]:.2f} ({turns[3][1]:.1f}) us; streamed kernel {turns[1][0]:.2f} "
                  f"({turns[1][1]:.1f}), {turns[2][0]:.2f} ({turns[2][1]:.1f}) us")
    return times


def launch_us(fn, reps: int) -> tuple[float, float]:
    """(median device time of the hand-written kernels fn() launches, read from
    a torch.profiler trace of reps calls; host time of one fn() call with the
    queue never full), both in microseconds."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    durations = sorted(e["dur"] for e in events if e.get("cat") == "kernel" and "dur" in e
                       and any(name in e["name"] for name in HAND_WRITTEN))
    # a trace may miss a few launches; the median needs most of them, not all
    require(len(durations) >= reps // 2, f"the profile shows {len(durations)} kernels for {reps} calls")
    return durations[len(durations) // 2], sorted(host)[reps // 2] * 1e6


def noisy_utterances(seed: int, lengths=UTTERANCE_SAMPLES):
    """Synthetic noisy speech: amplitude-modulated harmonic tones + noise."""
    rng = np.random.default_rng(seed)
    wavs = []
    for n in lengths:
        t = np.arange(n) / SR
        f0 = rng.uniform(100, 250)
        clean = sum(rng.uniform(0.2, 1) / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 8))
        clean *= 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t))
        noise = rng.standard_normal(n)
        wavs.append((0.1 * clean / np.abs(clean).max() + 0.03 * noise).astype(np.float32))
    return wavs


def set_recurrence(model, fn) -> None:
    for m in model.modules():
        if isinstance(m, GroupedGRULayer):
            m.recurrence = fn


def set_plain(model, plain: bool) -> None:
    """Put both plain versions (or both kernels) in a CRUSE+DF model's path."""
    set_recurrence(model, gru_sequence_reference if plain else gru_sequence)
    model.filter_fn = deep_filter_reference if plain else deep_filter


COUNTERS = {"gru_sequence": gru_sequence, "deep_filter": deep_filter,
            "tfcm_stack": fused_tfcm_stack_eval, "tfcm_block": fused_tfcm_block_eval,
            "tattn": flash_tattn_tm, "dw_stencil_fwd": dw_stencil_fwd,
            "dw_stencil_bwd": dw_stencil_bwd, "tail_bwd": tail_bwd, "mid_bwd": mid_bwd,
            "tattn_dq": tattn_dq, "tattn_dkv": tattn_dkv}


def reset_counts() -> None:
    for kernel in COUNTERS.values():
        kernel.launches = 0
    gru_sequence.resident_launches = 0


def counts() -> dict:
    return {name: kernel.launches for name, kernel in COUNTERS.items()}


def seed_batch_norm_stats(model, gen) -> None:
    """Seeded non-default BatchNorm statistics, so eval mode really uses them."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)


def build_inferencer(device):
    config = load_config(str(ROOT / "configs" / "cruse_base.toml"))
    gen = torch.Generator().manual_seed(SEED)
    model = build_from_config(config["model"], generator=gen)
    seed_batch_norm_stats(model, gen)
    ac = config["acoustics"]
    icfg = InferencerConfig(type=config["inferencer"]["type"], sr=int(ac["sr"]),
                            stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"])))
    return BatchInferencer(model, icfg, device)


def check_main_path(inferencer) -> int:
    """Drive run_batched once; returns the kernel launches it made."""
    wavs = noisy_utterances(SEED)
    names = [f"utt{i}" for i in range(len(wavs))]
    forwards = math.ceil(len(wavs) / BATCH)

    reset_counts()
    results = inferencer.run_batched(wavs, names, batch_size=BATCH, write=False)
    torch.cuda.synchronize()
    launches, df_launches = gru_sequence.launches, deep_filter.launches
    resident = gru_sequence.resident_launches

    require(launches == 2 * forwards and resident == launches and df_launches == 0,
            f"config-1 path launched gru_sequence {launches} times = 2 per forward x {forwards}, "
            f"{resident} of them the resident kernel, deep_filter {df_launches} times")
    require([r[0] for r in results] == names
            and all(r[1].shape == w.shape for r, w in zip(results, wavs))
            and all(0 < np.abs(r[1]).max() <= 32767 for r in results),
            "run_batched returned every utterance at its length")

    # the first batch again, as floats: the kernel's path vs the plain recurrence
    hop = inferencer.cfg.stft.hop_length
    padded = -(-max(len(w) for w in wavs) // hop) * hop
    x = torch.from_numpy(np.stack([np.pad(w, (0, padded - len(w))) for w in wavs[:BATCH]]))
    x = x.to(inferencer.device)
    with_kernel = inferencer.mag_to_mag(x)
    set_recurrence(inferencer.model, gru_sequence_reference)
    with_plain = inferencer.mag_to_mag(x)
    set_recurrence(inferencer.model, gru_sequence)
    torch.cuda.synchronize()
    err = float((with_kernel - with_plain).abs().max())
    require(tuple(with_kernel.shape) == tuple(x.shape) and bool(torch.isfinite(with_kernel).all()),
            f"enhanced batch is finite, shape {tuple(x.shape)}")
    require(err <= WAV_TOL, f"enhanced wav, kernel vs plain recurrence: max-abs {err:.3g} <= {WAV_TOL}")
    return launches


def df_inputs(b, t, f, t_dim, f_dim, causal, bins, history, device, seed):
    """Seeded deep-filter inputs on the card: the spectrum is the low f bins
    of a [B, T, bins] one (strided rows, as in the model); the history, when
    asked for, a batch-strided view, as the stream carries it."""
    gen = torch.Generator(device).manual_seed(seed)
    k = (2 * t_dim + 1) * (2 * f_dim + 1)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=device),
                             torch.randn(shape, generator=gen, device=device))

    spec = cplx(b, t, bins)[:, :, :f]
    coefs = torch.randn((b, t, f, k, 2), generator=gen, device=device) * 0.2
    hist = cplx(b, 2 * t_dim + 1, f)[:, 1:] if history else None
    return spec, coefs, hist


def check_df_kernel(device) -> float:
    """Deep-filter kernel vs plain version on the card; returns the largest error."""
    worst = 0.0
    for b, t, f, t_dim, f_dim, causal, bins, history in DF_SHAPES:
        spec, coefs, hist = df_inputs(b, t, f, t_dim, f_dim, causal, bins, history, device, SEED)
        with torch.inference_mode():
            got = deep_filter(spec, coefs, t_dim, f_dim, causal, hist)
            torch.cuda.synchronize()
            want = deep_filter_reference(spec, coefs, t_dim, f_dim, causal, hist)
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(torch.view_as_real(got)).all()) and err <= DF_TOL,
                f"deep_filter B={b} T={t} F={f} t={t_dim} f={f_dim} causal={causal} "
                f"history={history}: max-abs {err:.3g} <= {DF_TOL}")
        worst = max(worst, err)
    return worst


def build_cruse_df(device):
    """Config 3's full width (CruseDfConfig() defaults), seeded weights and
    BatchNorm statistics."""
    gen = torch.Generator().manual_seed(SEED + 3)
    model = CruseDfNet(CruseDfConfig(), generator=gen)
    seed_batch_norm_stats(model, gen)
    return model.to(device).eval()


def check_streaming(model, device) -> tuple[int, int]:
    """Drive StreamingEnhancer.run once; returns its (gru, deep_filter) launches."""
    cfg = StftConfig(n_fft=320, hop_length=160, center=False)
    enh = StreamingEnhancer(model, cfg)
    n, hop = cfg.n_fft, cfg.hop_length
    wav = torch.from_numpy(np.stack(noisy_utterances(
        SEED + 1, (STREAM_SECONDS * SR,) * STREAM_BATCH))).to(device)
    hops = (wav.shape[-1] - (n - hop)) // hop

    reset_counts()
    streamed = enh.run(wav)
    torch.cuda.synchronize()
    launches, df_launches = gru_sequence.launches, deep_filter.launches
    planned = launches if resident_plan(*STREAM_GRU[1]) else 0
    require(launches == 2 * hops and df_launches == hops
            and gru_sequence.resident_launches == planned,
            f"streaming path launched gru_sequence {launches} = 2 x {hops} hops "
            f"({planned} of them the resident kernel, as planned for T=1) and "
            f"deep_filter {df_launches} = 1 x {hops} hops")
    require(tuple(streamed.shape) == (STREAM_BATCH, hops * hop)
            and bool(torch.isfinite(streamed).all()),
            f"stream is finite, shape {(STREAM_BATCH, hops * hop)}")

    set_plain(model, True)
    plain = enh.run(wav)
    set_plain(model, False)
    err_plain = float((streamed - plain).abs().max())
    require(err_plain <= WAV_TOL,
            f"stream, kernels vs plain versions: max-abs {err_plain:.3g} <= {WAV_TOL}")

    with torch.inference_mode():
        spec = stft(wav, cfg)
        (mask, coefs), _ = model(model.compress(spec.abs()))
        offline = istft(apply_cruse_df(spec, mask, coefs, model.config), cfg)
    m = min(streamed.shape[-1], offline.shape[-1])
    err_offline = float((streamed[:, n:m] - offline[:, n:m]).abs().max())
    require(err_offline <= WAV_TOL, f"stream vs offline center=False past {n} samples: "
            f"max-abs {err_offline:.3g} <= {WAV_TOL}")

    state = enh.prime(enh.init_state(STREAM_BATCH), wav[:, : n - hop])
    x = wav[:, n - hop : n - hop + 8 * hop]
    singles = []
    single_state = state
    for i in range(8):
        out, single_state = enh.step(single_state, x[:, i * hop : (i + 1) * hop])
        singles.append(out)
    first, state = enh.step_multi(state, x[:, : 4 * hop])
    second, state = enh.step_multi(state, x[:, 4 * hop :])
    err_multi = float((torch.cat([first, second], -1) - torch.cat(singles, -1)).abs().max())
    require(err_multi <= 1e-6, f"step_multi(k=4) x 2 vs 8 steps: max-abs {err_multi:.3g} <= 1e-6")
    return launches, df_launches


def check_auto_path(model, device) -> tuple[int, int]:
    """Drive BatchInferencer(type="auto").run_batched with CRUSE+DF once;
    returns its (gru, deep_filter) launches."""
    inferencer = BatchInferencer(model, InferencerConfig(
        type="auto", sr=SR, stft=StftConfig(n_fft=320, hop_length=160)), device)
    wavs = noisy_utterances(SEED)
    names = [f"utt{i}" for i in range(len(wavs))]
    forwards = math.ceil(len(wavs) / BATCH)

    reset_counts()
    results = inferencer.run_batched(wavs, names, batch_size=BATCH, write=False)
    torch.cuda.synchronize()
    launches, df_launches = gru_sequence.launches, deep_filter.launches
    require(launches == 2 * forwards and df_launches == forwards,
            f"auto path launched gru_sequence {launches} = 2 x {forwards} forwards and "
            f"deep_filter {df_launches} = 1 x {forwards}")
    require([r[0] for r in results] == names
            and all(r[1].shape == w.shape for r, w in zip(results, wavs))
            and all(0 < np.abs(r[1]).max() <= 32767 for r in results),
            "auto run_batched returned every utterance at its length")

    hop = inferencer.cfg.stft.hop_length
    padded = -(-max(len(w) for w in wavs) // hop) * hop
    x = torch.from_numpy(np.stack([np.pad(w, (0, padded - len(w))) for w in wavs[:BATCH]]))
    x = x.to(device)
    with_kernels = inferencer.auto(x)
    set_plain(model, True)
    with_plain = inferencer.auto(x)
    set_plain(model, False)
    torch.cuda.synchronize()
    err = float((with_kernels - with_plain).abs().max())
    require(bool(torch.isfinite(with_kernels).all()) and err <= WAV_TOL,
            f"auto enhanced wav, kernels vs plain versions: max-abs {err:.3g} <= {WAV_TOL}")
    return launches, df_launches


def stream_seconds(enh, wav) -> float:
    """Wall seconds of one synchronised StreamingEnhancer.run, after a warm-up."""
    enh.run(wav[:, : 4 * enh.cfg.hop_length])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enh.run(wav)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_stream(enh, wav, hops: int = 20) -> None:
    """torch.profiler over `hops` streaming hops (see ``profile_calls``)."""
    hop = enh.cfg.hop_length
    keep = enh.cfg.n_fft - hop
    x = wav[:, keep : keep + (2 * hops + 1) * hop]
    carry = {"state": enh.prime(enh.init_state(wav.shape[0]), wav[:, :keep]), "i": 0}

    def one_hop():
        i = carry["i"]
        _, carry["state"] = enh.step(carry["state"], x[:, i * hop : (i + 1) * hop])
        carry["i"] = i + 1

    profile_calls(one_hop, hops, f"B={wav.shape[0]} streaming hop (a call is one hop)")


def enhancement_seconds(strategy, x, reps: int = 3) -> float:
    """Wall seconds of one synchronised strategy(x) call (an inferencer's
    ``mag_to_mag`` or ``auto``), after a warm-up."""
    strategy(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        strategy(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def scaled_err(got, want) -> tuple[float, float]:
    """(max-abs error, its bound's scale max(1, max|want|))."""
    return float((got - want).abs().max()), max(1.0, float(want.abs().max()))


def tfcm_inputs(b, k, c, t, n_layers, device, seed):
    """Seeded x [B, K, C, T] and folded parameters of n_layers blocks with
    non-default BatchNorm statistics and PReLU slopes."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (c, c), "w2": (c, c), "wd": (3, 3, c), "a1": (), "a2": ()}
    blocks = []
    for _ in range(n_layers):
        p = {key: rng.standard_normal(shapes.get(key, (c,))) * c ** -0.5 for key in PARAM_KEYS}
        p.update(g1=1 + 0.2 * rng.standard_normal(c), g2=1 + 0.2 * rng.standard_normal(c),
                 v1=rng.uniform(0.5, 1.5, c), v2=rng.uniform(0.5, 1.5, c),
                 a1=rng.uniform(0.05, 0.3), a2=rng.uniform(0.05, 0.3),
                 wd=rng.standard_normal((3, 3, c)) / 3)
        blocks.append({key: torch.tensor(np.float32(v)) for key, v in p.items()})
    x = torch.from_numpy(rng.standard_normal((b, k, c, t)).astype(np.float32)).to(device)
    return x, fold_eval_params(blocks).to(device)


def check_tfcm_kernel(device) -> tuple[float, float]:
    """TFCM stack and block kernels vs the plain version on the card; returns
    the largest max-abs error of the stack and of the block."""
    worst = {"stack": 0.0, "block": 0.0}
    cases = [(*shape, DILATIONS, None, None, TFCM_TOL, "stack") for shape in TFCM_STAGES]
    cases += [(*TFCM_STAGES[0], (d,), None, None, TFCM_BLOCK_TOL, "block") for d in (1, 8)]
    cases += [(*shape, TFCM_TOL, "ragged stack") for shape in TFCM_RAGGED]
    for b, k, c, t, dils, t_chunk, k_chunk, tol, what in cases:
        x, params = tfcm_inputs(b, k, c, t, len(dils), device, SEED)
        with torch.inference_mode():
            if len(dils) == 1:
                got = fused_tfcm_block_eval(x, params, dilation=dils[0], t_chunk=t_chunk, k_chunk=k_chunk)
            else:
                got = fused_tfcm_stack_eval(x, params, dilations=dils, t_chunk=t_chunk, k_chunk=k_chunk)
            torch.cuda.synchronize()
            want = tfcm_stack_reference(x, params, dils)
        err, scale = scaled_err(got, want)
        require(bool(torch.isfinite(got).all()) and err <= tol * scale,
                f"tfcm {what} {(b, k, c, t)} dilations {dils} tiles ({k_chunk}, {t_chunk}): "
                f"max-abs {err:.3g} <= {tol} x {scale:.3g}")
        kind = "block" if len(dils) == 1 else "stack"
        worst[kind] = max(worst[kind], err)
    return worst["stack"], worst["block"]


def check_attn_kernel(device) -> float:
    """Temporal-attention forward kernel vs the plain version on the card, and
    its logsumexp (causal cases) vs the plain logsumexp of the masked logits;
    returns the largest max-abs error of the output."""
    worst = 0.0
    cases = [(bf, c, cv, 626, w, True) for bf, c, cv in ATTN_STAGES for w in (WINDOW, None)]
    cases += [(bf, c, cv, 626, None, False) for bf, c, cv in ATTN_STAGES]
    cases += [(64, 6, 24, 100, WINDOW, True),  # T < window
              (64, 8, 32, 200, WINDOW, True), (64, 12, 48, 200, 50, True),  # T off the 32-query warp
              (64, 6, 24, 200, None, False), (5, 3, 12, 37, 7, True),
              (64, 6, 24, 1, WINDOW, True), (64, 6, 24, 31, WINDOW, True),  # T = 1, inside one key tile
              (64, 8, 32, 33, None, True), (64, 8, 32, 33, None, False),  # one key past a tile
              (64, 8, 32, 200, 1, True), (64, 8, 32, 200, 32, True),  # window 1 and one tile
              (1, 6, 24, 626, WINDOW, True),  # BF = 1
              (7, 3, 12, 300, WINDOW, True), (7, 16, 48, 300, WINDOW, True),  # c = 3 / 16, C = 12 / 48
              (7, 16, 48, 300, None, False)]
    for bf, c, cv, t, window, causal in cases:
        q, k, v = attn_inputs(bf, c, cv, t, device, SEED)
        what = f"tattn BF={bf} c={c} C={cv} T={t} window={window} causal={causal}"
        with torch.inference_mode():
            got = flash_tattn_tm(q, k, v, window, causal=causal)
            lse = _launch_fwd(q, k, v, window, causal, with_lse=True)[1] if causal else None
            torch.cuda.synchronize()
            want = tattn_reference(q, k, v, window, causal)
            err, scale = scaled_err(got, want)
            require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL * scale,
                    f"{what}: max-abs {err:.3g} <= {ATTN_TOL} x {scale:.3g}")
            if lse is not None:
                logits = (torch.einsum("bct,bcs->bts", q, k) * c ** -0.5).masked_fill_(
                    ~band_mask(t, window, device), -math.inf)
                require_close(lse, torch.logsumexp(logits, dim=-1), ATTN_TOL, f"{what}: logsumexp")
        worst = max(worst, err)
    return worst


def mtfaa_counts() -> tuple[int, int, int, int]:
    """(tfcm stack, tfcm block, attention, deep filter) launches."""
    return (fused_tfcm_stack_eval.launches, fused_tfcm_block_eval.launches,
            flash_tattn_tm.launches, deep_filter.launches)


def plain_block(x, params, dilation):
    return tfcm_stack_reference(x, params, (dilation,))


def set_plain_mtfaa(model, plain: bool) -> None:
    """Put every plain version (or every kernel) in an MTFAA model's eval and
    training paths."""
    for m in model.modules():
        if isinstance(m, TFCM):
            m.stack_fn = tfcm_stack_reference if plain else fused_tfcm_stack_eval
        elif isinstance(m, TFCMBlock):
            m.block_fn = plain_block if plain else fused_tfcm_block_eval
            m.train_fn = tfcm_block_reference if plain else tfcm_block_train
            m.dw_fn = dw_taps_reference if plain else dw_causal_tm
        elif isinstance(m, AxialSelfAttention):
            m.attn_fn = tattn_reference if plain else flash_tattn_tm
    model.filter_fn = deep_filter_reference if plain else deep_filter


def seed_mtfaa_stats(model, gen) -> None:
    """Seeded non-default BatchNorm statistics and affines, and PReLU slopes."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormC):
                n = m.mean.numel()
                m.mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.var.copy_(torch.rand(n, generator=gen) + 0.5)
                m.scale.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
            elif isinstance(m, PReLUc):
                m.negative_slope.fill_(float(torch.rand((), generator=gen)) * 0.3)


def build_mtfaa(config: MtfaaConfig | None, device, seed: int):
    """Config 5b from configs/mtfaa_windowed.toml (config=None) or the given
    config, with seeded weights and statistics, on the card in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    if config is None:
        model = build_from_config(load_config(str(ROOT / "configs" / "mtfaa_windowed.toml"))["model"],
                                  generator=gen)
    else:
        model = MtfaaNet(config, generator=gen)
    seed_mtfaa_stats(model, gen)
    return model.to(device).eval()


def mtfaa_inferencer(model, device):
    ac = load_config(str(ROOT / "configs" / "mtfaa_windowed.toml"))["acoustics"]
    return BatchInferencer(model, InferencerConfig(
        type="auto", sr=int(ac["sr"]),
        stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"]))), device)


def check_mtfaa_forward(inferencer, x, what: str) -> None:
    """One auto forward on x [B, L]: one launch of each path kernel per stage
    (6 TFCM stacks, 3 attentions, 1 deep filter), and the waveform against the
    same batch through every plain version."""
    reset_counts()
    with_kernels = inferencer.auto(x)
    torch.cuda.synchronize()
    counts = mtfaa_counts()
    require(counts == (6, 0, 3, 1), f"{what}: one forward launched (tfcm stack, tfcm block, "
            f"tattn, deep_filter) = {counts} = (6, 0, 3, 1)")
    set_plain_mtfaa(inferencer.model, True)
    with_plain = inferencer.auto(x)
    set_plain_mtfaa(inferencer.model, False)
    torch.cuda.synchronize()
    err = float((with_kernels - with_plain).abs().max())
    require(tuple(with_kernels.shape) == tuple(x.shape) and bool(torch.isfinite(with_kernels).all())
            and err <= WAV_TOL, f"{what}: enhanced wav finite, shape {tuple(x.shape)}, kernels vs "
            f"plain versions max-abs {err:.3g} <= {WAV_TOL}")


def check_mtfaa_path(inferencer) -> tuple[int, int, int]:
    """Drive BatchInferencer(type="auto").run_batched with config 5b once;
    returns its (tfcm stack, tattn, deep_filter) launches."""
    wavs = noisy_utterances(SEED)
    names = [f"utt{i}" for i in range(len(wavs))]
    forwards = math.ceil(len(wavs) / BATCH)

    reset_counts()
    results = inferencer.run_batched(wavs, names, batch_size=BATCH, write=False)
    torch.cuda.synchronize()
    stack, block, attn, df = mtfaa_counts()
    gru = gru_sequence.launches
    require((stack, block, attn, df, gru) == (6 * forwards, 0, 3 * forwards, forwards, 0),
            f"config-5b path launched tfcm stack {stack} = 6 x {forwards} forwards, tattn {attn} "
            f"= 3 x {forwards}, deep_filter {df} = 1 x {forwards}, tfcm block {block} = 0, "
            f"gru_sequence {gru} = 0")
    require([r[0] for r in results] == names
            and all(r[1].shape == w.shape for r, w in zip(results, wavs))
            and all(0 < np.abs(r[1]).max() <= 32767 for r in results),
            "config-5b run_batched returned every utterance at its length")

    hop = inferencer.cfg.stft.hop_length
    padded = -(-max(len(w) for w in wavs) // hop) * hop
    x = torch.from_numpy(np.stack([np.pad(w, (0, padded - len(w))) for w in wavs[:BATCH]]))
    check_mtfaa_forward(inferencer, x.to(inferencer.device), "config-5b batch of 4 x 10 s")
    return stack, attn, df


def check_tfcm_block_path(device) -> int:
    """A lone TFCMBlock (eval) at stage 0's shape: one block launch, equal to
    its plain version; returns its block launches."""
    gen = torch.Generator().manual_seed(SEED + 5)
    block = TFCMBlock(24, dilation=4, generator=gen)
    seed_mtfaa_stats(block, gen)
    block = block.to(device).eval()
    x = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(TFCM_STAGES[0])
                         .astype(np.float32)).to(device)
    reset_counts()
    with torch.inference_mode():
        got = block(x)
        torch.cuda.synchronize()
        counts = mtfaa_counts()
        block.block_fn = plain_block
        want = block(x)
        block.block_fn = fused_tfcm_block_eval
    err, scale = scaled_err(got, want)
    require(counts == (0, 1, 0, 0) and err <= TFCM_BLOCK_TOL * scale,
            f"TFCMBlock(24, d=4) forward: launches {counts} = (0, 1, 0, 0), vs plain max-abs "
            f"{err:.3g} <= {TFCM_BLOCK_TOL} x {scale:.3g}")
    return counts[1]


def tfcm_design_bytes(shape, dilations) -> int:
    """Bytes the layer kernels move for one stack as planned: each block reads
    x over its tile and halo once per output-channel group, reads x again at
    its own positions (the residual) and writes y (edge tiles counted whole;
    the halo and the second read mostly hit L2)."""
    b, k, c, t = shape
    groups = _blocking(c)[1]
    total = 0
    for tile, d in zip(_layer_plan(b, k, c, t, tuple(dilations), None, None), dilations):
        tiles = b * -(-k // tile.kt) * -(-t // tile.tt)
        total += 4 * c * (tiles * (tile.kt + 2) * (tile.tt + 2 * d) * groups + 2 * b * k * t)
    return total


def print_tfcm_layers(shape, dilations, smi) -> None:
    """Each layer's tile, shared memory a block, blocks an SM and the
    kernel's registers and spills, as the card reports them."""
    b, k, c, t = shape
    for tile, d in zip(_layer_plan(b, k, c, t, tuple(dilations), None, None), dilations):
        info = layer_kernel_info(c, tile.smem)
        print(f"  tfcm_layer_kernel<{c}> d={d} on {smi}: tile {tile.kt} bands x {tile.tt} frames, "
              f"{tile.src} -> {tile.dst}, {tile.smem} B of shared memory a block, {info['blocks_per_sm']} "
              f"blocks an SM, {info['threads']} threads, {info['registers']} registers, "
              f"{info['spill_bytes']} B of local (spill) memory a thread")


def time_mtfaa_kernels(device, smi) -> dict:
    """Kernel vs plain times (ms) at the main path's shapes; prints them."""
    times = {}
    with torch.inference_mode():
        for shape in TFCM_STAGES:
            x, params = tfcm_inputs(*shape, len(DILATIONS), device, SEED + 1)
            ms = cuda_ms(lambda: fused_tfcm_stack_eval(x, params, dilations=DILATIONS), reps=20)
            plain = cuda_ms(lambda: tfcm_stack_reference(x, params, DILATIONS), reps=5)
            nbytes = 2 * x.numel() * 4  # x read once, y written once
            design = tfcm_design_bytes(shape, DILATIONS)
            least = bound(nbytes, len(DILATIONS) * x.numel() * (2 * shape[2] + 9))
            print(f"tfcm stack {list(shape)} dilations {DILATIONS} on {smi}: kernel {ms:.3f} ms "
                  f"({len(DILATIONS)} layer launches), bound {least['bound_ms']:.4f} ms ({least['bound_by']}; "
                  f"least bytes {nbytes / 1e9:.3f} GB = {nbytes / ms / 1e6:.1f} GB/s), design bytes "
                  f"{design / 1e9:.3f} GB = {design / ms / 1e6:.1f} GB/s, plain {plain:.3f} ms "
                  f"({'kernel faster' if ms < plain else 'KERNEL SLOWER'})")
            print_tfcm_layers(shape, DILATIONS, smi)
            times.setdefault("tfcm_stack", (ms, plain))
        x, params = tfcm_inputs(*TFCM_STAGES[0], 1, device, SEED + 1)
        ms = cuda_ms(lambda: fused_tfcm_block_eval(x, params, dilation=1), reps=20)
        plain = cuda_ms(lambda: tfcm_stack_reference(x, params, (1,)), reps=5)
        nbytes = 2 * x.numel() * 4
        design = tfcm_design_bytes(TFCM_STAGES[0], (1,))
        print(f"tfcm block {list(TFCM_STAGES[0])} d=1 on {smi}: kernel {ms:.3f} ms = "
              f"{nbytes / ms / 1e6:.1f} GB/s of the least bytes, design bytes {design / 1e9:.3f} GB = "
              f"{design / ms / 1e6:.1f} GB/s, plain {plain:.3f} ms = {nbytes / plain / 1e6:.1f} GB/s "
              f"({'kernel faster' if ms < plain else 'KERNEL SLOWER'})")
        print_tfcm_layers(TFCM_STAGES[0], (1,), smi)
        times["tfcm_block"] = (ms, plain)
        del x, params
    # the forward at all three stage geometries, with and without the window
    # (ops/tattn_timing.py: kernel alone, wrapper, bound, library call,
    # instance), and at stage 0 the plain version
    times["tattn_stages"] = time_tattn_fwd(device, ATTN_STAGES, (WINDOW, None))
    bf, c, cv = ATTN_STAGES[0]
    q, k, v = attn_inputs(bf, c, cv, 626, device, SEED + 1)
    for row in times["tattn_stages"]:
        require(row["info"]["spill_bytes"] == 0, f"the tattn forward instance at c={row['c']}, C={row['C']} "
                f"spills nothing")
        require(row["traced"] == row["calls"] and row["launches_per_call"] <= 1,
                f"a profile of {row['calls']} tattn forward calls (window {row['window']}) saw each call's "
                f"kernel ({row['traced']}) and {row['launches_per_call']:.1f} <= 1 device launches a call")
        line = describe_tattn(row)
        if (row["bf"], row["c"], row["C"]) == (bf, c, cv):
            with torch.inference_mode():
                plain = cuda_ms(lambda: tattn_reference(q, k, v, row["window"]), reps=5)
            line += (f"; plain {plain:.3f} ms ({'kernel faster' if row['wrapper_ms'] < plain else 'KERNEL SLOWER'}; "
                     f"the plain logits are {bf * 626 * 626 * 4 / 1e9:.3f} GB)")
            times.setdefault("tattn", (row["wrapper_ms"], plain))
        print(f"{line} on {smi}", flush=True)
    del q, k, v
    with torch.inference_mode():
        b, t, f, t_dim, f_dim = MTFAA_DF[:5]
        spec, coefs, _ = df_inputs(*MTFAA_DF, device, SEED + 1)
        ms = cuda_ms(lambda: deep_filter(spec, coefs, t_dim, f_dim), reps=20)
        plain = cuda_ms(lambda: deep_filter_reference(spec, coefs, t_dim, f_dim), reps=5)
        nbytes = coefs.numel() * 4 + 2 * spec.numel() * 8
        least = bound(nbytes, spec.numel() * coefs.shape[3] * 4)
        print(f"deep_filter B={b} T={t} F={f} K={coefs.shape[3]} (config 5b) on {smi}: kernel "
              f"{ms:.3f} ms = {nbytes / ms / 1e6:.1f} GB/s, bound {least['bound_ms']:.4f} ms "
              f"({least['bound_by']}), plain {plain:.3f} ms "
              f"({'kernel faster' if ms < plain else 'KERNEL SLOWER'})")
    return times


def stage_inputs(b, k, c, t, d, device, seed):
    """Seeded inputs of the training kernels at one shape: x_ext [B,K,C,T+2d],
    two [B,K,C,T] tensors (an activation and a gradient), wd, and a
    BatchNorm's (mean, var, scale, bias) and PReLU slope off their defaults."""
    gen = torch.Generator(device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    stats = (randn(c, scale=0.3), torch.rand(c, generator=gen, device=device) + 0.5,
             1 + randn(c, scale=0.2), randn(c, scale=0.2),
             torch.rand((), generator=gen, device=device) * 0.25 + 0.05)
    return randn(b, k, c, t + 2 * d), randn(b, k, c, t), randn(b, k, c, t), randn(3, 3, c, scale=1 / 3), stats


def require_close(got, want, tol: float, what: str) -> float:
    err, scale = scaled_err(got, want)
    require(bool(torch.isfinite(got).all()) and err <= tol * scale,
            f"{what}: max-abs {err:.3g} <= {tol} x {scale:.3g}")
    return err


def check_train_kernels(device) -> dict:
    """The stencil (forward, backward), tail_bwd and mid_bwd against their plain
    versions on the card; returns each kernel's largest max-abs error."""
    worst = {"dw_fwd": 0.0, "dw_bwd": 0.0, "tail_bwd": 0.0, "mid_bwd": 0.0}
    cases = [(*shape, d) for shape in TFCM_STAGES for d in DILATIONS] + list(TRAIN_RAGGED)
    eps = 1e-5
    for b, k, c, t, d in cases:
        x_ext, h, g, wd, (m, v, ga, be, a) = stage_inputs(b, k, c, t, d, device, SEED)
        what = f"{(b, k, c, t)} d={d}"
        with torch.inference_mode():
            errs = [require_close(dw_stencil_fwd(x_ext, wd, d), dw_taps_reference(x_ext, wd, d),
                                  ELEMENT_TOL, f"dw_stencil_fwd {what}")]
            worst["dw_fwd"] = max(worst["dw_fwd"], *errs)
            got, want = dw_stencil_bwd(g, x_ext, wd, d), dw_bwd_reference(g, x_ext, wd, d)
            errs = [require_close(got[0], want[0], ELEMENT_TOL, f"dw_stencil_bwd dx {what}"),
                    require_close(got[1], want[1], SUM_TOL, f"dw_stencil_bwd dwd {what}")]
            require(torch.equal(dw_stencil_bwd(g, x_ext, wd, d)[1], got[1]),
                    f"dw_stencil_bwd dwd {what}: two calls give the same bits")
            worst["dw_bwd"] = max(worst["dw_bwd"], *errs)
            got = tail_bwd(g, h, m, v, ga, be, a, eps)
            want = tail_bwd_reference(g, h, m, v, ga, be, a, eps)
            errs = [require_close(got[0], want[0], ELEMENT_TOL, f"tail_bwd dh2n {what}")]
            errs += [require_close(x, y, SUM_TOL, f"tail_bwd {name} {what}")
                     for name, x, y in zip(("dgamma2", "dbeta2", "da2"), got[1:], want[1:])]
            worst["tail_bwd"] = max(worst["tail_bwd"], *errs)
            got = mid_bwd(g, h, wd, m, v, ga, be, a, d, eps)
            want = mid_bwd_reference(g, h, wd, m, v, ga, be, a, d, eps)
            errs = [require_close(got[0], want[0], ELEMENT_TOL, f"mid_bwd dh1n {what}")]
            errs += [require_close(x, y, SUM_TOL, f"mid_bwd {name} {what}")
                     for name, x, y in zip(("dwd", "dgamma1", "dbeta1", "da1", "dbd"), got[1:], want[1:])]
            worst["mid_bwd"] = max(worst["mid_bwd"], *errs)
        del x_ext, h, g, got, want
    worst["mid_bwd"] = max(worst["mid_bwd"], check_mid_tiles(device))
    fwd_err, bwd_err = check_dw_tiles(device)
    worst["dw_fwd"], worst["dw_bwd"] = max(worst["dw_fwd"], fwd_err), max(worst["dw_bwd"], bwd_err)
    return worst


def check_dw_tiles(device) -> tuple[float, float]:
    """The stencil's kernels at TRAIN_RAGGED's shapes and at the tiles of
    DW_TILINGS, into y, dx, the per-tile partial sums and dwd filled with NaN
    first (so a value the kernels never write shows): y and dx against the
    plain versions, the partials against theirs, dwd against the plain tap
    sums; first, that no instance at config 5b's tiles spills and that each
    holds the blocks an SM that dw_plan assumes. Returns the
    forward's and the backward's largest errors."""
    for backward in (False, True):
        smem = max(dw_plan(*shape, d, backward).smem for shape in TFCM_STAGES for d in DILATIONS)
        for vec in (1, 2, 4):
            info = dw_kernel_info(backward, vec, smem)
            require(info["spill_bytes"] == 0 and info["blocks_per_sm"] == DW_BLOCKS_PER_SM[backward],
                    f"the stencil's {'backward' if backward else 'forward'} instance with {4 * vec}-byte copies "
                    f"spills nothing and holds {info['blocks_per_sm']} = {DW_BLOCKS_PER_SM[backward]} blocks an "
                    f"SM at {smem} B, as dw_plan assumes ({info['registers']} registers)")
    worst = [0.0, 0.0]
    for b, k, c, t, d, kb, tt, shift in [(*shape, None, None, 0) for shape in TRAIN_RAGGED] + list(DW_TILINGS):
        gen = torch.Generator(device).manual_seed(SEED + 5)
        sizes = (b * k * c * (t + 2 * d), b * k * c * t)
        x_ext, g = (torch.randn(n + 4, generator=gen, device=device)[shift : shift + n] for n in sizes)
        x_ext, g = x_ext.view(b, k, c, t + 2 * d), g.view(b, k, c, t)
        wd = torch.randn((3, 3, c), generator=gen, device=device) / 3
        pf, pb = dw_plan(b, k, c, t, d, False, kb, tt), dw_plan(b, k, c, t, d, True, kb, tt)
        what = (f"{(b, k, c, t)} d={d}{', misaligned' if shift else ''}, tiles {pf.kb} x {pf.tt} forward, "
                f"{pb.kb} x {pb.tt} backward ({pb.tiles} a channel)")
        with torch.inference_mode():
            y = torch.full((b, k, c, t), float("nan"), device=device)
            launch_dw_fwd(x_ext, wd, d, pf, y)
            worst[0] = max(worst[0], require_close(y, dw_taps_reference(x_ext, wd, d), ELEMENT_TOL,
                                                   f"dw_stencil forward {what}"))
            dx, part, dwd = (z.fill_(float("nan")) for z in dw_bwd_buffers(x_ext, pb))
            launch_dw_bwd(g, x_ext, wd, d, pb, dx, part, dwd)
            want = dw_bwd_reference(g, x_ext, wd, d)
            worst[1] = max(worst[1], require_close(dx, want[0], ELEMENT_TOL, f"dw_stencil backward dx {what}"),
                           require_close(part, dw_partials_reference(g, x_ext, d, pb), SUM_TOL,
                                         f"dw_stencil backward partial sums {what}"),
                           require_close(dwd, want[1], SUM_TOL, f"dw_stencil backward dwd {what}"))
    return worst[0], worst[1]


def check_mid_tiles(device) -> float:
    """mid_bwd's two kernels at TRAIN_RAGGED's shapes and at the tiles of
    MID_TILINGS, into outputs and partials filled with NaN first (so a value
    the kernels never write shows): dh1n, each tile's partial sums (against
    their plain version) and the five sums; returns the largest error."""
    worst, eps = 0.0, 1e-5
    names = ("dwd", "dgamma1", "dbeta1", "da1", "dbd")
    for b, k, c, t, d, kb, tt in [(*shape, None, None) for shape in TRAIN_RAGGED] + list(MID_TILINGS):
        _, h, g, wd, (m, v, ga, be, a) = stage_inputs(b, k, c, t, d, device, SEED + 3)
        plan = mid_plan(b, k, c, t, d, kb, tt)
        what = f"{(b, k, c, t)} d={d}, tile {plan.kb} bands x {plan.tt} frames, {plan.tiles} a channel"
        with torch.inference_mode():
            dh1n, part, out = (x.fill_(float("nan")) for x in mid_buffers(h, plan))
            launch_mid(g, h, wd, m, v, ga, be, a, d, eps, plan, dh1n, part, out)
            want = mid_bwd_reference(g, h, wd, m, v, ga, be, a, d, eps)
            errs = [require_close(dh1n, want[0], ELEMENT_TOL, f"mid_bwd dh1n {what}"),
                    require_close(part, mid_partials_reference(g, h, wd, m, v, ga, be, a, d, eps, plan),
                                  SUM_TOL, f"mid_bwd partial sums {what}")]
            errs += [require_close(x, y, SUM_TOL, f"mid_bwd {name} {what}")
                     for name, x, y in zip(names, mid_sums(out, c), want[1:])]
        worst = max(worst, *errs)
    return worst


def check_attn_bwd(device) -> tuple[float, float]:
    """The attention's dq and dk/dv kernels against the plain dense backward on
    the card, through autograd on ``flash_tattn_tm`` (one launch of each a
    call), and both kernels again through ``_launch_dq`` and ``_launch_dkv``
    into dq, dk and dv filled with NaN first, fed by the forward kernel's
    output and logsumexp, so an element that no lane writes shows; first,
    that config 5b's three dq and three dk/dv instances spill nothing.
    Returns (dq, dk/dv) largest errors."""
    for _, c, cv in ATTN_STAGES:
        for name, instance_info in (("tattn_dq", tattn_dq_info), ("tattn_dkv", tattn_dkv_info)):
            info = instance_info(c, cv)
            require(info["spill_bytes"] == 0, f"the {name} instance at c={c}, C={cv} spills nothing "
                    f"({info['registers']} registers, {info['blocks_per_sm']} blocks an SM)")
    worst_dq = worst_dkv = 0.0
    cases = [(bf, c, cv, 626, w) for bf, c, cv in ATTN_STAGES for w in (WINDOW, None)]
    cases += [(64, 6, 24, 100, WINDOW),  # T < window
              (64, 8, 32, 200, WINDOW), (64, 12, 48, 200, 50),  # T off the 128 tile
              (5, 3, 12, 37, 7), (3, 2, 8, 300, None),
              (64, 6, 24, 1, WINDOW), (64, 6, 24, 31, WINDOW),  # T = 1, inside one 32-frame tile
              (64, 8, 32, 33, None), (64, 8, 32, 65, WINDOW),  # the last key block holds one key
              (64, 8, 32, 200, 1), (64, 8, 32, 200, 32),  # window 1 and one tile
              (1, 6, 24, 626, WINDOW),  # BF = 1
              (7, 3, 12, 300, WINDOW), (7, 16, 48, 300, WINDOW), (7, 16, 48, 300, None)]  # c = 3 / 16, C = 12 / 48
    for bf, c, cv, t, window in cases:
        q, k, v = attn_inputs(bf, c, cv, t, device, SEED)
        dout = attn_inputs(bf, c, cv, t, device, SEED + 1)[2]
        what = f"BF={bf} c={c} C={cv} T={t} window={window}"
        q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
        before = counts()
        out = flash_tattn_tm(q, k, v, window)  # forward with the logsumexp
        got = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        after = counts()
        require(all(after[n] - before[n] == 1 for n in ("tattn", "tattn_dq", "tattn_dkv")),
                f"tattn under autograd {what}: one forward, one dq and one dk/dv launch")
        with torch.inference_mode():
            want = tattn_bwd_reference(q, k, v, dout, window)
            require_close(out, tattn_reference(q, k, v, window), ATTN_TOL, f"tattn forward (lse) {what}")
            worst_dq = max(worst_dq, require_close(got[0], want[0], ATTN_TOL, f"tattn_dq {what}"))
            worst_dkv = max(worst_dkv, require_close(got[1], want[1], ATTN_TOL, f"tattn_dkv dk {what}"),
                            require_close(got[2], want[2], ATTN_TOL, f"tattn_dkv dv {what}"))
            out, lse = _launch_fwd(q, k, v, window, True, with_lse=True)
            dd = (dout * out).sum(dim=1)
            dq, dk, dv = torch.full_like(q, math.nan), torch.full_like(k, math.nan), torch.full_like(v, math.nan)
            _launch_dq(q, k, v, dout, lse, dd, window, dq)
            _launch_dkv(q, k, v, dout, lse, dd, window, dk, dv)
            worst_dq = max(worst_dq, require_close(dq, want[0], ATTN_TOL, f"tattn_dq into NaN {what}"))
            worst_dkv = max(worst_dkv, require_close(dk, want[1], ATTN_TOL, f"tattn_dkv dk into NaN {what}"),
                            require_close(dv, want[2], ATTN_TOL, f"tattn_dkv dv into NaN {what}"))
        del q, k, v, dout, out, lse, dd, got, want, dq, dk, dv
    return worst_dq, worst_dkv


def gradient_close(got, want, gscale: float) -> tuple[bool, float]:
    """A gradient leaf agrees: relative GRAD_REL_TOL, or GRAD_ABS_TOL of the largest gradient."""
    err = float((got - want).abs().max())
    return err <= GRAD_REL_TOL * float(want.abs().max()) or err <= GRAD_ABS_TOL * gscale, err


def check_tfcm_block_train(device) -> None:
    """tfcm_block_train's outputs and its 13 gradients against autograd through
    the plain block, on the card."""
    for (b, k, c, t), d in ((TFCM_STAGES[0], 4), (TFCM_STAGES[2], 1), ((2, 7, 12, 131), 64)):
        gen = torch.Generator(device).manual_seed(SEED + d)

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=device) * scale

        values = {"w1": randn(c, c, scale=c ** -0.5), "b1": randn(c, scale=0.1),
                  "g1": 1 + randn(c, scale=0.2), "be1": randn(c, scale=0.2),
                  "a1": torch.tensor(0.2, device=device), "wd": randn(3, 3, c, scale=1 / 3),
                  "bd": randn(c, scale=0.1), "g2": 1 + randn(c, scale=0.2),
                  "be2": randn(c, scale=0.2), "a2": torch.tensor(0.1, device=device),
                  "w2": randn(c, c, scale=c ** -0.5), "b2": randn(c, scale=0.1)}
        x, g = randn(b, k, c, t, scale=0.5), randn(b, k, c, t)
        results = []
        for fn in (tfcm_block_train, tfcm_block_reference):
            leaves = [x.clone().requires_grad_()] + [values[n].clone().requires_grad_() for n in PARAM_NAMES]
            out = fn(leaves[0], tuple(leaves[1:]), d, 1e-5)
            grads = torch.autograd.grad(out[0], leaves, g)
            results.append(([o.detach() for o in out], grads))
            del out, leaves
        torch.cuda.synchronize()
        what = f"tfcm_block_train {(b, k, c, t)} d={d}"
        for name, got, want in zip(("y", "new_hist", "m1", "v1", "m2", "v2"), results[0][0], results[1][0]):
            require_close(got, want, ELEMENT_TOL, f"{what} {name}")
        gscale = max(float(w.abs().max()) for w in results[1][1])
        for name, got, want in zip(("x",) + PARAM_NAMES, results[0][1], results[1][1]):
            ok, err = gradient_close(got, want, gscale)
            if name in ("b1", "bd"):  # they feed a BatchNorm: zero but for rounding, on both sides
                ok = err <= GRAD_ABS_TOL * gscale
            require(ok, f"{what} d{name}: max-abs {err:.3g} (relative {GRAD_REL_TOL} or "
                    f"{GRAD_ABS_TOL} x {gscale:.3g})")
        del results, x, g


def noisy_clean_pairs(seed: int, b: int, seconds: int, device):
    """Seeded (noisy, clean) batches [B, L] on the card."""
    noisy = np.stack(noisy_utterances(seed, (seconds * SR,) * b))
    rng = np.random.default_rng(seed + 1000)
    noise = (0.03 * rng.standard_normal(noisy.shape)).astype(np.float32)
    return {"noisy": torch.from_numpy(noisy).to(device), "clean": torch.from_numpy(noisy - noise).to(device)}


def train_config() -> StepConfig:
    """The step of configs/mtfaa_windowed.toml in float32, at a constant rate as
    the reference's benchmark runs it (the config's 500-step warm-up would
    start from a rate of 0, and three steps would move nothing)."""
    config = load_config(str(ROOT / "configs" / "mtfaa_windowed.toml"))
    ac, opt = config["acoustics"], config["optimizer"]
    return StepConfig(stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"])),
                      learning_rate=float(opt["lr"]), beta1=float(opt["beta1"]), beta2=float(opt["beta2"]),
                      clip_grad_norm=float(config["trainer"]["train"]["clip_grad_norm_value"]),
                      loss_weights=tuple(sorted((k, float(v)) for k, v in config["loss"]["weights"].items())))


def named_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def check_train_steps(config, b: int, seconds: int, seed: int, device, what: str,
                      expected: dict) -> dict:
    """Drive make_train_step for TRAIN_STEPS steps at full width; returns the
    launches it made. Before that, the first batch's losses, gradients and
    BatchNorm statistics against the same weights with every kernel swapped for
    its plain version, in float32 and in float64.

    Why float64: a gradient that has come down through all 24 TFCM blocks, the
    phase encoder's square root and the spectral loss's power law carries the
    rounding of every float32 sum above it, and the plain float32 versions
    themselves miss the float64 gradient of the phase encoder's leaves by about
    1e-2 of the largest gradient. So the comparison is leaf by leaf: a leaf of
    the kernels' run passes when it is within GRAD_REL_TOL of the float64 leaf,
    or within GRAD_ABS_TOL of the largest gradient, or no further from the
    float64 leaf than GRAD_NOISE_FACTOR times what the plain float32 run's
    SAME leaf is. A wrong gradient of a leaf whose float32 rounding is small
    fails, however noisy other leaves are."""
    cfg = train_config()
    batches = [noisy_clean_pairs(seed + i, b, seconds, device) for i in range(TRAIN_STEPS)]
    runs = {}
    for name, dtype in (("float64", torch.float64), ("plain", torch.float32), ("kernels", torch.float32)):
        model = build_mtfaa(config, device, seed).to(dtype)
        set_plain_mtfaa(model, name != "kernels")
        state = init_train_state(model, cfg, device)
        grads, losses, _ = make_loss_gradients(model, cfg)(
            state.balancer_state, {k: v.to(dtype) for k, v in batches[0].items()})
        torch.cuda.synchronize()
        runs[name] = ([g.double() for g in grads], losses, named_state(model))
        del grads
        if name != "kernels":
            del model, state
            torch.cuda.empty_cache()
    (grads, losses, stats), (plain_grads, ref_losses, ref_stats) = runs["kernels"], runs["plain"]
    exact = runs["float64"][0]
    for name in losses:
        err = abs(float(losses[name]) - float(ref_losses[name]))
        require(err <= 1e-4 * max(1.0, abs(float(ref_losses[name]))),
                f"{what}: loss {name} {float(losses[name]):.6g}, kernels vs plain versions {err:.3g}")
    gscale = max(float(g.abs().max()) for g in exact)
    worst, worst_noise, worst_ratio, by_noise, bad = 0.0, 0.0, 0.0, 0, []
    for (name, _), got, plain, want in zip(model.named_parameters(), grads, plain_grads, exact):
        ok, err = gradient_close(got, want, gscale)
        noise = float((plain - want).abs().max())  # this leaf's float32 rounding, plain versions
        worst, worst_noise = max(worst, err), max(worst_noise, noise)
        if not ok:
            by_noise += 1
            worst_ratio = max(worst_ratio, err / noise if noise > 0 else math.inf)
            if err > GRAD_NOISE_FACTOR * noise:
                bad.append((name, f"err {err:.3g}", f"plain float32's {noise:.3g}",
                            f"leaf max {float(want.abs().max()):.3g}"))
    require(not bad, f"{what}: {len(grads)} gradient leaves against the float64 plain step: kernels' "
            f"worst {worst / gscale:.3g} of the largest gradient {gscale:.3g}, plain float32's worst "
            f"{worst_noise / gscale:.3g}; {by_noise} leaves beyond relative {GRAD_REL_TOL} and "
            f"{GRAD_ABS_TOL} of the largest, each held to {GRAD_NOISE_FACTOR} x the same leaf's plain "
            f"float32 error (worst ratio {worst_ratio:.3g}); failing {bad[:10]}")
    err = max(float((stats[k] - ref_stats[k]).abs().max() / max(1.0, float(ref_stats[k].abs().max())))
              for k in ref_stats if k.endswith((".mean", ".var")))
    require(err <= 1e-4, f"{what}: BatchNorm running statistics, kernels vs plain versions {err:.3g} <= 1e-4")
    del runs, grads, plain_grads, exact

    before = named_state(model)
    step = make_train_step(model, cfg)
    reset_counts()
    metrics = []
    for data in batches:
        state, m = step(state, data)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launched = counts()
    require(launched == {k: v * TRAIN_STEPS for k, v in expected.items()},
            f"{what}: {TRAIN_STEPS} train steps launched {launched} = {TRAIN_STEPS} x {expected}")
    require(all(math.isfinite(v) for m in metrics for v in m.values())
            and all(m["nonfinite_skipped"] == 0 for m in metrics)
            and state.step == TRAIN_STEPS and state.opt_state.count == TRAIN_STEPS,
            f"{what}: finite losses and gradient norms {metrics}")
    after = named_state(model)
    stuck = [k for k in before if torch.equal(before[k], after[k])]
    require(all(k.endswith("bias") for k in stuck) and len(stuck) <= len(before) // 10,
            f"{what}: {len(before) - len(stuck)} of {len(before)} parameters and BatchNorm "
            f"statistics moved (all but biases whose gradient is exactly zero: {stuck})")

    bad = {k: v.clone() for k, v in batches[0].items()}
    bad["noisy"][0, 1000] = float("nan")
    kept = [t.clone() for t in state.opt_state.mu + state.opt_state.nu] + list(state.balancer_state.total.values())
    new_state, m = step(state, bad)
    require(float(m["nonfinite_skipped"]) == 1.0 and new_state.opt_state.count == TRAIN_STEPS
            and all(torch.equal(after[k], v) for k, v in model.state_dict().items())
            and all(torch.equal(a, b) for a, b in zip(
                kept, new_state.opt_state.mu + new_state.opt_state.nu
                + list(new_state.balancer_state.total.values()))),
            f"{what}: a step on a batch with a NaN is skipped and changes nothing")
    return launched


def library_ms(device) -> dict:
    """Times (ms) of the PyTorch calls that compute a kernel's function, on
    tensors already in the library's layout, at the main paths' shapes.
    Timed here and used nowhere in the port."""
    import torch.nn.functional as F
    times = {}
    b, k, c, t = TFCM_STAGES[0]
    d = 1
    x_ext, _, g, wd, _ = stage_inputs(b, k, c, t, d, device, SEED + 1)
    with torch.inference_mode():
        x = x_ext.permute(0, 2, 1, 3).contiguous()  # [B, C, K, T + 2d]: cuDNN's NCHW
        w = wd.permute(2, 1, 0)[:, None].contiguous()  # [C, 1, band tap, time tap]
        gy = g.permute(0, 2, 1, 3).contiguous()
        conv = lambda: F.conv2d(x, w, None, 1, (1, 0), (1, d), c)  # noqa: E731
        require_close(conv().permute(0, 2, 1, 3), dw_stencil_fwd(x_ext, wd, d), 1e-4,
                      "cuDNN depthwise conv2d computes the stencil")
        times["dw_fwd"] = cuda_ms(conv, reps=10)
        times["dw_bwd"] = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            gy, x, w, None, (1, 1), (1, 0), (1, d), False, (0, 0), c, (True, True, False)), reps=10)
    del x_ext, g, x, gy
    # the attention's library times come from ops/tattn_timing.py

    b, t, g_, h = CONFIG1_GRU
    gru = torch.nn.GRU(h, h, batch_first=True).to(device)
    x = torch.randn(b, t, h, device=device)
    with torch.inference_mode():
        times["gru"] = g_ * cuda_ms(lambda: gru(x), reps=3)  # one call a group
    return times


def time_train_kernels(device, smi, lib: dict) -> dict:
    """Each training kernel and its plain version at stage 0 (ms), with the
    bytes it must move and the multiply-adds it does; tail_bwd and mid_bwd
    also at every stage and d (``time_tfcm_bwd_stages``); prints them."""
    entries = {}
    b, k, c, t = TFCM_STAGES[0]
    d, eps = 1, 1e-5
    x_ext, h, g, wd, (m, v, ga, be, a) = stage_inputs(b, k, c, t, d, device, SEED + 1)
    points, tensor = b * k * c * t, b * k * c * t * 4
    ext = x_ext.numel() * 4
    cases = {  # name: (kernel, plain, least bytes, multiply-adds, library ms)
        "dw_stencil_fwd": (lambda: dw_stencil_fwd(x_ext, wd, d), lambda: dw_taps_reference(x_ext, wd, d),
                           ext + tensor, 9 * points, lib["dw_fwd"]),
        "dw_stencil_bwd": (lambda: dw_stencil_bwd(g, x_ext, wd, d), lambda: dw_bwd_reference(g, x_ext, wd, d),
                           2 * ext + tensor, 18 * points, lib["dw_bwd"]),
        "tail_bwd": (lambda: tail_bwd(g, h, m, v, ga, be, a, eps),
                     lambda: tail_bwd_reference(g, h, m, v, ga, be, a, eps), 3 * tensor, 6 * points, None),
        # dh1a and the tap sums 9 each, BN1 2, the other sums 4
        "mid_bwd": (lambda: mid_bwd(g, h, wd, m, v, ga, be, a, d, eps),
                    lambda: mid_bwd_reference(g, h, wd, m, v, ga, be, a, d, eps), 3 * tensor,
                    24 * points, None),
    }
    with torch.inference_mode():
        for name, (kernel, plain, nbytes, fmas, library) in cases.items():
            ms, plain_ms = cuda_ms(kernel, reps=20), cuda_ms(plain, reps=5)
            entries[name] = {"ms": ms, "plain_ms": plain_ms, **bound(nbytes, fmas), "library_ms": library}
            print(f"{name} {[b, k, c, t]} d={d} on {smi}: kernel {ms:.3f} ms = {nbytes / ms / 1e6:.1f} GB/s "
                  f"of {nbytes / 1e6:.1f} MB, bound {entries[name]['bound_ms']:.4f} ms "
                  f"({entries[name]['bound_by']}), plain {plain_ms:.3f} ms, library "
                  f"{'none' if library is None else f'{library:.3f} ms'} "
                  f"({'kernel faster' if ms < plain_ms else 'KERNEL SLOWER'} than plain)")
    del x_ext, h, g
    time_tfcm_bwd_stages(device, smi)
    for name, stages in time_dw_stages(device, smi).items():
        entries[name]["stages"] = stages

    # the backward's two kernels at all three stage geometries, with and
    # without the window (ops/tattn_timing.py: kernel alone, wrapper, bound,
    # the library's backward, the dk/dv instance), and at stage 0 the plain
    # dense backward; the JSON line keeps the windowed stage-0 case, config 5b's
    bf, cq, cv = ATTN_STAGES[0]
    q, kk, vv = attn_inputs(bf, cq, cv, 626, device, SEED + 1)
    dout = attn_inputs(bf, cq, cv, 626, device, SEED + 2)[2]
    plain = {}
    with torch.inference_mode():
        for window in (WINDOW, None):
            plain[window] = cuda_ms(lambda: tattn_bwd_reference(q, kk, vv, dout, window), reps=3)
    del q, kk, vv, dout
    for row in time_tattn_bwd(device, ATTN_STAGES, (WINDOW, None)):
        name = f"tattn_{row['kind']}"
        if row["info"] is not None:
            require(row["info"]["spill_bytes"] == 0,
                    f"the {name} instance at c={row['c']}, C={row['C']} spills nothing")
        require(row["traced"] == row["calls"] and row["launches_per_call"] <= 1,
                f"a profile of {row['calls']} {name} calls (BF={row['bf']}, window {row['window']}) saw each "
                f"call's kernel ({row['traced']}) and {row['launches_per_call']:.1f} <= 1 device launches a call")
        line = describe_tattn(row)
        if row["bf"] == bf:
            line += f"; plain dense backward (dq, dk and dv together) {plain[row['window']]:.3f} ms"
            entries.setdefault(name, {"ms": row["wrapper_ms"], "plain_ms": plain[row["window"]], "stages": [],
                                      **{key: row[key] for key in ("bound_ms", "bound_by", "library_ms")}})
        entries[name]["stages"].append({key: row[key] for key in STAGE_KEYS})
        print(f"{line} on {smi}", flush=True)
    return entries


def time_dw_stages(device, smi) -> dict:
    """The stencil's forward and backward at config 5b's four stage shapes and
    d = 1, 2, 4, 8 (``ops/dw_timing.py``): kernels alone, wrapper, device
    launches a call, the bound, cuDNN's call, the tile and its instance; a
    step's 24 calls of each against their summed bound. Checks that a call
    is at most its kernels' launches and that no instance spills. Returns
    the kernels line's ``stages`` of each."""
    rows = time_dw(device, TFCM_STAGES, DILATIONS)
    for row in rows:
        require(row["launches_per_call"] <= DW_LAUNCHES_PER_CALL[row["kind"]] and row["info"]["spill_bytes"] == 0,
                f"a dw_stencil {row['kind']} call is {row['launches_per_call']:.1f} <= "
                f"{DW_LAUNCHES_PER_CALL[row['kind']]} device launches, its instance spills nothing "
                f"({row['shape']}, d={row['d']})")
        print(f"{describe_dw(row)} on {smi}", flush=True)
    for kind in ("forward", "backward"):
        print(f"{describe_step(rows, kind)} on {smi}")
    return {f"dw_stencil_{'fwd' if kind == 'forward' else 'bwd'}":
            [{key: row[key] for key in DW_STAGE_KEYS} for row in rows if row["kind"] == kind]
            for kind in ("forward", "backward")}


def time_tfcm_bwd_stages(device, smi) -> None:
    """tail_bwd and mid_bwd at config 5b's four stage shapes and d = 1, 2, 4,
    8 (``ops/tfcm_bwd_timing.py``): the wrapper, the kernels alone, device
    launches a call, the bound; mid_bwd's tile and what the card reports of
    it; a step's 24 calls of each against their summed bound. Checks that
    a mid_bwd call is at most two device launches."""
    rows = time_tfcm_bwd(device, TFCM_STAGES, DILATIONS)
    for row in rows:
        line = describe(row)
        if row["kernel"] == "mid_bwd":
            plan = mid_plan(*row["shape"], row["d"])
            info = mid_kernel_info(plan.smem)
            line += (f"; tile {plan.kb} bands x {plan.tt} frames, {plan.tiles * row['shape'][2]} blocks, "
                     f"{plan.smem} B of shared memory a block, {info['blocks_per_sm']} blocks an SM, "
                     f"{info['threads']} threads, {info['registers']} registers, {info['spill_bytes']} B spilled")
            require(row["launches_per_call"] <= MID_LAUNCHES_PER_CALL,
                    f"a mid_bwd call is {row['launches_per_call']:.1f} <= {MID_LAUNCHES_PER_CALL} device "
                    f"launches ({row['shape']}, d={row['d']}, profile)")
        print(f"{line} on {smi}", flush=True)
    for name in ("tail_bwd", "mid_bwd"):
        mine = [r for r in rows if r["kernel"] == name]
        step = {key: sum(r[key] for stage in STACK_STAGES for r in mine
                         if list(r["shape"]) == list(TFCM_STAGES[stage]))
                * (len(DILATIONS) if name == "tail_bwd" else 1)
                for key in ("kernel_ms", "wrapper_ms", "bound_ms")}
        print(f"{name}, a config-5b train step's {6 * len(DILATIONS)} calls (6 stacks at stages "
              f"{STACK_STAGES} x d = {DILATIONS}) on {smi}: kernels alone {step['kernel_ms']:.3f} ms, "
              f"wrappers {step['wrapper_ms']:.3f} ms, summed bound {step['bound_ms']:.3f} ms (bytes)")


def time_train_step(device, smi) -> None:
    """One B=16 x 10 s config-5b train step with the kernels and with the plain
    versions (wall ms after a warm-up, peak memory), and a profile of a step."""
    cfg = train_config()
    data = noisy_clean_pairs(SEED + 7, MTFAA_BATCH, MTFAA_SECONDS, device)
    profiled = False
    for plain in (True, False, False, True):
        model = build_mtfaa(None, device, SEED + 4)
        set_plain_mtfaa(model, plain)
        state = init_train_state(model, cfg, device)
        step = make_train_step(model, cfg)
        state, _ = step(state, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, data)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"MTFAA config 5b train step B={MTFAA_BATCH} x {MTFAA_SECONDS} s, f32, on {smi}, "
              f"{'plain versions' if plain else 'kernels'}: {ms:.1f} ms a step = "
              f"{MTFAA_BATCH * MTFAA_SECONDS / ms * 1e3:.1f} s of audio a second, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if not plain and not profiled:
            profiled = True
            box = {"state": state}

            def one_step():
                box["state"], _ = step(box["state"], data)

            prof = profile_calls(one_step, 2, f"B={MTFAA_BATCH} x {MTFAA_SECONDS} s config-5b train step, kernels")
            mid_ms = sum(prof.device_ms.get(name, 0.0) for name in ("mid_tile_kernel", "mid_finish_kernel"))
            print(f"config-5b train step on {smi}: mid_bwd's kernels {mid_ms:.3f} ms a step in "
                  f"{sum(prof.launches.get(n, 0.0) for n in ('mid_tile_kernel', 'mid_finish_kernel')):.1f} "
                  f"launches; the stencil forward's {prof.device_ms.get('dw_fwd_kernel', 0.0):.3f} ms in "
                  f"{prof.launches.get('dw_fwd_kernel', 0.0):.1f} launches (their summed bound "
                  f"{sum(dw_bound(TFCM_STAGES[i], d, 'forward')['bound_ms'] for i in STACK_STAGES for d in DILATIONS):.3f} "
                  f"ms); "
                  f"{prof.kernels:.1f} device launches a step")
            require(prof.kernels <= STEP_KERNELS_BEFORE - 96,
                    f"the config-5b train step's profile shows {prof.kernels:.1f} device launches a step "
                    f"<= {STEP_KERNELS_BEFORE} - 96")
            del box
        del model, state, step
        torch.cuda.empty_cache()


class Profile(NamedTuple):
    launches: dict  # *_kernel function -> launches a call
    device_ms: dict  # *_kernel function -> device ms a call
    kernels: float  # device launches a call, all kernels


def profile_calls(fn, calls: int, label: str) -> Profile:
    """torch.profiler over `calls` calls of fn: device time by kernel (the 20
    that take most, then every hand-written kernel the calls launched, its
    template instances summed, with the share of the busy time they take
    together), the device's busy time per call (union of kernel intervals)
    and its idle share against the call's wall time measured without the
    profiler. Returns the launches and device time a call of every
    ``*_kernel`` function, and the device launches a call."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up, then the calls timed without the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name: dict = {}
    for e in kernels:
        total, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + e["dur"], n + 1)
    busy, end = 0.0, -math.inf
    for start, dur in sorted((e["ts"], e["dur"]) for e in kernels):
        busy += max(0.0, start + dur - max(start, end))
        end = max(end, start + dur)
    busy_ms = busy / calls / 1e3
    print(f"profile, {label}: {len(kernels) / calls:.1f} kernels per call, device busy "
          f"{busy_ms:.4f} ms per call of {wall_ms:.4f} ms wall (without the profiler): "
          f"idle {1 - busy_ms / wall_ms:.1%}")
    for name, (total, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {total / calls:10.2f} us/call  {n / calls:5.1f}/call  {name[:100]}")
    named = {}  # every *_kernel function, its template instances summed
    for name, (total, n) in by_name.items():
        match = re.search(r"\b(\w+_kernel)\b", name)
        if match:
            had = named.get(match.group(1), (0.0, 0))
            named[match.group(1)] = (had[0] + total, had[1] + n)
    own = {name: v for name, v in named.items() if name in HAND_WRITTEN}
    own_ms = sum(total for total, _ in own.values()) / calls / 1e3
    print(f"  hand-written kernels, {label}: {own_ms:.4f} ms per call = {own_ms / busy_ms:.1%} of the busy time")
    for name, (total, n) in sorted(own.items(), key=lambda kv: -kv[1][0]):
        print(f"  {total / calls:10.2f} us/call  {n / calls:5.1f}/call  {total / n:9.2f} us each  {name}")
    return Profile({name: n / calls for name, (_, n) in named.items()},
                   {name: total / calls / 1e3 for name, (total, _) in named.items()}, len(kernels) / calls)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    if Path(cruse_tpu_torch.__file__).resolve().parent != ROOT / "cruse_tpu_torch":
        print(f"chip_smoke: run it from the repository root, not {ROOT}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi name, power.limit: {smi}", flush=True)

    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.load_library, KERNELS))
    gru_err = check_gru_kernel(device)

    inferencer = build_inferencer(device)
    launches = check_main_path(inferencer)

    gru_times = time_gru_kernels(device, smi)
    kernel_ms, plain_ms = gru_times["routed"], gru_times["plain"]

    seconds = 10
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal((256, seconds * SR))
                         .astype(np.float32) * 0.1).to(device)
    kernel_s = enhancement_seconds(inferencer.mag_to_mag, x)
    set_recurrence(inferencer.model, gru_sequence_reference)
    plain_s = enhancement_seconds(inferencer.mag_to_mag, x, reps=1)
    set_recurrence(inferencer.model, gru_sequence)
    print(f"enhancement B=256 x {seconds} s on {smi}: {kernel_s * 1e3:.1f} ms = "
          f"{256 * seconds / kernel_s:.1f}x realtime with the kernel; plain recurrence "
          f"{plain_s * 1e3:.1f} ms = {256 * seconds / plain_s:.1f}x realtime")
    profile_calls(lambda: inferencer.mag_to_mag(x), 2, f"B=256 x {seconds} s config-1 mag_to_mag")
    del inferencer

    df_err = check_df_kernel(device)
    model = build_cruse_df(device)
    stream_gru, stream_df = check_streaming(model, device)
    auto_gru, auto_df = check_auto_path(model, device)

    b, t, f, t_dim, f_dim = CONFIG3_DF[:5]
    spec, coefs, _ = df_inputs(*CONFIG3_DF, device, SEED + 2)
    with torch.inference_mode():
        df_ms = cuda_ms(lambda: deep_filter(spec, coefs, t_dim, f_dim), reps=10)
        df_plain_ms = cuda_ms(lambda: deep_filter_reference(spec, coefs, t_dim, f_dim), reps=2)
    nbytes = coefs.numel() * 4 + 2 * spec.numel() * 8  # coefficients + spectrum + output, once
    print(f"deep_filter B={b} T={t} F={f} K={coefs.shape[3]} on {smi}: kernel {df_ms:.3f} ms = "
          f"{nbytes / df_ms / 1e6:.1f} GB/s of {nbytes / 1e9:.3f} GB, plain {df_plain_ms:.3f} ms = "
          f"{nbytes / df_plain_ms / 1e6:.1f} GB/s "
          f"({'kernel faster' if df_ms < df_plain_ms else 'KERNEL SLOWER'})")
    del spec, coefs

    enh = StreamingEnhancer(model, StftConfig(n_fft=320, hop_length=160, center=False))
    wav = torch.from_numpy(np.random.default_rng(SEED).standard_normal((256, seconds * SR))
                           .astype(np.float32) * 0.1).to(device)
    hop = enh.cfg.hop_length
    audio = 256 * ((wav.shape[-1] - (enh.cfg.n_fft - hop)) // hop) * hop / SR
    stream_kernel_s = stream_seconds(enh, wav)
    set_plain(model, True)
    stream_plain_s = stream_seconds(enh, wav)
    set_plain(model, False)
    print(f"streaming CRUSE+DF B=256 x {seconds} s ({audio / 256:.2f} s streamed) on {smi}: "
          f"{stream_kernel_s * 1e3:.1f} ms = {audio / stream_kernel_s:.1f}x realtime with the "
          f"kernels; plain versions {stream_plain_s * 1e3:.1f} ms = "
          f"{audio / stream_plain_s:.1f}x realtime")
    rtf = enh.measure_rtf(noisy_utterances(SEED, (2 * SR,))[0][None], sr=SR, num_frames=150)
    print(f"streaming CRUSE+DF B=1 on {smi}: {rtf * hop / SR * 1e3:.4f} ms per {hop}-sample hop, "
          f"rtf {rtf:.4f}")
    profile_stream(enh, wav)
    del enh, wav, model
    torch.cuda.empty_cache()

    tfcm_err, block_err = check_tfcm_kernel(device)
    attn_err = check_attn_kernel(device)
    mtfaa = build_mtfaa(None, device, SEED + 4)
    inferencer = mtfaa_inferencer(mtfaa, device)
    stack_launches, attn_launches, mtfaa_df = check_mtfaa_path(inferencer)
    causal_inferencer = mtfaa_inferencer(build_mtfaa(MtfaaConfig(), device, SEED + 6), device)
    x = torch.from_numpy(np.stack(noisy_utterances(
        SEED + 2, (CAUSAL_SECONDS * SR,) * CAUSAL_BATCH))).to(device)
    check_mtfaa_forward(causal_inferencer, x, f"config 5 (full-causal attention) "
                        f"B={CAUSAL_BATCH} x {CAUSAL_SECONDS} s")
    del causal_inferencer
    block_launches = check_tfcm_block_path(device)
    torch.cuda.empty_cache()

    times = time_mtfaa_kernels(device, smi)
    b, seconds = MTFAA_BATCH, MTFAA_SECONDS
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal((b, seconds * SR))
                         .astype(np.float32) * 0.1).to(device)
    kernel_s = enhancement_seconds(inferencer.auto, x)
    set_plain_mtfaa(mtfaa, True)
    plain_s = enhancement_seconds(inferencer.auto, x, reps=2)
    set_plain_mtfaa(mtfaa, False)
    print(f"MTFAA config 5b auto enhancement B={b} x {seconds} s on {smi}: {kernel_s * 1e3:.1f} ms = "
          f"{b * seconds / kernel_s:.1f}x realtime with the kernels; plain versions "
          f"{plain_s * 1e3:.1f} ms = {b * seconds / plain_s:.1f}x realtime")
    launched = profile_calls(lambda: inferencer.auto(x), 3, f"B={b} x {seconds} s config-5b auto forward").launches
    require(launched.get("tfcm_layer_kernel") == 6 * len(DILATIONS) and "tfcm_eval_kernel" not in launched,
            f"the config-5b forward's profile shows {launched.get('tfcm_layer_kernel')} tfcm_layer_kernel "
            f"launches = 6 stacks x {len(DILATIONS)} layers, and no launch of the whole-ladder kernel")

    del inferencer, mtfaa, x
    torch.cuda.empty_cache()

    train_errs = check_train_kernels(device)
    dq_err, dkv_err = check_attn_bwd(device)
    check_tfcm_block_train(device)
    torch.cuda.empty_cache()
    train_launches = check_train_steps(
        None, MTFAA_BATCH, MTFAA_SECONDS, SEED + 8, device,
        f"config-5b train step B={MTFAA_BATCH} x {MTFAA_SECONDS} s", STEP_LAUNCHES)
    torch.cuda.empty_cache()
    pallas_launches = check_train_steps(
        MtfaaConfig(attention_window=WINDOW, tfcm_dw_impl="pallas"), CAUSAL_BATCH, CAUSAL_SECONDS,
        SEED + 9, device, f'config-5b train step, "pallas" TFCM route, B={CAUSAL_BATCH} x {CAUSAL_SECONDS} s',
        dict(STEP_LAUNCHES, dw_stencil_bwd=24, tail_bwd=0, mid_bwd=0))
    check_train_steps(MtfaaConfig(), CAUSAL_BATCH, CAUSAL_SECONDS, SEED + 10, device,
                      f"config-5 train step (full-causal attention) B={CAUSAL_BATCH} x {CAUSAL_SECONDS} s",
                      STEP_LAUNCHES)
    torch.cuda.empty_cache()

    lib = library_ms(device)
    print(f"library calls on {smi}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in lib.items()))
    train_times = time_train_kernels(device, smi, lib)
    time_train_step(device, smi)

    # least bytes (each input read once, each output written once) and
    # multiply-adds of the kernels of the earlier slices, at the timed shapes
    b, t, g, h = CONFIG1_GRU
    gru_bound = bound(4 * (b * t * g * 4 * h + 2 * b * g * h + g * 3 * h * h + g * 3 * h),
                      b * t * g * 3 * h * h)
    b, t, f = CONFIG3_DF[:3]
    taps = (2 * CONFIG3_DF[3] + 1) * (2 * CONFIG3_DF[4] + 1)
    df_bound = bound(b * t * f * (8 * taps + 16), b * t * f * taps * 4)
    b, k, c, t = TFCM_STAGES[0]
    layer_fmas = b * k * t * c * (2 * c + 9)
    stack_bound = bound(2 * 4 * b * k * c * t, len(DILATIONS) * layer_fmas)
    block_bound = bound(2 * 4 * b * k * c * t, layer_fmas)
    attn_row = times["tattn_stages"][0]  # stage 0, window 126

    def entry(name, source, replaces, launches, err, times, bounds, library):
        return {"name": name, "route": "cuda", "source": f"cruse_tpu_torch/ops/csrc/{source}.cu",
                "replaces": f"cruse_tpu/ops/{replaces}", "launches": launches, "max_abs_err": err,
                "ms": times[0], "plain_ms": times[1], **bounds, "library_ms": library}

    def train_entry(name, source, replaces, launches, err):
        e = train_times[name]
        return {**entry(name, source, replaces, launches, err, (e["ms"], e["plain_ms"]),
                        {"bound_ms": e["bound_ms"], "bound_by": e["bound_by"]}, e["library_ms"]),
                **({"stages": e["stages"]} if "stages" in e else {})}

    print(json.dumps({"kernels": [
        {**entry("gru_sequence", "gru_sequence", "gru_kernel.py:82", launches + stream_gru + auto_gru,
                 gru_err, (kernel_ms, plain_ms), gru_bound, lib["gru"]),
         "resident_ms": gru_times["f32"][0], "streamed_ms": gru_times["f32"][1]},
        entry("deep_filter", "deep_filter", "deep_filter_kernel.py:91", stream_df + auto_df + mtfaa_df,
              df_err, (df_ms, df_plain_ms), df_bound, None),
        entry("tfcm_stack", "tfcm_eval", "tfcm_kernel.py:212", stack_launches, tfcm_err,
              times["tfcm_stack"], stack_bound, None),
        entry("tfcm_block", "tfcm_eval", "tfcm_kernel.py:103", block_launches, block_err,
              times["tfcm_block"], block_bound, None),
        {**entry("tattn", "tattn", "asa_kernel.py:190", attn_launches + train_launches["tattn"], attn_err,
                 times["tattn"], {key: attn_row[key] for key in ("bound_ms", "bound_by")}, attn_row["library_ms"]),
         "stages": [{key: row[key] for key in STAGE_KEYS} for row in times["tattn_stages"]]},
        train_entry("dw_stencil_fwd", "dw_stencil", "dw_kernel.py:154", train_launches["dw_stencil_fwd"],
                    train_errs["dw_fwd"]),
        train_entry("dw_stencil_bwd", "dw_stencil", "dw_kernel.py:197", pallas_launches["dw_stencil_bwd"],
                    train_errs["dw_bwd"]),
        train_entry("tail_bwd", "tfcm_bwd", "tfcm_bwd_kernels.py:92", train_launches["tail_bwd"],
                    train_errs["tail_bwd"]),
        train_entry("mid_bwd", "tfcm_bwd", "tfcm_bwd_kernels.py:236", train_launches["mid_bwd"],
                    train_errs["mid_bwd"]),
        train_entry("tattn_dq", "tattn_bwd", "asa_kernel.py:266", train_launches["tattn_dq"], dq_err),
        train_entry("tattn_dkv", "tattn_bwd", "asa_kernel.py:282", train_launches["tattn_dkv"], dkv_err),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
