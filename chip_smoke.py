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
6. holds the deep-filter kernels against their plain versions within 1e-5:
   the forward at config 3's offline shape (B=64, T=1001, F=96, t=2, f=1, the
   low bins of a 161-bin spectrum), the streaming hop's (B=256, T=1, with
   history), config 5b's streaming hop (B=64, T=1, all 257 bins, with
   history), both hops in the server's pools (B=16 and B=8), ragged ones
   (T < 2*t_dim, a symmetric layout) and MTFAA's (B=16, T=626, all 257
   bins, t=1, f=1), the backward at each of them without
   history (two calls giving the same bits), both through autograd (one
   launch each), and both at forced ``df_plan`` tiles (T off the span, T <
   2*t_dim, one span, a misaligned coefficient base, the strided 161-bin
   slice, F=257 whole and split) into outputs filled with NaN first, after a
   check that the instances at the main shapes spill nothing; and on a
   lazily conjugated spectrum and history (``spec.conj()``) and a gradient
   that comes back through ``.conj()`` of the output, against the plain
   versions on the resolved tensors;
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
9. times streaming B=256 x 10 s (999 hops) with the kernels
   and with the plain versions (x-realtime), and one hop at B=1; profiles
   B=256 streaming hops (kernels per hop, device time by kernel, the
   device's busy time and idle share);
10. drives config 4's streaming path: DFSMN at the JAX package's bench shape
    (``DfsmnNet(in_freq=161, hidden_dim=256, num_blocks=6, left_frames=2,
    right_frames=0)``, seeded weights and skip weights),
    ``StreamingEnhancer.run`` on B=8 synthetic 4 s utterances; checks that a
    hop launches none of the port's kernels (DFSMN has none), the output's
    length and finiteness, the stream against the offline center=False path
    past the first n_fft samples within 1e-4 and ``step_multi`` (k=4) against
    4 steps; times B=256 x 10 s streams (x-realtime) and one hop at B=1, and
    profiles 20 hops at B=256 and at B=1;
11. holds the MTFAA kernels against their plain versions on the card: the
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
12. drives config 5b's path: full-width MTFAA from
    ``configs/mtfaa_windowed.toml`` (seeded weights, BatchNorm statistics and
    PReLU slopes), ``BatchInferencer(type="auto").run_batched`` on the six
    utterances in batches of 4; checks 6 TFCM-stack, 3 attention and 1
    deep-filter launches per forward (and none of the stencil: the adapter
    asks for no streaming state), the outputs, and the waveform against
    the same batch through all plain versions within 1e-4; then config 5
    (``MtfaaConfig()``, full-causal attention) at B=4 x 4 s the same way, and
    a lone ``TFCMBlock`` (one block launch);
13. times the TFCM stack at the four stage shapes and one block (ms, the
    bound, GB/s over the least bytes and over the design's bytes; for each
    layer its tile, buffers, shared memory a block, blocks an SM, registers
    and spills as the card reports them), the attention forward at stage 0
    with and without the window against its plain version, and at all three
    stages with and without it (``ops/tattn_timing.py``: the kernel alone from
    a profile, the wrapper, the bound, ``scaled_dot_product_attention`` with
    the band mask, and the instance's registers, spills and blocks an SM,
    checked to spill nothing and, from a trace that saw every call, to be one
    device launch a call), and one B=16 x 10 s config-5b enhancement with
    the kernels and with the plain versions (x-realtime); profiles one B=16 forward (kernels per forward, device time
    by kernel, busy time and idle share) and checks that it shows 24
    ``tfcm_layer_kernel`` launches (6 stacks x 4 layers);
14. holds the stencil's forward kernel at the streaming hop's T = 1 (x_ext
    of 1 + 2d frames) at config 5b's four stage shapes, B=64, d = 1, 2, 4, 8,
    into outputs filled with NaN first (1e-5), and drives config 5b's
    streaming path: the same MTFAA through ``StreamingEnhancer.run`` on B=8
    synthetic 4 s utterances (n_fft 512, hop 256, center=False); checks 24
    stencil and 1 deep-filter launches a hop and no other kernel (no TFCM
    stack, no attention), the stream against the same stream through the
    plain stencil and deep filter and against the offline windowed forward
    (the stack and attention kernels) + iSTFT past n_fft samples, each within
    1e-4, ``step_multi`` against steps, and two chunks carried through the
    state of a state=None call against one call (2e-4); times B=64 x 10 s
    streams and one hop at B=1, profiles 20 hops at B=64 and B=1, and times
    the stencil at the hop's four stage shapes at B=1 (``ops/dw_timing.py``);
15. serves config 3 and config 5b at once: one ``MultiModelServer`` with a
    pool of full-width CRUSE+DF (16 slots) and one of config 5b (8 slots), the
    same models as above; 17 and 9 synthetic sessions of 0.5 to 3 s and 0.5 to
    1 s, of priorities 0 to 2, opened in stages (more sessions than slots, so
    slots are reused), fed a hop an iteration, stepped with every third
    iteration rationed to one dispatch, drained at the end of their input and
    closed; checks that every server call launched exactly 2 GRU and 1
    deep-filter kernels a config-3 step and 24 stencil and 1 deep-filter
    kernels a config-5b step, and each session against the same session
    streamed alone (B=1) with the kernels and, in one batch, through the plain
    versions, within 1e-4; times config 3's pool at 256 slots x 10 s
    (aggregate x-realtime, ms a step), ``StreamingEnhancer.run`` on the same
    audio, and profiles 20 server steps; then runs the serve CLI
    (``python -m cruse_tpu_torch.infer.serve``) as a subprocess with config 1
    (``configs/cruse_base.toml``, priority 1) and config 5b, 10 sessions of 2
    s, ``--realtime --max_dispatches 1``: it must exit 0 and write every
    session at its input's length; prints its p50, p99 and missed deadlines;
16. holds the training kernels against their plain versions on the card at
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
17. drives the training path: full-width config 5b, seeded weights, B=16 x 10 s
    of seeded noisy/clean pairs, 3 steps of ``make_train_step``; checks 24
    stencil-forward, 24 ``tail_bwd``, 24 ``mid_bwd``, 3 attention-forward, 3 dq,
    3 dk/dv, 1 deep-filter forward and 1 deep-filter backward launches a step
    and no eval-kernel launch, finite losses and
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
18. holds both GRU backward kernels (the resident one, whose weight stays in
    a cluster's shared memory, at every cluster size that holds the weight
    with a unit in every block, and the streamed one) against their plain
    version on the card at config 2's shape (B=128, T=1001, G=4, H=176), B=13
    and 17 (off the 8-row tile), H=33, T=1, H=512 (only the streamed kernel;
    the resident launcher must refuse it, as it must every other cluster
    size), H=200, 256 and 177 (planned clusters of 4 and 8), with dh_last
    None and nonzero: into dx_proj, dhp and dh0 filled with NaN first, and
    through ``gru_sequence_bwd`` (dx_proj, dh0, dw_hh, db_hh; one launch, of
    the kernel ``resident_bwd_plan`` names, by the counters), each within
    1e-4 of its largest value (f32 sums over 1,001 steps); checks that a
    forward kernel's launcher refuses tensors that want a gradient; then drives
    config 2's CRUSE train step (``configs/cruse_base.toml``) and config 3's
    CRUSE+DF (``CruseDfConfig()``) as in 17: the first batch's losses,
    gradients (float64, leaf by leaf) and BatchNorm statistics at B=8 x 10 s,
    then 3 steps at B=128 x 10 s (CRUSE) and B=32 x 10 s (CRUSE+DF) with 2
    GRU forward and 2 GRU backward launches a step (and 1 + 1 deep-filter
    launches for CRUSE+DF), no other kernel and no plain version;
19. times every training kernel and its plain version at stage 0, ``tail_bwd``
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
    with the band mask as the library call (its forward is timed in 13),
    the dk/dv instance's registers, spills and blocks an SM) and the plain
    dense backward at stage 0,
    the deep filter's forward and backward at config 5b and config 3 and the
    forward at config 3's and config 5b's hops (``ops/df_timing.py``: the kernels alone from a
    profile, checked to be one device launch a call, the wrappers, the
    bound, the plain versions, the plan and its instance, and the plain
    forward + ``autograd.grad`` that the step ran before the backward
    kernel), one B=16 x 10 s train step with the kernels, with the plain
    versions and with every kernel but the deep filter's (the step before
    the backward kernel), their peak memory, and profiles a step with the
    kernels and one with the plain deep filter (``mid_bwd``'s and the deep
    filter's device time a step, and a check that the step makes at least
    96 device launches fewer than the 6,270 it made with eight launches a
    ``mid_bwd`` call); both GRU backward kernels alone at config 2's shape
    and at B=32 (``ops/gru_bwd_timing.py``: CUDA events in turns, resident,
    streamed, streamed, resident), the bound and ``autograd.grad`` through
    cuDNN's ``nn.GRU``, one call a group, at both; the wrapper and the plain
    walk at config 2; one config-2 step at B=128 x 10 s and one CRUSE+DF step
    at B=32 x 10 s (wall ms, peak memory) and a profile of the config-2 step
    (2 launches each of the resident GRU forward and backward kernels, none
    of the streamed backward, busy time, idle share);
20. drives the trainer slice: writes a synthetic corpus (24 clean clips of
    4 s of tones under a syllable envelope, 24 noise clips) and a copy of
    ``configs/cruse_base.toml`` pointed at it, 2 epochs of 4 steps, every
    other field as published (B=32 x 3 s training, 2 batches of 8 x 5 s
    validation); runs ``python -m cruse_tpu_torch.train``'s ``main`` in this
    process on the card: native host I/O, on-card mixing, the prefetcher,
    asynchronous validation scoring, checkpoints; checks 2 + 2 GRU launches
    a step and 2 a validation batch and nothing else, finite epoch means,
    both validations and their composite scores in the log, the native
    assembler's calls, ``latest``, ``best`` and ``model_0002.npz``; serves
    that snapshot with ``python -m cruse_tpu_torch.infer --weights`` on two
    clips, within 1e-4 of the trainer's own enhancement; resumes with
    ``-R`` at 3 epochs (the restored state equal to ``latest`` bit for bit,
    epoch 3 alone run); holds one step's losses (1e-5 relative) and
    gradients (tests/test_torch_train_step.py's bounds) against the plain
    recurrence on a pre-mixed batch; prints the trainer's ms a step against
    the bare ``make_train_step`` on pre-mixed batches, the data stages'
    ms a batch, the validation's device and scoring times, the checkpoint
    saves, and profiles a 12-step epoch (device idle share);
21. drives the deployment path: config 1 (``configs/cruse_base.toml``, seeded
    weights and BatchNorm statistics) exported offline at B=16 x 10 s on the
    card in float32 and int8 (``infer/export.py``, ``nn/quantize.py``),
    saved and loaded (``infer/artifact.py``): 2 resident GRU launches a call
    and nothing else, within 1e-5 of eager ``mag_to_mag`` on the same
    (dequantized) weights, float32 within 1e-4 of the plain recurrence, int8
    against float32 above 25 dB; config 3 (``CruseDfConfig()``) exported as
    the streaming step at B=1 and B=16 (and int8 at B=1), primed and run 100
    hops against ``StreamingEnhancer`` within 1e-5, exactly 2 GRU and 1
    deep-filter launch a hop; times a call and a B=1 hop (the eager hop with
    and without the custom ops' dispatch, in turns), file sizes, and profiles
    a float32 and an int8 artifact hop (the launches the in-program
    dequantize adds); then five fresh CLI processes at once: ``run_exported``
    on the config-1 artifact (each wav as the artifact enhances it here),
    ``infer --quantize int8`` (config 1) and ``serve --quantize int8``
    (config 1 with 5b), each against the same run on the dequantized weights
    within 1e-6. Then MTFAA: config 5b (``configs/mtfaa_windowed.toml``)
    exported offline at B=16 x 10 s in float32 and int8, 6 TFCM stack calls
    (24 layer launches), 3 attention and 1 deep-filter launch a call and
    nothing else, within 1e-5 of eager ``auto`` on the same (dequantized)
    weights, float32 within 1e-4 of the plain versions, int8 against float32
    above 25 dB, each call timed in turns with eager and profiled (device
    launches a call against eager's); config 5 (``MtfaaConfig()``, full
    causal) offline at B=4 x 4 s with the eager forward's launches; config
    5b as the streaming step at B=1 and B=8 (and int8 at B=1), 100 hops
    against ``StreamingEnhancer`` within 1e-5, 24 stencil and 1 deep-filter
    launches a hop, the B=1 hop's latency (each hop synchronised) in turns
    with the eager hop with and without the five custom ops' dispatch, the
    host cost of the three MTFAA ops' dispatch, and profiles of the eager,
    float32 and int8 hops (the float32 artifact hop may launch no more device
    kernels than the eager hop: it folds nothing per call); last ``export
    --streaming`` and ``run_exported`` on config 5b against the eager
    ``infer --streaming`` CLI on the same seeded weights, within one int16
    step;
22. prints a JSON line of the kernels (each with its launches on the main
    paths, its error, its time, the plain version's, the least time the card
    could take for its bytes or its multiply-adds, and the library call's time
    where there is one), then ``{"ok": true, "device": ...}``.

TF32 is off for matmuls and convolutions throughout, so every comparison is
in full float32.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
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
import cruse_tpu_torch.ops.asa_kernel as asa_kernel
import cruse_tpu_torch.ops.deep_filter_kernel as deep_filter_kernel
import cruse_tpu_torch.ops.dw_kernel as dw_kernel
import cruse_tpu_torch.ops.gru_kernel as gru_kernel
import cruse_tpu_torch.ops.tfcm_kernel as tfcm_kernel
from cruse_tpu_torch.data import native as native_io
from cruse_tpu_torch.data.manifest import write_manifest
from cruse_tpu_torch.data.mixer import draw_mix, mix_batch
from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer import artifact as artifact_lib
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.export import export_offline, export_streaming
from cruse_tpu_torch.infer.serve import build_model as serve_build_model
from cruse_tpu_torch.infer.server import MultiModelServer, StreamingServer, tree_leaves
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import (
    CruseDfConfig, CruseDfNet, CruseNet, DfsmnConfig, DfsmnNet, MtfaaConfig, MtfaaNet, build_from_config)
from cruse_tpu_torch.models.cruse_df import apply_cruse_df
from cruse_tpu_torch.models.mtfaa import (
    AxialSelfAttention, BatchNormC, PReLUc, TFCM, TFCMBlock)
from cruse_tpu_torch.nn.gru import GroupedGRULayer
from cruse_tpu_torch.nn.quantize import (
    attach_int8, dequantize_tree, int8_state_dict, load_dequantized, quantize_variables, report_line)
from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.asa_kernel import (
    _launch_dkv, _launch_dq, _launch_fwd, band_mask, flash_tattn_tm, tattn_bwd_reference, tattn_dkv, tattn_dkv_info,
    tattn_dq, tattn_dq_info, tattn_reference)
from cruse_tpu_torch.ops.deep_filter_kernel import (
    deep_filter, deep_filter_backward_reference, deep_filter_bwd, deep_filter_reference, df_kernel_info, df_plan,
    df_vector_floats, launch_df_bwd, launch_df_fwd)
from cruse_tpu_torch.ops.df_timing import df_inputs, misaligned, time_df
from cruse_tpu_torch.ops.df_timing import describe as describe_df
from cruse_tpu_torch.ops.dw_kernel import (
    DW_BLOCKS_PER_SM, dw_bwd_buffers, dw_bwd_reference, dw_causal_tm, dw_kernel_info, dw_partials_reference, dw_plan,
    dw_stencil_bwd, dw_stencil_fwd, dw_taps_reference, launch_dw_bwd, launch_dw_fwd)
from cruse_tpu_torch.ops.dw_timing import describe as describe_dw
from cruse_tpu_torch.ops.dw_timing import describe_step, dw_bound, time_dw
from cruse_tpu_torch.ops.gru_kernel import (
    CLUSTER_SIZES, MAX_HIDDEN, bwd_fit_at, cluster_fit, gru_backward_walk_reference, gru_sequence,
    gru_sequence_backward_reference, gru_sequence_bwd, gru_sequence_reference, launch_gru_bwd_resident,
    launch_gru_bwd_streamed, launch_resident, launch_streamed, resident_bwd_plan, resident_plan)
from cruse_tpu_torch.ops.gru_bwd_timing import describe as describe_gru_bwd
from cruse_tpu_torch.ops.gru_bwd_timing import time_kernels as time_gru_bwd_kernels
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
from cruse_tpu_torch.train import checkpoint as checkpoint_lib
from cruse_tpu_torch.train.__main__ import build_trainer, dataset_from, parse_args
from cruse_tpu_torch.train.__main__ import main as train_main
from cruse_tpu_torch.train.step import (
    StepConfig, init_train_state, make_loss_gradients, make_train_step)
from cruse_tpu_torch.utils.config import load_config
from cruse_tpu_torch.utils.weights import flax_from_state_dict, save_flax_npz

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNELS = ("gru_sequence", "gru_bwd", "deep_filter", "tfcm_eval", "tattn", "dw_stencil", "tfcm_bwd",
           "tattn_bwd")  # csrc/<name>.cu
CONFIG1_GRU = (256, 1001, 4, 176)  # B, T, G, H of config 1's bottleneck banks
STREAM_GRU = ((256, 1, 4, 176), (8, 1, 4, 176), (16, 1, 4, 176))  # config 3's streaming hop; the server's pool
RAGGED_GRU = ((3, 7, 4, 176), (3, 7, 3, 50))
# a row tile with one live row; an odd split of the units; clusters of 4 (f32) and of 8 (bf16
# weights; f32 takes the streamed kernel); a size only the streamed kernel takes
CLUSTER_GRU = ((17, 7, 4, 176), (3, 7, 2, 177), (5, 6, 2, 200), (3, 5, 2, 384), (3, 5, 2, 500))
STEP_GRU = ((256, 1, 4, 176), (8, 1, 4, 176), (1, 1, 4, 176))  # the T=1 shapes that are timed
# B, T, G, H of the GRU backward kernels' cases: config 2's banks at its published batch (B=128 x 10 s);
# B off the 8-row tile; an odd H; T = 1; the largest H the streamed kernel takes (no cluster holds it);
# planned clusters of 4 and 8, H off the unit groups
CONFIG2_GRU = (128, 1001, 4, 176)
GRU_BWD_SHAPES = (CONFIG2_GRU, (13, 37, 4, 176), (3, 5, 2, 33), (9, 1, 3, 50), (2, 4, 1, 512), (5, 6, 2, 200),
                  (3, 5, 2, 256), (17, 4, 1, 177))
GRU_BWD_TOL = 1e-4  # x max|ref| of each output: f32 sums over up to 1,001 steps, and over B x T terms
# config 2's train step at its published batch, CRUSE+DF's at B=32, and both at B=8 for the float64 check
CONFIG2_BATCH, CRUSE_DF_BATCH, CRUSE_CHECK_BATCH, CRUSE_SECONDS = 128, 32, 8, 10
# B, T, F, t_dim, f_dim, causal, spectrum bins (>= F: the low bins of a wider one), history
CONFIG3_DF = (256, 1001, 96, 2, 1, True, 161, False)
MTFAA_DF = (16, 626, 257, 1, 1, True, 257, False)  # config 5b, B=16 x 10 s: every bin, K=9
DF_SHAPES = ((64, 1001, 96, 2, 1, True, 161, False),  # config 3 offline
             (256, 1, 96, 2, 1, True, 161, True),  # config 3 streaming hop
             (64, 1, 257, 1, 1, True, 257, True),  # config 5b's streaming hop: every bin, with history
             (1, 1, 257, 1, 1, True, 257, True),  # config 5b's hop at B=1, as measure_rtf streams it
             (16, 1, 96, 2, 1, True, 161, True),  # config 3's hop in the server's 16-slot pool
             (8, 1, 257, 1, 1, True, 257, True),  # config 5b's hop in the server's 8-slot pool
             (3, 7, 24, 1, 1, True, 24, False),  # ragged
             (3, 3, 24, 2, 1, True, 24, True),  # T < 2 * t_dim, with history
             (3, 3, 24, 2, 1, True, 24, False),  # T < 2 * t_dim, zero fill
             (3, 9, 20, 1, 2, False, 20, False),  # symmetric layout
             MTFAA_DF)
# B, T, F, t_dim, f_dim, causal, spectrum bins, history, and the plan's span and bins, and the floats by which
# the coefficients start past a 16-byte boundary, of the deep filter's forced tiles (the backward's where no history)
DF_TILINGS = ((3, 50, 96, 2, 1, True, 161, False, 7, 48, 0),  # T off the span; the strided 161-bin slice, 2 ranges
              (3, 3, 24, 2, 1, True, 24, False, 2, 24, 0),  # T < 2 * t_dim
              (3, 3, 24, 2, 1, True, 24, True, 2, 10, 0),  # T < 2 * t_dim, with history, ragged bins
              (2, 40, 20, 1, 2, False, 20, False, 40, 20, 0),  # one span, symmetric
              (2, 17, 37, 1, 1, True, 37, False, 5, 37, 1),  # a misaligned base: 4-byte copies
              (2, 17, 37, 1, 1, True, 37, False, 4, 12, 2),  # an 8-byte base, ragged bins
              (4, 30, 257, 1, 1, True, 257, False, 4, 257, 0),  # F = 257: rows off 16 bytes; 8-byte copies back
              (4, 30, 257, 1, 1, True, 257, False, 6, 130, 0),  # F = 257 in two ranges
              (3, 1, 96, 2, 1, True, 161, True, 1, 48, 0))  # the hop in two ranges
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
    "gru_sequence_kernel", "gru_resident_kernel", "deep_filter_kernel", "deep_filter_bwd_kernel", "tfcm_layer_kernel",
    "tattn_fwd_kernel",
    "tattn_dq_kernel", "tattn_dkv_kernel", "dw_fwd_kernel", "dw_bwd_kernel", "dw_finish_kernel",
    "tail_bwd_kernel", "mid_tile_kernel", "mid_finish_kernel", "gru_bwd_kernel", "gru_bwd_resident_kernel"))
# launches one config-5b train step makes: 6 stacks x 4 blocks, 3 attentions, 1 deep filter
STEP_LAUNCHES = {"dw_stencil_fwd": 24, "dw_stencil_bwd": 0, "tail_bwd": 24, "mid_bwd": 24,
                 "tattn": 3, "tattn_dq": 3, "tattn_dkv": 3, "tfcm_stack": 0, "tfcm_block": 0,
                 "deep_filter": 1, "deep_filter_bwd": 1, "gru_sequence": 0, "gru_sequence_bwd": 0}
# and one config-2 CRUSE step: 2 GRU banks, each a forward and a backward launch; CRUSE+DF's adds the deep filter
CRUSE_STEP_LAUNCHES = {**{name: 0 for name in STEP_LAUNCHES}, "gru_sequence": 2, "gru_sequence_bwd": 2}
CRUSE_DF_STEP_LAUNCHES = {**CRUSE_STEP_LAUNCHES, "deep_filter": 1, "deep_filter_bwd": 1}
# what the kernels line gives of each attention kernel's timed stage geometries (ops/tattn_timing.py's rows)
STAGE_KEYS = ("bf", "c", "C", "window", "kernel_ms", "wrapper_ms", "bound_ms", "library_ms")
# and of the stencil's timed stage shapes and dilations (ops/dw_timing.py's rows)
DW_STAGE_KEYS = ("shape", "d", "kernel_ms", "wrapper_ms", "bound_ms", "library_ms", "kb", "tt")
# and of the deep filter's timed shapes (ops/df_timing.py's rows)
DF_STAGE_KEYS = ("shape", "b", "t", "f", "t_dim", "f_dim", "kernel_ms", "wrapper_ms", "bound_ms", "plain_ms", "span",
                 "bins")
# config 4, the JAX package's bench shape (bench.py:205), and its streams: B=8 x 4 s checked, B=256 x 10 s timed
DFSMN_CONFIG = DfsmnConfig(in_freq=161, hidden_dim=256, num_blocks=6, left_frames=2, right_frames=0)
DFSMN_RTF_BATCH = 256
# config 5b streamed: B=8 x 4 s checked, B=64 x 10 s timed; the stencil's T = 1 cases at every batch that streams
MTFAA_STREAM_BATCH, MTFAA_STREAM_SECONDS, MTFAA_RTF_BATCH = 8, 4, 64
HOP_DW_BATCHES = (1, MTFAA_STREAM_BATCH, MTFAA_RTF_BATCH)
CHUNK_TOL = 2e-4  # two chunks carried through the state against one call: the JAX package's own bound
# the server: one MultiModelServer with a config-3 pool and a config-5b pool, each session checked against
# the same session streamed alone; sessions (count, shortest and longest seconds) of each pool
SERVER_POOLS = {"cruse_df": 16, "mtfaa_5b": 8}  # slots
SERVER_SESSIONS = {"cruse_df": (17, 0.5, 3.0), "mtfaa_5b": (9, 0.5, 1.0)}
SERVER_LAUNCHES = {"cruse_df": {"gru_sequence": 2, "deep_filter": 1},  # a step of each pool
                   "mtfaa_5b": {"dw_stencil_fwd": 24, "deep_filter": 1}}
SERVER_RTF_SLOTS, SERVER_RTF_SECONDS = 256, 10  # config 3's pool timed
SERVE_CLI_SESSIONS, SERVE_CLI_SECONDS = 10, 2  # the serve CLI's run, half on each model
# the deployment path: config 1's offline artifact (float32 and int8) at B=16 x 10 s; config 3's streaming
# artifact at B=1 and B=16 over 100 hops (and int8 at B=1); the CLIs' runs on utterances of 2 s
DEPLOY_BATCH, DEPLOY_SECONDS = 16, 10
DEPLOY_STREAM_BATCHES, DEPLOY_HOPS = (1, 16), 100
DEPLOY_TOL = 1e-5  # an artifact against the eager path on the same weights
INT8_SNR_DB = 25.0  # int8 against float32 waveforms (the JAX package's tests/test_quantize.py bound)
CLI_TOL = 1e-6  # --quantize int8 against the same run on the dequantized weights, in floats
WAV_STEP = 1.0 / 32768  # the CLIs' int16 wavs of one run in two processes: cuDNN's algorithms vary by a rounding
CLI_FILES, CLI_SECONDS = 4, 2
# config 5b's artifacts: a call offline (6 stacks of 4 layers, 3 attentions, the deep filter) and a hop
# streamed (24 blocks' stencils, the deep filter); the streams' batches
MTFAA_CALL_LAUNCHES = {"tfcm_stack": 6, "tattn": 3, "deep_filter": 1}
MTFAA_HOP_LAUNCHES = {"dw_stencil_fwd": 24, "deep_filter": 1}
MTFAA_DEPLOY_BATCHES = (1, MTFAA_STREAM_BATCH)
TRAINER_CLIPS, TRAINER_VALID_CLIPS, TRAINER_CLIP_SECONDS = 24, 4, 4  # the trainer phase's corpus
TRAINER_EPOCHS, TRAINER_STEPS = 2, 4  # the train CLI's run (then -R for one more epoch)
TRAINER_VALID_BATCHES = 2  # the CLI validates on two batches, as tools/train.py does
TRAINER_PROFILE_STEPS = 12  # the profiled epoch
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


COUNTERS = {"gru_sequence": gru_sequence, "deep_filter": deep_filter, "deep_filter_bwd": deep_filter_bwd,
            "tfcm_stack": fused_tfcm_stack_eval, "tfcm_block": fused_tfcm_block_eval,
            "tattn": flash_tattn_tm, "dw_stencil_fwd": dw_stencil_fwd,
            "dw_stencil_bwd": dw_stencil_bwd, "tail_bwd": tail_bwd, "mid_bwd": mid_bwd,
            "tattn_dq": tattn_dq, "tattn_dkv": tattn_dkv, "gru_sequence_bwd": gru_sequence_bwd}


def reset_counts() -> None:
    for kernel in COUNTERS.values():
        kernel.launches = 0
    gru_sequence.resident_launches = 0
    gru_sequence_bwd.resident_launches = 0


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


def check_df_kernel(device) -> tuple[float, float]:
    """The deep filter's kernels against their plain versions on the card:
    the forward at DF_SHAPES, the backward at those without history (two
    calls giving the same bits), both through autograd at config 5b's shape
    (one launch each), and both at DF_TILINGS (``check_df_tiles``). Returns
    the forward's and the backward's largest errors."""
    worst = [0.0, 0.0]
    for b, t, f, t_dim, f_dim, causal, bins, history in DF_SHAPES:
        spec, coefs, hist, g = df_inputs(b, t, f, t_dim, f_dim, causal, bins, history, device, SEED)
        what = f"B={b} T={t} F={f} t={t_dim} f={f_dim} causal={causal} history={history}"
        with torch.inference_mode():
            got = deep_filter(spec, coefs, t_dim, f_dim, causal, hist)
            torch.cuda.synchronize()
            want = deep_filter_reference(spec, coefs, t_dim, f_dim, causal, hist)
            err = float((got - want).abs().max())
            require(bool(torch.isfinite(torch.view_as_real(got)).all()) and err <= DF_TOL,
                    f"deep_filter {what}: max-abs {err:.3g} <= {DF_TOL}")
            worst[0] = max(worst[0], err)
            if history:
                continue
            got = deep_filter_bwd(g, spec, coefs, t_dim, f_dim, causal)
            again = deep_filter_bwd(g, spec, coefs, t_dim, f_dim, causal)
            want = deep_filter_backward_reference(g, spec, coefs, t_dim, f_dim, causal)
            errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
            require(all(bool(torch.isfinite(torch.view_as_real(x) if x.is_complex() else x).all()) for x in got)
                    and max(errs) <= DF_TOL, f"deep_filter_bwd {what}: dspec, dcoefs max-abs "
                    f"{errs[0]:.3g}, {errs[1]:.3g} <= {DF_TOL}")
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"deep_filter_bwd {what}: two calls give the same dspec and dcoefs bits")
            worst[1] = max(worst[1], *errs)
    spec, coefs, _, g = df_inputs(*MTFAA_DF, device, SEED + 1)
    t_dim, f_dim = MTFAA_DF[3:5]
    spec.requires_grad_(), coefs.requires_grad_()
    before = counts()
    out = deep_filter(spec, coefs, t_dim, f_dim)
    got = torch.autograd.grad(out, (spec, coefs), g)
    torch.cuda.synchronize()
    after = counts()
    require(all(after[n] - before[n] == 1 for n in ("deep_filter", "deep_filter_bwd")),
            "deep_filter under autograd at config 5b's shape: one forward and one backward launch")
    with torch.inference_mode():
        want = deep_filter_backward_reference(g, spec, coefs, t_dim, f_dim, True)
    errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
    require(max(errs) <= DF_TOL, f"deep_filter's gradients through autograd at config 5b's shape: max-abs "
            f"{errs[0]:.3g}, {errs[1]:.3g} <= {DF_TOL}")
    del spec, coefs, g, out, got, want
    tiles = check_df_tiles(device)
    conj = check_df_conj(device)
    return max(worst[0], tiles[0], conj[0]), max(worst[1], *errs, tiles[1], conj[1])


def check_df_conj(device) -> tuple[float, float]:
    """The deep filter on a lazily conjugated spectrum (config 3's strided
    low-bin slice, at B=8) and history (the hop), and its gradients through
    autograd where the cotangent comes back through ``.conj()`` of the output,
    against the plain versions on the resolved tensors, within DF_TOL (the
    kernels read ``data_ptr()``: the values before the conjugation, unless
    the wrappers resolve it). Returns the forward's and the backward's
    largest errors."""
    b, t, f, t_dim, f_dim, causal, bins, _ = CONFIG3_DF
    spec, coefs, _, g = df_inputs(8, t, f, t_dim, f_dim, causal, bins, False, device, SEED + 5)
    hop = DF_SHAPES[1]
    spec_h, coefs_h, hist, _ = df_inputs(*hop, device, SEED + 6)
    with torch.inference_mode():
        errs = [float((deep_filter(spec.conj(), coefs, t_dim, f_dim) - deep_filter_reference(
                    spec.conj().resolve_conj(), coefs, t_dim, f_dim)).abs().max()),
                float((deep_filter(spec_h.conj(), coefs_h, t_dim, f_dim, True, hist.conj()) - deep_filter_reference(
                    spec_h.conj().resolve_conj(), coefs_h, t_dim, f_dim, True, hist.conj().resolve_conj())).abs().max())]
    torch.cuda.synchronize()
    require(max(errs) <= DF_TOL, f"deep_filter of spec.conj() (B=8 T={t} F={f}) and of the hop with "
            f"history.conj(): max-abs {errs[0]:.3g}, {errs[1]:.3g} <= {DF_TOL}")
    results = []
    before = counts()
    for fn in (deep_filter, deep_filter_reference):
        s, c = spec.clone().requires_grad_(), coefs.clone().requires_grad_()
        out = fn(s.conj(), c, t_dim, f_dim)
        results.append(torch.autograd.grad((out.conj() * g).real.sum(), (s, c)))
        if fn is deep_filter:
            after = counts()
    torch.cuda.synchronize()
    grad_errs = [float((x - y).abs().max()) for x, y in zip(*results)]
    require(all(after[n] - before[n] == 1 for n in ("deep_filter", "deep_filter_bwd")) and max(grad_errs) <= DF_TOL,
            f"deep_filter's gradients in spec and coefs through spec.conj() and out.conj() (one forward and one "
            f"backward launch): max-abs {grad_errs[0]:.3g}, {grad_errs[1]:.3g} <= {DF_TOL}")
    return max(errs), max(grad_errs)


def check_df_tiles(device) -> tuple[float, float]:
    """Both deep-filter kernels at the forced plans of DF_TILINGS, into outputs
    filled with NaN first (so a value the kernels never write shows), against
    the plain versions; first, that the instances at the main shapes' plans
    spill nothing. Returns the forward's and the backward's largest errors."""
    for shape in (MTFAA_DF, CONFIG3_DF):
        b, t, f, t_dim, f_dim, causal, _, _ = shape
        for backward in (False, True):
            plan = df_plan(b, t, f, t_dim, f_dim, causal, backward=backward)
            for vec in (1, 2, 4):
                info = df_kernel_info(backward, vec, plan.smem, plan.threads)
                require(info["spill_bytes"] == 0, f"the deep filter's {'backward' if backward else 'forward'} "
                        f"instance with {4 * vec}-byte copies spills nothing at the plan of B={b} T={t} F={f} "
                        f"({info['registers']} registers, {info['blocks_per_sm']} blocks an SM at {plan.smem} B, "
                        f"planned {plan.blocks_per_sm})")
    worst = [0.0, 0.0]
    nan = complex(math.nan, math.nan)
    for b, t, f, t_dim, f_dim, causal, bins, history, span, nb, shift in DF_TILINGS:
        spec, coefs, hist, g = df_inputs(b, t, f, t_dim, f_dim, causal, bins, history, device, SEED + 5)
        coefs = misaligned(coefs, shift)
        pf = df_plan(b, t, f, t_dim, f_dim, causal, history, span=span, bins=nb)
        what = (f"B={b} T={t} F={f} t={t_dim} f={f_dim} causal={causal} history={history}, "
                f"{4 * df_vector_floats(coefs)}- and {4 * df_vector_floats(coefs, coefs)}-byte copies forward and "
                f"backward, plan {pf.span} frames x {pf.bins} bins")
        with torch.inference_mode():
            out = torch.full((b, t, f), nan, dtype=torch.complex64, device=device)
            launch_df_fwd(spec, coefs, t_dim, f_dim, causal, hist, pf, out)
            want = deep_filter_reference(spec, coefs, t_dim, f_dim, causal, hist)
            err = float((out - want).abs().max())
            require(bool(torch.isfinite(torch.view_as_real(out)).all()) and err <= DF_TOL,
                    f"deep_filter forward {what}: max-abs {err:.3g} <= {DF_TOL}")
            worst[0] = max(worst[0], err)
            if history:
                continue
            pb = df_plan(b, t, f, t_dim, f_dim, causal, backward=True, span=span, bins=nb)
            dspec = torch.full((b, t, f), nan, dtype=torch.complex64, device=device)
            dcoefs = torch.full_like(coefs, math.nan)
            launch_df_bwd(g, spec, coefs, t_dim, f_dim, causal, pb, dspec, dcoefs)
            want = deep_filter_backward_reference(g, spec, coefs, t_dim, f_dim, causal)
            errs = [float((x - y).abs().max()) for x, y in zip((dspec, dcoefs), want)]
            require(bool(torch.isfinite(torch.view_as_real(dspec)).all() and torch.isfinite(dcoefs).all())
                    and max(errs) <= DF_TOL, f"deep_filter backward {what}: dspec, dcoefs max-abs "
                    f"{errs[0]:.3g}, {errs[1]:.3g} <= {DF_TOL}")
            worst[1] = max(worst[1], *errs)
    return worst[0], worst[1]


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
    returns its (tfcm stack, tattn, deep_filter) launches. The adapter asks
    for no streaming state, so no stencil runs for the TFCM histories."""
    wavs = noisy_utterances(SEED)
    names = [f"utt{i}" for i in range(len(wavs))]
    forwards = math.ceil(len(wavs) / BATCH)

    reset_counts()
    results = inferencer.run_batched(wavs, names, batch_size=BATCH, write=False)
    torch.cuda.synchronize()
    stack, block, attn, df = mtfaa_counts()
    gru, dw = gru_sequence.launches, dw_stencil_fwd.launches
    require((stack, block, attn, df, gru, dw) == (6 * forwards, 0, 3 * forwards, forwards, 0, 0),
            f"config-5b path launched tfcm stack {stack} = 6 x {forwards} forwards, tattn {attn} "
            f"= 3 x {forwards}, deep_filter {df} = 1 x {forwards}, tfcm block {block} = 0, "
            f"gru_sequence {gru} = 0, dw_stencil_fwd {dw} = 0 (no streaming state asked for)")
    require([r[0] for r in results] == names
            and all(r[1].shape == w.shape for r, w in zip(results, wavs))
            and all(0 < np.abs(r[1]).max() <= 32767 for r in results),
            "config-5b run_batched returned every utterance at its length")

    hop = inferencer.cfg.stft.hop_length
    padded = -(-max(len(w) for w in wavs) // hop) * hop
    x = torch.from_numpy(np.stack([np.pad(w, (0, padded - len(w))) for w in wavs[:BATCH]]))
    check_mtfaa_forward(inferencer, x.to(inferencer.device), "config-5b batch of 4 x 10 s")
    return stack, attn, df


def check_dw_hop(device) -> float:
    """The stencil's forward kernel at the streaming hop's T = 1 (x_ext of 1 +
    2d frames) at config 5b's four stage shapes, at each batch the streams
    run (HOP_DW_BATCHES, each with the tile ``dw_plan`` gives it), d = 1, 2,
    4, 8, into outputs filled with NaN first; returns the largest error."""
    worst = 0.0
    for b in HOP_DW_BATCHES:
        for _, k, c, _ in TFCM_STAGES:
            for d in DILATIONS:
                x_ext, _, _, wd, _ = stage_inputs(b, k, c, 1, d, device, SEED)
                plan = dw_plan(b, k, c, 1, d)
                y = torch.full((b, k, c, 1), math.nan, device=device)
                with torch.inference_mode():
                    launch_dw_fwd(x_ext, wd, d, plan, y)
                    torch.cuda.synchronize()
                    worst = max(worst, require_close(y, dw_taps_reference(x_ext, wd, d), ELEMENT_TOL,
                                                     f"dw_stencil forward at the hop, {(b, k, c, 1)} d={d} "
                                                     f"tile ({plan.kb}, {plan.tt})"))
    return worst


def build_dfsmn(device):
    """Config 4 at the bench shape, seeded weights; the skip weights, zero
    at initialisation as in the JAX package, seeded too so the skip chain counts."""
    gen = torch.Generator().manual_seed(SEED + 11)
    model = DfsmnNet(DFSMN_CONFIG, generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("skip_weight"):
                p.fill_(0.3 + 0.5 * float(torch.rand((), generator=gen)))
    return model.to(device).eval()


def check_stream(enh, wav, offline, what: str, kernels: dict) -> dict:
    """Drive ``enh.run`` on wav once: the launches it made equal ``kernels``
    (name -> launches a hop; every other kernel none), the output finite and
    of the stream's length, within WAV_TOL of ``offline(wav)`` (the offline
    center=False path) past the first n_fft samples, the first row's first
    second streamed alone (B=1, the batch ``measure_rtf`` times) within
    WAV_TOL of the batch's, and ``step_multi`` (k=4) within 1e-6 of 4 steps.
    Returns the launches and the output."""
    n, hop = enh.cfg.n_fft, enh.cfg.hop_length
    hops = (wav.shape[-1] - (n - hop)) // hop
    reset_counts()
    streamed = enh.run(wav)
    torch.cuda.synchronize()
    launched = counts()
    want = {name: kernels.get(name, 0) * hops for name in launched}
    require(launched == want, f"{what}: {hops} hops launched {launched} = {want}")
    require(tuple(streamed.shape) == (wav.shape[0], hops * hop) and bool(torch.isfinite(streamed).all()),
            f"{what}: the stream is finite, shape {(wav.shape[0], hops * hop)}")
    with torch.inference_mode():
        reference = offline(wav)
    m = min(streamed.shape[-1], reference.shape[-1])
    err = float((streamed[:, n:m] - reference[:, n:m]).abs().max())
    require(err <= WAV_TOL, f"{what}: stream vs offline center=False past {n} samples: max-abs {err:.3g} <= {WAV_TOL}")
    alone = enh.run(wav[:1, :SR])
    err = float((alone - streamed[:1, : alone.shape[-1]]).abs().max())
    require(bool(torch.isfinite(alone).all()) and err <= WAV_TOL,
            f"{what}: row 0's first second streamed alone (B=1) vs in the batch: max-abs {err:.3g} <= {WAV_TOL}")
    state = enh.prime(enh.init_state(wav.shape[0]), wav[:, : n - hop])
    x = wav[:, n - hop : n - hop + 8 * hop]
    singles, single_state = [], state
    for i in range(8):
        out, single_state = enh.step(single_state, x[:, i * hop : (i + 1) * hop])
        singles.append(out)
    first, state = enh.step_multi(state, x[:, : 4 * hop])
    second, state = enh.step_multi(state, x[:, 4 * hop :])
    err = float((torch.cat([first, second], -1) - torch.cat(singles, -1)).abs().max())
    require(err <= 1e-6, f"{what}: step_multi(k=4) x 2 vs 8 steps: max-abs {err:.3g} <= 1e-6")
    return {"launches": launched, "stream": streamed}


def time_stream(enh, wav, seconds: int, what: str, smi) -> None:
    """x-realtime of ``enh.run`` on wav, one hop's wall time at B=1, and
    profiles of 20 hops at wav's batch and at B=1."""
    hop = enh.cfg.hop_length
    audio = wav.shape[0] * ((wav.shape[-1] - (enh.cfg.n_fft - hop)) // hop) * hop / SR
    run_s = stream_seconds(enh, wav)
    print(f"streaming {what} B={wav.shape[0]} x {seconds} s on {smi}: {run_s * 1e3:.1f} ms = "
          f"{audio / run_s:.1f}x realtime")
    rtf = enh.measure_rtf(noisy_utterances(SEED, (2 * SR,))[0][None], sr=SR, num_frames=150)
    print(f"streaming {what} B=1 on {smi}: {rtf * hop / SR * 1e3:.4f} ms per {hop}-sample hop, rtf {rtf:.4f}")
    profile_stream(enh, wav)
    profile_stream(enh, wav[:1])


def check_dfsmn_stream(device, smi) -> None:
    """Config 4 streamed (it has no kernel of its own; a hop launches none of the port's)."""
    model = build_dfsmn(device)
    cfg = StftConfig(n_fft=320, hop_length=160, center=False)
    enh = StreamingEnhancer(model, cfg)
    wav = torch.from_numpy(np.stack(noisy_utterances(SEED + 12, (STREAM_SECONDS * SR,) * STREAM_BATCH))).to(device)

    def offline(x):
        spec = stft(x, cfg)
        mask, _ = model(model.compress(spec.abs()))
        return istft(spec * mask, cfg)

    check_stream(enh, wav, offline, f"DFSMN config 4 stream B={STREAM_BATCH} x {STREAM_SECONDS} s", {})
    seconds = 10
    wav = torch.from_numpy(np.random.default_rng(SEED).standard_normal((DFSMN_RTF_BATCH, seconds * SR))
                           .astype(np.float32) * 0.1).to(device)
    time_stream(enh, wav, seconds, "DFSMN config 4", smi)


def check_mtfaa_stream(model, device, smi) -> tuple[int, int]:
    """Config 5b streamed: the launches of a hop (24 stencils, 1 deep filter,
    no TFCM-stack or attention kernel), the stream against the same stream
    through the plain stencil and deep filter and against the offline
    windowed forward (the stack and attention kernels) + iSTFT, step_multi,
    then two chunks carried through a state=None call's state against one
    call; times and profiles. Returns its (stencil, deep filter) launches."""
    cfg = StftConfig(n_fft=512, hop_length=256, center=False)
    enh = StreamingEnhancer(model, cfg)
    wav = torch.from_numpy(np.stack(noisy_utterances(
        SEED + 13, (MTFAA_STREAM_SECONDS * SR,) * MTFAA_STREAM_BATCH))).to(device)
    blocks = 2 * len(model.config.channels) * model.config.tfcm_layers

    def offline(x):
        spec = stft(x, cfg)
        (enhanced, _), _ = model(torch.stack([spec.real, spec.imag], dim=-1))
        return istft(enhanced, cfg)

    what = f"MTFAA config 5b stream B={MTFAA_STREAM_BATCH} x {MTFAA_STREAM_SECONDS} s"
    done = check_stream(enh, wav, offline, what, {"dw_stencil_fwd": blocks, "deep_filter": 1})
    set_plain_mtfaa(model, True)
    plain = enh.run(wav)
    set_plain_mtfaa(model, False)
    err = float((done["stream"] - plain).abs().max())
    require(err <= WAV_TOL, f"{what}, kernels vs the plain stencil and deep filter: max-abs {err:.3g} <= {WAV_TOL}")

    with torch.inference_mode():
        spec = stft(wav[:2], cfg)
        cspec = torch.stack([spec.real, spec.imag], dim=-1)
        (full, _), _ = model(cspec)
        split = cspec.shape[1] // 3
        (first, _), state = model(cspec[:, :split])
        (second, _), _ = model(cspec[:, split:], state)
    chunk_err = float((torch.cat([first, second], dim=1) - full).abs().max())
    require(chunk_err <= CHUNK_TOL, f"MTFAA config 5b, {split} + {cspec.shape[1] - split} frames carried "
            f"through the first call's state vs one call: max-abs {chunk_err:.3g} <= {CHUNK_TOL}")

    seconds = 10
    wav = torch.from_numpy(np.random.default_rng(SEED).standard_normal((MTFAA_RTF_BATCH, seconds * SR))
                           .astype(np.float32) * 0.1).to(device)
    time_stream(enh, wav, seconds, "MTFAA config 5b", smi)
    launched = done["launches"]
    return launched["dw_stencil_fwd"], launched["deep_filter"]


def single_stream(enh, wav: np.ndarray) -> np.ndarray:
    """wav streamed alone (B=1, unprimed) zero-padded to whole hops and
    trimmed to its length: what a server session returns."""
    padded = np.pad(wav, (0, (-len(wav)) % enh.cfg.hop_length))
    out, _ = enh.step_multi(enh.init_state(1), torch.from_numpy(padded[None]).to(enh.device))
    return out[0, : len(wav)].cpu().numpy()


def plain_streams(enh, wavs: list, set_plain_fn) -> list:
    """The wavs streamed as one batch through the model's plain versions
    (zero-padded to the longest, whole hops), each trimmed to its length."""
    hop = enh.cfg.hop_length
    longest = -(-max(len(w) for w in wavs) // hop) * hop
    x = torch.from_numpy(np.stack([np.pad(w, (0, longest - len(w))) for w in wavs])).to(enh.device)
    set_plain_fn(enh.model, True)
    out, _ = enh.step_multi(enh.init_state(len(wavs)), x)
    set_plain_fn(enh.model, False)
    out = out.cpu().numpy()
    return [out[i, : len(w)] for i, w in enumerate(wavs)]


def check_server(cruse_df, mtfaa, device, smi) -> dict:
    """One MultiModelServer with a config-3 pool (CRUSE+DF, 16 slots) and a
    config-5b pool (8 slots) on the card: sessions of mixed priorities opened
    in stages (more than a pool's slots, so slots are reused), fed a hop an
    iteration, stepped with some iterations rationed to one dispatch, drained
    and closed. Each step launches exactly its pools' kernels; each session
    equals the same session streamed alone at B=1 with the kernels and, with
    the plain versions, within WAV_TOL. Returns the launches of the server's
    steps by kernel."""
    t0 = time.perf_counter()
    configs = {"cruse_df": (cruse_df, StftConfig(n_fft=320, hop_length=160, center=False), set_plain),
               "mtfaa_5b": (mtfaa, StftConfig(n_fft=512, hop_length=256, center=False), set_plain_mtfaa)}
    server = MultiModelServer()
    for name, (model, cfg, _) in configs.items():
        server.add_model(name, model, cfg, max_streams=SERVER_POOLS[name], device=device)
    rng = np.random.default_rng(SEED + 19)
    queue = []  # (pool, priority, wav), the pools' sessions interleaved
    for p, (name, (count, shortest, longest)) in enumerate(SERVER_SESSIONS.items()):
        lengths = (rng.uniform(shortest, longest, count) * SR).astype(int)
        queue += [(name, i % 3, w) for i, w in enumerate(noisy_utterances(SEED + 20 + p, lengths))]
    queue.sort(key=lambda q: rng.uniform())
    sessions, live, opened = [], {}, {name: set() for name in configs}
    launched = {name: 0 for name in COUNTERS}
    wrong: list = []

    def dispatch(call, *args):
        """A server call; its launches must be its pools' steps' exactly."""
        steps = {name: server.pool(name).steps for name in configs}
        reset_counts()
        res = call(*args)
        got = counts()
        taken = {name: server.pool(name).steps - steps[name] for name in configs}
        want = {k: sum(n * SERVER_LAUNCHES[name].get(k, 0) for name, n in taken.items()) for k in got}
        if got != want:
            wrong.append((taken, got))
        for k, v in got.items():
            launched[k] += v
        return res

    def admit(limit: int):
        while queue and len(live) < limit:
            name, priority, wav = queue[0]
            try:
                handle = server.open(name, priority)
            except RuntimeError:
                return  # the pool is full
            queue.pop(0)
            opened[name].add(handle[1])
            live[handle] = {"name": name, "wav": wav, "pos": 0, "outs": []}
            sessions.append(live[handle])

    admit(sum(SERVER_POOLS.values()) // 2)  # the first stage half fills the slots
    iteration = 0
    while live or queue:
        for handle, s in live.items():
            hop = configs[s["name"]][1].hop_length
            server.feed(handle, s["wav"][s["pos"] : s["pos"] + hop])
            s["pos"] = min(s["pos"] + hop, len(s["wav"]))
        for handle, out in dispatch(server.step, 1 if iteration % 3 == 1 else None).items():
            live[handle]["outs"].append(out)
        for handle, s in list(live.items()):
            if s["pos"] == len(s["wav"]) and not server.ready(handle):
                s["outs"].append(dispatch(server.drain, handle))
                server.close(handle)
                del live[handle]
        iteration += 1
        admit(len(live) + 2 if iteration < 40 else len(queue) + len(live))  # then stages of two
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    steps = {name: server.pool(name).steps for name in configs}
    require(not wrong, f"server: every call launched its pools' steps' kernels exactly ({wrong[:3]})")
    want = {k: sum(steps[name] * SERVER_LAUNCHES[name].get(k, 0) for name in configs) for k in launched}
    require(launched == want, f"server: {steps} steps launched {launched} = {want} "
            "(2 GRU + 1 deep filter a config-3 step, 24 stencil + 1 deep filter a config-5b step)")
    for name in configs:
        count = SERVER_SESSIONS[name][0]
        require(len(opened[name]) < count, f"server pool {name}: {count} sessions in {len(opened[name])} "
                f"slots of {SERVER_POOLS[name]}: slots reused")
    for name, (model, cfg, plain_fn) in configs.items():
        enh = StreamingEnhancer(model, cfg)
        mine = [s for s in sessions if s["name"] == name]
        plain = plain_streams(enh, [s["wav"] for s in mine], plain_fn)
        worst, whole = [0.0, 0.0], True
        for s, want_plain in zip(mine, plain):
            got = np.concatenate(s["outs"])
            whole &= got.shape == s["wav"].shape and bool(np.isfinite(got).all())
            worst[0] = max(worst[0], float(np.abs(got - single_stream(enh, s["wav"])).max()))
            worst[1] = max(worst[1], float(np.abs(got - want_plain).max()))
        require(whole, f"server pool {name}: each session returns its input's length, finite")
        require(max(worst) <= WAV_TOL, f"server pool {name}: {len(mine)} sessions vs each streamed alone at B=1 "
                f"with the kernels, and with the plain versions: max-abs {worst[0]:.3g}, {worst[1]:.3g} <= {WAV_TOL}")
        print(f"server pool {name}: {len(tree_leaves(server.pool(name)._state))} masked state leaves, "
              f"{server.pool(name).steps} steps")
    print(f"server check on {smi}: {len(sessions)} sessions in {iteration} iterations, {served_s:.2f} s; "
          f"the phase {time.perf_counter() - t0:.2f} s")
    return launched


def time_server(model, device, smi) -> None:
    """Config 3's pool at SERVER_RTF_SLOTS slots, every slot fed 10 s at
    once and stepped until empty (aggregate x-realtime, wall ms a step),
    ``StreamingEnhancer.run`` on the same audio, and a profile of 20 steps."""
    t0 = time.perf_counter()
    cfg = StftConfig(n_fft=320, hop_length=160, center=False)
    server = StreamingServer(model, cfg, SERVER_RTF_SLOTS, device=device)
    wav = np.random.default_rng(SEED).standard_normal((SERVER_RTF_SLOTS, SERVER_RTF_SECONDS * SR)) \
        .astype(np.float32) * 0.1
    sids = [server.open() for _ in range(SERVER_RTF_SLOTS)]
    for sid in sids:
        server.feed(sid, wav[sid])
    server.step()  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = 0
    while server.step():
        steps += 1
    seconds = time.perf_counter() - t1
    audio = SERVER_RTF_SLOTS * steps * cfg.hop_length / SR
    print(f"server config 3, {SERVER_RTF_SLOTS} slots x {SERVER_RTF_SECONDS} s on {smi}: {steps} steps in "
          f"{seconds * 1e3:.1f} ms = {seconds / steps * 1e3:.4f} ms a step = {audio / seconds:.1f}x realtime "
          f"aggregate; {len(tree_leaves(server._state))} masked state leaves")
    x = torch.from_numpy(wav).to(device)
    run_s = stream_seconds(server.enhancer, x)
    audio = SERVER_RTF_SLOTS * ((x.shape[-1] - (cfg.n_fft - cfg.hop_length)) // cfg.hop_length) * cfg.hop_length / SR
    print(f"StreamingEnhancer.run config 3, B={SERVER_RTF_SLOTS} x {SERVER_RTF_SECONDS} s on {smi} (the same "
          f"call): {run_s * 1e3:.1f} ms = {audio / run_s:.1f}x realtime")
    for sid in sids:
        server.feed(sid, wav[sid, : 45 * cfg.hop_length])
    profile_calls(server.step, 20, f"config-3 server step, {SERVER_RTF_SLOTS} slots (a call is one step)")
    print(f"server timing phase: {time.perf_counter() - t0:.2f} s")


def check_serve_cli(smi) -> None:
    """The serve CLI as a subprocess, config 1 and config 5b registered,
    SERVE_CLI_SESSIONS sessions of 2 s (half each, the config-1 ones at a
    higher priority), --realtime --max_dispatches 1: it must exit 0 with
    every output as long as its input; prints its QoS line."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wavs = noisy_utterances(SEED + 21, (SERVE_CLI_SECONDS * SR + 77,) * SERVE_CLI_SESSIONS)
        for i, w in enumerate(wavs):
            write_wav(str(tmp / ("base" if i % 2 else "m5b") / f"s{i}.wav"), w, SR)
        cmd = [sys.executable, "-m", "cruse_tpu_torch.infer.serve",
               "-M", f"base={ROOT / 'configs/cruse_base.toml'}", "-M", f"m5b={ROOT / 'configs/mtfaa_windowed.toml'}",
               "-I", f"{tmp / 'base'}@base:1", "-I", f"{tmp / 'm5b'}@m5b:0", "-O", str(tmp / "out"),
               "--realtime", "--max_dispatches", "1"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        require(proc.returncode == 0, f"serve CLI exits 0 ({proc.returncode}; {proc.stderr[-1500:]})")
        lengths = {f.stem: read_wav(str(f))[0].shape[-1] for f in (tmp / "out").glob("*.wav")}
        require(lengths == {f"s{i}": len(w) for i, w in enumerate(wavs)},
                f"serve CLI wrote all {len(wavs)} sessions, each as long as its input")
        lines = [line for line in proc.stdout.splitlines() if "realtime" in line]
        require(any("realtime QoS" in line for line in lines), "serve CLI printed its realtime QoS line")
    for line in lines:
        print(f"serve CLI on {smi} ({seconds:.1f} s with start-up): {line}")


def snr_db(ref, test) -> float:
    ref, test = ref.double(), test.double()
    return float(10 * torch.log10((ref ** 2).sum() / ((ref - test) ** 2).sum().clamp_min(1e-300)))


def clone_model(model, device, state=None, keep_int8: bool = False):
    """A copy of ``model`` on ``device`` with its weights, or with ``state``'s
    int8 ones loaded dequantized (eager serving) or kept as int8 codes and
    scales (``attach_int8``, what an int8 artifact is exported from)."""
    clone = type(model)(model.config)
    clone.load_state_dict(model.state_dict())
    if state is not None:
        (attach_int8 if keep_int8 else load_dequantized)(clone, state)
    return clone.to(device).eval()


OP_MODULES = (gru_kernel, deep_filter_kernel, tfcm_kernel, asa_kernel, dw_kernel)  # a custom op's _forward each


@contextlib.contextmanager
def direct_forwards():
    """The five wrappers calling their launchers without the custom ops'
    dispatch, as they did before the ops were registered."""
    saved = [module._forward for module in OP_MODULES]
    for module in OP_MODULES:
        module._forward = module._forward_impl
    try:
        yield
    finally:
        for module, forward in zip(OP_MODULES, saved):
            module._forward = forward


def require_launches(what: str, want: dict) -> None:
    """The counters since ``reset_counts``: exactly ``want`` (a counter's
    name -> its launches; every GRU launch the resident kernel's), and
    nothing else."""
    torch.cuda.synchronize()
    got = counts()
    want = {**{name: 0 for name in got}, **want}
    require(got == want and gru_sequence.resident_launches == want["gru_sequence"],
            f"{what}: launches {({k: v for k, v in got.items() if v})} = {({k: v for k, v in want.items() if v})}"
            + (", every GRU launch the resident kernel's" if want["gru_sequence"] else ""))


def hop_ms(step, state, hops) -> float:
    """Wall ms a hop of ``step`` over ``hops`` (a list of [B, hop] tensors),
    synchronised at the end, after a warm-up hop."""
    _, state = step(state, hops[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for hop in hops:
        _, state = step(state, hop)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(hops) * 1e3


def in_turns(runs: dict, rounds: int = 2) -> dict:
    """Each of ``runs`` (name -> a function returning a list of times) called
    in turns, forwards then backwards, ``rounds`` times: name -> every time."""
    times = {key: [] for key in runs}
    for key in [*runs, *reversed(runs)] * rounds:
        times[key] += runs[key]()
    return times


def hop_latencies_ms(step, state, hops) -> list:
    """Wall ms of each hop of ``step`` over ``hops``, each synchronised (a
    real-time hop's latency), after a warm-up hop."""
    _, state = step(state, hops[0])
    torch.cuda.synchronize()
    times = []
    for hop in hops:
        t0 = time.perf_counter()
        _, state = step(state, hop)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def median_range(times: list) -> str:
    ordered = sorted(times)
    return f"median {ordered[len(ordered) // 2]:.4f} ms, range {ordered[0]:.4f}-{ordered[-1]:.4f} ms"


def dispatch_us(device, smi, calls: int = 1000) -> None:
    """Host µs a call of ``gru_sequence`` and ``deep_filter`` at the config-3
    B=1 hop's shapes (G=4, H=176; 96 bins, 15 taps, a history), through the
    custom op and with the launcher called directly (``op_dispatch_us``)."""
    gru_args = gru_inputs(1, 1, 4, 176, device, SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    spec = torch.randn(1, 1, 96, dtype=torch.complex64, device=device, generator=gen)
    coefs = torch.randn(1, 1, 96, 15, 2, device=device, generator=gen)
    history = torch.randn(1, 4, 96, dtype=torch.complex64, device=device, generator=gen)
    op_dispatch_us({"gru_sequence": lambda: gru_sequence(*gru_args),
                    "deep_filter": lambda: deep_filter(spec, coefs, 2, 1, True, history)},
                   "at the config-3 B=1 hop", smi, calls)


def mtfaa_dispatch_us(device, smi, calls: int = 1000) -> None:
    """The same for the three MTFAA ops at config 5b's stage 0 at B=1 and one
    frame (K=64, C=24; c=6 for the attention; d=1 for the stencil, its hop
    shape), shapes at which the host's time is the call's."""
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, device=device, generator=gen) * 0.3

    x, params = randn(1, 64, 24, 1), randn(len(DILATIONS), 2 * 24 * 24 + 12 * 24 + 2)
    q, k, v = randn(64, 6, 1), randn(64, 6, 1), randn(64, 24, 1)
    x_ext, wd = randn(1, 64, 24, 3), randn(3, 3, 24)
    op_dispatch_us({"tfcm_eval": lambda: fused_tfcm_stack_eval(x, params, dilations=DILATIONS),
                    "tattn_fwd": lambda: flash_tattn_tm(q, k, v, WINDOW),
                    "dw_fwd": lambda: dw_causal_tm(x_ext, wd, 1)},
                   "at config 5b's stage 0, B=1, T=1", smi, calls)


def op_dispatch_us(fns: dict, where: str, smi, calls: int) -> None:
    """Each of ``fns`` (name -> a call of a wrapper) through its custom op and
    with the launcher called directly (``direct_forwards``), in turns, each
    run of ``calls`` calls synchronised at its end: host µs a call."""
    for name, fn in fns.items():
        times = {"custom op": [], "direct": []}
        for mode in ("custom op", "direct", "direct", "custom op"):
            with torch.inference_mode(), direct_forwards() if mode == "direct" else contextlib.nullcontext():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) / calls * 1e6)
        print(f"{name} {where} on {smi}: " + "; ".join(
            f"{mode} " + ", ".join(f"{t:.2f}" for t in ts) + " us a call" for mode, ts in times.items()))


def check_offline_artifacts(device, smi, tmp: Path) -> tuple[int, Path]:
    """Config 1 (``configs/cruse_base.toml``, seeded weights and BatchNorm
    statistics) exported offline at B=16 x 10 s on the card, float32 and
    int8, saved and loaded: each call 2 resident GRU launches and nothing
    else; each within DEPLOY_TOL of eager ``mag_to_mag`` on the same
    (dequantized) weights, float32 within WAV_TOL of the plain recurrence,
    int8 against float32 above INT8_SNR_DB; times and file sizes. Returns
    the GRU launches and the float32 artifact's path."""
    config = load_config(str(ROOT / "configs" / "cruse_base.toml"))
    gen = torch.Generator().manual_seed(SEED + 30)
    model = build_from_config(config["model"], generator=gen)
    seed_batch_norm_stats(model, gen)
    ac = config["acoustics"]
    icfg = InferencerConfig(type=config["inferencer"]["type"], sr=int(ac["sr"]),
                            stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"])))
    state, report = int8_state_dict(model)
    print(f"config 1: {report_line(report)}")
    length = DEPLOY_SECONDS * SR
    x = torch.from_numpy(np.stack(noisy_utterances(SEED + 31, (length,) * DEPLOY_BATCH))).to(device)
    outs, launches = {}, 0
    for quant in (None, "int8"):
        what = f"config-1 offline artifact ({quant or 'fp32'}, B={DEPLOY_BATCH} x {DEPLOY_SECONDS} s)"
        t0 = time.perf_counter()
        program = export_offline(clone_model(model, device, state if quant else None, keep_int8=True), icfg,
                                 DEPLOY_BATCH, length, device)
        path = tmp / f"config1_{quant or 'fp32'}.zip"
        artifact_lib.save_offline(str(path), program, {"model": config["model"]["path"], "sr": SR,
                                                       "n_fft": icfg.stft.n_fft, "hop_length": icfg.stft.hop_length,
                                                       "batch": DEPLOY_BATCH, "length": length, "quantized": quant,
                                                       "device": str(device)})
        export_s = time.perf_counter() - t0
        art = artifact_lib.load(str(path), device)
        params = sum(t.numel() * t.element_size() for t in art.program.state_dict.values())
        reset_counts()
        got = art.enhance(x)
        require_launches(what, {"gru_sequence": 2})
        launches += 2
        require(tuple(got.shape) == tuple(x.shape) and bool(torch.isfinite(got).all()), f"{what}: finite, {tuple(x.shape)}")
        eager = BatchInferencer(clone_model(model, device, state if quant else None), icfg, device)
        err = float((got - eager.mag_to_mag(x)).abs().max())
        require(err <= DEPLOY_TOL, f"{what} vs eager mag_to_mag on the same weights: max-abs {err:.3g} <= {DEPLOY_TOL}")
        if quant is None:
            set_recurrence(eager.model, gru_sequence_reference)
            plain_err = float((got - eager.mag_to_mag(x)).abs().max())
            set_recurrence(eager.model, gru_sequence)
            require(plain_err <= WAV_TOL, f"{what} vs the plain recurrence: max-abs {plain_err:.3g} <= {WAV_TOL}")
        art_s, eager_s = enhancement_seconds(art.enhance, x), enhancement_seconds(eager.mag_to_mag, x)
        print(f"{what} on {smi}: {art_s * 1e3:.3f} ms a call, eager mag_to_mag {eager_s * 1e3:.3f} ms; file "
              f"{path.stat().st_size / 1e6:.3f} MB, parameters {params / 1e6:.3f} MB; export and save {export_s:.1f} s")
        outs[quant] = got
    snr = snr_db(outs[None], outs["int8"])
    require(snr > INT8_SNR_DB, f"config-1 int8 artifact against float32: {snr:.2f} dB > {INT8_SNR_DB} dB")
    return launches, tmp / "config1_fp32.zip"


def check_streaming_artifacts(device, smi, tmp: Path) -> tuple[int, int]:
    """Config 3 (``CruseDfConfig()``, seeded) exported as the streaming step on
    the card at B=1 and B=16, saved and loaded, primed and run DEPLOY_HOPS
    hops against ``StreamingEnhancer`` on the same hops (within DEPLOY_TOL),
    exactly 2 resident GRU and 1 deep-filter launch a hop; the same for an
    int8 artifact at B=1 against the eager path on the dequantized weights.
    Times a B=1 hop of the artifact and of the eager path with the custom ops
    and without them (the wrappers calling the launchers directly), in turns,
    and profiles a float32 and an int8 artifact hop. Returns the (GRU, deep
    filter) launches."""
    model = build_cruse_df(device)
    cfg = StftConfig(n_fft=320, hop_length=160, center=False)
    keep, hop = cfg.n_fft - cfg.hop_length, cfg.hop_length
    state, report = int8_state_dict(model)
    print(f"config 3: {report_line(report)}")
    gru_total = df_total = 0
    arts = {}
    for b, quant in [(b, None) for b in DEPLOY_STREAM_BATCHES] + [(1, "int8")]:
        what = f"config-3 streaming artifact ({quant or 'fp32'}, B={b}, {DEPLOY_HOPS} hops)"
        t0 = time.perf_counter()
        program, init = export_streaming(clone_model(model, device, state if quant else None, keep_int8=True), cfg,
                                         b, device)
        path = tmp / f"config3_{quant or 'fp32'}_b{b}.zip"
        artifact_lib.save_streaming(str(path), program, init, {"model": "CruseDfConfig()", "sr": SR, "n_fft": cfg.n_fft,
                                                               "hop_length": hop, "batch": b, "quantized": quant,
                                                               "device": str(device)})
        export_s = time.perf_counter() - t0
        art = artifact_lib.load(str(path), device)
        enh = StreamingEnhancer(clone_model(model, device, state if quant else None), cfg)
        wav = torch.from_numpy(np.stack(noisy_utterances(SEED + 32 + b, (keep + DEPLOY_HOPS * hop,) * b))).to(device)
        hops = [wav[:, keep + i * hop : keep + (i + 1) * hop] for i in range(DEPLOY_HOPS)]
        a_state, e_state = art.prime(art.init_state(), wav[:, :keep]), enh.prime(enh.init_state(b), wav[:, :keep])
        reset_counts()
        got = []
        for h in hops:
            out, a_state = art.step(a_state, h)
            got.append(out)
        require_launches(what, {"gru_sequence": 2 * DEPLOY_HOPS, "deep_filter": DEPLOY_HOPS})
        gru_total, df_total = gru_total + 2 * DEPLOY_HOPS, df_total + DEPLOY_HOPS
        want = []
        for h in hops:
            out, e_state = enh.step(e_state, h)
            want.append(out)
        got, want = torch.cat(got, -1), torch.cat(want, -1)
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= DEPLOY_TOL,
                f"{what} vs StreamingEnhancer on the same weights: max-abs {err:.3g} <= {DEPLOY_TOL}")
        print(f"{what}: file {path.stat().st_size / 1e6:.3f} MB; export and save {export_s:.1f} s")
        if b == 1:
            arts[quant] = (art, enh, a_state, e_state, hops)
    art, enh, a_state, e_state, hops = arts[None]

    def direct_hop_ms():
        with direct_forwards():
            return hop_ms(enh.step, e_state, hops)

    times = in_turns({"eager, direct launchers": lambda: [direct_hop_ms()],
                      "eager, custom ops": lambda: [hop_ms(enh.step, e_state, hops)],
                      "artifact": lambda: [hop_ms(art.step, a_state, hops)],
                      "int8 artifact": lambda: [hop_ms(arts["int8"][0].step, arts["int8"][2], hops)]})
    print(f"config-3 B=1 hop on {smi}: " + "; ".join(
        f"{key} " + ", ".join(f"{t:.4f}" for t in ts) + " ms" for key, ts in times.items()))
    dispatch_us(device, smi)
    kernels = {}
    for quant, (a, _, st, _, _) in (("fp32", arts[None]), ("int8", arts["int8"])):
        carry = {"state": st, "i": 0}

        def one_hop():
            _, carry["state"] = a.step(carry["state"], hops[carry["i"] % len(hops)])
            carry["i"] += 1

        kernels[quant] = profile_calls(one_hop, 20, f"config-3 B=1 {quant} streaming artifact hop").kernels
    print(f"config-3 B=1 hop on {smi}: the int8 artifact makes {kernels['int8']:.1f} device launches a hop, the "
          f"float32 one {kernels['fp32']:.1f}: {kernels['int8'] - kernels['fp32']:.1f} more (each int8 weight "
          f"dequantized, and w_hh laid out again for the resident kernel, every hop)")
    return gru_total, df_total


def run_cli(args: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", *map(str, args)], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def wav_dir_err(got: Path, want: Path, names: list) -> float:
    """Largest max-abs difference between same-named wavs of two directories."""
    worst = 0.0
    for name in names:
        a, b = read_wav(str(got / f"{name}.wav"))[0], read_wav(str(want / f"{name}.wav"))[0]
        if a.shape != b.shape or a.size == 0:
            raise RuntimeError(f"check failed: {got.name}/{name}.wav is {a.shape}, {want.name}'s {b.shape}")
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def check_deploy_clis(device, smi, tmp: Path, artifact: Path) -> None:
    """The CLIs on the card, five fresh subprocesses at once: ``run_exported``
    on the config-1 artifact (each wav as the artifact enhances it in this
    process); ``infer --quantize int8`` on config 1 and ``serve --quantize
    int8`` on config 1 with config 5b, seeded weights, each against the same
    run on the dequantized weights (a bridge ``.npz``). The CLIs write int16
    wavs, and one run in two processes differs by a rounding (cuDNN's
    transposed-conv algorithms), so wavs agree within WAV_STEP; the same
    weights through the CLIs' own loaders (``infer.serve.build_model``) give
    enhanced floats within CLI_TOL in this process (``mag_to_mag``, and one
    session of each served model)."""
    names = [f"u{i}" for i in range(CLI_FILES)]
    wavs = noisy_utterances(SEED + 40, (CLI_SECONDS * SR + 77,) * CLI_FILES)
    for name, w in zip(names, wavs):  # the same audio as each model's sessions, under names of their own
        for sub, prefix in (("in", ""), ("in_base", "base_"), ("in_m5b", "m5b_")):
            write_wav(str(tmp / sub / f"{prefix}{name}.wav"), w, SR)
    base, m5b = ROOT / "configs/cruse_base.toml", ROOT / "configs/mtfaa_windowed.toml"
    seed = SEED + 41
    for config, npz in ((base, "base.npz"), (m5b, "m5b.npz")):
        model, _, _ = serve_build_model(str(config), None, seed)
        save_flax_npz(dequantize_tree(quantize_variables(flax_from_state_dict(model))), str(tmp / npz))
    serve = ["-I", f"{tmp / 'in_base'}@base:1", "-I", f"{tmp / 'in_m5b'}@m5b:0", "--max_streams", "2"]
    procs = {
        "run_exported": run_cli(["cruse_tpu_torch.infer.run_exported", "-A", artifact, "-I", tmp / "in",
                                 "-O", tmp / "run_exported", "--device", device]),
        "infer int8": run_cli(["cruse_tpu_torch.infer", "-C", base, "-I", tmp / "in", "-O", tmp / "infer_int8",
                               "--batch", CLI_FILES, "--seed", seed, "--quantize", "int8", "--device", device]),
        "infer dequantized": run_cli(["cruse_tpu_torch.infer", "-C", base, "-I", tmp / "in", "-O", tmp / "infer_deq",
                                      "--batch", CLI_FILES, "--weights", tmp / "base.npz", "--device", device]),
        "serve int8": run_cli(["cruse_tpu_torch.infer.serve", "-M", f"base={base}", "-M", f"m5b={m5b}", *serve,
                               "-O", tmp / "serve_int8", "--seed", seed, "--quantize", "int8", "--device", device]),
        "serve dequantized": run_cli(["cruse_tpu_torch.infer.serve", "-M", f"base={base}:{tmp / 'base.npz'}",
                                      "-M", f"m5b={m5b}:{tmp / 'm5b.npz'}", *serve, "-O", tmp / "serve_deq",
                                      "--device", device]),
    }
    t0 = time.perf_counter()
    logs = {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"{key} CLI exits 0 ({proc.returncode}; {err[-1500:]})")
        logs[key] = out
    print(f"the five CLI runs on {smi} took {time.perf_counter() - t0:.1f} s together, start-up included")
    require(any("int8 weights:" in line for line in logs["infer int8"].splitlines())
            and sum("int8 weights:" in line for line in logs["serve int8"].splitlines()) == 2,
            "infer and serve logged their int8 report lines")
    art = artifact_lib.load(str(artifact), device)
    batch, length = art.input_shape
    x = np.zeros((batch, length), np.float32)
    for i, name in enumerate(names):
        x[i, : len(wavs[i])] = read_wav(str(tmp / "in" / f"{name}.wav"))[0]
    want = art.enhance(torch.from_numpy(x).to(device)).cpu().numpy()
    for i, name in enumerate(names):
        write_wav(str(tmp / "run_here" / f"{name}.wav"), to_int16_scaled(want[i, : len(wavs[i])]), SR)
    err = wav_dir_err(tmp / "run_exported", tmp / "run_here", names)
    require(err <= WAV_STEP, f"run_exported (a fresh process) vs the artifact in this one: max-abs {err:.3g} "
            "<= one int16 step")
    for cli, outputs in (("infer", names), ("serve", [f"{m}_{n}" for m in ("base", "m5b") for n in names])):
        err = wav_dir_err(tmp / f"{cli}_int8", tmp / f"{cli}_deq", outputs)
        require(err <= WAV_STEP, f"{cli} --quantize int8 vs {cli} on the dequantized weights (wavs): max-abs "
                f"{err:.3g} <= one int16 step")
    clip = torch.from_numpy(x[:CLI_FILES, : CLI_SECONDS * SR]).to(device)
    for config, npz in ((base, "base.npz"), (m5b, "m5b.npz")):
        pair = [serve_build_model(str(config), None, seed, "int8"), serve_build_model(str(config), str(tmp / npz), seed)]
        model, cfg, _ = pair[0]
        if config == base:
            icfg = InferencerConfig(type="mag_to_mag", sr=SR, stft=StftConfig(n_fft=cfg.n_fft, hop_length=cfg.hop_length))
            got, want = (BatchInferencer(m, icfg, device).mag_to_mag(clip) for m, _, _ in pair)
            err = float((got - want).abs().max())
            require(err <= CLI_TOL, f"config 1 mag_to_mag, int8 loaded vs the dequantized .npz: max-abs {err:.3g} "
                    f"<= {CLI_TOL}")
        padded = np.pad(x[0, : CLI_SECONDS * SR], (0, (-CLI_SECONDS * SR) % cfg.hop_length))
        got, want = (StreamingServer(m, c, 1, device=device).run_session(padded) for m, c, _ in pair)
        err = float(np.abs(got - want).max())
        require(err <= CLI_TOL, f"{config.name} served session, int8 loaded vs the dequantized .npz: max-abs "
                f"{err:.3g} <= {CLI_TOL}")
    for line in logs["serve int8"].splitlines()[-1:]:
        print(f"serve --quantize int8 on {smi}: {line}")


def check_mtfaa_offline_artifacts(device, smi, tmp: Path) -> dict:
    """Config 5b (``configs/mtfaa_windowed.toml``, seeded weights and
    statistics) exported offline at B=16 x 10 s on the card, float32 and
    int8, saved and loaded: each call MTFAA_CALL_LAUNCHES and nothing else,
    within DEPLOY_TOL of eager ``auto`` on the same (dequantized) weights,
    float32 within WAV_TOL of the plain versions, int8 against float32 above
    INT8_SNR_DB; a call timed in turns with eager, file sizes, and the device
    launches a call of both from a profile. Then config 5 (``MtfaaConfig()``,
    full causal) at B=4 x 4 s in float32: the eager forward's launches, within
    DEPLOY_TOL of it. Returns the launches its artifacts made."""
    model = build_mtfaa(None, device, SEED + 50)
    icfg = mtfaa_inferencer(model, device).cfg
    state, report = int8_state_dict(model)
    print(f"config 5b: {report_line(report)}")
    length = MTFAA_SECONDS * SR
    x = torch.from_numpy(np.stack(noisy_utterances(SEED + 51, (length,) * MTFAA_BATCH))).to(device)
    launched = {name: 0 for name in MTFAA_CALL_LAUNCHES}
    outs = {}
    for quant in (None, "int8"):
        what = f"config-5b offline artifact ({quant or 'fp32'}, B={MTFAA_BATCH} x {MTFAA_SECONDS} s)"
        t0 = time.perf_counter()
        program = export_offline(clone_model(model, device, state if quant else None, keep_int8=True), icfg,
                                 MTFAA_BATCH, length, device)
        path = tmp / f"config5b_{quant or 'fp32'}.zip"
        artifact_lib.save_offline(str(path), program, {"model": "configs/mtfaa_windowed.toml", "sr": SR,
                                                       "n_fft": icfg.stft.n_fft, "hop_length": icfg.stft.hop_length,
                                                       "batch": MTFAA_BATCH, "length": length, "quantized": quant,
                                                       "device": str(device)})
        export_s = time.perf_counter() - t0
        art = artifact_lib.load(str(path), device)
        reset_counts()
        got = art.enhance(x)
        require_launches(what, MTFAA_CALL_LAUNCHES)
        launched = {name: n + MTFAA_CALL_LAUNCHES[name] for name, n in launched.items()}
        require(tuple(got.shape) == tuple(x.shape) and bool(torch.isfinite(got).all()),
                f"{what}: finite, {tuple(x.shape)}")
        eager = mtfaa_inferencer(clone_model(model, device, state if quant else None), device)
        err = float((got - eager.auto(x)).abs().max())
        require(err <= DEPLOY_TOL, f"{what} vs eager auto on the same weights: max-abs {err:.3g} <= {DEPLOY_TOL}")
        if quant is None:
            set_plain_mtfaa(eager.model, True)
            plain_err = float((got - eager.auto(x)).abs().max())
            set_plain_mtfaa(eager.model, False)
            require(plain_err <= WAV_TOL, f"{what} vs the plain versions: max-abs {plain_err:.3g} <= {WAV_TOL}")
        times = in_turns({"artifact": lambda: [enhancement_seconds(art.enhance, x) * 1e3],
                          "eager auto": lambda: [enhancement_seconds(eager.auto, x) * 1e3]}, rounds=1)
        kernels = {key: profile_calls(fn, 3, f"{what}, {key}").kernels
                   for key, fn in (("artifact", lambda: art.enhance(x)), ("eager auto", lambda: eager.auto(x)))}
        print(f"{what} on {smi}: " + "; ".join(f"{key} " + ", ".join(f"{t:.3f}" for t in ts) + " ms a call"
                                               for key, ts in times.items())
              + f"; device launches a call: artifact {kernels['artifact']:.1f}, eager {kernels['eager auto']:.1f}; "
              f"file {path.stat().st_size / 1e6:.3f} MB; export and save {export_s:.1f} s")
        outs[quant] = got
        del eager, art, program
    snr = snr_db(outs[None], outs["int8"])
    require(snr > INT8_SNR_DB, f"config-5b int8 artifact against float32: {snr:.2f} dB > {INT8_SNR_DB} dB")
    del outs, x
    torch.cuda.empty_cache()

    what = f"config-5 offline artifact (fp32, B={CAUSAL_BATCH} x {CAUSAL_SECONDS} s)"
    eager = mtfaa_inferencer(build_mtfaa(MtfaaConfig(), device, SEED + 52), device)
    x = torch.from_numpy(np.stack(noisy_utterances(SEED + 53, (CAUSAL_SECONDS * SR,) * CAUSAL_BATCH))).to(device)
    reset_counts()
    want = eager.auto(x)
    torch.cuda.synchronize()
    eager_launches = {name: n for name, n in counts().items() if n}
    t0 = time.perf_counter()
    program = export_offline(clone_model(eager.model, device), eager.cfg, CAUSAL_BATCH, CAUSAL_SECONDS * SR, device)
    path = tmp / "config5_fp32.zip"
    artifact_lib.save_offline(str(path), program, {"model": "MtfaaConfig()", "sr": SR, "n_fft": 512, "hop_length": 256,
                                                   "batch": CAUSAL_BATCH, "length": CAUSAL_SECONDS * SR,
                                                   "quantized": None, "device": str(device)})
    export_s = time.perf_counter() - t0
    art = artifact_lib.load(str(path), device)
    reset_counts()
    got = art.enhance(x)
    require_launches(f"{what}, as the eager forward's", eager_launches)
    launched = {name: n + eager_launches.get(name, 0) for name, n in launched.items()}
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()) and err <= DEPLOY_TOL,
            f"{what} vs eager auto on the same weights: max-abs {err:.3g} <= {DEPLOY_TOL}")
    print(f"{what}: file {path.stat().st_size / 1e6:.3f} MB; export and save {export_s:.1f} s")
    return launched


def check_mtfaa_streaming_artifacts(device, smi, tmp: Path) -> dict:
    """Config 5b exported as the streaming step on the card at B=1 and B=8
    (and int8 at B=1), saved and loaded, primed and run DEPLOY_HOPS hops
    against ``StreamingEnhancer`` on the same hops (within DEPLOY_TOL), each
    hop MTFAA_HOP_LAUNCHES and nothing else. The B=1 hop's latency (each hop
    synchronised) of the eager path with and without the custom ops'
    dispatch and of both artifacts, in turns; the MTFAA ops' dispatch cost;
    profiles of an eager, a float32 and an int8 hop, the float32 artifact's
    launching no more device kernels than the eager one's. Returns the
    launches its artifacts made."""
    model = build_mtfaa(None, device, SEED + 54)
    cfg = StftConfig(n_fft=512, hop_length=256, center=False)
    keep, hop = cfg.n_fft - cfg.hop_length, cfg.hop_length
    state, _ = int8_state_dict(model)
    launched = {name: 0 for name in MTFAA_HOP_LAUNCHES}
    per_run = {name: n * DEPLOY_HOPS for name, n in MTFAA_HOP_LAUNCHES.items()}
    arts = {}
    for b, quant in [(b, None) for b in MTFAA_DEPLOY_BATCHES] + [(1, "int8")]:
        what = f"config-5b streaming artifact ({quant or 'fp32'}, B={b}, {DEPLOY_HOPS} hops)"
        t0 = time.perf_counter()
        program, init = export_streaming(clone_model(model, device, state if quant else None, keep_int8=True), cfg,
                                         b, device)
        path = tmp / f"config5b_{quant or 'fp32'}_b{b}.zip"
        artifact_lib.save_streaming(str(path), program, init, {"model": "configs/mtfaa_windowed.toml", "sr": SR,
                                                               "n_fft": cfg.n_fft, "hop_length": hop, "batch": b,
                                                               "quantized": quant, "device": str(device)})
        export_s = time.perf_counter() - t0
        art = artifact_lib.load(str(path), device)
        enh = StreamingEnhancer(clone_model(model, device, state if quant else None), cfg)
        wav = torch.from_numpy(np.stack(noisy_utterances(SEED + 55 + b, (keep + DEPLOY_HOPS * hop,) * b))).to(device)
        hops = [wav[:, keep + i * hop : keep + (i + 1) * hop] for i in range(DEPLOY_HOPS)]
        a_state, e_state = art.prime(art.init_state(), wav[:, :keep]), enh.prime(enh.init_state(b), wav[:, :keep])
        reset_counts()
        got = []
        for h in hops:
            out, a_state = art.step(a_state, h)
            got.append(out)
        require_launches(what, per_run)
        launched = {name: n + per_run[name] for name, n in launched.items()}
        want = []
        for h in hops:
            out, e_state = enh.step(e_state, h)
            want.append(out)
        got, want = torch.cat(got, -1), torch.cat(want, -1)
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= DEPLOY_TOL,
                f"{what} vs StreamingEnhancer on the same weights: max-abs {err:.3g} <= {DEPLOY_TOL}")
        print(f"{what}: file {path.stat().st_size / 1e6:.3f} MB; export and save {export_s:.1f} s")
        if b == 1:
            arts[quant] = (art, enh, a_state, e_state, hops)
    art, enh, a_state, e_state, hops = arts[None]

    def eager_direct():
        with direct_forwards():
            return hop_latencies_ms(enh.step, e_state, hops)

    times = in_turns({"eager, direct launchers": eager_direct,
                      "eager, custom ops": lambda: hop_latencies_ms(enh.step, e_state, hops),
                      "artifact": lambda: hop_latencies_ms(art.step, a_state, hops),
                      "int8 artifact": lambda: hop_latencies_ms(arts["int8"][0].step, arts["int8"][2], hops)},
                     rounds=1)
    print(f"config-5b B=1 hop on {smi}, {2 * DEPLOY_HOPS} hops each, each synchronised: " + "; ".join(
        f"{key} {median_range(ts)}" for key, ts in times.items()))
    mtfaa_dispatch_us(device, smi)
    kernels = {}
    for key, step, st in (("eager", enh.step, e_state), ("fp32", art.step, a_state),
                          ("int8", arts["int8"][0].step, arts["int8"][2])):
        carry = {"state": st, "i": 0}

        def one_hop():
            _, carry["state"] = step(carry["state"], hops[carry["i"] % len(hops)])
            carry["i"] += 1

        kernels[key] = profile_calls(one_hop, 20, f"config-5b B=1 {key} streaming hop").kernels
    require(kernels["fp32"] <= kernels["eager"],
            f"config-5b B=1 hop: the float32 artifact makes {kernels['fp32']:.1f} device launches a hop <= the eager "
            f"hop's {kernels['eager']:.1f} (it folds nothing per call)")
    print(f"config-5b B=1 hop on {smi}: the int8 artifact makes {kernels['int8']:.1f} device launches a hop, the "
          f"float32 one {kernels['fp32']:.1f}: {kernels['int8'] - kernels['fp32']:.1f} more (each int8 weight "
          f"dequantized, and stage 2's TFCM parameters folded, every hop)")
    return launched


def check_mtfaa_clis(device, smi, tmp: Path) -> None:
    """``export --streaming`` of config 5b (``configs/mtfaa_windowed.toml``,
    seeded weights) at B=CLI_FILES and the eager ``infer --streaming`` CLI on
    the same seed, at once, then ``run_exported`` on the artifact, all fresh
    processes on the card, over CLI_FILES utterances of about CLI_SECONDS
    (whole hops past the prime, so both write every hop): wav by wav within
    WAV_STEP."""
    names = [f"m{i}" for i in range(CLI_FILES)]
    hop = 256  # config 5b's, and its prime n_fft - hop
    length = hop + (CLI_SECONDS * SR - hop) // hop * hop
    for name, w in zip(names, noisy_utterances(SEED + 56, (length,) * CLI_FILES)):
        write_wav(str(tmp / "in_mtfaa" / f"{name}.wav"), w, SR)
    config, seed, artifact = ROOT / "configs/mtfaa_windowed.toml", SEED + 57, tmp / "m5b_stream.zip"
    t0 = time.perf_counter()
    procs = {"export --streaming": run_cli(["cruse_tpu_torch.infer.export", "-C", config, "-O", artifact,
                                            "--seed", seed, "--batch", CLI_FILES, "--streaming", "--device", device]),
             "infer --streaming": run_cli(["cruse_tpu_torch.infer", "-C", config, "-I", tmp / "in_mtfaa",
                                           "-O", tmp / "m5b_infer", "--streaming", "--seed", seed, "--device", device])}
    logs = {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        failed = f" ({proc.returncode}; {err[-1500:]})" if proc.returncode else ""
        require(proc.returncode == 0, f"{key} CLI on config 5b exits 0{failed}")
        logs[key] = out
    require("reload check OK" in logs["export --streaming"], "export --streaming reloaded and ran its artifact")
    proc = run_cli(["cruse_tpu_torch.infer.run_exported", "-A", artifact, "-I", tmp / "in_mtfaa",
                    "-O", tmp / "m5b_run_exported", "--device", device])
    out, err = proc.communicate(timeout=600)
    failed = f" ({proc.returncode}; {err[-1500:]})" if proc.returncode else ""
    require(proc.returncode == 0, f"run_exported on the config-5b stream exits 0{failed}")
    print(f"the config-5b CLI runs on {smi} took {time.perf_counter() - t0:.1f} s, start-up included; run_exported: "
          f"{out.strip().splitlines()[-1]}")
    err = wav_dir_err(tmp / "m5b_run_exported", tmp / "m5b_infer", names)
    require(err <= WAV_STEP, f"run_exported on the config-5b stream (B={CLI_FILES}) vs infer --streaming (B=1) on the "
            f"same seed: max-abs {err:.3g} <= one int16 step")


def write_trainer_corpus(root: Path) -> None:
    """TRAINER_CLIPS clean clips of TRAINER_CLIP_SECONDS s (three tones under a
    syllable-rate envelope, as examples/make_tiny_corpus.py makes them) and as
    many noise clips, with train / validation manifests (the last
    TRAINER_VALID_CLIPS of each for validation)."""
    rng = np.random.default_rng(SEED + 7)
    n = TRAINER_CLIP_SECONDS * SR
    t = np.arange(n) / SR
    files = {"clean": [], "noise": []}
    for i in range(TRAINER_CLIPS):
        env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t + rng.uniform(0, 6)))
        tones = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) for f in (210, 430, 870))
        files["clean"].append(str(root / f"clean_{i}.wav"))
        write_wav(files["clean"][-1], (env * tones / 3 * 0.3).astype(np.float32), SR)
        files["noise"].append(str(root / f"noise_{i}.wav"))
        write_wav(files["noise"][-1], (rng.standard_normal(n) * 0.1).astype(np.float32), SR)
    split = TRAINER_CLIPS - TRAINER_VALID_CLIPS
    for kind, paths in files.items():
        write_manifest(paths[:split], str(root / f"{kind}_train.txt"))
        write_manifest(paths[split:], str(root / f"{kind}_valid.txt"))


def trainer_config(root: Path, epochs: int) -> Path:
    """configs/cruse_base.toml with its manifests pointed at the corpus under
    root, its runs written there, and TRAINER_STEPS steps an epoch for
    ``epochs`` epochs; every other field as published."""
    text = (ROOT / "configs" / "cruse_base.toml").read_text()
    for old, new in (('save_dir = "runs"', f'save_dir = "{root / "runs"}"'),
                     ("epochs = 100", f"epochs = {epochs}"),
                     ("steps_per_epoch = 200", f"steps_per_epoch = {TRAINER_STEPS}"),
                     ("manifests/", f"{root}/")):
        if old not in text:
            raise RuntimeError(f"check failed: configs/cruse_base.toml has no {old!r}")
        text = text.replace(old, new)
    path = root / f"cruse_base_{epochs}.toml"
    path.write_text(text)
    return path


def epoch_lines(log_text: str, epoch: int) -> dict:
    """The trainer's logged epoch means: metric -> value."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(rf"  epoch {epoch} (\w+): (\S+)", log_text)}


def served_against_trainer(trainer, config: Path, snapshot: Path, root: Path) -> None:
    """``python -m cruse_tpu_torch.infer --weights model_NNNN.npz`` on two
    validation clips against the trainer's own enhancement of them (the
    CLI writes int16 at 0.8 of full scale: the trainer's output is scaled the
    same way and held within 1e-4)."""
    clips, out = root / "clips", root / "served"
    clips.mkdir()
    names = [f"clean_{i}" for i in range(TRAINER_CLIPS - 2, TRAINER_CLIPS)]
    for name in names:
        os.link(root / f"{name}.wav", clips / f"{name}.wav")
    t0 = time.perf_counter()
    proc = run_cli(["cruse_tpu_torch.infer", "-C", config, "-I", clips, "-O", out, "--weights", snapshot])
    _, stderr = proc.communicate(timeout=600)
    require(proc.returncode == 0, f"infer --weights {snapshot.name} exits 0 ({stderr[-2000:]})")
    worst = 0.0
    for name in names:
        wav = torch.from_numpy(read_wav(str(clips / f"{name}.wav"))[0][None]).to(trainer.device)
        own = trainer.enhance(wav)[0].cpu().numpy()
        own = 0.8 * 32767 * own / np.abs(own).max() / 32768
        served = read_wav(str(out / f"{name}.wav"))[0]
        require(served.shape == own.shape, f"served {name}: {served.shape} samples = {own.shape}")
        worst = max(worst, float(np.abs(served - own).max()))
    require(worst <= WAV_TOL, f"infer --weights {snapshot.name} on {len(names)} clips against the trainer's "
            f"enhancement: max-abs {worst:.3g} <= {WAV_TOL} ({time.perf_counter() - t0:.1f} s with start-up)")


def trainer_state_equals(trainer, saved: dict) -> bool:
    """The trainer's state equals a checkpoint's tensors bit for bit."""
    state = trainer.state
    model = state.model.state_dict()
    return (all(torch.equal(model[k].cpu(), v) for k, v in saved["model"].items()) and model.keys() == saved["model"].keys()
            and all(torch.equal(a.cpu(), b) for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                                                          saved["opt_mu"] + saved["opt_nu"]))
            and len(state.opt_state.mu) == len(saved["opt_mu"]) and state.opt_state.count == saved["opt_count"]
            and all(torch.equal(state.balancer_state.total[k].cpu(), v) for k, v in saved["balancer_total"].items())
            and all(torch.equal(state.balancer_state.fix[k].cpu(), v) for k, v in saved["balancer_fix"].items())
            and state.step == saved["step"])


def check_trainer_step(trainer, batch) -> None:
    """One step's forward and backward from the trainer's weights on one
    pre-mixed batch, with the GRU kernels and with the plain recurrence
    (``set_recurrence``): losses within 1e-5 relative, gradients leaf by leaf
    within tests/test_torch_train_step.py's bounds (relative 2e-3, or 3e-3
    of the largest gradient + 1e-3)."""
    model, cfg = trainer.state.model, trainer.step_cfg
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for name, recurrence in (("kernels", gru_sequence), ("plain", gru_sequence_reference)):
        set_recurrence(model, recurrence)
        grads, losses, _ = make_loss_gradients(model, cfg)(trainer.state.balancer_state, batch)
        runs[name] = ([g.detach().clone() for g in grads], {k: float(v) for k, v in losses.items()})
        model.load_state_dict(kept)  # the forward moved the BatchNorm statistics
    set_recurrence(model, gru_sequence)
    (grads, losses), (plain_grads, plain_losses) = runs["kernels"], runs["plain"]
    for name, value in plain_losses.items():
        require(abs(losses[name] - value) <= 1e-5 * abs(value),
                f"trainer step: loss {name} {losses[name]:.7g}, kernels vs plain recurrence within 1e-5 relative")
    gscale = max(float(g.abs().max()) for g in plain_grads)
    bad = []
    for (name, _), got, want in zip(model.named_parameters(), grads, plain_grads):
        err = float((got - want).abs().max())
        if not (err <= 2e-3 * float(want.abs().max()) or err <= 3e-3 * gscale + 1e-3):
            bad.append((name, err))
    require(not bad, f"trainer step: {len(grads)} gradient leaves, kernels vs plain recurrence (relative 2e-3, or "
            f"3e-3 x {gscale:.3g} + 1e-3); failing {bad[:5]}")


def time_trainer_data(ds, batches: int = 6) -> dict:
    """ms a batch of the dataset's three stages, each synchronised: host
    assembly (native I/O), the pinned host-to-device copy, the mixing on
    the card; the first batch is a warm-up."""
    gen = torch.Generator(device=ds.device).manual_seed(SEED)
    stages = {"host": [], "copy": [], "mix": []}
    for _ in range(batches + 1):
        t0 = time.perf_counter()
        arrays = ds.host_batch()
        t1 = time.perf_counter()
        clean, noise, rir, rir_noise = ds.to_device(arrays)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mix_batch(clean, noise, ds.mixer_cfg, draw_mix(gen, ds.cfg.batch_size, ds.mixer_cfg), rir, rir_noise)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, seconds in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(seconds)
    return {key: float(np.mean(v[1:])) * 1e3 for key, v in stages.items()}


def time_bare_steps(trainer, ds, steps: int) -> float:
    """ms a step of the bare ``make_train_step`` on pre-mixed batches on the
    card (after a warm-up step), the trainer's model and state."""
    batches = list(ds.batches(num_batches=TRAINER_STEPS))
    step = make_train_step(trainer.state.model, trainer.step_cfg)
    state, _ = step(trainer.state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    trainer.state = state
    return (time.perf_counter() - t0) / steps * 1e3


def check_trainer(device, smi) -> dict:
    """The trainer slice on the card through the train CLI in this process
    (so that the kernel counters can be read): config 2 at its published
    batch on a synthetic corpus, resumed, its step against the plain
    recurrence, its snapshot served by the infer CLI; then its timings.
    Returns the GRU launches of the two CLI runs."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_trainer_corpus(root)
        config = trainer_config(root, TRAINER_EPOCHS)
        runs = root / "runs" / "cruse_base"
        assembled = native_io.assemble_batch.calls
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_main(["-C", str(config)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        steps = TRAINER_EPOCHS * TRAINER_STEPS
        require_launches(f"train CLI, config 2, {TRAINER_EPOCHS} epochs x {TRAINER_STEPS} steps + "
                         f"{TRAINER_EPOCHS} validations of {TRAINER_VALID_BATCHES} batches",
                         {"gru_sequence": 2 * steps + 2 * TRAINER_VALID_BATCHES * TRAINER_EPOCHS,
                          "gru_sequence_bwd": 2 * steps})
        launched = counts()
        log_text = (runs / "train.log").read_text()
        for epoch in range(1, TRAINER_EPOCHS + 1):
            means = epoch_lines(log_text, epoch)
            require(set(means) >= {"loss_si_snr", "loss_spec", "grad_norm"}
                    and all(math.isfinite(v) for v in means.values()) and means["nonfinite_skipped"] == 0,
                    f"train CLI epoch {epoch}: finite means {means}")
        require("NON-FINITE" not in log_text and log_text.count("composite score") == TRAINER_EPOCHS,
                f"train CLI: {TRAINER_EPOCHS} validations logged with their composite scores")
        print("\n".join(line for line in log_text.splitlines() if "composite score" in line or ": noisy " in line))
        batches_assembled = native_io.assemble_batch.calls - assembled
        require(batches_assembled == 2 * (steps + TRAINER_VALID_BATCHES),
                f"train CLI: host I/O native, {batches_assembled} assemble_batch calls = 2 x "
                f"({steps} train + {TRAINER_VALID_BATCHES} validation batches)")
        print(f"trainer host I/O path: native ({native_io.library_path()})", flush=True)
        ckpt = runs / "checkpoints"
        require(all((ckpt / name).is_file() for name in ("latest", "best", f"model_{TRAINER_EPOCHS:04d}",
                                                         f"model_{TRAINER_EPOCHS:04d}.npz")),
                f"train CLI wrote latest, best, model_{TRAINER_EPOCHS:04d} and its .npz")
        served_against_trainer(trainer, config, ckpt / f"model_{TRAINER_EPOCHS:04d}.npz", root)

        resumed_config = trainer_config(root, TRAINER_EPOCHS + 1)
        resumed = build_trainer(parse_args(["-C", str(resumed_config), "-R"]))
        saved = checkpoint_lib.load_checkpoint(ckpt / "latest")
        require(resumed.start_epoch == TRAINER_EPOCHS + 1 and trainer_state_equals(resumed, saved),
                f"-R restores latest bit for bit (model, Adam's moments and count, balancer, step {saved['step']}) "
                f"and resumes at epoch {resumed.start_epoch}")
        reset_counts()
        resumed.train()
        require_launches("train CLI -R, one epoch + one validation",
                         {"gru_sequence": 2 * TRAINER_STEPS + 2 * TRAINER_VALID_BATCHES,
                          "gru_sequence_bwd": 2 * TRAINER_STEPS})
        launched = {k: v + counts()[k] for k, v in launched.items()}
        log_text = (runs / "train.log").read_text()
        require(resumed.state.step == steps + TRAINER_STEPS and log_text.count("1 epoch =") == 1
                and log_text.count(f"{TRAINER_EPOCHS + 1} epoch =") == 1,
                f"-R ran epoch {TRAINER_EPOCHS + 1} alone: step {resumed.state.step}")

        ds = dataset_from(load_config(str(config))["train_dataset"], device)
        check_trainer_step(resumed, next(ds.batches(num_batches=1)))

        batch_size, seconds = ds.cfg.batch_size, ds.cfg.sub_sample_seconds
        step_s = trainer.timings["step"][1:]
        trainer_ms = float(np.mean(step_s)) * 1e3
        print(f"trainer (config 2, B={batch_size} x {seconds:g} s) on {smi}: {trainer_ms:.2f} ms a step = "
              f"{batch_size * seconds / trainer_ms * 1e3:.1f}x realtime, over the {len(step_s)} steps after the first "
              f"(median {np.median(step_s) * 1e3:.2f} ms; {np.mean(trainer.timings['data_wait'][1:]) * 1e3:.2f} ms "
              f"of a step waiting for data; the first step {trainer.timings['step'][0] * 1e3:.1f} ms)")
        bare_ms = time_bare_steps(resumed, ds, 2 * TRAINER_STEPS)
        print(f"bare make_train_step (config 2, B={batch_size} x {seconds:g} s, pre-mixed batches) on {smi}: "
              f"{bare_ms:.2f} ms a step = {batch_size * seconds / bare_ms * 1e3:.1f}x realtime; the trainer's "
              f"step / the bare step = {trainer_ms / bare_ms:.3f}")
        data_ms = time_trainer_data(ds)
        print(f"trainer data (B={batch_size} x {seconds:g} s, native I/O) on {smi}: host assembly "
              f"{data_ms['host']:.2f} ms, host-to-device copy {data_ms['copy']:.2f} ms, device mixing "
              f"{data_ms['mix']:.2f} ms a batch")
        timings = trainer.timings
        print(f"trainer validation ({TRAINER_VALID_BATCHES} batches of "
              f"{resumed.validation_batches[0]['noisy'].shape[0]} x "
              f"{resumed.validation_batches[0]['noisy'].shape[1] / SR:g} s) on {smi}: device enhancement "
              + ", ".join(f"{s * 1e3:.1f}" for s in timings["validation_enhance"]) + " ms; host scoring ("
              + ", ".join(resumed.cfg.metrics) + ") " + ", ".join(f"{s:.2f}" for s in timings["scoring"])
              + " s; checkpoint saves " + ", ".join(f"{s * 1e3:.1f}" for s in timings["save"]) + " ms")
        resumed.cfg.steps_per_epoch = TRAINER_PROFILE_STEPS
        epoch = iter(range(100, 200))
        profile_calls(lambda: resumed._train_epoch(next(epoch)), 1,
                      f"trainer epoch of {TRAINER_PROFILE_STEPS} steps, config 2 B={batch_size} x {seconds:g} s, "
                      f"on {smi}")
        print(f"trainer phase: the first CLI run {run_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        del trainer, resumed, ds
    torch.cuda.empty_cache()
    return launched


def check_deployment(device, smi) -> dict:
    """The deployment path (``check_offline_artifacts``,
    ``check_streaming_artifacts``, ``check_deploy_clis``, then MTFAA's
    ``check_mtfaa_offline_artifacts``, ``check_mtfaa_streaming_artifacts``,
    ``check_mtfaa_clis``) in one temporary directory; returns the kernel
    launches its artifacts made."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gru_offline, artifact = check_offline_artifacts(device, smi, tmp)
        torch.cuda.empty_cache()
        gru_stream, df_stream = check_streaming_artifacts(device, smi, tmp)
        torch.cuda.empty_cache()
        check_deploy_clis(device, smi, tmp, artifact)
        mtfaa_offline = check_mtfaa_offline_artifacts(device, smi, tmp)
        torch.cuda.empty_cache()
        mtfaa_stream = check_mtfaa_streaming_artifacts(device, smi, tmp)
        torch.cuda.empty_cache()
        check_mtfaa_clis(device, smi, tmp)
    return {"gru_sequence": gru_offline + gru_stream,
            "deep_filter": df_stream + mtfaa_offline["deep_filter"] + mtfaa_stream["deep_filter"],
            "tfcm_stack": mtfaa_offline["tfcm_stack"], "tattn": mtfaa_offline["tattn"],
            "dw_stencil_fwd": mtfaa_stream["dw_stencil_fwd"]}


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


def train_config(name: str = "mtfaa_windowed.toml") -> StepConfig:
    """The step of a config file (configs/mtfaa_windowed.toml, or config 2's
    configs/cruse_base.toml) in float32, at a constant rate as the reference's
    benchmark runs it (the MTFAA config's 500-step warm-up would start from a
    rate of 0, and three steps would move nothing)."""
    config = load_config(str(ROOT / "configs" / name))
    ac, opt = config["acoustics"], config["optimizer"]
    return StepConfig(stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"])),
                      learning_rate=float(opt["lr"]), beta1=float(opt["beta1"]), beta2=float(opt["beta2"]),
                      clip_grad_norm=float(config["trainer"]["train"]["clip_grad_norm_value"]),
                      loss_weights=tuple(sorted((k, float(v)) for k, v in config["loss"]["weights"].items())))


def named_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def mtfaa_factory(config: MtfaaConfig | None, device, seed: int):
    """``build(plain)``: the seeded full-width MTFAA on the card, with its
    kernels or every kernel swapped for its plain version."""
    def build(plain: bool):
        model = build_mtfaa(config, device, seed)
        set_plain_mtfaa(model, plain)
        return model
    return build


def cruse_factory(df: bool, device, seed: int):
    """``build(plain)``: config 2's CRUSE (``configs/cruse_base.toml``) or
    config 3's CRUSE+DF (``CruseDfConfig()``), seeded weights and BatchNorm
    statistics, on the card, with the kernels or their plain versions."""
    def build(plain: bool):
        gen = torch.Generator().manual_seed(seed)
        if df:
            model = CruseDfNet(CruseDfConfig(), generator=gen)
        else:
            model = build_from_config(load_config(str(ROOT / "configs" / "cruse_base.toml"))["model"], generator=gen)
        seed_batch_norm_stats(model, gen)
        model = model.to(device)
        if df:
            set_plain(model, plain)
        else:
            set_recurrence(model, gru_sequence_reference if plain else gru_sequence)
        return model
    return build


def check_train_steps(build, cfg: StepConfig, b: int, seconds: int, seed: int, device, what: str,
                      expected: dict, steps_b: int | None = None) -> dict:
    """Drive make_train_step for TRAIN_STEPS steps at full width (batches of
    ``steps_b``, default b); returns the launches it made. Before that, the
    first batch of b (the steps' first batch where steps_b is b) through the
    model ``build(plain)`` makes: its losses, gradients and BatchNorm
    statistics against the same weights with every kernel swapped for its
    plain version, in float32 and in float64.

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
    batches = [noisy_clean_pairs(seed + i, steps_b or b, seconds, device) for i in range(TRAIN_STEPS)]
    first = batches[0] if steps_b in (None, b) else noisy_clean_pairs(seed, b, seconds, device)
    runs = {}
    for name, dtype in (("float64", torch.float64), ("plain", torch.float32), ("kernels", torch.float32)):
        model = build(name != "kernels").to(dtype)
        state = init_train_state(model, cfg, device)
        grads, losses, _ = make_loss_gradients(model, cfg)(
            state.balancer_state, {k: v.to(dtype) for k, v in first.items()})
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
              for k in ref_stats if k.endswith((".mean", ".var", ".running_mean", ".running_var")))
    require(err <= 1e-4, f"{what}: BatchNorm running statistics, kernels vs plain versions {err:.3g} <= 1e-4")
    del runs, grads, plain_grads, exact, first

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


def gru_bwd_case(shape, device, seed: int, with_dh_last: bool):
    """Seeded (x_proj, h0, w_hh, b_hh, y, dy, dh_last or None, hp) at a shape,
    y from the plain recurrence, hp = h_prev . w_hh^T + b_hh for all t."""
    x, h0, w, b = gru_inputs(*shape, device, seed)
    gen = torch.Generator(device).manual_seed(seed + 1)
    with torch.inference_mode():
        y, _ = gru_sequence_reference(x, h0, w, b)
        dy = torch.randn(y.shape, generator=gen, device=device)
        dh_last = torch.randn(h0.shape, generator=gen, device=device) * 0.5 if with_dh_last else None
        h_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
        hp = (torch.einsum("btgh,gkh->btgk", h_prev, w) + b).contiguous()
    return x, h0, w, b, y, dy, dh_last, hp


def check_gru_bwd(device) -> float:
    """Both GRU backward kernels against their plain version on the card at
    GRU_BWD_SHAPES, with dh_last None and nonzero: the streamed kernel, and the
    resident one at each cluster size that ``bwd_fit_at`` gives a fit (its
    launcher must raise at the others), each launched into
    dx_proj, dhp and dh0 filled with NaN first (so a value it never writes
    shows) against the plain walk; and ``gru_sequence_bwd`` (all four
    gradients, one launch, of the kernel ``resident_bwd_plan`` picks, read
    from the counters). Each output within GRU_BWD_TOL of its largest value.
    Also that a forward kernel's launcher refuses tensors that want a
    gradient, and bf16 weights under a gradient. Returns the routed kernel's
    largest max-abs error (dx_proj, dhp, dh0) at config 2's shape."""
    worst = 0.0
    for shape in GRU_BWD_SHAPES:
        for with_dh_last in (False, True):
            x, h0, w, b, y, dy, dh_last, hp = gru_bwd_case(shape, device, SEED + 11, with_dh_last)
            what = f"gru_sequence_bwd B, T, G, H = {shape}, dh_last {'nonzero' if with_dh_last else 'None'}"
            plan = resident_bwd_plan(*shape)
            with torch.inference_mode():
                walk = gru_backward_walk_reference(dy, dh_last, x, h0, w, b, y)
                launchers = {"streamed": launch_gru_bwd_streamed}
                for cs in CLUSTER_SIZES:
                    launch = lambda *args, cs=cs: launch_gru_bwd_resident(*args, cs=cs)  # noqa: E731
                    if bwd_fit_at(shape[3], cs) is not None:
                        launchers[f"resident CS={cs}"] = launch
                        continue
                    try:
                        launch(x, hp, y, h0, dy, dh_last, w, *(torch.empty_like(t) for t in (x, x, h0)))
                        refused = False
                    except ValueError:
                        refused = True
                    require(refused, f"{what}: the resident launcher refuses a cluster of {cs}, which does not "
                                     f"hold the weight or leaves a block without a unit")
                for label, launch in launchers.items():
                    outs = [torch.full_like(x, math.nan), torch.full_like(x, math.nan), torch.full_like(h0, math.nan)]
                    launch(x, hp, y, h0, dy, dh_last, w, *outs)
                    torch.cuda.synchronize()
                    for name, got, want in zip(("dx_proj", "dhp", "dh0"), outs, walk):
                        err, scale = float((got - want).abs().max()), float(want.abs().max())
                        require(bool(torch.isfinite(got).all()) and err <= GRU_BWD_TOL * scale,
                                f"{what}, {label} kernel into NaN-filled outputs: {name} max-abs "
                                f"{err:.3g} <= {GRU_BWD_TOL} x {scale:.3g}")
                        routed = label == ("streamed" if plan is None else f"resident CS={plan[0]}")
                        if shape == CONFIG2_GRU and routed:
                            worst = max(worst, err)
                before = gru_sequence_bwd.launches, gru_sequence_bwd.resident_launches
                wrapped = gru_sequence_bwd(dy, dh_last, x, h0, w, b, y)
                torch.cuda.synchronize()
                for name, got, want in zip(("dx_proj", "dh0", "dw_hh", "db_hh"), wrapped,
                                           gru_sequence_backward_reference(dy, dh_last, x, h0, w, b, y)):
                    err, scale = float((got - want).abs().max()), float(want.abs().max())
                    require(bool(torch.isfinite(got).all()) and err <= GRU_BWD_TOL * scale,
                            f"{what}, wrapper: {name} max-abs {err:.3g} <= {GRU_BWD_TOL} x {scale:.3g}")
                launched = (gru_sequence_bwd.launches - before[0], gru_sequence_bwd.resident_launches - before[1])
                require(launched == (1, int(plan is not None)),
                        f"{what}: the wrapper makes one launch, of the {'streamed' if plan is None else 'resident'} "
                        f"kernel as resident_bwd_plan says ({plan}); counted {launched}")
            del x, h0, w, b, y, dy, dh_last, hp, walk, outs, wrapped
    x, h0, w, b = gru_inputs(3, 5, 2, 16, device, SEED)
    try:
        launch_resident(x.requires_grad_(), h0, w, b)
        refused = False
    except RuntimeError:
        refused = True
    try:
        gru_sequence(x, h0, w, b, weight_dtype=torch.bfloat16)
        refused_bf16 = False
    except NotImplementedError:
        refused_bf16 = True
    require(refused and refused_bf16, "a forward kernel's launcher refuses tensors that want a gradient outside "
            "gru_sequence, and gru_sequence refuses bf16 weights under a gradient")
    torch.cuda.empty_cache()
    return worst


def time_gru_bwd(device, smi, lib: dict) -> dict:
    """Both GRU backward kernels at config 2's shape and at CRUSE+DF's B=32
    (``ops/gru_bwd_timing.py``: CUDA events in turns, resident, streamed,
    streamed, resident; dh_last None as in the step; the bound from the least
    bytes and the multiply-adds of w_hh^T . dhp); at config 2 also the wrapper
    with its two products and its plain version (the walk); the library call
    at both. Returns the kernels line's numbers (config 2, the resident
    kernel, which the plan routes there, as ``ms``)."""
    rows = {}
    for b_, key, name in ((CONFIG2_BATCH, "gru_bwd", "config 2"), (CRUSE_DF_BATCH, "gru_bwd_b32", "CRUSE+DF")):
        rows[b_] = row = time_gru_bwd_kernels((b_, *CONFIG2_GRU[1:]), device, SEED + 13)
        print(f"{describe_gru_bwd(name, row)}; cuDNN nn.GRU backward, one call a group (it also takes the "
              f"input projection's gradients) {lib[key]:.3f} ms; on {smi}", flush=True)
    b, t, g, h = CONFIG2_GRU
    x, h0, w, bias, y, dy, _, _ = gru_bwd_case(CONFIG2_GRU, device, SEED + 13, False)
    with torch.inference_mode():
        wrapper = lambda: gru_sequence_bwd(dy, None, x, h0, w, bias, y)  # noqa: E731
        wrapper_ms = cuda_ms(wrapper, reps=3)
        plain_ms = cuda_ms(lambda: gru_backward_walk_reference(dy, None, x, h0, w, bias, y), reps=1)
    row = rows[CONFIG2_BATCH]
    print(f"gru_sequence_bwd B={b} T={t} G={g} H={h} f32 on {smi}: wrapper (hp and dw_hh products + the resident "
          f"kernel) {wrapper_ms:.3f} ms; plain walk {plain_ms:.1f} ms", flush=True)
    return {"ms": sum(row["resident_ms"]) / 2, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": lib["gru_bwd"],
            "resident_ms": sum(row["resident_ms"]) / 2, "streamed_ms": sum(row["streamed_ms"]) / 2,
            "b32": {key: rows[CRUSE_DF_BATCH][key] for key in ("resident_ms", "streamed_ms", "bound_ms")}
            | {"library_ms": lib["gru_bwd_b32"]}}


def time_cruse_steps(device, smi) -> None:
    """One config-2 CRUSE train step at B=128 x 10 s and one CRUSE+DF step at
    B=32 x 10 s, f32 (wall ms after a warm-up, peak memory), and a profile of
    the config-2 step: kernels a step, device busy time and idle share, the
    GRU kernels' device time."""
    cfg = train_config("cruse_base.toml")
    for df, b in ((False, CONFIG2_BATCH), (True, CRUSE_DF_BATCH)):
        what = f"{'CRUSE+DF (config 3)' if df else 'CRUSE config 2'} train step B={b} x {CRUSE_SECONDS} s, f32"
        model = cruse_factory(df, device, SEED + 14)(False)
        state = init_train_state(model, cfg, device)
        step = make_train_step(model, cfg)
        data = noisy_clean_pairs(SEED + 15, b, CRUSE_SECONDS, device)
        state, _ = step(state, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, data)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"{what}, on {smi}: {ms:.1f} ms a step = {b * CRUSE_SECONDS / ms * 1e3:.1f} s of audio a second, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
        if not df:
            box = {"state": state}

            def one_step():
                box["state"], _ = step(box["state"], data)

            prof = profile_calls(one_step, 2, what)
            gru = ("gru_bwd_resident_kernel", "gru_resident_kernel", "gru_bwd_kernel")
            print(f"{what}, on {smi}: " + ", ".join(
                f"{name} {prof.device_ms.get(name, 0.0):.3f} ms in {prof.launches.get(name, 0.0):.1f} launches"
                for name in gru) + f"; {prof.kernels:.1f} device launches a step", flush=True)
            require([prof.launches.get(name, 0) for name in gru] == [2, 2, 0],
                    f"{what}: the profile shows 2 gru_bwd_resident_kernel and 2 gru_resident_kernel launches a "
                    f"step, and no gru_bwd_kernel")
            del box
        del model, state, step, data
        torch.cuda.empty_cache()


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
    # the backward: autograd.grad through cuDNN's GRU at config 2's shape, one call a group
    b, t, g_, h = CONFIG2_GRU
    x = torch.randn(b, t, h, device=device, requires_grad=True)
    out, _ = gru(x)
    gy = torch.randn_like(out)
    leaves = (x, *gru.parameters())
    times["gru_bwd"] = g_ * cuda_ms(lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True), reps=3)
    # and at CRUSE+DF's step batch
    x = torch.randn(CRUSE_DF_BATCH, t, h, device=device, requires_grad=True)
    out, _ = gru(x)
    gy = torch.randn_like(out)
    leaves = (x, *gru.parameters())
    times["gru_bwd_b32"] = g_ * cuda_ms(lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True), reps=3)
    del x, out, gy, leaves
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


def time_df_kernels(device, smi) -> list:
    """The deep filter's forward and backward at config 5b and config 3 and the
    forward at the hop (``ops/df_timing.py``): kernels alone, wrapper, device
    launches a call, the bound, the plain version, the plan and its
    instance, and at 5b the plain forward + ``autograd.grad``. Checks that a
    call is one device launch and that no instance spills. Returns the rows."""
    rows = time_df(device)
    for row in rows:
        require(row["launches_per_call"] <= 1 and row["info"]["spill_bytes"] == 0,
                f"a deep_filter {row['kind']} call at {row['shape']} is {row['launches_per_call']:.1f} <= 1 device "
                f"launches and its instance spills nothing")
        print(f"{describe_df(row)} on {smi}", flush=True)
    return rows


def time_train_step(device, smi) -> None:
    """One B=16 x 10 s config-5b train step with the kernels, with the plain
    versions, and with every kernel but the deep filter's (the step before
    the deep filter's backward kernel; wall ms after a warm-up, peak memory),
    in turns; and a profile of a step with the kernels and of one with the
    plain deep filter."""
    cfg = train_config()
    data = noisy_clean_pairs(SEED + 7, MTFAA_BATCH, MTFAA_SECONDS, device)
    profiled = set()
    kinds = ("plain versions", "kernels", "kernels but the plain deep filter")
    for kind in kinds + kinds[::-1]:
        model = build_mtfaa(None, device, SEED + 4)
        set_plain_mtfaa(model, kind == "plain versions")
        if kind == "kernels but the plain deep filter":
            model.filter_fn = deep_filter_reference
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
        print(f"MTFAA config 5b train step B={MTFAA_BATCH} x {MTFAA_SECONDS} s, f32, on {smi}, {kind}: "
              f"{ms:.1f} ms a step = {MTFAA_BATCH * MTFAA_SECONDS / ms * 1e3:.1f} s of audio a second, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if kind != "plain versions" and kind not in profiled:
            profiled.add(kind)
            box = {"state": state}

            def one_step():
                box["state"], _ = step(box["state"], data)

            prof = profile_calls(one_step, 2, f"B={MTFAA_BATCH} x {MTFAA_SECONDS} s config-5b train step, {kind}")
            mid_ms = sum(prof.device_ms.get(name, 0.0) for name in ("mid_tile_kernel", "mid_finish_kernel"))
            print(f"config-5b train step, {kind}, on {smi}: mid_bwd's kernels {mid_ms:.3f} ms a step in "
                  f"{sum(prof.launches.get(n, 0.0) for n in ('mid_tile_kernel', 'mid_finish_kernel')):.1f} "
                  f"launches; the stencil forward's {prof.device_ms.get('dw_fwd_kernel', 0.0):.3f} ms in "
                  f"{prof.launches.get('dw_fwd_kernel', 0.0):.1f} launches (their summed bound "
                  f"{sum(dw_bound(TFCM_STAGES[i], d, 'forward')['bound_ms'] for i in STACK_STAGES for d in DILATIONS):.3f} "
                  f"ms); the deep filter's forward {prof.device_ms.get('deep_filter_kernel', 0.0):.4f} ms in "
                  f"{prof.launches.get('deep_filter_kernel', 0.0):.1f} launches and backward "
                  f"{prof.device_ms.get('deep_filter_bwd_kernel', 0.0):.4f} ms in "
                  f"{prof.launches.get('deep_filter_bwd_kernel', 0.0):.1f} launches; "
                  f"{prof.kernels:.1f} device launches a step")
            require(prof.kernels <= STEP_KERNELS_BEFORE - 96,
                    f"the config-5b train step's profile ({kind}) shows {prof.kernels:.1f} device launches a step "
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

    df_err, df_bwd_err = check_df_kernel(device)
    model = build_cruse_df(device)
    stream_gru, stream_df = check_streaming(model, device)
    auto_gru, auto_df = check_auto_path(model, device)


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
    check_dfsmn_stream(device, smi)
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
    with torch.inference_mode():
        spec = stft(x, inferencer.cfg.stft)
        cspec = torch.stack([spec.real, spec.imag], dim=-1)

    def model_forward(with_state: bool):
        with torch.inference_mode():
            return mtfaa(cspec, with_state=with_state)

    # what the state a state=None call returns costs; the offline adapters pass with_state=False
    costs = [profile_calls(lambda: model_forward(with_state), 3, f"B={b} x {seconds} s config-5b model forward, "
                           f"with_state={with_state}").kernels for with_state in (False, True)]
    print(f"config-5b forward B={b} x {seconds} s on {smi}: the returned state costs {costs[1] - costs[0]:.1f} "
          f"device launches a call ({costs[0]:.1f} -> {costs[1]:.1f})")
    del x, spec, cspec
    torch.cuda.empty_cache()

    hop_dw_err = check_dw_hop(device)
    stream_dw, stream_df_5b = check_mtfaa_stream(mtfaa, device, smi)
    hop_rows = time_dw(device, shapes=[(1, k, c, 1) for _, k, c, _ in TFCM_STAGES])
    for row in hop_rows:
        print(f"at the config-5b hop (B=1, T=1) on {smi}: {describe_dw(row)}")

    cruse_df = build_cruse_df(device)
    server_launches = check_server(cruse_df, mtfaa, device, smi)
    time_server(cruse_df, device, smi)
    del cruse_df
    torch.cuda.empty_cache()
    check_serve_cli(smi)

    del inferencer, mtfaa
    torch.cuda.empty_cache()

    train_errs = check_train_kernels(device)
    dq_err, dkv_err = check_attn_bwd(device)
    check_tfcm_block_train(device)
    torch.cuda.empty_cache()
    train_launches = check_train_steps(
        mtfaa_factory(None, device, SEED + 8), train_config(), MTFAA_BATCH, MTFAA_SECONDS, SEED + 8, device,
        f"config-5b train step B={MTFAA_BATCH} x {MTFAA_SECONDS} s", STEP_LAUNCHES)
    torch.cuda.empty_cache()
    pallas_launches = check_train_steps(
        mtfaa_factory(MtfaaConfig(attention_window=WINDOW, tfcm_dw_impl="pallas"), device, SEED + 9),
        train_config(), CAUSAL_BATCH, CAUSAL_SECONDS, SEED + 9, device,
        f'config-5b train step, "pallas" TFCM route, B={CAUSAL_BATCH} x {CAUSAL_SECONDS} s',
        dict(STEP_LAUNCHES, dw_stencil_bwd=24, tail_bwd=0, mid_bwd=0))
    check_train_steps(mtfaa_factory(MtfaaConfig(), device, SEED + 10), train_config(), CAUSAL_BATCH, CAUSAL_SECONDS,
                      SEED + 10, device,
                      f"config-5 train step (full-causal attention) B={CAUSAL_BATCH} x {CAUSAL_SECONDS} s",
                      STEP_LAUNCHES)
    torch.cuda.empty_cache()

    gru_bwd_err = check_gru_bwd(device)
    cruse_cfg = train_config("cruse_base.toml")
    cruse_launches = check_train_steps(
        cruse_factory(False, device, SEED + 16), cruse_cfg, CRUSE_CHECK_BATCH, CRUSE_SECONDS, SEED + 16, device,
        f"config-2 CRUSE train step (check at B={CRUSE_CHECK_BATCH}, steps at B={CONFIG2_BATCH}, {CRUSE_SECONDS} s)",
        CRUSE_STEP_LAUNCHES, CONFIG2_BATCH)
    torch.cuda.empty_cache()
    cruse_df_launches = check_train_steps(
        cruse_factory(True, device, SEED + 17), cruse_cfg, CRUSE_CHECK_BATCH, CRUSE_SECONDS, SEED + 17, device,
        f"CRUSE+DF train step (check at B={CRUSE_CHECK_BATCH}, steps at B={CRUSE_DF_BATCH}, {CRUSE_SECONDS} s)",
        CRUSE_DF_STEP_LAUNCHES, CRUSE_DF_BATCH)
    torch.cuda.empty_cache()

    lib = library_ms(device)
    print(f"library calls on {smi}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in lib.items()))
    train_times = time_train_kernels(device, smi, lib)
    df_rows = time_df_kernels(device, smi)
    time_train_step(device, smi)
    gru_bwd_times = time_gru_bwd(device, smi, lib)
    time_cruse_steps(device, smi)
    torch.cuda.empty_cache()
    trainer_launches = check_trainer(device, smi)
    deploy_launches = check_deployment(device, smi)  # last: torch.export's tracing machinery after every profile

    # least bytes (each input read once, each output written once) and
    # multiply-adds of the kernels of the earlier slices, at the timed shapes
    b, t, g, h = CONFIG1_GRU
    gru_bound = bound(4 * (b * t * g * 4 * h + 2 * b * g * h + g * 3 * h * h + g * 3 * h),
                      b * t * g * 3 * h * h)
    b, k, c, t = TFCM_STAGES[0]
    layer_fmas = b * k * t * c * (2 * c + 9)
    stack_bound = bound(2 * 4 * b * k * c * t, len(DILATIONS) * layer_fmas)
    block_bound = bound(2 * 4 * b * k * c * t, layer_fmas)
    attn_row = times["tattn_stages"][0]  # stage 0, window 126
    df_fwd = next(row for row in df_rows if row["kind"] == "forward" and row["shape"] == "config 3")
    df_bwd = next(row for row in df_rows if row["kind"] == "backward" and row["shape"] == "5b")

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
        {**entry("gru_sequence", "gru_sequence", "gru_kernel.py:82",
                 launches + stream_gru + auto_gru + cruse_launches["gru_sequence"] + cruse_df_launches["gru_sequence"]
                 + server_launches["gru_sequence"] + deploy_launches["gru_sequence"]
                 + trainer_launches["gru_sequence"],
                 gru_err, (kernel_ms, plain_ms), gru_bound, lib["gru"]),
         "resident_ms": gru_times["f32"][0], "streamed_ms": gru_times["f32"][1],
         "server_launches": server_launches["gru_sequence"], "artifact_launches": deploy_launches["gru_sequence"],
         "trainer_launches": trainer_launches["gru_sequence"]},
        {"name": "gru_sequence_bwd", "route": "cuda", "source": "cruse_tpu_torch/ops/csrc/gru_bwd.cu",
         "replaces": "cruse_tpu/nn/gru.py:30 (no TPU kernel: the JAX step differentiates gru_scan)",
         "launches": cruse_launches["gru_sequence_bwd"] + cruse_df_launches["gru_sequence_bwd"]
         + trainer_launches["gru_sequence_bwd"],
         "max_abs_err": gru_bwd_err, **gru_bwd_times, "trainer_launches": trainer_launches["gru_sequence_bwd"]},
        {**entry("deep_filter", "deep_filter", "deep_filter_kernel.py:91",
                 stream_df + auto_df + mtfaa_df + train_launches["deep_filter"] + cruse_df_launches["deep_filter"]
                 + stream_df_5b + server_launches["deep_filter"] + deploy_launches["deep_filter"],
                 df_err,
                 (df_fwd["wrapper_ms"], df_fwd["plain_ms"]), {key: df_fwd[key] for key in ("bound_ms", "bound_by")},
                 None),
         "server_launches": server_launches["deep_filter"], "artifact_launches": deploy_launches["deep_filter"],
         "stages": [{key: row[key] for key in DF_STAGE_KEYS} for row in df_rows if row["kind"] == "forward"]},
        {"name": "deep_filter_bwd", "route": "cuda", "source": "cruse_tpu_torch/ops/csrc/deep_filter.cu",
         "replaces": "cruse_tpu/models/deep_filter.py:94 (no TPU kernel: the JAX step differentiates the plain "
                     "deep_filter_apply_tm)",
         "launches": train_launches["deep_filter_bwd"] + cruse_df_launches["deep_filter_bwd"],
         "max_abs_err": df_bwd_err, "ms": df_bwd["wrapper_ms"], "plain_ms": df_bwd["plain_ms"],
         "bound_ms": df_bwd["bound_ms"], "bound_by": df_bwd["bound_by"], "library_ms": None,
         "stages": [{key: row[key] for key in DF_STAGE_KEYS} for row in df_rows if row["kind"] == "backward"]},
        {**entry("tfcm_stack", "tfcm_eval", "tfcm_kernel.py:212", stack_launches + deploy_launches["tfcm_stack"],
                 tfcm_err, times["tfcm_stack"], stack_bound, None),
         "artifact_launches": deploy_launches["tfcm_stack"]},
        entry("tfcm_block", "tfcm_eval", "tfcm_kernel.py:103", block_launches, block_err,
              times["tfcm_block"], block_bound, None),
        {**entry("tattn", "tattn", "asa_kernel.py:190",
                 attn_launches + train_launches["tattn"] + deploy_launches["tattn"], attn_err, times["tattn"], {key: attn_row[key] for key in ("bound_ms", "bound_by")},
                 attn_row["library_ms"]),
         "artifact_launches": deploy_launches["tattn"],
         "stages": [{key: row[key] for key in STAGE_KEYS} for row in times["tattn_stages"]]},
        {**train_entry("dw_stencil_fwd", "dw_stencil", "dw_kernel.py:154",
                       train_launches["dw_stencil_fwd"] + stream_dw + server_launches["dw_stencil_fwd"]
                       + deploy_launches["dw_stencil_fwd"], max(train_errs["dw_fwd"], hop_dw_err)),
         "server_launches": server_launches["dw_stencil_fwd"], "artifact_launches": deploy_launches["dw_stencil_fwd"],
         "hop_stages": [{key: row[key] for key in DW_STAGE_KEYS} for row in hop_rows if row["kind"] == "forward"]},
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
