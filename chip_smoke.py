#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (cruse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA device (no JAX
needed). In order, and any failure exits non-zero:

1. prints the device and ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``cruse_tpu_torch/ops/csrc``, one nvcc per
   source, all started together (ptxas report);
3. holds the grouped-GRU kernel against its plain PyTorch version on the card
   at config-1 shapes (B=256, T=1001, G=4, H=176), at the streaming step's
   (T=1) and on ragged shapes: f32 within 1e-4, bf16 weights within 1e-3
   (same bf16-rounded weights);
4. drives config 1's path: full-width CRUSE from ``configs/cruse_base.toml``
   with seeded weights and seeded non-default BatchNorm statistics,
   ``BatchInferencer.run_batched`` on six synthetic noisy utterances of 2 to
   10 s in batches of 4; checks the outputs, that the GRU kernel launched
   twice per forward (one per bank), and that the enhanced waveforms agree
   with the same batch through the plain recurrence on the card within 1e-4;
5. times the GRU kernel and the plain version with CUDA events, and one
   B=256 x 10 s enhancement with each;
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
    8, K not a multiple of the band tile, C=4), and the temporal attention at
    the three stage geometries (BF=1024/512/256, c=6/8/12, C=24/32/48, T=626)
    with window 126, without one, with T < window, T off the tile and
    non-causal, within 1e-5; tolerances scale with max(1, max|ref|);
11. drives config 5b's path: full-width MTFAA from
    ``configs/mtfaa_windowed.toml`` (seeded weights, BatchNorm statistics and
    PReLU slopes), ``BatchInferencer(type="auto").run_batched`` on the six
    utterances in batches of 4; checks 6 TFCM-stack, 3 attention and 1
    deep-filter launches per forward, the outputs, and the waveform against
    the same batch through all plain versions within 1e-4; then config 5
    (``MtfaaConfig()``, full-causal attention) at B=4 x 4 s the same way, and
    a lone ``TFCMBlock`` (one block launch);
12. times the TFCM stack at the four stage shapes and one block (ms, GB/s
    over the least bytes), the attention at stage 0 with and without the
    window, the deep filter at MTFAA's shape, and one B=16 x 10 s config-5b enhancement with the kernels and
    with the plain versions (x-realtime); profiles one B=16 forward (kernels
    per forward, device time by kernel, busy time and idle share);
13. prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``.

TF32 is off for matmuls and convolutions throughout, so every comparison is
in full float32.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
from cruse_tpu_torch.ops.asa_kernel import flash_tattn_tm, tattn_reference
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter, deep_filter_reference
from cruse_tpu_torch.ops.gru_kernel import gru_sequence, gru_sequence_reference
from cruse_tpu_torch.ops.tfcm_kernel import (
    PARAM_KEYS, fold_eval_params, fused_tfcm_block_eval, fused_tfcm_stack_eval,
    tfcm_stack_reference)
from cruse_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNELS = ("gru_sequence", "deep_filter", "tfcm_eval", "tattn")  # csrc/<name>.cu
CONFIG1_GRU = (256, 1001, 4, 176)  # B, T, G, H of config 1's bottleneck banks
STREAM_GRU = ((256, 1, 4, 176), (8, 1, 4, 176))  # config 3's streaming hop
RAGGED_GRU = ((3, 7, 4, 176), (3, 7, 3, 50))
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
               (2, 5, 12, 9, (1, 2), None, None))
ATTN_STAGES = ((1024, 6, 24), (512, 8, 32), (256, 12, 48))
WINDOW = 126
TFCM_TOL, TFCM_BLOCK_TOL, ATTN_TOL = 1e-4, 1e-5, 1e-5
MTFAA_BATCH, MTFAA_SECONDS = 16, 10
CAUSAL_BATCH, CAUSAL_SECONDS = 4, 4


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
    """Kernel vs plain version on the card; returns the largest f32 error."""
    worst = 0.0
    for shape in (CONFIG1_GRU, *STREAM_GRU, *RAGGED_GRU):
        args = gru_inputs(*shape, device, SEED)
        with torch.inference_mode():
            got = gru_sequence(*args)
            torch.cuda.synchronize()
            want = gru_sequence_reference(*args)
            err = max_err(got, want)
            require(all(bool(torch.isfinite(x).all()) for x in got)
                    and err <= F32_TOL, f"gru_sequence f32 {shape}: max-abs {err:.3g} <= {F32_TOL}")
            worst = max(worst, err)
            got = gru_sequence(*args, weight_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            want = gru_sequence_reference(*args, weight_dtype=torch.bfloat16)
            err = max_err(got, want)
            require(err <= BF16_TOL, f"gru_sequence bf16 weights {shape}: max-abs {err:.3g} <= {BF16_TOL}")
    return worst


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


def reset_counts() -> None:
    for kernel in (gru_sequence, deep_filter, fused_tfcm_stack_eval, fused_tfcm_block_eval,
                   flash_tattn_tm):
        kernel.launches = 0


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

    require(launches == 2 * forwards and df_launches == 0,
            f"config-1 path launched gru_sequence {launches} times = 2 per forward x {forwards}, "
            f"deep_filter {df_launches} times")
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
    require(launches == 2 * hops and df_launches == hops,
            f"streaming path launched gru_sequence {launches} = 2 x {hops} hops and "
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


def attn_inputs(bf, c, cv, t, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device) for shape in ((bf, c, t), (bf, c, t), (bf, cv, t))]


def check_attn_kernel(device) -> float:
    """Temporal-attention kernel vs the plain version on the card; returns
    the largest max-abs error."""
    worst = 0.0
    cases = [(bf, c, cv, 626, w, True) for bf, c, cv in ATTN_STAGES for w in (WINDOW, None)]
    cases += [(bf, c, cv, 626, None, False) for bf, c, cv in ATTN_STAGES]
    cases += [(64, 6, 24, 100, WINDOW, True),  # T < window
              (64, 8, 32, 200, WINDOW, True), (64, 12, 48, 200, 50, True),  # T off the 128 tile
              (64, 6, 24, 200, None, False), (5, 3, 12, 37, 7, True)]
    for bf, c, cv, t, window, causal in cases:
        q, k, v = attn_inputs(bf, c, cv, t, device, SEED)
        with torch.inference_mode():
            got = flash_tattn_tm(q, k, v, window, causal=causal)
            torch.cuda.synchronize()
            want = tattn_reference(q, k, v, window, causal)
        err, scale = scaled_err(got, want)
        require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL * scale,
                f"tattn BF={bf} c={c} C={cv} T={t} window={window} causal={causal}: "
                f"max-abs {err:.3g} <= {ATTN_TOL} x {scale:.3g}")
        worst = max(worst, err)
    return worst


def mtfaa_counts() -> tuple[int, int, int, int]:
    """(tfcm stack, tfcm block, attention, deep filter) launches."""
    return (fused_tfcm_stack_eval.launches, fused_tfcm_block_eval.launches,
            flash_tattn_tm.launches, deep_filter.launches)


def plain_block(x, params, dilation):
    return tfcm_stack_reference(x, params, (dilation,))


def set_plain_mtfaa(model, plain: bool) -> None:
    """Put every plain version (or every kernel) in an MTFAA model's path."""
    for m in model.modules():
        if isinstance(m, TFCM):
            m.stack_fn = tfcm_stack_reference if plain else fused_tfcm_stack_eval
        elif isinstance(m, TFCMBlock):
            m.block_fn = plain_block if plain else fused_tfcm_block_eval
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


def time_mtfaa_kernels(device, smi) -> dict:
    """Kernel vs plain times (ms) at the main path's shapes; prints them."""
    times = {}
    with torch.inference_mode():
        for shape in TFCM_STAGES:
            x, params = tfcm_inputs(*shape, len(DILATIONS), device, SEED + 1)
            ms = cuda_ms(lambda: fused_tfcm_stack_eval(x, params, dilations=DILATIONS), reps=20)
            plain = cuda_ms(lambda: tfcm_stack_reference(x, params, DILATIONS), reps=5)
            nbytes = 2 * x.numel() * 4  # x read once, y written once
            print(f"tfcm stack {list(shape)} dilations {DILATIONS} on {smi}: kernel {ms:.3f} ms = "
                  f"{nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e9:.3f} GB, plain {plain:.3f} ms = "
                  f"{nbytes / plain / 1e6:.1f} GB/s ({'kernel faster' if ms < plain else 'KERNEL SLOWER'})")
            times.setdefault("tfcm_stack", (ms, plain))
        x, params = tfcm_inputs(*TFCM_STAGES[0], 1, device, SEED + 1)
        ms = cuda_ms(lambda: fused_tfcm_block_eval(x, params, dilation=1), reps=20)
        plain = cuda_ms(lambda: tfcm_stack_reference(x, params, (1,)), reps=5)
        nbytes = 2 * x.numel() * 4
        print(f"tfcm block {list(TFCM_STAGES[0])} d=1 on {smi}: kernel {ms:.3f} ms = "
              f"{nbytes / ms / 1e6:.1f} GB/s, plain {plain:.3f} ms = {nbytes / plain / 1e6:.1f} GB/s "
              f"({'kernel faster' if ms < plain else 'KERNEL SLOWER'})")
        times["tfcm_block"] = (ms, plain)
        del x, params
        bf, c, cv = ATTN_STAGES[0]
        q, k, v = attn_inputs(bf, c, cv, 626, device, SEED + 1)
        for window in (WINDOW, None):
            ms = cuda_ms(lambda: flash_tattn_tm(q, k, v, window), reps=20)
            plain = cuda_ms(lambda: tattn_reference(q, k, v, window), reps=5)
            print(f"tattn BF={bf} c={c} C={cv} T=626 window={window} on {smi}: kernel {ms:.3f} ms, "
                  f"plain {plain:.3f} ms ({'kernel faster' if ms < plain else 'KERNEL SLOWER'}; "
                  f"the plain logits are {bf * 626 * 626 * 4 / 1e9:.3f} GB)")
            times.setdefault("tattn", (ms, plain))
        del q, k, v
        b, t, f, t_dim, f_dim = MTFAA_DF[:5]
        spec, coefs, _ = df_inputs(*MTFAA_DF, device, SEED + 1)
        ms = cuda_ms(lambda: deep_filter(spec, coefs, t_dim, f_dim), reps=20)
        plain = cuda_ms(lambda: deep_filter_reference(spec, coefs, t_dim, f_dim), reps=5)
        nbytes = coefs.numel() * 4 + 2 * spec.numel() * 8
        print(f"deep_filter B={b} T={t} F={f} K={coefs.shape[3]} (config 5b) on {smi}: kernel "
              f"{ms:.3f} ms = {nbytes / ms / 1e6:.1f} GB/s, plain {plain:.3f} ms "
              f"({'kernel faster' if ms < plain else 'KERNEL SLOWER'})")
    return times


def profile_calls(fn, calls: int, label: str) -> None:
    """torch.profiler over `calls` calls of fn: device time by kernel, the
    device's busy time per call (union of kernel intervals) and its idle
    share against the call's wall time measured without the profiler."""
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

    args = gru_inputs(*CONFIG1_GRU, device, SEED + 1)
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: gru_sequence(*args), reps=5)
        bf16_ms = cuda_ms(lambda: gru_sequence(*args, weight_dtype=torch.bfloat16), reps=5)
        plain_ms = cuda_ms(lambda: gru_sequence_reference(*args), reps=2)
    b, t, g, h = CONFIG1_GRU
    print(f"gru_sequence B={b} T={t} G={g} H={h} on {smi}: kernel f32 {kernel_ms:.3f} ms, "
          f"kernel bf16 weights {bf16_ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"({'kernel faster' if kernel_ms < plain_ms else 'KERNEL SLOWER'})")

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
    del inferencer, args

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
    profile_calls(lambda: inferencer.auto(x), 3, f"B={b} x {seconds} s config-5b auto forward")

    print(json.dumps({"kernels": [{
        "name": "gru_sequence", "route": "cuda",
        "source": "cruse_tpu_torch/ops/csrc/gru_sequence.cu",
        "replaces": "cruse_tpu/ops/gru_kernel.py:82",
        "launches": launches + stream_gru + auto_gru, "max_abs_err": gru_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }, {
        "name": "deep_filter", "route": "cuda",
        "source": "cruse_tpu_torch/ops/csrc/deep_filter.cu",
        "replaces": "cruse_tpu/ops/deep_filter_kernel.py:91",
        "launches": stream_df + auto_df + mtfaa_df, "max_abs_err": df_err,
        "ms": df_ms, "plain_ms": df_plain_ms,
    }, {
        "name": "tfcm_stack", "route": "cuda",
        "source": "cruse_tpu_torch/ops/csrc/tfcm_eval.cu",
        "replaces": "cruse_tpu/ops/tfcm_kernel.py:212",
        "launches": stack_launches, "max_abs_err": tfcm_err,
        "ms": times["tfcm_stack"][0], "plain_ms": times["tfcm_stack"][1],
    }, {
        "name": "tfcm_block", "route": "cuda",
        "source": "cruse_tpu_torch/ops/csrc/tfcm_eval.cu",
        "replaces": "cruse_tpu/ops/tfcm_kernel.py:103",
        "launches": block_launches, "max_abs_err": block_err,
        "ms": times["tfcm_block"][0], "plain_ms": times["tfcm_block"][1],
    }, {
        "name": "tattn", "route": "cuda",
        "source": "cruse_tpu_torch/ops/csrc/tattn.cu",
        "replaces": "cruse_tpu/ops/asa_kernel.py:190",
        "launches": attn_launches, "max_abs_err": attn_err,
        "ms": times["tattn"][0], "plain_ms": times["tattn"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
