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
   ragged ones (T < 2*t_dim, a symmetric layout);
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
10. prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``.

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
from cruse_tpu.utils.config import load_config
from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.infer.streaming import StreamingEnhancer
from cruse_tpu_torch.models import CruseDfConfig, CruseDfNet, build_from_config
from cruse_tpu_torch.models.cruse_df import apply_cruse_df
from cruse_tpu_torch.nn.gru import GroupedGRULayer
from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter, deep_filter_reference
from cruse_tpu_torch.ops.gru_kernel import gru_sequence, gru_sequence_reference

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNELS = ("gru_sequence", "deep_filter")  # csrc/<name>.cu
CONFIG1_GRU = (256, 1001, 4, 176)  # B, T, G, H of config 1's bottleneck banks
STREAM_GRU = ((256, 1, 4, 176), (8, 1, 4, 176))  # config 3's streaming hop
RAGGED_GRU = ((3, 7, 4, 176), (3, 7, 3, 50))
# B, T, F, t_dim, f_dim, causal, spectrum bins (>= F: the low bins of a wider one), history
CONFIG3_DF = (256, 1001, 96, 2, 1, True, 161, False)
DF_SHAPES = ((64, 1001, 96, 2, 1, True, 161, False),  # config 3 offline
             (256, 1, 96, 2, 1, True, 161, True),  # config 3 streaming hop
             (3, 7, 24, 1, 1, True, 24, False),  # ragged
             (3, 3, 24, 2, 1, True, 24, True),  # T < 2 * t_dim, with history
             (3, 3, 24, 2, 1, True, 24, False),  # T < 2 * t_dim, zero fill
             (3, 9, 20, 1, 2, False, 20, False))  # symmetric layout
F32_TOL, BF16_TOL, DF_TOL, WAV_TOL = 1e-4, 1e-3, 1e-5, 1e-4
SR = 16000
UTTERANCE_SAMPLES = (32017, 59123, 81611, 105777, 132941, 160000)  # 2 .. 10 s
BATCH = 4
STREAM_BATCH, STREAM_SECONDS = 8, 4


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
    gru_sequence.launches = 0
    deep_filter.launches = 0


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
    """torch.profiler over `hops` streaming hops: device time by kernel, the
    device's busy time per hop (union of kernel intervals) and its idle share
    against the hop's wall time measured without the profiler."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    hop = enh.cfg.hop_length
    keep = enh.cfg.n_fft - hop
    x = wav[:, keep : keep + 2 * hops * hop]
    state = enh.prime(enh.init_state(wav.shape[0]), wav[:, :keep])
    for i in range(hops):  # warm-up, then the hops timed without the profiler
        _, state = enh.step(state, x[:, i * hop : (i + 1) * hop])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(hops):
        _, state = enh.step(state, x[:, i * hop : (i + 1) * hop])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / hops * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(hops):
            _, state = enh.step(state, x[:, i * hop : (i + 1) * hop])
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name: dict = {}
    for e in kernels:
        total, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + e["dur"], calls + 1)
    busy, end = 0.0, -math.inf
    for start, dur in sorted((e["ts"], e["dur"]) for e in kernels):
        busy += max(0.0, start + dur - max(start, end))
        end = max(end, start + dur)
    busy_ms = busy / hops / 1e3
    print(f"profile, B={wav.shape[0]} streaming hop: {len(kernels) / hops:.1f} kernels per hop, "
          f"device busy {busy_ms:.4f} ms per hop of {wall_ms:.4f} ms wall (without the "
          f"profiler): idle {1 - busy_ms / wall_ms:.1%}")
    for name, (total, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {total / hops:9.2f} us/hop  {calls / hops:5.1f}/hop  {name[:100]}")


def enhancement_seconds(inferencer, x, reps: int = 3) -> float:
    inferencer.mag_to_mag(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        inferencer.mag_to_mag(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


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
    kernel_s = enhancement_seconds(inferencer, x)
    set_recurrence(inferencer.model, gru_sequence_reference)
    plain_s = enhancement_seconds(inferencer, x, reps=1)
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
        "launches": stream_df + auto_df, "max_abs_err": df_err,
        "ms": df_ms, "plain_ms": df_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
