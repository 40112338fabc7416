#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (cruse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA device (no JAX
needed). In order, and any failure exits non-zero:

1. prints the device and ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``cruse_tpu_torch/ops/csrc`` (ptxas report);
3. holds the grouped-GRU kernel against its plain PyTorch version on the card
   at config-1 shapes (B=256, T=1001, G=4, H=176) and on ragged shapes:
   f32 within 1e-4, bf16 weights within 1e-3 (same bf16-rounded weights);
4. drives the main path: full-width CRUSE from ``configs/cruse_base.toml``
   with seeded weights and seeded non-default BatchNorm statistics,
   ``BatchInferencer.run_batched`` on six synthetic noisy utterances of 2 to
   10 s in batches of 4; checks the outputs, that the kernel launched twice
   per forward (one per GRU bank), and that the enhanced waveforms agree with
   the same batch through the plain recurrence on the card within 1e-4;
5. times the kernel and the plain version with CUDA events, and one B=256 x
   10 s enhancement with each;
6. prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``.

TF32 is off for matmuls and convolutions throughout, so every comparison is
in full float32.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import cruse_tpu_torch
from cruse_tpu.utils.config import load_config
from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
from cruse_tpu_torch.models import build_from_config
from cruse_tpu_torch.nn.gru import GroupedGRULayer
from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.gru_kernel import gru_sequence, gru_sequence_reference

ROOT = Path(__file__).resolve().parent
SEED = 0
CONFIG1_GRU = (256, 1001, 4, 176)  # B, T, G, H of config 1's bottleneck banks
RAGGED_GRU = ((3, 7, 4, 176), (3, 7, 3, 50))
F32_TOL, BF16_TOL, WAV_TOL = 1e-4, 1e-3, 1e-4
SR = 16000
UTTERANCE_SAMPLES = (32017, 59123, 81611, 105777, 132941, 160000)  # 2 .. 10 s
BATCH = 4


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
    for shape in (CONFIG1_GRU, *RAGGED_GRU):
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


def noisy_utterances(seed: int):
    """Synthetic noisy speech: amplitude-modulated harmonic tones + noise."""
    rng = np.random.default_rng(seed)
    wavs = []
    for n in UTTERANCE_SAMPLES:
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


def build_inferencer(device):
    config = load_config(str(ROOT / "configs" / "cruse_base.toml"))
    gen = torch.Generator().manual_seed(SEED)
    model = build_from_config(config["model"], generator=gen)
    with torch.no_grad():  # seeded non-default BatchNorm statistics
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    ac = config["acoustics"]
    icfg = InferencerConfig(type=config["inferencer"]["type"], sr=int(ac["sr"]),
                            stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"])))
    return BatchInferencer(model, icfg, device)


def check_main_path(inferencer) -> int:
    """Drive run_batched once; returns the kernel launches it made."""
    wavs = noisy_utterances(SEED)
    names = [f"utt{i}" for i in range(len(wavs))]
    forwards = math.ceil(len(wavs) / BATCH)

    gru_sequence.launches = 0
    results = inferencer.run_batched(wavs, names, batch_size=BATCH, write=False)
    torch.cuda.synchronize()
    launches = gru_sequence.launches

    require(launches == 2 * forwards,
            f"main path launched gru_sequence {launches} times = 2 per forward x {forwards}")
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

    _build.load_library("gru_sequence")
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

    print(json.dumps({"kernels": [{
        "name": "gru_sequence", "route": "cuda",
        "source": "cruse_tpu_torch/ops/csrc/gru_sequence.cu",
        "replaces": "cruse_tpu/ops/gru_kernel.py:82",
        "launches": launches, "max_abs_err": gru_err, "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
