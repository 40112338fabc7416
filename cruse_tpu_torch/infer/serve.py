"""Serving CLI of the port (counterpart of ``tools/serve.py``): many
concurrent enhancement sessions, over one model or several, through the
``MultiModelServer`` priority scheduler.

    python -m cruse_tpu_torch.infer.serve -M NAME=CONFIG.toml[:WEIGHTS.npz] [-M ...] \\
        -I PATH[@MODEL[:PRIORITY]] [-I ...] -O out_dir [--max_streams 8] \\
        [--max_dispatches 0] [--feed_chunk 1] [--realtime] [--quantize int8] [--seed 0] [--device cuda]

Each ``-M`` registers a model with its own pool of stream slots; its weights
come from a bridge ``.npz`` (``cruse_tpu_torch.utils.weights.save_flax_npz``)
or, without one, are made from ``--seed``. Each ``-I`` queues sessions (a
wav, a directory of wavs or a manifest ``.txt``) against a model (the first
by default) at a priority (0 by default). Sessions are admitted as slots
free up, fed ``--feed_chunk`` hops an iteration, stepped under an optional
budget of pool dispatches an iteration (priority decides who keeps cadence),
drained at the end of their input and written to ``-O`` at the input's
length. A multi-mic model's (McCruse's) sessions read every channel of their
wavs (``[M, L]``, M the model's mics) and write the enhanced reference mic.
Every streaming family serves, a causal BSRNN (``configs/tiny_bsrnn_causal.toml``)
included; an offline BSRNN is refused by the streaming guard. The run ends
with the aggregate x-realtime line; ``--realtime``
paces one iteration a hop period of the first model and reports the p50 and
p99 of an iteration against that budget and the share of missed deadlines.

The models run on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the CPU; a CUDA device that is not there is an
error. ``--quantize int8`` quantizes every model's weights by the JAX
package's rule (``nn.quantize``) and loads them dequantized once, so the
device holds float32 weights. Not ported, and refused by name: ``-N``
(slots sharded over a torch.distributed mesh of cards).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path


def build_model(config_path: str, weights: str | None, seed: int, quantize: str | None = None):
    """A model from its TOML config, with bridged or seeded weights (int8,
    loaded dequantized, with ``quantize="int8"``); returns (model,
    center=False StftConfig, sample rate)."""
    import torch

    from cruse_tpu_torch.dsp.stft import StftConfig
    from cruse_tpu_torch.models import build_from_config
    from cruse_tpu_torch.nn.quantize import load_int8_for_serving
    from cruse_tpu_torch.utils.config import load_config, log
    from cruse_tpu_torch.utils.weights import load_flax_npz, state_dict_from_flax

    config = load_config(config_path)
    ac = config["acoustics"]
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(seed))
    variables = load_flax_npz(weights) if weights else None
    if quantize == "int8":
        log(f"{config_path}: {load_int8_for_serving(model, variables)}")
    elif variables is not None:
        model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    cfg = StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"]), center=False)
    return model, cfg, int(ac.get("sr", 16000))


def parse_model(spec: str) -> tuple[str, str, str | None]:
    """``NAME=CONFIG.toml[:WEIGHTS.npz]`` -> (name, config path, weights or None)."""
    name, sep, rest = spec.partition("=")
    if not sep or not name or not rest:
        raise SystemExit(f"-M {spec!r}: expected NAME=CONFIG.toml[:WEIGHTS.npz]")
    config_path, colon, weights = rest.rpartition(":")
    if not colon or not config_path.endswith(".toml"):
        return name, rest, None
    return name, config_path, weights


def expand_inputs(spec: str, default_model: str) -> tuple[list, str, int]:
    """``PATH[@MODEL[:PRIORITY]]`` -> (wav paths, model, priority)."""
    from cruse_tpu_torch.data.manifest import load_manifest

    model, priority, path = default_model, 0, spec
    if "@" in spec:
        path, tail = spec.rsplit("@", 1)
        model, colon, prio = tail.partition(":")
        if colon:
            priority = int(prio)
    p = Path(path)
    if p.is_dir():
        files = sorted(str(f) for f in p.glob("*.wav"))
    elif p.suffix == ".txt":
        files = load_manifest(str(p))
    else:
        files = [str(p)]
    if not files:
        raise SystemExit(f"-I {spec!r}: no wavs under {path}")
    return files, model, priority


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m cruse_tpu_torch.infer.serve",
                                     description="cruse_tpu_torch streaming server")
    parser.add_argument("-M", "--model", action="append", required=True, metavar="NAME=CONFIG[:WEIGHTS]",
                        help="Register a model (repeatable); weights from a bridge .npz, else from --seed.")
    parser.add_argument("-I", "--input", action="append", required=True, metavar="PATH[@MODEL[:PRIORITY]]",
                        help="A wav, a directory of wavs or a manifest .txt of sessions (repeatable).")
    parser.add_argument("-O", "--output_dir", required=True)
    parser.add_argument("--max_streams", type=int, default=8,
                        help="Slots of each model's pool (sessions beyond it queue).")
    parser.add_argument("--max_dispatches", type=int, default=0,
                        help="Pool dispatches an iteration (0: every pool with ready work; "
                             ">0 rations them by priority).")
    parser.add_argument("--feed_chunk", type=int, default=1,
                        help="Hops of input fed a session an iteration (>1 simulates bursty "
                             "arrivals; the backlog drains at one hop an iteration).")
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="Weight-only per-channel int8 for every registered model, dequantized once "
                             "when loaded (the device holds float32 weights).")
    parser.add_argument("-N", "--num_devices", type=int, default=0,
                        help="Shard every pool's slots over N cards (not ported: refused for N > 1).")
    parser.add_argument("--realtime", action="store_true",
                        help="Pace one iteration a hop period and report the p50 / p99 of an "
                             "iteration and the share of missed hop deadlines.")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the weights of a model without a .npz.")
    parser.add_argument("--device", default="cuda", help="cuda (the default), cuda:N, or cpu.")
    args = parser.parse_args(argv)
    if args.num_devices > 1:
        raise SystemExit(f"-N {args.num_devices}: serving over a mesh of cards is not ported "
                         "(it waits for torch.distributed)")

    import numpy as np
    import torch

    from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
    from cruse_tpu_torch.infer.server import MultiModelServer
    from cruse_tpu_torch.utils.config import log

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    server = MultiModelServer()
    hops, srs, mics = {}, {}, {}
    for spec in args.model:
        name, config_path, weights = parse_model(spec)
        model, cfg, sr = build_model(config_path, weights, args.seed, args.quantize)
        server.add_model(name, model, cfg, max_streams=args.max_streams, device=device)
        hops[name], srs[name], mics[name] = cfg.hop_length, sr, server.pool(name).mics  # 0: one channel
        log(f"registered model {name!r} (hop {cfg.hop_length}, {sr} Hz, {args.max_streams} slots"
            + (f", {mics[name]} mics" if mics[name] else "") + ")")

    default_model = server.models[0]
    queue = []  # (wav path, model, priority)
    for spec in args.input:
        files, model_name, priority = expand_inputs(spec, default_model)
        if model_name not in server.models:
            raise SystemExit(f"-I {spec!r}: unknown model {model_name!r} (registered: {server.models})")
        queue.extend((f, model_name, priority) for f in files)
    log(f"{len(queue)} sessions queued over {len(server.models)} model(s)")

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    live = {}  # handle -> session record
    audio_served = 0.0  # seconds of audio in the hops served
    t0 = time.perf_counter()

    def admit():
        while queue:
            path, model_name, priority = queue[0]
            try:
                handle = server.open(model_name, priority=priority)
            except RuntimeError:
                return  # the pool is full; wait for a drain
            queue.pop(0)
            wav, _ = read_wav(path, sr=srs[model_name], mono=not mics[model_name])
            if mics[model_name] and (wav.ndim != 2 or wav.shape[0] != mics[model_name]):
                raise SystemExit(f"{path}: model {model_name!r} takes {mics[model_name]}-channel wavs, "
                                 f"got shape {wav.shape}")
            live[handle] = {"name": Path(path).stem, "model": model_name, "wav": wav.astype(np.float32),
                            "pos": 0, "outs": [], "t": time.perf_counter(), "priority": priority}

    # real-time pacing: one iteration a hop period; an iteration that overruns
    # the period is a missed deadline (an audible glitch in a live deployment)
    hop_period = hops[default_model] / srs[default_model]
    iter_times: list = []
    next_tick = time.perf_counter()
    budget = args.max_dispatches if args.max_dispatches > 0 else None

    admit()
    while live or queue:
        if args.realtime:
            now = time.perf_counter()
            if now < next_tick:
                time.sleep(next_tick - now)
            next_tick = max(next_tick + hop_period, time.perf_counter() - hop_period)
            it0 = time.perf_counter()
        for handle, s in live.items():  # each live session's next chunk of input
            nxt = s["wav"][..., s["pos"] : s["pos"] + args.feed_chunk * hops[s["model"]]]
            if nxt.shape[-1]:
                server.feed(handle, nxt)
                s["pos"] += nxt.shape[-1]
        for handle, hop_out in server.step(max_dispatches=budget).items():
            live[handle]["outs"].append(hop_out)
            audio_served += hops[handle[0]] / srs[handle[0]]
        if args.realtime:
            iter_times.append(time.perf_counter() - it0)
        for handle, s in list(live.items()):  # retire: drain, write, free the slot
            if s["pos"] >= s["wav"].shape[-1] and not server.ready(handle):
                tail = server.drain(handle)
                if len(tail):
                    s["outs"].append(tail)
                    audio_served += len(tail) / srs[s["model"]]
                server.close(handle)
                out = np.concatenate(s["outs"]) if s["outs"] else np.zeros(0, np.float32)
                dt = time.perf_counter() - s["t"]
                audio = s["wav"].shape[-1] / srs[s["model"]]
                write_wav(str(out_dir / f"{s['name']}.wav"), to_int16_scaled(out), srs[s["model"]])
                log(f"  {s['name']} ({s['model']}, prio {s['priority']}): {audio:.2f}s audio in "
                    f"{dt:.2f}s wall (session rtf {dt / max(audio, 1e-9):.3f})")
                del live[handle]
        admit()

    wall = time.perf_counter() - t0
    log(f"served {audio_served:.2f}s of audio in {wall:.2f}s ({audio_served / max(wall, 1e-9):.1f}x "
        f"realtime aggregate)")
    if args.realtime and iter_times:
        ts = np.sort(np.asarray(iter_times))
        p50 = ts[len(ts) // 2] * 1e3
        p99 = ts[min(int(0.99 * len(ts)), len(ts) - 1)] * 1e3
        missed = float(np.mean(ts > hop_period)) * 100.0
        log(f"realtime QoS: iteration p50 {p50:.2f} ms / p99 {p99:.2f} ms vs {hop_period * 1e3:.1f} ms "
            f"hop budget; {missed:.1f}% deadlines missed")


if __name__ == "__main__":
    main()
