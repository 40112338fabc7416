"""Enhancement CLI of the port:

    python -m cruse_tpu_torch.infer -C cfg.toml -I wav_dir -O out_dir \\
        [--weights w.npz] [--seed N] [--batch N | --chunk_seconds S] \\
        [--postfilter sin|envelope] [--quantize int8] [--device cpu]
    python -m cruse_tpu_torch.infer -C cfg.toml -I wav_dir -O out_dir \\
        --streaming [--hops_per_step k] [--weights w.npz] [--device cpu]

Weights come from a bridge ``.npz`` written by
``cruse_tpu_torch.utils.weights.save_flax_npz`` from cruse_tpu variables, or,
without ``--weights``, are made from ``--seed``. The offline mode uses the
config's ``[inferencer] type`` (``mag_to_mag``, ``complex_mask`` for
FullSubNet's cIRM, ``multi_channel_directional`` for McCruse,
``multi_channel_mag_to_mag``, or ``auto``, the default as in
``tools/infer.py``); McCruse and the ``multi_channel_*`` strategies read each
wav with all its channels (``[M, L]``), the others a mono downmix;
``--batch N`` (N > 1) enhances N utterances per forward, otherwise one per
forward. ``--postfilter sin|envelope`` overrides the config's ``[inferencer]
postfilter`` (``mag_to_mag`` and ``multi_channel_directional`` apply it to
the mask; the other strategies ignore it).
``--chunk_seconds S`` enhances each file, one per forward, as 50 %
overlapping chunks of S seconds (``BatchInferencer.enhance_long``); it takes
precedence over ``--batch``.
``--quantize int8`` quantizes the weights (bridged or seeded) by the JAX
package's rule (``nn.quantize``) and loads them dequantized once: the model
runs the int8 weights' values in float32, so the device holds float32.
``--streaming`` runs each file as one stream (B=1) frame by frame through
``StreamingEnhancer`` with a ``center=False`` STFT, logging the per-hop
real-time factor; ``--hops_per_step k`` feeds k hops per call. It streams
CRUSE, CRUSE+DF, DFSMN (``configs/tiny_dfsmn.toml``), a windowed MTFAA
(``configs/demo_mtfaa_windowed.toml``), FullSubNet with
``norm = "cumulative_laplace_norm"``, McCruse (multi-mic wavs,
``configs/tiny_mc.toml``; the output is the reference mic) and a causal
BSRNN (``configs/tiny_bsrnn_causal.toml``); a full-causal MTFAA
(``configs/tiny_mtfaa.toml``) is refused, for it carries no attention state,
and so are a FullSubNet with an offline norm or a look-ahead and the
offline BSRNN (``configs/tiny_bsrnn.toml``, whose GroupNorm reads the whole
utterance; it runs offline through ``auto``). The model runs
on the card (``--device cuda``, the default) unless ``--device cpu`` asks for
the CPU; a CUDA device that is not there is an error, never a quiet fall back
to the CPU.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m cruse_tpu_torch.infer",
                                     description="cruse_tpu_torch batch inferencer")
    parser.add_argument("-C", "--configuration", required=True, help="Config (*.toml).")
    parser.add_argument("-I", "--input", required=True, help="Directory of wavs.")
    parser.add_argument("-O", "--output_dir", required=True, help="Where to write enhanced wavs.")
    parser.add_argument("--weights", default=None,
                        help="Bridge .npz of cruse_tpu variables (save_flax_npz).")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the weights without --weights.")
    parser.add_argument("--batch", type=int, default=0, help="Utterances per forward (0/1: one).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default), cuda:N, or cpu.")
    parser.add_argument("--streaming", action="store_true",
                        help="Frame-by-frame causal path, one stream per file.")
    parser.add_argument("--hops_per_step", type=int, default=1,
                        help="Streaming: hops per step_multi call (k > 1 adds (k-1)*hop/sr "
                             "seconds of latency).")
    parser.add_argument("--postfilter", choices=["sin", "envelope"], default=None,
                        help="Mask post-filter of mag_to_mag (overrides [inferencer] postfilter).")
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="Weight-only per-channel int8 (the JAX package's rule), dequantized once "
                             "when loaded: the device holds float32 weights.")
    parser.add_argument("--chunk_seconds", type=float, default=0.0,
                        help="Long-audio mode: each file as 50%% overlapping chunks of this many "
                             "seconds, stitched (one file per forward; takes precedence over --batch).")
    args = parser.parse_args(argv)
    if args.streaming and (args.batch > 1 or args.chunk_seconds > 0):
        raise SystemExit("--streaming is the one-stream low-latency path; it does not "
                         "compose with --batch or --chunk_seconds")

    import torch

    from cruse_tpu_torch.data.wavio import read_wav
    from cruse_tpu_torch.dsp.stft import StftConfig
    from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
    from cruse_tpu_torch.models import McCruseNet, build_from_config
    from cruse_tpu_torch.nn.quantize import load_int8_for_serving
    from cruse_tpu_torch.utils.config import load_config, log
    from cruse_tpu_torch.utils.weights import load_flax_npz, state_dict_from_flax

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    config = load_config(args.configuration)
    ac = config["acoustics"]
    sr = int(ac.get("sr", 16000))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(args.seed))
    variables = load_flax_npz(args.weights) if args.weights else None
    if args.quantize == "int8":
        log(load_int8_for_serving(model, variables))
    elif variables is not None:
        model.load_state_dict(state_dict_from_flax(variables, model), strict=True)

    inp = Path(args.input)
    if not inp.is_dir():
        raise SystemExit(f"-I {inp}: not a directory of wavs")
    files = sorted(inp.glob("*.wav"))
    if not files:
        raise SystemExit(f"no wavs found under {inp}")

    strategy = config.get("inferencer", {}).get("type", "auto")
    # McCruse and the multi-channel strategies take [M, L] wavs, not a mono downmix
    mono = not (isinstance(model, McCruseNet) or strategy.startswith("multi_channel"))
    if args.streaming:
        stream(model, files, args, ac, sr, device, mono)
        return

    icfg = InferencerConfig(
        type=strategy,
        sr=sr,
        stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"])),
        output_dir=args.output_dir,
        postfilter=args.postfilter or config.get("inferencer", {}).get("postfilter"),
    )
    inferencer = BatchInferencer(model, icfg, device)
    if args.chunk_seconds > 0:
        long_audio(inferencer, files, args.chunk_seconds, sr, mono)
    elif args.batch > 1:
        inferencer.run_batched([read_wav(str(f), sr=sr, mono=mono)[0] for f in files],
                               [f.stem for f in files], batch_size=args.batch)
    else:
        inferencer({"noisy": read_wav(str(f), sr=sr, mono=mono)[0][None], "name": [f.stem]} for f in files)


def long_audio(inferencer, files, chunk_seconds: float, sr: int, mono: bool = True) -> None:
    """Each file through ``enhance_long``, one file per forward."""
    import time

    import torch

    from cruse_tpu_torch.data.wavio import read_wav
    from cruse_tpu_torch.utils.config import log

    for f in files:
        wav = torch.from_numpy(read_wav(str(f), sr=sr, mono=mono)[0][None])
        t1 = time.perf_counter()
        out = inferencer.enhance_long(wav, chunk_seconds=chunk_seconds)[0].cpu().numpy()
        rtf = (time.perf_counter() - t1) / (len(out) / sr)
        log(f"{f.stem} ({len(out) / sr:.1f}s in {chunk_seconds:g}s chunks), rtf: {rtf}")
        inferencer._emit(f.stem, out, rtf, write=True)


def stream(model, files, args, ac: dict, sr: int, device, mono: bool = True) -> None:
    """Each file as one stream (B=1): its per-hop rtf, then the enhanced wav
    (``mono=False``: every channel in, ``[1, M, hop]`` a hop)."""
    import numpy as np
    import torch

    from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
    from cruse_tpu_torch.dsp.stft import StftConfig
    from cruse_tpu_torch.infer.streaming import StreamingEnhancer
    from cruse_tpu_torch.utils.config import log

    cfg = StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"]), center=False)
    enhancer = StreamingEnhancer(model.to(device), cfg)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    k = max(args.hops_per_step, 1)
    hop, keep = cfg.hop_length, cfg.n_fft - cfg.hop_length
    for f in files:
        wav = read_wav(str(f), sr=sr, mono=mono)[0][None]
        rtf = enhancer.measure_rtf(wav, sr=sr, num_frames=20)
        x = torch.from_numpy(wav).to(device)
        state = enhancer.prime(enhancer.init_state(1), x[..., :keep])
        rest = x[..., keep:]
        whole = rest.shape[-1] // (k * hop) * k  # hops fed k at a time; the rest one by one
        outs = []
        for i in range(0, whole, k):
            out, state = enhancer.step_multi(state, rest[..., i * hop : (i + k) * hop])
            outs.append(out)
        for i in range(whole, rest.shape[-1] // hop):
            out, state = enhancer.step(state, rest[..., i * hop : (i + 1) * hop])
            outs.append(out)
        out = torch.cat(outs, dim=-1)[0].cpu().numpy() if outs else np.zeros(0, np.float32)
        log(f"{f.stem}, streaming rtf: {rtf}")
        write_wav(str(out_dir / f"{f.stem}.wav"), to_int16_scaled(out), sr)


if __name__ == "__main__":
    main()
