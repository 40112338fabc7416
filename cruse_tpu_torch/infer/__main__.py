"""Enhancement CLI of the port:

    python -m cruse_tpu_torch.infer -C cfg.toml -I wav_dir -O out_dir \\
        [--weights w.npz] [--seed N] [--batch N] [--device cpu]
    python -m cruse_tpu_torch.infer -C cfg.toml -I wav_dir -O out_dir \\
        --streaming [--hops_per_step k] [--weights w.npz] [--device cpu]

Weights come from a bridge ``.npz`` written by
``cruse_tpu_torch.utils.weights.save_flax_npz`` from cruse_tpu variables, or,
without ``--weights``, are made from ``--seed``. The offline mode uses the
config's ``[inferencer] type`` (``mag_to_mag``, or ``auto``, the default as in
``tools/infer.py``); ``--batch N``
(N > 1) enhances N utterances per forward, otherwise one per forward.
``--streaming`` runs each file as one stream (B=1) frame by frame through
``StreamingEnhancer`` with a ``center=False`` STFT, logging the per-hop
real-time factor; ``--hops_per_step k`` feeds k hops per call. The model runs
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
    args = parser.parse_args(argv)
    if args.streaming and args.batch > 1:
        raise SystemExit("--streaming is the one-stream low-latency path; it does not "
                         "compose with --batch")

    import torch

    from cruse_tpu_torch.data.wavio import read_wav
    from cruse_tpu_torch.dsp.stft import StftConfig
    from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
    from cruse_tpu_torch.models import build_from_config
    from cruse_tpu_torch.utils.config import load_config
    from cruse_tpu_torch.utils.weights import load_flax_npz, state_dict_from_flax

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    config = load_config(args.configuration)
    ac = config["acoustics"]
    sr = int(ac.get("sr", 16000))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        model.load_state_dict(state_dict_from_flax(load_flax_npz(args.weights), model), strict=True)

    inp = Path(args.input)
    if not inp.is_dir():
        raise SystemExit(f"-I {inp}: not a directory of wavs")
    files = sorted(inp.glob("*.wav"))
    if not files:
        raise SystemExit(f"no wavs found under {inp}")

    if args.streaming:
        stream(model, files, args, ac, sr, device)
        return

    icfg = InferencerConfig(
        type=config.get("inferencer", {}).get("type", "auto"),
        sr=sr,
        stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"])),
        output_dir=args.output_dir,
        postfilter=config.get("inferencer", {}).get("postfilter"),
    )
    inferencer = BatchInferencer(model, icfg, device)
    if args.batch > 1:
        inferencer.run_batched([read_wav(str(f), sr=sr)[0] for f in files],
                               [f.stem for f in files], batch_size=args.batch)
    else:
        inferencer({"noisy": read_wav(str(f), sr=sr)[0][None], "name": [f.stem]} for f in files)


def stream(model, files, args, ac: dict, sr: int, device) -> None:
    """Each file as one stream (B=1): its per-hop rtf, then the enhanced wav."""
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
        wav = read_wav(str(f), sr=sr)[0][None]
        rtf = enhancer.measure_rtf(wav, sr=sr, num_frames=20)
        x = torch.from_numpy(wav).to(device)
        state = enhancer.prime(enhancer.init_state(1), x[:, :keep])
        rest = x[:, keep:]
        whole = rest.shape[-1] // (k * hop) * k  # hops fed k at a time; the rest one by one
        outs = []
        for i in range(0, whole, k):
            out, state = enhancer.step_multi(state, rest[:, i * hop : (i + k) * hop])
            outs.append(out)
        for i in range(whole, rest.shape[-1] // hop):
            out, state = enhancer.step(state, rest[:, i * hop : (i + 1) * hop])
            outs.append(out)
        out = torch.cat(outs, dim=-1)[0].cpu().numpy() if outs else np.zeros(0, np.float32)
        log(f"{f.stem}, streaming rtf: {rtf}")
        write_wav(str(out_dir / f"{f.stem}.wav"), to_int16_scaled(out), sr)


if __name__ == "__main__":
    main()
