"""Batch enhancement CLI of the port:

    python -m cruse_tpu_torch.infer -C cfg.toml -I wav_dir -O out_dir \\
        [--weights w.npz] [--seed N] [--batch N] [--device cuda]

Weights come from a bridge ``.npz`` written by
``cruse_tpu_torch.utils.weights.save_flax_npz`` from cruse_tpu variables, or,
without ``--weights``, are made from ``--seed``. ``--batch N`` (N > 1)
enhances N utterances per forward; otherwise one per forward. A CUDA device
that is not there is an error, never a quiet fall back to the CPU.
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
    parser.add_argument("--device", default="cpu", help="cpu, cuda or cuda:N.")
    args = parser.parse_args(argv)

    import torch

    from cruse_tpu.utils.config import load_config
    from cruse_tpu_torch.data.wavio import read_wav
    from cruse_tpu_torch.dsp.stft import StftConfig
    from cruse_tpu_torch.infer.batch import BatchInferencer, InferencerConfig
    from cruse_tpu_torch.models import build_from_config
    from cruse_tpu_torch.utils.weights import cruse_state_dict_from_flax, load_flax_npz

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    config = load_config(args.configuration)
    ac = config["acoustics"]
    sr = int(ac.get("sr", 16000))
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        state = cruse_state_dict_from_flax(load_flax_npz(args.weights), model.config)
        model.load_state_dict(state, strict=True)

    inp = Path(args.input)
    if not inp.is_dir():
        raise SystemExit(f"-I {inp}: not a directory of wavs")
    files = sorted(inp.glob("*.wav"))
    if not files:
        raise SystemExit(f"no wavs found under {inp}")

    icfg = InferencerConfig(
        type=config.get("inferencer", {}).get("type", "mag_to_mag"),
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


if __name__ == "__main__":
    main()
