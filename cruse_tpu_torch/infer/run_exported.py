"""Enhance wavs from an exported artifact ALONE (counterpart of
``tools/run_exported.py``): no config, no weights, no model code. The
consumer half of the deployment path: ``python -m
cruse_tpu_torch.infer.export`` writes the container, this runner loads it
through ``infer/artifact.py`` and serves audio through it.

    python -m cruse_tpu_torch.infer.run_exported -A model.zip -I wav_dir -O out_dir \\
        [--device cuda]

  offline artifact:   each wav is zero-padded to the exported [B, L] window,
                      enhanced in groups of B, trimmed, written.
  streaming artifact: each group of B wavs streams hop by hop through the
                      exported step from the shipped initial state, primed
                      with the first n_fft - hop samples so that output
                      sample j is input sample j's; B files ride a step.
                      A multi-mic artifact ("num_mics" M in its meta) reads
                      [M, L] wavs and writes the enhanced reference mic.

The artifact runs on the device it was exported on, which ``--device`` (the
card by default) must name.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path


def _groups(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m cruse_tpu_torch.infer.run_exported",
                                     description="run an exported enhancement artifact")
    parser.add_argument("-A", "--artifact", required=True, help="Container from cruse_tpu_torch.infer.export.")
    parser.add_argument("-I", "--input", required=True, help="Directory of wavs or a manifest .txt.")
    parser.add_argument("-O", "--output_dir", required=True, help="Where to write enhanced wavs.")
    parser.add_argument("--device", default="cuda", help="The artifact's device: cuda (the default), cuda:N, or cpu.")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from cruse_tpu_torch.data.manifest import load_manifest
    from cruse_tpu_torch.data.wavio import read_wav, to_int16_scaled, write_wav
    from cruse_tpu_torch.infer import artifact as artifact_lib
    from cruse_tpu_torch.utils.config import log

    art = artifact_lib.load(args.artifact, args.device)
    meta = art.meta
    sr = int(meta.get("sr", 16000))
    num_mics = meta.get("num_mics")
    device = meta["device"]
    log(f"loaded {art.kind} artifact ({meta.get('model', 'unknown model')}, sr={sr}"
        + (f", mics={num_mics}" if num_mics else "") + f", {meta.get('quantized') or 'fp32'} weights, {device})")

    inp = Path(args.input)
    files = load_manifest(str(inp)) if inp.is_file() else sorted(str(p) for p in inp.glob("*.wav"))
    if not files:
        raise SystemExit(f"no wavs found under {inp}")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def write(f, y):
        write_wav(str(out_dir / f"{Path(f).stem}.wav"), to_int16_scaled(y), sr)

    def read(f):
        wav = read_wav(f, sr=sr, mono=not num_mics)[0]
        if num_mics and (wav.ndim != 2 or wav.shape[0] != num_mics):
            raise SystemExit(f"{f}: the artifact takes {num_mics}-mic wavs, got shape {wav.shape}")
        return wav

    if art.kind == "offline":
        batch, length = art.input_shape
        for group in _groups(files, batch):
            wavs = [read(f) for f in group]
            for f, w in zip(group, wavs):
                if w.shape[-1] > length:
                    raise SystemExit(
                        f"{f}: {w.shape[-1]} samples > exported window {length}; "
                        "re-export with a larger --seconds or use a --streaming "
                        "artifact for unbounded-length audio")
            x = np.zeros((batch, length), np.float32)
            for i, w in enumerate(wavs):
                x[i, : w.shape[-1]] = w
            t0 = time.perf_counter()
            out = art.enhance(torch.from_numpy(x).to(device)).cpu().numpy()
            dt = time.perf_counter() - t0
            for f, w, y in zip(group, wavs, out):
                write(f, y[: w.shape[-1]])
            log(f"enhanced {len(group)} files, rtf: {dt / (batch * length / sr):.4f}")
        return

    batch, hop = art.hop_shape[0], art.hop_shape[-1]
    # priming the analysis buffer with the first n_fft - hop samples makes output
    # sample j correspond to input sample j (the infer CLI's --streaming contract);
    # without it the stream is delayed by n_fft - hop samples
    prime_len = int(meta["n_fft"]) - hop
    for group in _groups(files, batch):
        wavs = [read(f) for f in group]
        max_len = max(w.shape[-1] for w in wavs)
        n_hops = max(-(-(max_len - prime_len) // hop), 1)  # ceil: the padded feed covers every sample
        feed_len = prime_len + n_hops * hop
        x = np.zeros((*art.hop_shape[:-1], feed_len), np.float32)
        for i, w in enumerate(wavs):
            n = min(w.shape[-1], feed_len)
            x[i, ..., :n] = w[..., :n]
        x = torch.from_numpy(x).to(device)
        state = art.prime(art.init_state(), x[..., :prime_len])
        outs = []
        t0 = time.perf_counter()
        for h in range(n_hops):
            lo = prime_len + h * hop
            o, state = art.step(state, x[..., lo : lo + hop])
            outs.append(o)
        out = torch.cat(outs, dim=-1).cpu().numpy()  # [B, n_hops * hop]; the copy waits for the device
        dt = time.perf_counter() - t0
        for f, w, y in zip(group, wavs, out):
            write(f, y[: min(w.shape[-1], out.shape[-1])])
        log(f"streamed {len(group)} files x {n_hops} hops, per-stream rtf: {dt / (n_hops * hop / sr):.4f}")


if __name__ == "__main__":
    main()
