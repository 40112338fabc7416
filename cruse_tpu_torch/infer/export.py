"""Export CLI of the port (counterpart of ``tools/export.py``): a model as a
self-contained ``torch.export`` artifact (``infer/artifact.py``), which
``python -m cruse_tpu_torch.infer.run_exported`` runs without the config,
the model code or the weights.

    python -m cruse_tpu_torch.infer.export -C cfg.toml -O model.zip \\
        [--weights w.npz | --seed N] [--batch B] [--seconds S] [--streaming] \\
        [--quantize int8] [--device cuda]

Offline, the program is the whole enhancement of a ``[B, S * sr]`` batch:
STFT, the model, iSTFT. The body traced is ``mag_to_mag`` where the config's
``[inferencer] type`` says so, else the family's forward adapter (``auto``),
whatever the type names, as ``tools/export.py`` exports it: FullSubNet's
``complex_mask`` config exports ``auto``'s body, the cIRM from
``sqrt(|X|² + 1e-12)`` where ``complex_mask`` reads ``|X|``. With
``--streaming`` it is the per-hop step ``(state, hop [B, hop]) -> (out,
state')`` of ``StreamingEnhancer`` (``hop [B, M, hop]`` for the multi-mic
McCruse, whose ``meta.json`` then holds ``num_mics``), shipped with its
initial state. Both are traced under ``torch.no_grad()`` from the
inferencers' bodies, in which every hand-written kernel on the path is a
custom op: ``torch.ops.cruse_tpu_torch``
``.gru_sequence`` (CRUSE, CRUSE+DF, FullSubNet's four GRUs, McCruse),
``deep_filter`` (CRUSE+DF, MTFAA),
``tfcm_eval`` and ``tattn_fwd`` (MTFAA offline: a TFCM stack, a temporal
attention) and ``dw_fwd`` (MTFAA streamed: the TFCM blocks' stencil). The
saved program launches the hand-written kernels on the card, the plain
versions on the CPU. The program is fixed to the device it was exported on
(``--device``, the card by default; a CUDA device that is not there is an
error).

``--quantize int8`` keeps the large weights as int8 codes and float32 scales
in the program, which dequantizes them on every call (``nn.quantize``,
``attach_int8``), and logs the quantization report. The export reloads the
artifact through ``artifact.load`` and runs it once before it exits 0.

Exported: CRUSE, CRUSE+DF, DFSMN, MTFAA (configs 5 and 5b offline, a
windowed MTFAA also streamed; a full-causal one streamed raises
``StreamingEnhancer``'s ``ValueError``), FullSubNet offline and, with the
cumulative norm, streamed, McCruse streamed, and BSRNN offline and, causal,
streamed (a non-causal one streamed raises ``StreamingEnhancer``'s
``ValueError``). BSRNN's program keeps each LSTM as one ``aten.lstm`` node,
cuDNN's RNN on the card: this path never calls ``run_decompositions()``,
which would unroll it frame by frame. Its streamed state is flat like the
others: the cumulative norms' running sums and float32 counts, each time
LSTM's ``(h, c)`` as ``[B·31, 1, 2N]``. In int8 the LSTMs' ``weight_ih_l0`` /
``weight_hh_l0`` (and their ``_reverse``) and the band Linears hold int8
codes, dequantized in the program before each ``aten.lstm``. McCruse offline is refused by name before
tracing: the JAX exporter cannot export it either, for it
feeds the adapter a single-channel ``[B, L]`` STFT where McCruse's takes
``[B, M, T, F, 2]``. The MTFAA offline program runs the
model without its streaming state (``with_state=False``, as the ``auto``
adapter does). Its TFCM parameters are folded once, before tracing
(``models/mtfaa.py::frozen_folds``), and held as constants of a float32
program; a stack whose weights hold int8 leaves folds in the program after
the dequantize, as ``tools/export.py`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.utils._pytree as pytree
from torch import nn

from cruse_tpu_torch.models.mtfaa import frozen_folds

class _Program(nn.Module):
    """An inferencer's body as a module, so that ``torch.export`` lifts the
    model's weights (the body reads the same ``model``)."""

    def __init__(self, model: nn.Module, body):
        super().__init__()
        self.model = model
        self.body = body

    def forward(self, *args):
        return self.body(*args)


class _FlatStep(nn.Module):
    """``StreamingEnhancer``'s step with the model state flattened at the
    boundary to a tuple of tensors, so that a saved program names no type of
    the models (CRUSE+DF's ``DfStreamState``, nested tuples)."""

    def __init__(self, enhancer, model_state_spec):
        super().__init__()
        self.model = enhancer.model
        self.enhancer = enhancer
        self.spec = model_state_spec

    def forward(self, state, hop):
        model_state = pytree.tree_unflatten(list(state.model_state), self.spec)
        out, new = self.enhancer._step_impl(state._replace(model_state=model_state), hop)
        return out, new._replace(model_state=tuple(pytree.tree_leaves(new.model_state)))


def export_offline(model: nn.Module, icfg, batch: int, length: int, device):
    """The ``torch.export`` program of enhanced [B, L] = graph(noisy [B, L]):
    ``_mag_to_mag_impl`` for ``icfg.type == "mag_to_mag"``, else
    ``_auto_impl``. McCruse is refused (see the module doc)."""
    from cruse_tpu_torch.infer.batch import BatchInferencer
    from cruse_tpu_torch.models.mc_cruse import McCruseNet

    if isinstance(model, McCruseNet):
        raise NotImplementedError(
            "exporting McCruse offline is not supported: the JAX exporter (tools/export.py) traces the "
            "single-channel [B, L] program, whose STFT the multi-channel adapter refuses (it takes [B, M, T, F, "
            "2]), so there is no reference program; export the streamed step with --streaming")
    if icfg.type != "mag_to_mag":
        icfg = dataclasses.replace(icfg, type="auto")
    inferencer = BatchInferencer(model, icfg, device)
    body = inferencer._mag_to_mag_impl if icfg.type == "mag_to_mag" else inferencer._auto_impl
    example = torch.zeros(batch, length, device=inferencer.device)
    with torch.no_grad(), frozen_folds(inferencer.model):
        program = torch.export.export(_Program(inferencer.model, body), (example,))
    program.example_inputs = None  # else the saved program carries the [B, L] batch of zeros
    return program


def export_streaming(model: nn.Module, cfg, batch: int, device):
    """(the program of the per-hop step, its initial state): the state a
    ``StreamState`` whose ``model_state`` is a flat tuple of tensors. The
    hop is ``[B, hop]``, or ``[B, M, hop]`` for a multi-mic model."""
    from cruse_tpu_torch.infer.artifact import StreamState
    from cruse_tpu_torch.infer.streaming import StreamingEnhancer

    enhancer = StreamingEnhancer(model.to(device), cfg)
    state = enhancer.init_state(batch)
    leaves, spec = pytree.tree_flatten(state.model_state)
    init = StreamState(state.input_tail, state.ola_tail, tuple(leaves))
    hop = torch.zeros(*state.input_tail.shape[:-1], cfg.hop_length, device=enhancer.device)
    with torch.no_grad(), frozen_folds(enhancer.model):
        program = torch.export.export(_FlatStep(enhancer, spec), (init, hop))
    program.example_inputs = None  # the initial state ships once, as init.pt
    return program, init


def build(config: dict, weights: str | None, seed: int, quantize: str | None):
    """The config's model with bridged or seeded weights; int8 kept in the
    module (``attach_int8``) with ``quantize="int8"``."""
    from cruse_tpu_torch.models import build_from_config
    from cruse_tpu_torch.nn.quantize import attach_int8, int8_state_dict, report_line
    from cruse_tpu_torch.utils.config import log
    from cruse_tpu_torch.utils.weights import load_flax_npz, state_dict_from_flax

    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(seed))
    variables = load_flax_npz(weights) if weights else None
    if quantize == "int8":
        state, report = int8_state_dict(model, variables)
        log(report_line(report))
        attach_int8(model, state)
    elif variables is not None:
        model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return model.eval()


def main(argv=None):
    """The export CLI; returns the artifact as its reload check loaded it."""
    parser = argparse.ArgumentParser(prog="python -m cruse_tpu_torch.infer.export",
                                     description="export an enhancement artifact")
    parser.add_argument("-C", "--configuration", required=True, help="Config (*.toml).")
    parser.add_argument("-O", "--output", required=True, help="The artifact (a zip container).")
    parser.add_argument("--weights", default=None, help="Bridge .npz of cruse_tpu variables (save_flax_npz).")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the weights without --weights.")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=10.0, help="Offline: the input's length.")
    parser.add_argument("--streaming", action="store_true",
                        help="Export the per-hop streaming step (state, hop) -> (out, state) instead of "
                             "the offline batch program.")
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="Weight-only per-channel int8: the large kernels are kept in the artifact as "
                             "int8 + scales, dequantized in the program.")
    parser.add_argument("--device", default="cuda", help="cuda (the default), cuda:N, or cpu.")
    args = parser.parse_args(argv)

    from cruse_tpu_torch.dsp.stft import StftConfig
    from cruse_tpu_torch.infer import artifact as artifact_lib
    from cruse_tpu_torch.infer.batch import InferencerConfig
    from cruse_tpu_torch.utils.config import load_config, log

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    config = load_config(args.configuration)
    ac = config["acoustics"]
    sr, n_fft, hop_length = int(ac.get("sr", 16000)), int(ac["n_fft"]), int(ac["hop_length"])
    model = build(config, args.weights, args.seed, args.quantize)
    meta = {"model": config["model"]["path"], "sr": sr, "n_fft": n_fft, "hop_length": hop_length,
            "batch": args.batch, "quantized": args.quantize}

    if args.streaming:
        cfg = StftConfig(n_fft=n_fft, hop_length=hop_length, center=False)
        program, init = export_streaming(model, cfg, args.batch, device)
        meta["device"] = str(init.input_tail.device)
        meta["num_mics"] = init.input_tail.shape[1] if init.input_tail.dim() == 3 else None
        artifact_lib.save_streaming(args.output, program, init, meta)
        log(f"exported {os.path.getsize(args.output) / 1e6:.2f} MB streaming step (B={args.batch}, "
            f"hop={hop_length}" + (f", mics={meta['num_mics']}" if meta["num_mics"] else "")
            + f", {meta['device']}) -> {args.output}")
        art = artifact_lib.load(args.output, device)
        out, _ = art.step(art.init_state(), torch.zeros(art.hop_shape, device=meta["device"]))
        if tuple(out.shape) != (args.batch, hop_length):
            raise RuntimeError(f"reload check: a hop came back {tuple(out.shape)}")
    else:
        length = int(args.seconds * sr)
        icfg = InferencerConfig(type=config.get("inferencer", {}).get("type", "auto"), sr=sr,
                                stft=StftConfig(n_fft=n_fft, hop_length=hop_length))
        program = export_offline(model, icfg, args.batch, length, device)
        meta.update(length=length, strategy=icfg.type, device=str(next(model.parameters()).device))
        artifact_lib.save_offline(args.output, program, meta)
        log(f"exported {os.path.getsize(args.output) / 1e6:.2f} MB program for input [{args.batch}, {length}] "
            f"({icfg.type}, {meta['device']}) -> {args.output}")
        art = artifact_lib.load(args.output, device)
        out = art.enhance(torch.zeros(art.input_shape, device=meta["device"]))
        if tuple(out.shape) != (args.batch, length):
            raise RuntimeError(f"reload check: the output came back {tuple(out.shape)}")
    log("reload check OK")
    return art


if __name__ == "__main__":
    main()
