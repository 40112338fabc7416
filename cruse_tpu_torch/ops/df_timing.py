"""Time the deep filter's kernels (``csrc/deep_filter.cu``: the forward
``deep_filter_kernel``, the backward ``deep_filter_bwd_kernel``) on one CUDA
card.

    python3 -m cruse_tpu_torch.ops.df_timing [--out rows.json] [--sweep] [--source FILE.cu ...]

Shapes: config 5b (B=16 x 10 s: T=626, all F=257 bins, K=9), config 3
(B=256 x 10 s: T=1001, the low F=96 of 161 bins, K=15), config 3's
streaming hop (B=256, T=1, with 4 frames of history; forward only) and
config 5b's (B=1, T=1, all 257 bins, with 2 frames of history; forward
only). For each
shape and direction it prints the wrapper's time (CUDA events around
back-to-back calls), the kernel's device time alone and the device launches
a call (a torch.profiler trace of a few calls between marker kernels,
``tfcm_bwd_timing.profiled``), the least bytes (each input read once, each
output written once), the bound they give at 3.35 TB/s with its share, the
plain version's time, the plan (``df_plan``) and what the card reports of
the instance (registers, spills, blocks an SM). At config 5b it also times
the plain forward with ``autograd.grad`` through it: what a training step
pays for the deep filter without the kernels.

``--sweep`` times instead both kernels at config 5b and config 3 over a grid
of plans (spans x bins, ``df_plan``'s choice marked), each checked against
the plain version first, by CUDA events behind a spin kernel
(``dw_timing.queued_ms``: the device's time alone, whatever the host's).

``--source FILE.cu`` (repeatable) builds each file as the port builds its
kernels (``tattn_timing.build_source``) and times its ``deep_filter_f32``
beside this checkout's forward at every shape, by ``queued_ms`` in turns
(this checkout's, the files', then back): the first port's
``deep_filter.cu`` (a block a tile of frames loaded whole; its C entry takes
no plan) or an edited copy.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from cruse_tpu_torch.ops.deep_filter_kernel import (
    deep_filter, deep_filter_backward_reference, deep_filter_bwd, deep_filter_reference, df_kernel_info, df_plan,
    df_vector_floats, launch_df_bwd, launch_df_fwd)
from cruse_tpu_torch.ops.dw_timing import queued_ms
from cruse_tpu_torch.ops.tattn_timing import build_source
from cruse_tpu_torch.ops.tfcm_bwd_timing import bound, card, events_ms, profiled

# B, T, F, t_dim, f_dim, causal, spectrum bins (>= F: the low bins of a wider one), history
CONFIG5B = (16, 626, 257, 1, 1, True, 257, False)
CONFIG3 = (256, 1001, 96, 2, 1, True, 161, False)
HOP = (256, 1, 96, 2, 1, True, 161, True)
HOP_5B = (1, 1, 257, 1, 1, True, 257, True)
SHAPES = {"5b": CONFIG5B, "config 3": CONFIG3, "config-3 hop": HOP, "5b hop": HOP_5B}
KERNEL_NAME = re.compile(r"\bdeep_filter\w*_kernel\b")
KINDS = ("forward", "backward")
SWEEP_SPANS = (1, 2, 4, 8, 13, 19, 32, 64, 128, None)  # None: all of T
SWEEP_BINS = {"5b": (257, 130, 66), "config 3": (96, 48, 32)}
CHECK_TOL = 1e-5


def df_inputs(b, t, f, t_dim, f_dim, causal, bins, history, device, seed: int = 0):
    """Seeded (spec, coefs, history, grad): the spectrum is the low f bins of a
    [B, T, bins] one (strided rows, as in config 3); the history, when asked
    for, a batch-strided view, as the stream carries it; grad, a gradient of
    the output."""
    gen = torch.Generator(device).manual_seed(seed)
    k = (2 * t_dim + 1) * (2 * f_dim + 1)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=device),
                             torch.randn(shape, generator=gen, device=device))

    spec = cplx(b, t, bins)[:, :, :f]
    coefs = torch.randn((b, t, f, k, 2), generator=gen, device=device) * 0.2
    hist = cplx(b, 2 * t_dim + 1, f)[:, 1:] if history else None
    return spec, coefs, hist, cplx(b, t, f)


def df_bound(b, t, f, t_dim, f_dim, history=False, backward=False) -> dict:
    """Least bytes and multiply-adds of one call, and the least time they
    give. Forward: coefficients, spectrum (and history) read, output
    written once; 4 multiply-adds a tap and bin. Backward: the gradient,
    spectrum and coefficients read, dspec and dcoefs written once; 8."""
    k = (2 * t_dim + 1) * (2 * f_dim + 1)
    bins = b * t * f
    if backward:
        nbytes, fmas = bins * (16 * k + 24), bins * k * 8
    else:
        nbytes, fmas = bins * (8 * k + 16) + (b * 2 * t_dim * f * 8 if history else 0), bins * k * 4
    return {"bytes": nbytes, "fmas": fmas, **bound(nbytes, fmas)}


def plain_pair(spec, coefs, t_dim, f_dim, g):
    """The plain forward and ``autograd.grad`` through it: what a step pays
    for the deep filter without the kernels."""
    spec = spec.detach().requires_grad_()
    coefs = coefs.detach().requires_grad_()

    def run():
        out = deep_filter_reference(spec, coefs, t_dim, f_dim)
        return torch.autograd.grad(out, (spec, coefs), g)
    return run


def time_df(device, shapes=SHAPES, reps: int = 20, calls: int = 10) -> list:
    """One row a shape and direction (the backward where there is no
    history): wrapper ms, kernel-alone ms, device launches a call, the bound,
    the plain version's ms, the plan and its instance; at config 5b the plain
    forward + backward ms."""
    rows = []
    for name, shape in shapes.items():
        b, t, f, t_dim, f_dim, causal, _, history = shape
        spec, coefs, hist, g = df_inputs(*shape, device)
        cases = [("forward", lambda: deep_filter(spec, coefs, t_dim, f_dim, causal, hist),
                  lambda: deep_filter_reference(spec, coefs, t_dim, f_dim, causal, hist))]
        if not history:
            cases.append(("backward", lambda: deep_filter_bwd(g, spec, coefs, t_dim, f_dim, causal),
                          lambda: deep_filter_backward_reference(g, spec, coefs, t_dim, f_dim, causal)))
        for kind, fn, plain in cases:
            backward = kind == "backward"
            with torch.inference_mode():
                wrapper = events_ms(fn, reps)
                kernel, launches, _ = profiled(fn, calls, name=KERNEL_NAME)
                plain_ms = events_ms(plain, max(2, reps // 4))
            plan = df_plan(b, t, f, t_dim, f_dim, causal, history, backward)
            vec = df_vector_floats(coefs, coefs if backward else None)  # dcoefs: as aligned as coefs
            row = {"kind": kind, "shape": name, "b": b, "t": t, "f": f, "t_dim": t_dim, "f_dim": f_dim,
                   "wrapper_ms": wrapper, "kernel_ms": kernel, "launches_per_call": launches, "plain_ms": plain_ms,
                   **df_bound(b, t, f, t_dim, f_dim, history, backward), "span": plan.span, "bins": plan.bins,
                   "blocks": plan.blocks, "smem_bytes": plan.smem, "planned_blocks_per_sm": plan.blocks_per_sm,
                   "vec": vec, "info": df_kernel_info(backward, vec, plan.smem, plan.threads)}
            if name == "5b" and not backward:
                row["plain_pair_ms"] = events_ms(plain_pair(spec, coefs, t_dim, f_dim, g), 5)
            rows.append(row)
        del spec, coefs, hist, g
    return rows


def misaligned(x: torch.Tensor, shift: int) -> torch.Tensor:
    """The same values starting ``shift`` floats past an allocation's start."""
    if not shift:
        return x
    return torch.cat([x.new_zeros(shift), x.flatten()])[shift:].view(x.shape)


def sweep(device, shapes=("5b", "config 3"), spans=SWEEP_SPANS, shifts=(0, 2, 1), reps: int = 20) -> list:
    """Both kernels at each shape over the plans spans x bins (None: all of
    T), and at the chosen plan with the coefficients (and dcoefs) starting
    ``shifts`` floats past a 16-byte boundary (the copy width follows), each
    held against the plain version first, by ``queued_ms``; one row a plan,
    copy width and direction."""
    rows = []
    for name in shapes:
        b, t, f, t_dim, f_dim, causal, _, _ = SHAPES[name]
        spec, coefs0, _, g = df_inputs(*SHAPES[name], device)
        out = torch.empty((b, t, f), dtype=torch.complex64, device=device)
        with torch.inference_mode():
            wants = (deep_filter_reference(spec, coefs0, t_dim, f_dim, causal),
                     deep_filter_backward_reference(g, spec, coefs0, t_dim, f_dim, causal))
        for backward, kind in enumerate(KINDS):
            chosen = df_plan(b, t, f, t_dim, f_dim, causal, backward=bool(backward))
            grid = [(nb, span, 0) for nb in SWEEP_BINS[name]
                    for span in sorted({min(s or t, t) for s in spans} | {chosen.span})]
            grid += [(chosen.bins, chosen.span, shift) for shift in shifts if shift]
            for nb, span, shift in grid:
                coefs = misaligned(coefs0, shift)
                dspec, dcoefs = torch.empty_like(out), misaligned(torch.empty_like(coefs0), shift)
                plan = df_plan(b, t, f, t_dim, f_dim, causal, backward=bool(backward), span=span, bins=nb)
                if backward:
                    fn = lambda: launch_df_bwd(g, spec, coefs, t_dim, f_dim, causal, plan, dspec,  # noqa: E731
                                               dcoefs)
                else:
                    fn = lambda: launch_df_fwd(spec, coefs, t_dim, f_dim, causal, None, plan, out)  # noqa: E731
                with torch.inference_mode():
                    fn()
                    got = (dspec, dcoefs) if backward else (out,)
                    want = wants[1] if backward else (wants[0],)
                    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
                    if not err <= CHECK_TOL:
                        raise RuntimeError(f"deep_filter {kind} {name} at {plan} differs from the plain "
                                           f"version by {err:.3g}")
                    ms = queued_ms(fn, reps)
                rows.append({"kind": kind, "shape": name, "span": plan.span, "bins": plan.bins,
                             "blocks": plan.blocks, "blocks_per_sm": plan.blocks_per_sm,
                             "vec": df_vector_floats(coefs, dcoefs if backward else None), "ms": ms,
                             "bound_ms": df_bound(b, t, f, t_dim, f_dim, backward=bool(backward))["bound_ms"],
                             "planned": plan == chosen and not shift})
                del coefs, dspec, dcoefs
        del spec, coefs0, g, out, wants
    return rows


def source_entry(library: Path):
    """(forward entry, takes a plan) of a built source: this port's entry
    takes the plan (span, bins); the first port's does not."""
    lib = ctypes.CDLL(str(library))
    fwd, planned = lib.deep_filter_f32, hasattr(lib, "deep_filter_bwd_f32")
    pointer, stride = ctypes.c_void_p, ctypes.c_longlong
    fwd.argtypes = ([pointer, stride, stride, pointer, stride, pointer, pointer]
                    + [ctypes.c_int] * (8 if planned else 6) + [pointer])
    fwd.restype = ctypes.c_int
    return fwd, planned


def time_sources(device, sources: list, shapes=SHAPES, reps: int = 20) -> list:
    """This checkout's forward (at the plan, into a preallocated output) and
    each source's ``deep_filter_f32`` at every shape, by ``queued_ms`` in
    turns (this checkout's, the sources', the sources reversed, this
    checkout's): one row a shape, ``{"ms": {name: [ms, ms]}}``."""
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libraries = list(pool.map(build_source, map(Path, sources)))
    by_source = [(str(path), source_entry(library)) for path, library in zip(sources, libraries)]
    rows = []
    for name, shape in shapes.items():
        b, t, f, t_dim, f_dim, causal, _, history = shape
        spec, coefs, hist, _ = df_inputs(*shape, device)
        out = torch.empty((b, t, f), dtype=torch.complex64, device=device)
        plan = df_plan(b, t, f, t_dim, f_dim, causal, history)
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.inference_mode():
            want = deep_filter_reference(spec, coefs, t_dim, f_dim, causal, hist)

        def launcher(entry, planned):
            ints = (b, t, f, t_dim, f_dim, int(causal)) + ((plan.span, plan.bins) if planned else ())

            def launch():
                err = entry(spec.data_ptr(), spec.stride(0), spec.stride(1),
                            None if hist is None else hist.data_ptr(), 0 if hist is None else hist.stride(0),
                            coefs.data_ptr(), out.data_ptr(), *ints, stream)
                if err != 0:
                    raise RuntimeError(f"a deep_filter entry failed with CUDA error {err}")
            return launch

        turns = [("this checkout", lambda: launch_df_fwd(spec, coefs, t_dim, f_dim, causal, hist, plan, out))]
        turns += [(path, launcher(*entry)) for path, entry in by_source]
        ms: dict = {}
        with torch.inference_mode():
            for who, fn in turns:
                fn()
                err = float((out - want).abs().max())
                if not err <= CHECK_TOL:
                    raise RuntimeError(f"deep_filter forward of {who} at {name} differs from the plain version "
                                       f"by {err:.3g}")
            for who, fn in turns + turns[::-1]:
                ms.setdefault(who, []).append(queued_ms(fn, reps))
        rows.append({"shape": name, "ms": ms, "bound_ms": df_bound(b, t, f, t_dim, f_dim, history)["bound_ms"]})
        del spec, coefs, hist, out, want
    return rows


def describe(row: dict) -> str:
    info = row["info"]
    line = (f"deep_filter {row['kind']} {row['shape']} (B={row['b']}, T={row['t']}, F={row['f']}, "
            f"t={row['t_dim']}, f={row['f_dim']}): kernel alone {row['kernel_ms']:.4f} ms, wrapper "
            f"{row['wrapper_ms']:.4f} ms, {row['launches_per_call']:.1f} device launches a call; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bytes'] / 1e6:.1f} MB) = "
            f"{row['bound_ms'] / row['kernel_ms']:.1%} of the kernel's time; plain {row['plain_ms']:.3f} ms; "
            f"plan {row['span']} frames x {row['bins']} bins, {row['blocks']} blocks, {row['smem_bytes']} B of "
            f"shared memory, {4 * row['vec']}-byte copies, {info['registers']} registers, {info['spill_bytes']} B "
            f"spilled, {info['blocks_per_sm']} blocks of {info['threads']} threads an SM (planned "
            f"{row['planned_blocks_per_sm']})")
    if "plain_pair_ms" in row:
        line += f"; plain forward + autograd backward {row['plain_pair_ms']:.3f} ms"
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--sweep", action="store_true", help="time both kernels over a grid of plans instead")
    parser.add_argument("--source", action="append", default=[],
                        help="also time this CUDA source's deep_filter_f32, in turns with this checkout's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("df_timing: no CUDA device")
    smi = card()
    device = torch.device("cuda:0")
    if args.sweep:
        rows = sweep(device)
        for row in rows:
            print(f"deep_filter {row['kind']} {row['shape']}, plan {row['span']} frames x {row['bins']} bins "
                  f"({row['blocks']} blocks, {row['blocks_per_sm']} an SM), {4 * row['vec']}-byte copies: "
                  f"{row['ms']:.4f} ms = "
                  f"{row['bound_ms'] / row['ms']:.1%} of the bound{' (df_plan)' if row['planned'] else ''} "
                  f"on {smi}", flush=True)
    elif args.source:
        rows = time_sources(device, args.source)
        for row in rows:
            times = "; ".join(f"{who} {', '.join(f'{ms:.4f}' for ms in turns)}" for who, turns in row["ms"].items())
            print(f"deep_filter forward {row['shape']} (bound {row['bound_ms']:.4f} ms), ms in turns: {times} "
                  f"on {smi}", flush=True)
    else:
        rows = time_df(device)
        for row in rows:
            print(f"{describe(row)} on {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
