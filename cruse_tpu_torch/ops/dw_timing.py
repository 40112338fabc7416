"""Time the depthwise stencil's kernels (``csrc/dw_stencil.cu``: the forward
``dw_fwd_kernel``, the backward ``dw_bwd_kernel`` + ``dw_finish_kernel``) on
one CUDA card at config 5b's four TFCM stage shapes (B=16 x 10 s:
[16,64,24,626], [16,32,32,626], [16,16,48,626], [16,128,4,626]) and d = 1,
2, 4, 8.

    python3 -m cruse_tpu_torch.ops.dw_timing [--out rows.json] [--sweep] [--source FILE.cu ...]

For each case and direction it prints the wrapper's time (CUDA events around
back-to-back calls), the kernels' device time alone and the device launches
a call (a torch.profiler trace of a few calls between marker kernels,
``tfcm_bwd_timing.profiled``), the least bytes (each input read once, each
output written once) and the bound they give at 3.35 TB/s with its share,
the cuDNN call that computes the same function on the same inputs
(``conv2d(groups=C)`` in NCHW, ``aten.convolution_backward`` for dx and
dwd; timed here, checked to agree with the kernels, used nowhere in the
port), the tile (``dw_plan``) and what the card reports of the instance
(registers, spills, blocks an SM). Then a config-5b train step's 24 forward
calls (6 stacks at stages 0, 0, 1, 1, 2, 3 x d = 1, 2, 4, 8) summed against
their summed bound, and the same for the backward's 24 calls on the
``"pallas"`` TFCM route.

``--sweep`` times instead both kernels over a grid of tiles (band groups x
spans) at each stage and d = 1, 8, with CUDA events behind a spin kernel
(``queued_ms``: the device's time alone, whatever the host's).

``--source FILE.cu`` (repeatable) builds each file as the port builds its
kernels (``tattn_timing.build_source``) and times its ``dw_stencil_fwd_f32``
and ``dw_stencil_bwd_f32`` beside this checkout's kernels at every case, by
``queued_ms`` in turns (this checkout's, the files', then back): the first
port's ``dw_stencil.cu`` (one block a row; its C entries take no tile) or
an edited copy.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from cruse_tpu_torch.ops.dw_kernel import (
    dw_bwd_buffers, dw_kernel_info, dw_plan, dw_stencil_bwd, dw_stencil_fwd, launch_dw_bwd, launch_dw_fwd)
from cruse_tpu_torch.ops.tattn_timing import build_source
from cruse_tpu_torch.ops.tfcm_bwd_timing import DILATIONS, STAGES, bound, card, events_ms, profiled

STACK_STAGES = (0, 0, 1, 1, 2, 3)  # the TFCM stage of each of a config-5b step's six stacks
KERNEL_NAME = re.compile(r"\bdw_\w*kernel\b")
KINDS = ("forward", "backward")
SPIN_CYCLES = 2_000_000  # torch.cuda._sleep ahead of queued calls: ~1 ms, longer than the host takes to queue them


def dw_inputs(shape, d: int, device, seed: int = 0):
    """Seeded x_ext [B, K, C, T + 2d], g [B, K, C, T] and wd [3, 3, C]."""
    b, k, c, t = shape
    gen = torch.Generator(device).manual_seed(seed)
    return (torch.randn((b, k, c, t + 2 * d), generator=gen, device=device),
            torch.randn((b, k, c, t), generator=gen, device=device),
            torch.randn((3, 3, c), generator=gen, device=device) / 3)


def dw_bound(shape, d: int, kind: str) -> dict:
    """Least bytes (forward: x_ext read, y written; backward: g and x_ext
    read, dx written, the 9 C sums negligible), multiply-adds (9 a point of y,
    18 backward) and the least time they give."""
    b, k, c, t = shape
    rows = b * k * c
    frames = t + (t + 2 * d) * (1 if kind == "forward" else 2)
    nbytes, fmas = 4 * rows * frames, (9 if kind == "forward" else 18) * rows * t
    return {"bytes": nbytes, "fmas": fmas, **bound(nbytes, fmas)}


def vector_floats(*tensors_and_strides) -> int:
    """The copy width (floats) the C entry picks: the widest of 4, 2 that
    every pointer's alignment and every row stride allow, else 1."""
    for v in (4, 2):
        if all(x.data_ptr() % (4 * v) == 0 and s % v == 0 for x, s in tensors_and_strides):
            return v
    return 1


def library_calls(x_ext, g, wd, d: int):
    """cuDNN's depthwise conv2d in NCHW and its backward (dx and dwd), on
    copies in that layout; checked against the kernels within 1e-4 x
    max(1, max|ours|)."""
    import torch.nn.functional as F

    c = wd.shape[-1]
    x = x_ext.permute(0, 2, 1, 3).contiguous()  # [B, C, K, T + 2d]
    w = wd.permute(2, 1, 0)[:, None].contiguous()  # [C, 1, band tap, time tap]
    gy = g.permute(0, 2, 1, 3).contiguous()
    conv = lambda: F.conv2d(x, w, None, 1, (1, 0), (1, d), c)  # noqa: E731
    conv_bwd = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        gy, x, w, None, (1, 1), (1, 0), (1, d), False, (0, 0), c, (True, True, False))
    dx, dwd = dw_stencil_bwd(g, x_ext, wd, d)
    gx, gw, _ = conv_bwd()
    for what, ours, theirs in (("forward", dw_stencil_fwd(x_ext, wd, d), conv().permute(0, 2, 1, 3)),
                               ("dx", dx, gx.permute(0, 2, 1, 3)), ("dwd", dwd, gw[:, 0].permute(2, 1, 0))):
        err = float((ours - theirs).abs().max())
        if not err <= 1e-4 * max(1.0, float(ours.abs().max())):
            raise RuntimeError(f"cuDNN's depthwise convolution differs from the stencil's {what} by {err:.3g}")
    return conv, conv_bwd


def queued_ms(fn, reps: int) -> float:
    """Device ms a call of fn over reps calls queued behind a spin kernel, so
    the card runs them back to back whatever the host's time a call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_dw(device, shapes=STAGES, dilations=DILATIONS, reps: int = 20, calls: int = 10) -> list:
    """One row a case and direction: shape, d, kind, wrapper ms, kernels-alone
    ms, device launches a call, the bound, cuDNN's ms, the tile and what the
    card reports of the instance."""
    rows = []
    for shape in shapes:
        b, k, c, t = shape
        for d in dilations:
            x_ext, g, wd = dw_inputs(shape, d, device)
            with torch.inference_mode():
                library = library_calls(x_ext, g, wd, d)
                fns = (lambda: dw_stencil_fwd(x_ext, wd, d), lambda: dw_stencil_bwd(g, x_ext, wd, d))
                for kind, fn, lib in zip(KINDS, fns, library):
                    backward = kind == "backward"
                    wrapper = events_ms(fn, reps)
                    kernel, launches, parts = profiled(fn, calls, name=KERNEL_NAME)
                    lib_ms = events_ms(lib, max(3, reps // 4))
                    plan = dw_plan(b, k, c, t, d, backward)
                    vec = vector_floats((x_ext, t + 2 * d), *([(g, t)] if backward else []))
                    rows.append({"kind": kind, "shape": list(shape), "d": d, "wrapper_ms": wrapper,
                                 "kernel_ms": kernel, "kernels": parts, "launches_per_call": launches,
                                 **dw_bound(shape, d, kind), "library_ms": lib_ms, "kb": plan.kb, "tt": plan.tt,
                                 "blocks": plan.tiles * c, "smem_bytes": plan.smem, "vec": vec,
                                 "info": dw_kernel_info(backward, vec, plan.smem)})
            del x_ext, g, library
    return rows


def step_sums(rows: list, kind: str = "forward") -> dict:
    """A config-5b train step's 24 calls of `kind` (the backward's on the
    ``"pallas"`` TFCM route): the rows' kernel, wrapper and bound ms summed
    over its six stacks' stages and the four dilations."""
    mine = [r for stage in STACK_STAGES for r in rows if r["kind"] == kind and r["shape"] == list(STAGES[stage])]
    return {key: sum(r[key] for r in mine) for key in ("kernel_ms", "wrapper_ms", "bound_ms")}


def describe_step(rows: list, kind: str) -> str:
    step = step_sums(rows, kind)
    return (f"dw_stencil {kind}, a config-5b train step's {len(STACK_STAGES) * len(DILATIONS)} calls (stages "
            f"{STACK_STAGES} x d = {DILATIONS}): kernels alone {step['kernel_ms']:.3f} ms, wrappers "
            f"{step['wrapper_ms']:.3f} ms, summed bound {step['bound_ms']:.3f} ms (bytes)")


def sweep(device, shapes=STAGES, dilations=(1, 8), bands=(32, 16, 8, 4, 2), spans=(None, 320),
          reps: int = 20) -> list:
    """Both kernels at each shape and d over the tiles bands x spans (None:
    the plan's), by ``queued_ms``; one row each."""
    rows = []
    for shape in shapes:
        b, k, c, t = shape
        for d in dilations:
            x_ext, g, wd = dw_inputs(shape, d, device)
            y = torch.empty((b, k, c, t), device=device)
            for backward in (False, True):
                chosen = dw_plan(b, k, c, t, d, backward)
                for kb in sorted({min(g_, k) for g_ in bands}, reverse=True):
                    for tt in spans:
                        plan = dw_plan(b, k, c, t, d, backward, kb, tt)
                        if backward:
                            buffers = dw_bwd_buffers(x_ext, plan)
                            fn = lambda: launch_dw_bwd(g, x_ext, wd, d, plan, *buffers)  # noqa: E731
                        else:
                            fn = lambda: launch_dw_fwd(x_ext, wd, d, plan, y)  # noqa: E731
                        with torch.inference_mode():
                            ms = queued_ms(fn, reps)
                        rows.append({"kind": KINDS[backward], "shape": list(shape), "d": d, "kb": plan.kb,
                                     "tt": plan.tt, "blocks": plan.tiles * c, "ms": ms,
                                     "bound_ms": dw_bound(shape, d, KINDS[backward])["bound_ms"],
                                     "planned": plan == chosen})
            del x_ext, g, y
    return rows


def source_entries(library: Path) -> tuple:
    """(forward, backward, takes a tile) C entries of a built source: this
    port's entries take the tile (kb, tt) and the backward its sums' buffers;
    the first port's take neither (one block a row, a [B K C, 9] part)."""
    lib = ctypes.CDLL(str(library))
    fwd, bwd = lib.dw_stencil_fwd_f32, lib.dw_stencil_bwd_f32
    tiled = hasattr(lib, "dw_stencil_info")
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (7 if tiled else 5) + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * (6 if tiled else 5) + [ctypes.c_int] * (7 if tiled else 5) + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd, tiled


def time_sources(device, sources: list, shapes=STAGES, dilations=DILATIONS, reps: int = 20) -> list:
    """This checkout's kernels (at the plan's tiles, into preallocated
    buffers) and each source's C entries at every case, by ``queued_ms`` in
    turns (this checkout's, the sources', the sources reversed, this
    checkout's): one row a case and direction, ``{"ms": {name: [ms, ms]}}``."""
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libraries = list(pool.map(build_source, map(Path, sources)))
    by_source = [(str(path), source_entries(library)) for path, library in zip(sources, libraries)]
    rows = []
    for shape in shapes:
        b, k, c, t = shape
        for d in dilations:
            x_ext, g, wd = dw_inputs(shape, d, device)
            y = torch.empty((b, k, c, t), device=device)
            pf, pb = dw_plan(b, k, c, t, d), dw_plan(b, k, c, t, d, True)
            dx, part, dwd = dw_bwd_buffers(x_ext, pb)
            row_part = torch.empty((b * k * c, 9), device=device)  # the first port's sums, a row each
            stream = torch.cuda.current_stream(device).cuda_stream

            def launcher(entry, tiled, backward):
                if backward:
                    args = ((g, x_ext, wd, dx, part, dwd) if tiled else (g, x_ext, wd, dx, row_part))
                    ints = (b, k, c, t, d, pb.kb, pb.tt) if tiled else (b, k, c, t, d)
                else:
                    args, ints = (x_ext, wd, y), ((b, k, c, t, d, pf.kb, pf.tt) if tiled else (b, k, c, t, d))

                def launch():
                    err = entry(*[a.data_ptr() for a in args], *ints, stream)
                    if err != 0:
                        raise RuntimeError(f"a dw_stencil entry failed with CUDA error {err}")
                return launch

            for backward, kind in enumerate(KINDS):
                mine = (lambda: launch_dw_bwd(g, x_ext, wd, d, pb, dx, part, dwd)) if backward else (
                    lambda: launch_dw_fwd(x_ext, wd, d, pf, y))
                turns = [("this checkout", mine)]
                turns += [(name, launcher(entries[backward], entries[2], backward)) for name, entries in by_source]
                ms: dict = {}
                with torch.inference_mode():
                    for name, fn in turns + turns[::-1]:
                        ms.setdefault(name, []).append(queued_ms(fn, reps))
                rows.append({"kind": kind, "shape": list(shape), "d": d, "ms": ms,
                             "bound_ms": dw_bound(shape, d, kind)["bound_ms"]})
            del x_ext, g, y, dx, part, dwd, row_part
    return rows


def describe(row: dict) -> str:
    info = row["info"]
    parts = ", ".join(f"{name} {ms:.4f}" for name, ms in sorted(row["kernels"].items()))
    return (f"dw_stencil {row['kind']} {row['shape']} d={row['d']}: kernels alone {row['kernel_ms']:.4f} ms "
            f"({parts}), wrapper {row['wrapper_ms']:.4f} ms, {row['launches_per_call']:.1f} device launches a "
            f"call; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bytes'] / 1e6:.1f} MB) = "
            f"{row['bound_ms'] / row['kernel_ms']:.1%} of the kernels' time; cuDNN {row['library_ms']:.4f} ms; "
            f"tile {row['kb']} bands x {row['tt']} frames, {row['blocks']} blocks, {row['smem_bytes']} B of "
            f"shared memory, {4 * row['vec']}-byte copies, {info['registers']} registers, {info['spill_bytes']} B "
            f"spilled, {info['blocks_per_sm']} blocks of {info['threads']} threads an SM")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--sweep", action="store_true", help="time both kernels over a grid of tiles instead")
    parser.add_argument("--source", action="append", default=[],
                        help="also time this CUDA source's dw_stencil entries, in turns with this checkout's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dw_timing: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    device = torch.device("cuda:0")
    if args.sweep:
        rows = sweep(device)
        for row in rows:
            print(f"dw_stencil {row['kind']} {row['shape']} d={row['d']}, tile {row['kb']} bands x {row['tt']} "
                  f"frames ({row['blocks']} blocks): {row['ms']:.4f} ms = {row['bound_ms'] / row['ms']:.1%} of "
                  f"the bound{' (dw_plan)' if row['planned'] else ''} on {smi}", flush=True)
    elif args.source:
        rows = time_sources(device, args.source)
        for row in rows:
            times = "; ".join(f"{name} {', '.join(f'{ms:.4f}' for ms in turns)}" for name, turns in row["ms"].items())
            print(f"dw_stencil {row['kind']} {row['shape']} d={row['d']} (bound {row['bound_ms']:.4f} ms), ms in "
                  f"turns: {times} on {smi}", flush=True)
        for kind in KINDS:
            turns = [r for r in rows if r["kind"] == kind]
            sums = {name: sum(min(r["ms"][name]) for stage in STACK_STAGES for r in turns
                              if r["shape"] == list(STAGES[stage])) for name in turns[0]["ms"]}
            print(f"dw_stencil {kind}, a config-5b train step's {len(STACK_STAGES) * len(DILATIONS)} calls, the "
                  f"faster turn of each case summed: " + "; ".join(f"{n} {ms:.3f} ms" for n, ms in sums.items())
                  + f" on {smi}", flush=True)
    else:
        rows = time_dw(device)
        for row in rows:
            print(f"{describe(row)} on {smi}", flush=True)
        for kind in KINDS:
            print(f"{describe_step(rows, kind)} on {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
