"""Time the GRU backward's kernels (``csrc/gru_bwd.cu``: the resident
``gru_bwd_resident_kernel`` and the streamed ``gru_bwd_kernel``) on one CUDA
card.

    python3 -m cruse_tpu_torch.ops.gru_bwd_timing [--out rows.json] [--sweep]

Shapes: config 2's two GRU banks at its published batch (B=128 x 10 s: T=1001,
G=4, H=176) and the CRUSE+DF step's B=32. For each shape it prints both
kernels' times by CUDA events in turns (resident, streamed, streamed,
resident; ``dh_last`` None, as in the step), in ms a launch and us a step, the
resident plan (``resident_bwd_plan``: cluster size, units a block, rows a
cluster, shared memory) and the bound: the least bytes (x_proj, hp, y, dy, h0
and w_hh read once, dx_proj, dhp and dh0 written once) at 3.35 TB/s, or the
multiply-adds of w_hh^T . dhp at 33.5 T a second, whichever is larger.

``--sweep`` times instead the resident kernel at every fit it takes at each
shape (each cluster size from the smallest that holds the slice up to 8, with
``BWD_TILE_ROWS`` = 8 rows a cluster, and with 16 from a copy of
``csrc/gru_bwd.cu`` built with ``kBwdRows`` = 16), each checked against the
plain walk first, in turns (the fits in order, then in reverse), with the
streamed kernel beside them.

``--breakdown`` times the resident kernel at config 2 as it is and with one
part cut out of or changed in a copy of ``csrc/gru_bwd.cu`` (``CUTS``: the
product, the gates, the global loads, the L2 prefetch, the global stores,
the unroll of the j loop; or a cluster barrier a step put back), in two
turns. A cut copy computes wrong values: only its time is read, and the
difference to the whole kernel is what the part costs. The copies are built
under ``build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.gru_kernel import (
    BWD_TILE_ROWS, CLUSTER_SIZES, bwd_fit_at, gru_backward_walk_reference, gru_sequence_reference,
    launch_gru_bwd_resident, launch_gru_bwd_streamed, packed_weight_bwd, resident_bwd_plan)
from cruse_tpu_torch.ops.tfcm_bwd_timing import bound, card, events_ms

SHAPES = {"config 2": (128, 1001, 4, 176), "CRUSE+DF": (32, 1001, 4, 176)}  # B, T, G, H
REPS = 3
CHECK_TOL = 1e-4  # x max|walk| of each output, as chip_smoke.py's GRU_BWD_TOL

_GATES = """      const float rg = sigmoid(xv[0][i] + hv[0][i]);
      const float zg = sigmoid(xv[1][i] + hv[1][i]);
      const float ng = tanhf(xv[2][i] + rg * hv[2][i]);
      fn[i] = (1.f - zg) * (1.f - ng * ng);
      fz[i] = (pv[i] - ng) * zg * (1.f - zg);
      fr[i] = hv[2][i] * rg * (1.f - rg);"""
_J = "      for (int j = part; j < H3; j += kParts) {"
_UNROLL = "#pragma unroll 4  // measured at config 2: 1 is 14 % slower, 2 is 7 % slower\n"
_STORE = "        if (b < B) {\n          const size_t at = ((static_cast<size_t>(b) * T + t) * G + g) * H3 + k;"
_SENT = "    // the one after.\n"  # the last line of the comment between the sends and the stores
_WAIT = "    barrier_wait(full + 8 * s, ((T - 1 - t) >> 1) & 1);\n"
# name: (old, new) pairs applied to the source; every old text must occur exactly once
CUTS = {
    "whole kernel": (),
    "no product": ((_J, "      for (int j = part; j < (T < 0 ? H3 : 0); j += kParts) {"),),
    "no gates' sigmoid and tanh": ((_GATES, "      const float rg = 0.5f, zg = 0.5f;\n      fn[i] = 0.01f * xv[2][i]; "
                                   "fz[i] = 0.01f * (xv[1][i] + pv[i]); fr[i] = 0.01f * (hv[2][i] + xv[0][i] + hv[0][i] "
                                   "+ hv[1][i]);"),),
    "no loads after the first step": (("      if (t > 0) load_step(t - 1);", "      if (t > T) load_step(t - 1);"),),
    "no L2 prefetch": (("      if (t > 1) prefetch_step(t - 2);", "      if (t > T) prefetch_step(t - 2);"),),
    "dx_proj and dhp stored at t = 0 only": ((_STORE, _STORE.replace("if (b < B) {", "if (b < B && t == 0) {")),),
    "a relaxed cluster barrier a step put back": (
        (_SENT, _SENT + '    if constexpr (CS > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");\n'),
        (_WAIT, "    if constexpr (CS > 1) cluster_wait();\n" + _WAIT)),
    "a cluster barrier with release a step put back": (
        (_SENT, _SENT + "    if constexpr (CS > 1) cluster_arrive();\n"),
        (_WAIT, "    if constexpr (CS > 1) cluster_wait();\n" + _WAIT)),
    "gate factors taken at step 0 only": (("    if (active && t > 0) gate_factors();", "    if (active && t < 0) gate_factors();"),),
    "j loop unrolled by 2": ((_UNROLL + _J, "#pragma unroll 2\n" + _J),),
    "j loop unrolled by 8": ((_UNROLL + _J, "#pragma unroll 8\n" + _J),),
}
# the copy of the source that --sweep builds for R = 16 rows a cluster
ROWS_16 = (("constexpr int kBwdRows = 8;", "constexpr int kBwdRows = 16;"),)


def bwd_inputs(b, t, g, h, device, seed: int = 0):
    """Seeded (x_proj, h0, w_hh, b_hh, y, dy, hp): weights in the layers' own
    init range, y from the plain recurrence, hp = h_prev . w_hh^T + b_hh."""
    gen = torch.Generator(device).manual_seed(seed)
    scale = h ** -0.5
    with torch.inference_mode():
        x = torch.randn((b, t, g, 3 * h), generator=gen, device=device)
        h0 = torch.randn((b, g, h), generator=gen, device=device) * 0.5
        w = (torch.rand((g, 3 * h, h), generator=gen, device=device) * 2 - 1) * scale
        bias = (torch.rand((g, 3 * h), generator=gen, device=device) * 2 - 1) * scale
        y, _ = gru_sequence_reference(x, h0, w, bias)
        dy = torch.randn(y.shape, generator=gen, device=device)
        hp = (torch.einsum("btgh,gkh->btgk", torch.cat([h0[:, None], y[:, :-1]], dim=1), w) + bias).contiguous()
    return x, h0, w, bias, y, dy, hp


def bwd_bound(b, t, g, h) -> dict:
    """The bound of one backward launch (see the module doc)."""
    return bound(4 * (b * t * g * 14 * h + 2 * b * g * h + g * 3 * h * h), b * t * g * 3 * h * h)


def _outputs(x, h0):
    return torch.empty_like(x), torch.empty_like(x), torch.empty_like(h0)


def time_kernels(shape, device, seed: int = 0) -> dict:
    """Both kernels at one shape, in turns (resident, streamed, streamed,
    resident): ms a launch of each turn, the plan and the bound."""
    b, t, g, h = shape
    x, h0, w, _, y, dy, hp = bwd_inputs(*shape, device, seed)
    outs = _outputs(x, h0)
    with torch.inference_mode():
        resident = lambda: launch_gru_bwd_resident(x, hp, y, h0, dy, None, w, *outs)  # noqa: E731
        streamed = lambda: launch_gru_bwd_streamed(x, hp, y, h0, dy, None, w, *outs)  # noqa: E731
        turns = [events_ms(fn, REPS) for fn in (resident, streamed, streamed, resident)]
    cs, u, rows, nbytes = resident_bwd_plan(*shape)
    return {"shape": shape, "resident_ms": [turns[0], turns[3]], "streamed_ms": [turns[1], turns[2]],
            "cs": cs, "u": u, "rows": rows, "shared_bytes": nbytes, **bwd_bound(*shape)}


def describe(name, row) -> str:
    b, t, g, h = row["shape"]
    res, stm = row["resident_ms"], row["streamed_ms"]
    return (f"gru backward {name} B={b} T={t} G={g} H={h} f32: resident {res[0]:.4f}, {res[1]:.4f} ms "
            f"({sum(res) / 2 / t * 1e3:.3f} us a step; CS={row['cs']}, U={row['u']}, R={row['rows']}, "
            f"{row['shared_bytes']} B of shared memory a block); streamed {stm[0]:.4f}, {stm[1]:.4f} ms "
            f"({sum(stm) / 2 / t * 1e3:.3f} us a step); bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"resident at {row['bound_ms'] / (sum(res) / 2):.1%} of it")


def fits(h):
    """Every (CS, U, R, bytes) the resident kernel takes at hidden size h, at
    R = 8 (the library) and 16 (a copy of the source)."""
    return [fit for rows in (BWD_TILE_ROWS, 16) for cs in CLUSTER_SIZES if (fit := bwd_fit_at(h, cs, rows))]


def _entry(lib: ctypes.CDLL):
    fn = lib.gru_bwd_resident_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_copy(fn, what, shape, cs, x, hp, y, h0, dy, packed, outs, stream) -> None:
    """A resident entry of a built copy of the source, dh_last None."""
    err = fn(*(a.data_ptr() for a in (x, hp, y, h0, dy)), None, packed.data_ptr(),
             *(o.data_ptr() for o in outs), *shape, cs, stream)
    if err:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err}")


def sweep(device, seed: int = 0) -> list:
    """The resident kernel at every fit, and the streamed kernel, at each shape:
    each checked against the walk, then timed in turns."""
    rows16 = _entry(build_copy("rows_16", ROWS_16))
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = []
    for name, shape in SHAPES.items():
        b, t, g, h = shape
        x, h0, w, bias, y, dy, hp = bwd_inputs(*shape, device, seed)
        outs = _outputs(x, h0)
        with torch.inference_mode():
            want = gru_backward_walk_reference(dy, None, x, h0, w, bias, y)
            runs = {}
            for cs, _, r, _ in fits(h):
                if r == BWD_TILE_ROWS:
                    runs[cs, r] = lambda cs=cs: launch_gru_bwd_resident(x, hp, y, h0, dy, None, w, *outs, cs=cs)
                else:
                    runs[cs, r] = lambda cs=cs, packed=packed_weight_bwd(w, cs): _launch_copy(
                        rows16, f"{name} R=16 CS={cs}", shape, cs, x, hp, y, h0, dy, packed, outs, stream)
            runs[None] = lambda: launch_gru_bwd_streamed(x, hp, y, h0, dy, None, w, *outs)
            for label, fn in runs.items():
                for out in outs:
                    out.fill_(float("nan"))
                fn()
                for out_name, got, ref in zip(("dx_proj", "dhp", "dh0"), outs, want):
                    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
                    if not (torch.isfinite(got).all() and err <= CHECK_TOL * scale):
                        raise RuntimeError(f"{name} {label or 'streamed'}: {out_name} max-abs {err:.3g} > {CHECK_TOL} x {scale:.3g}")
            order = list(runs) + list(reversed(runs))
            times = {label: [] for label in runs}
            for label in order:
                times[label].append(events_ms(runs[label], REPS))
        planned = resident_bwd_plan(*shape)
        for fit, ms in times.items():
            cs, r = fit or (None, None)
            nbytes = None if fit is None else bwd_fit_at(h, cs, r)[3]
            rows.append({"shape": name, "fit": "streamed" if fit is None else f"CS={cs}, R={r}", "ms": ms,
                         "us_a_step": sum(ms) / len(ms) / t * 1e3, "shared_bytes": nbytes,
                         "planned": fit == (planned[0], planned[2]), **bwd_bound(*shape)})
        del x, h0, w, bias, y, dy, hp, outs, want
        torch.cuda.empty_cache()
    return rows


def build_copy(name: str, edits) -> ctypes.CDLL:
    """A copy of gru_bwd.cu with the (old, new) edits applied, as a library."""
    source = (_build.SRC_DIR / "gru_bwd.cu").read_text()
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"copy {name!r}: the source no longer holds exactly one {old[:50]!r}...")
        source = source.replace(old, new)
    out = _build.BUILD_DIR / "gru_bwd_copies"
    out.mkdir(parents=True, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    (out / f"{stem}.cu").write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-o", str(out / f"lib{stem}.so"), str(out / f"{stem}.cu")],
                   check=True)
    return ctypes.CDLL(str(out / f"lib{stem}.so"))


def breakdown(device, seed: int = 0) -> list:
    """The resident kernel at config 2 with each of CUTS, two turns."""
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(build_copy, CUTS, CUTS.values())))
    shape = SHAPES["config 2"]
    b, t, g, h = shape
    x, h0, w, _, y, dy, hp = bwd_inputs(*shape, device, seed)
    cs = resident_bwd_plan(*shape)[0]
    packed = packed_weight_bwd(w, cs)
    outs = _outputs(x, h0)
    stream = torch.cuda.current_stream(device).cuda_stream
    entries = {name: _entry(lib) for name, lib in libs.items()}
    times = {name: [] for name in CUTS}
    for _ in range(2):
        for name, fn in entries.items():
            times[name].append(events_ms(lambda: _launch_copy(fn, name, shape, cs, x, hp, y, h0, dy, packed, outs,
                                                              stream), REPS))
    return [{"cut": name, "ms": ms, "us_a_step": sum(ms) / len(ms) / t * 1e3} for name, ms in times.items()]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--sweep", action="store_true", help="time the resident kernel at every fit instead")
    parser.add_argument("--breakdown", action="store_true", help="time the resident kernel with parts cut out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gru_bwd_timing: no CUDA device")
    smi = card()
    device = torch.device("cuda:0")
    if args.breakdown:
        rows = breakdown(device)
        for row in rows:
            print(f"gru_bwd_resident_kernel config 2, {row['cut']}: {', '.join(f'{ms:.4f}' for ms in row['ms'])} ms "
                  f"({row['us_a_step']:.3f} us a step) on {smi}", flush=True)
    elif args.sweep:
        rows = sweep(device)
        for row in rows:
            print(f"gru backward {row['shape']} {row['fit']}{' (resident_bwd_plan)' if row['planned'] else ''}: "
                  f"{', '.join(f'{ms:.4f}' for ms in row['ms'])} ms ({row['us_a_step']:.3f} us a step), "
                  f"{row['shared_bytes']} B a block, bound {row['bound_ms']:.4f} ms on {smi}", flush=True)
    else:
        rows = []
        for name, shape in SHAPES.items():
            row = time_kernels(shape, device)
            rows.append({"name": name, **row})
            print(f"{describe(name, row)} on {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
