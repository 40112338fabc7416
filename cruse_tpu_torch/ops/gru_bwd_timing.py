"""Time the GRU backward's kernels (``csrc/gru_bwd.cu``: route A, the
resident ``gru_bwd_resident_kernel`` at clusters of up to 8 blocks and
``gru_bwd_scatter_kernel`` at 16; route B, the row-tiled
``gru_bwd_rows_kernel``) on one CUDA card.

    python3 -m cruse_tpu_torch.ops.gru_bwd_timing [--out rows.json] [--sweep | --breakdown | --source FILE.cu]

Shapes: config 2's two GRU banks at its published batch (B=128 x 10 s: T=1001,
G=4, H=176), the CRUSE+DF step's B=32, and FullSubNet's two GRUs in its train
step at B=8 x 3 s (T=188, G=1): the full band (B=8, H=512) and the sub band,
its 257 bins folded into the batch (B=2056, H=384). For each shape it prints
the planned kernel's time by CUDA events in turns with route B's (planned,
row-tiled, row-tiled, planned; both turns of route B alone where it is the
plan; ``dh_last`` None, as in the step), in ms a launch and us a step, the plan
(``resident_bwd_plan``: cluster size, units a block, rows a cluster, shared
memory; route B's R) and the bound: the least bytes (x_proj, hp, y, dy, h0 and
w_hh read once, dx_proj, dhp and dh0 written once) at 3.35 TB/s, or the
multiply-adds of w_hh^T . dhp at 33.5 T a second, whichever is larger.

``--sweep`` times instead every instance each shape takes: route A at every
cluster size that holds the weight (up to 8 with ``BWD_TILE_ROWS`` = 8 rows,
and with 16 from a copy of ``csrc/gru_bwd.cu`` built with ``kBwdRows`` = 16;
16 blocks, ``scatter_fit``) and route B at every R that fits, each checked
against the plain walk first, in turns (the instances in order, then in
reverse).

``--source FILE.cu`` builds another ``gru_bwd.cu`` (a parent's, unpacked with
``git archive`` into ``build/parent/``) and times its ``gru_bwd_f32`` (the
streamed ``gru_bwd_kernel`` that route B replaced) in turns with this
checkout's planned kernel at each shape (theirs, ours, ours, theirs), both
checked against the walk first.

``--breakdown`` times the resident kernel at config 2 as it is and with one
part cut out of or changed in a copy of ``csrc/gru_bwd.cu`` (``CUTS``: the
product, the gates, the global loads, the L2 prefetch, the global stores,
the unroll of the j loop; or a cluster barrier a step put back; the edits
apply to the source before its 16-block kernel), and route B at FullSubNet's
sub band the same way (``ROWS_CUTS``: the product, the gates, both, or
chunks of 16 j rows in place of 32), in two turns. A cut copy
computes wrong values: only its time is read, and the difference to the
whole kernel is what the part costs. The copies are built under ``build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.gru_kernel import (
    BWD_SCATTER_CS, BWD_TILE_ROWS, CLUSTER_SIZES, ROW_TILES, backward_plan, bwd_fit_at, bwd_row_tile, bwd_rows_fit,
    gru_backward_walk_reference, gru_sequence_reference, launch_gru_bwd_resident, launch_gru_bwd_streamed,
    packed_weight_bwd, padded_weight_bwd)
from cruse_tpu_torch.ops.tfcm_bwd_timing import bound, card, events_ms

SHAPES = {"config 2": (128, 1001, 4, 176), "CRUSE+DF": (32, 1001, 4, 176),  # B, T, G, H
          "FullSubNet full band": (8, 188, 1, 512), "FullSubNet sub band": (8 * 257, 188, 1, 384)}
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
# route B's parts, cut out of copies of the whole source (each old text occurs once in it)
_PRODUCT = "      if (live) {\n        const float* ws = ring + s * stage + k8;"
_ROW_GATES = "    if (live) {\n      // a row's inputs"
_NONE = "if (live && T < 0)"
ROWS_CUTS = {
    "whole kernel": (),
    "no product": ((_PRODUCT, _PRODUCT.replace("if (live)", _NONE)),),
    "no gates": ((_ROW_GATES, _ROW_GATES.replace("if (live)", _NONE)),),
    "the ring and barriers alone": ((_PRODUCT, _PRODUCT.replace("if (live)", _NONE)),
                                    (_ROW_GATES, _ROW_GATES.replace("if (live)", _NONE))),
    "chunks of 16 j rows": (("constexpr int kRowsChunk = 32;", "constexpr int kRowsChunk = 16;"),),
}


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


def _planned(shape, device):
    """(label, launcher(x, hp, y, h0, dy, w, outs), plan) of the kernel
    ``backward_plan`` picks at the shape: route A's fit, or route B's R."""
    b, t, g, h = shape
    plan = backward_plan(*shape, device)
    if plan is not None:
        return (f"resident CS={plan[0]}",
                lambda x, hp, y, h0, dy, w, outs: launch_gru_bwd_resident(x, hp, y, h0, dy, None, w, *outs), plan)
    rows = bwd_row_tile(b, g, h)
    return (f"row-tiled R={rows}",
            lambda x, hp, y, h0, dy, w, outs: launch_gru_bwd_streamed(x, hp, y, h0, dy, None, w, *outs), rows)


def time_kernels(shape, device, seed: int = 0) -> dict:
    """The planned kernel and route B at one shape, in turns (planned,
    row-tiled, row-tiled, planned): ms a launch of each turn, the plan and
    the bound. Where route B is the plan, ``resident_ms`` is None."""
    b, t, g, h = shape
    x, h0, w, _, y, dy, hp = bwd_inputs(*shape, device, seed)
    outs = _outputs(x, h0)
    label, planned, plan = _planned(shape, device)
    with torch.inference_mode():
        rows = lambda: launch_gru_bwd_streamed(x, hp, y, h0, dy, None, w, *outs)  # noqa: E731
        first = (lambda: planned(x, hp, y, h0, dy, w, outs)) if isinstance(plan, tuple) else rows
        turns = [events_ms(fn, REPS) for fn in (first, rows, rows, first)]
    row = {"shape": shape, "planned": label, "rows_ms": [turns[1], turns[2]], "rows": bwd_row_tile(b, g, h),
           "resident_ms": [turns[0], turns[3]] if isinstance(plan, tuple) else None, **bwd_bound(*shape)}
    if isinstance(plan, tuple):
        row.update(dict(zip(("cs", "u", "cluster_rows", "shared_bytes"), plan)))
    return row


def describe(name, row) -> str:
    b, t, g, h = row["shape"]
    stm = row["rows_ms"]
    rows = (f"row-tiled (R={row['rows']}) {stm[0]:.4f}, {stm[1]:.4f} ms ({sum(stm) / 2 / t * 1e3:.3f} us a step)")
    planned = sum(row["resident_ms"] or stm) / 2
    if row["resident_ms"] is None:
        text = f"{rows}, the plan"
    else:
        res = row["resident_ms"]
        text = (f"resident {res[0]:.4f}, {res[1]:.4f} ms ({sum(res) / 2 / t * 1e3:.3f} us a step; CS={row['cs']}, "
                f"U={row['u']}, R={row['cluster_rows']}, {row['shared_bytes']} B of shared memory a block), the plan; "
                f"{rows}")
    return (f"gru backward {name} B={b} T={t} G={g} H={h} f32: {text}; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), the plan at {row['bound_ms'] / planned:.1%} of it")


def fits(h):
    """Every (CS, U, R, bytes) route A takes at hidden size h: up to 8 blocks
    at R = 8 (the library) and 16 (a copy of the source), and 16 blocks."""
    return [fit for rows in (BWD_TILE_ROWS, 16) for cs in (*CLUSTER_SIZES, BWD_SCATTER_CS)
            if (fit := bwd_fit_at(h, cs, rows))]


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


def _check(what, outs, want) -> None:
    for out_name, got, ref in zip(("dx_proj", "dhp", "dh0"), outs, want):
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        if not (torch.isfinite(got).all() and err <= CHECK_TOL * scale):
            raise RuntimeError(f"{what}: {out_name} max-abs {err:.3g} > {CHECK_TOL} x {scale:.3g}")


def _turns(runs: dict, outs, want, what: str) -> dict:
    """Each run into NaN-filled outputs, checked against the walk, then timed
    in turns: the runs in order, then in reverse."""
    for label, fn in runs.items():
        for out in outs:
            out.fill_(float("nan"))
        fn()
        _check(f"{what} {label}", outs, want)
    times = {label: [] for label in runs}
    for label in list(runs) + list(reversed(runs)):
        times[label].append(events_ms(runs[label], REPS))
    return times


def sweep(device, seed: int = 0) -> list:
    """Every instance of both routes at each shape: each checked against the
    walk, then timed in turns."""
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
                    runs[f"CS={cs}, R={r}"] = lambda cs=cs: launch_gru_bwd_resident(x, hp, y, h0, dy, None, w, *outs,
                                                                                   cs=cs)
                else:
                    runs[f"CS={cs}, R={r}"] = lambda cs=cs, packed=packed_weight_bwd(w, cs): _launch_copy(
                        rows16, f"{name} R=16 CS={cs}", shape, cs, x, hp, y, h0, dy, packed, outs, stream)
            for r in ROW_TILES:
                if bwd_rows_fit(h, r):
                    runs[f"row-tiled R={r}"] = lambda r=r: launch_gru_bwd_streamed(x, hp, y, h0, dy, None, w, *outs,
                                                                                  rows=r)
            times = _turns(runs, outs, want, name)
        label = _planned(shape, device)[0]
        for fit, ms in times.items():
            rows.append({"shape": name, "fit": fit, "ms": ms, "us_a_step": sum(ms) / len(ms) / t * 1e3,
                         "planned": fit in (label, f"{label.removeprefix('resident ')}, R={BWD_TILE_ROWS}"),
                         **bwd_bound(*shape)})
        del x, h0, w, bias, y, dy, hp, outs, want
        torch.cuda.empty_cache()
    return rows


def against_source(path: str, device, seed: int = 0) -> list:
    """Another source's streamed ``gru_bwd_f32`` and this checkout's planned
    kernel at each shape, checked, then in turns (theirs, ours, ours, theirs)."""
    lib = build_copy("source", (), source=path)
    fn = lib.gru_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = []
    for name, shape in SHAPES.items():
        b, t, g, h = shape
        x, h0, w, bias, y, dy, hp = bwd_inputs(*shape, device, seed)
        outs = _outputs(x, h0)
        label, planned, _ = _planned(shape, device)

        def theirs():
            err = fn(*(a.data_ptr() for a in (x, hp, y, h0, dy)), None, w.data_ptr(),
                     *(o.data_ptr() for o in outs), *shape, stream)
            if err:
                raise RuntimeError(f"{path} gru_bwd_f32: launch failed with CUDA error {err}")

        with torch.inference_mode():
            want = gru_backward_walk_reference(dy, None, x, h0, w, bias, y)
            runs = {"theirs": theirs, "ours": lambda: planned(x, hp, y, h0, dy, w, outs)}
            for run in runs.values():
                for out in outs:
                    out.fill_(float("nan"))
                run()
                _check(name, outs, want)
            ms = [events_ms(runs[k], REPS) for k in ("theirs", "ours", "ours", "theirs")]
        rows.append({"shape": name, "planned": label, "theirs_ms": [ms[0], ms[3]], "ours_ms": [ms[1], ms[2]],
                     **bwd_bound(*shape)})
        del x, h0, w, bias, y, dy, hp, outs, want
        torch.cuda.empty_cache()
    return rows


# the edits of a copy apply to the source before this line, which holds the resident kernel
_SCATTER = "// The 16-block kernel's shared memory"


def build_copy(name: str, edits, source=None, whole=False) -> ctypes.CDLL:
    """A copy of gru_bwd.cu (or of the file ``source``) with the (old, new)
    edits applied to its part before the 16-block kernel (or, ``whole``, to
    all of it), as a library."""
    head, mark, tail = Path(source or _build.SRC_DIR / "gru_bwd.cu").read_text().partition(_SCATTER)
    if whole:
        head, mark, tail = head + mark + tail, "", ""
    for old, new in edits:
        if head.count(old) != 1:
            raise RuntimeError(f"copy {name!r}: the source no longer holds exactly one {old[:50]!r}...")
        head = head.replace(old, new)
    source = head + mark + tail
    out = _build.BUILD_DIR / "gru_bwd_copies"
    out.mkdir(parents=True, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    (out / f"{stem}.cu").write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-o", str(out / f"lib{stem}.so"), str(out / f"{stem}.cu")],
                   check=True)
    return ctypes.CDLL(str(out / f"lib{stem}.so"))


def breakdown_rows(device, seed: int = 0) -> list:
    """Route B at FullSubNet's sub band, at its planned R, with each of
    ROWS_CUTS, two turns."""
    with ThreadPoolExecutor(len(ROWS_CUTS)) as pool:
        # the copies' names differ from CUTS': a library is loaded once a path
        libs = dict(zip(ROWS_CUTS, pool.map(lambda n: build_copy(f"rows {n}", ROWS_CUTS[n], whole=True), ROWS_CUTS)))
    shape = SHAPES["FullSubNet sub band"]
    b, t, g, h = shape
    rows = bwd_row_tile(b, g, h)
    x, h0, w, _, y, dy, hp = bwd_inputs(*shape, device, seed)
    w_p = padded_weight_bwd(w)
    outs = _outputs(x, h0)
    stream = torch.cuda.current_stream(device).cuda_stream
    entries = {}
    for name, lib in libs.items():
        fn = lib.gru_bwd_rows_f32
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn

    def launch(fn, name):
        err = fn(*(a.data_ptr() for a in (x, hp, y, h0, dy)), None, w_p.data_ptr(), *(o.data_ptr() for o in outs),
                 *shape, rows, stream)
        if err:
            raise RuntimeError(f"{name}: launch failed with CUDA error {err}")

    times = {name: [] for name in ROWS_CUTS}
    for _ in range(2):
        for name, fn in entries.items():
            times[name].append(events_ms(lambda: launch(fn, name), REPS))
    return [{"kernel": f"gru_bwd_rows_kernel FullSubNet sub band R={rows}", "cut": name, "ms": ms,
             "us_a_step": sum(ms) / len(ms) / t * 1e3} for name, ms in times.items()]


def breakdown(device, seed: int = 0) -> list:
    """The resident kernel at config 2 with each of CUTS, two turns; then
    ``breakdown_rows``."""
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(build_copy, CUTS, CUTS.values())))
    shape = SHAPES["config 2"]
    b, t, g, h = shape
    x, h0, w, _, y, dy, hp = bwd_inputs(*shape, device, seed)
    cs = backward_plan(*shape, device)[0]
    packed = packed_weight_bwd(w, cs)
    outs = _outputs(x, h0)
    stream = torch.cuda.current_stream(device).cuda_stream
    entries = {name: _entry(lib) for name, lib in libs.items()}
    times = {name: [] for name in CUTS}
    for _ in range(2):
        for name, fn in entries.items():
            times[name].append(events_ms(lambda: _launch_copy(fn, name, shape, cs, x, hp, y, h0, dy, packed, outs,
                                                              stream), REPS))
    return ([{"kernel": "gru_bwd_resident_kernel config 2", "cut": name, "ms": ms,
              "us_a_step": sum(ms) / len(ms) / t * 1e3} for name, ms in times.items()]
            + breakdown_rows(device, seed))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    modes = parser.add_mutually_exclusive_group()
    modes.add_argument("--sweep", action="store_true", help="time every instance of both routes instead")
    modes.add_argument("--breakdown", action="store_true", help="time the kernels with parts cut out")
    modes.add_argument("--source", help="time this gru_bwd.cu's streamed kernel in turns with the planned one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gru_bwd_timing: no CUDA device")
    smi = card()
    device = torch.device("cuda:0")
    if args.breakdown:
        rows = breakdown(device)
        for row in rows:
            print(f"{row['kernel']}, {row['cut']}: {', '.join(f'{ms:.4f}' for ms in row['ms'])} ms "
                  f"({row['us_a_step']:.3f} us a step) on {smi}", flush=True)
    elif args.sweep:
        rows = sweep(device)
        for row in rows:
            print(f"gru backward {row['shape']} {row['fit']}{' (the plan)' if row['planned'] else ''}: "
                  f"{', '.join(f'{ms:.4f}' for ms in row['ms'])} ms ({row['us_a_step']:.3f} us a step), "
                  f"bound {row['bound_ms']:.4f} ms on {smi}", flush=True)
    elif args.source:
        rows = against_source(args.source, device)
        for row in rows:
            print(f"gru backward {row['shape']}: {args.source} gru_bwd_f32 "
                  f"{', '.join(f'{ms:.4f}' for ms in row['theirs_ms'])} ms; this checkout's {row['planned']} "
                  f"{', '.join(f'{ms:.4f}' for ms in row['ours_ms'])} ms; bound {row['bound_ms']:.4f} ms on {smi}",
                  flush=True)
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
