"""Time the GRU forward's two routes (``csrc/gru_sequence.cu``: the resident
``gru_resident_kernel`` and the row-tiled ``gru_rows_kernel``) on one CUDA
card, at FullSubNet's widths.

    python3 -m cruse_tpu_torch.ops.gru_timing [--out rows.json] [--sweep] [--breakdown]

``--sweep`` times both routes at H = 512 (the full band, 16 blocks x 8 rows a
cluster) and H = 384 (the sub band, 16 blocks x 16 rows) over batches from
one 16-block cluster to many waves of them (``SWEEP``), at long T by CUDA
events and at T = 1 by the kernels' device time in a profile (a launch's host
time exceeds it), with the row-tiled kernel at ``row_tile``'s R; it prints
the card's count of co-resident 16-block clusters and which route
``resident_plan`` takes. ``HOP_CLUSTER_WAVES`` and ``MAX_CLUSTER_WAVES`` come
from it.

``--breakdown`` times the row-tiled kernel at FullSubNet's sub band (B=4112,
T=626, H=384, R=32) and at R=8 and 16 as it is and with one part cut out of a
copy of the source (``CUTS``: the weight's ring, the product, the update), in
two turns. A cut copy computes wrong values: only its time is read, and the
difference to the whole kernel is what the part costs. Without the update the
compiler drops the product too, so that copy times the ring and the barriers
alone. The copies are built under ``build/``.
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
    cluster_fit, co_resident_clusters, launch_resident, launch_streamed, resident_plan, row_tile, transposed_weight)
from cruse_tpu_torch.ops.tfcm_bwd_timing import card, events_ms

REPS = 3
# (H, T, batches): the full band's rows and the sub band's B x 257, at a train step's and a hop's T
SWEEP = ((512, 626, (16, 64, 128, 256, 512)), (384, 188, (128, 257, 514, 1028, 2056)),
         (512, 1, (8, 64, 128)), (384, 1, (16, 257, 514, 2056)))
BREAKDOWN = ((4112, 626, 1, 384, 32), (2056, 188, 1, 384, 16), (1028, 188, 1, 384, 8))  # B, T, G, H, R

_FILL0 = "    for (int n = 0; n < lead && n < total; ++n) fill(n);\n"
_FILL = "      if (tid == 0 && i + lead < total) fill(i + lead);\n"
_WAIT = "      barrier_wait(full + 8 * s, phase);\n"
_ARRIVE = "      if (lane == 0) barrier_arrive(empty + 8 * s);\n"
_K = "          for (int kk = 0; kk < min(8, rows - k8); ++kk) {"
_UPDATE = "    if (live) {\n      const int valid = min(kUnits, H - j0);"
# name: (old, new) pairs applied to the source; every old text must occur exactly once
CUTS = {
    "whole kernel": (),
    "no ring (the stages never filled, never waited on)": ((_FILL0, ""), (_FILL, ""), (_WAIT, ""), (_ARRIVE, "")),
    "no product": ((_K, _K.replace("kk < min(8, rows - k8)", "kk < (T < 0 ? 8 : 0)")),),
    "no update (and so no product)": ((_UPDATE, _UPDATE.replace("if (live) {", "if (live && T < 0) {")),),
}


def inputs(b, t, g, h, device, seed: int = 0):
    """Seeded (x_proj, h0, w_hh, b_hh), the weights in the layers' own init range."""
    gen = torch.Generator(device).manual_seed(seed)
    scale = h ** -0.5
    return [torch.randn((b, t, g, 3 * h), generator=gen, device=device),
            torch.randn((b, g, h), generator=gen, device=device) * 0.5,
            (torch.rand((g, 3 * h, h), generator=gen, device=device) * 2 - 1) * scale,
            (torch.rand((g, 3 * h), generator=gen, device=device) * 2 - 1) * scale]


def device_us(fn, reps: int = 30) -> float:
    """Median device time (us) of the GRU kernels that reps calls of fn launch, from a profile."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = sorted(e.device_time for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "gru_" in e.name)
    if len(times) < reps // 2:
        raise RuntimeError(f"the profile shows {len(times)} GRU kernels for {reps} calls")
    return times[len(times) // 2]


def sweep(device, seed: int = 0) -> list:
    """Both routes over SWEEP, in turns (resident, row-tiled, row-tiled, resident)."""
    rows = []
    for h, t, batches in SWEEP:
        fit = cluster_fit(h)
        clusters = co_resident_clusters(device, h)
        for b in batches:
            args = inputs(b, t, 1, h, device, seed)
            r = row_tile(b, 1, h)
            with torch.inference_mode():
                resident = lambda: launch_resident(*args)  # noqa: E731
                tiled = lambda: launch_streamed(*args, rows=r)  # noqa: E731
                clock = (lambda fn: events_ms(fn, REPS)) if t > 1 else (lambda fn: device_us(fn) / 1e3)
                turns = [clock(fn) for fn in (resident, tiled, tiled, resident)]
            planned = resident_plan(b, t, 1, h, clusters=clusters) is not None
            rows.append({"h": h, "t": t, "b": b, "clusters": -(-b // fit.rows), "co_resident": clusters,
                         "resident_ms": [turns[0], turns[3]], "rows": r, "blocks": -(-b // r),
                         "row_tiled_ms": [turns[1], turns[2]], "plan": "resident" if planned else "row-tiled"})
            del args
            torch.cuda.empty_cache()
    return rows


def build_copy(name: str, edits) -> ctypes.CDLL:
    """A copy of gru_sequence.cu with the (old, new) edits applied, as a library."""
    source = (_build.SRC_DIR / "gru_sequence.cu").read_text()
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"copy {name!r}: the source no longer holds exactly one {old[:50]!r}...")
        source = source.replace(old, new)
    out = _build.BUILD_DIR / "gru_sequence_copies"
    out.mkdir(parents=True, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    (out / f"{stem}.cu").write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-o", str(out / f"lib{stem}.so"), str(out / f"{stem}.cu")],
                   check=True)
    return ctypes.CDLL(str(out / f"lib{stem}.so"))


def breakdown(device, seed: int = 0) -> list:
    """The row-tiled kernel at BREAKDOWN with each of CUTS, two turns."""
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(build_copy, CUTS, CUTS.values())))
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = []
    for b, t, g, h, r in BREAKDOWN:
        x, h0, w, bias = inputs(b, t, g, h, device, seed)
        w_t = transposed_weight(w, torch.float32)
        y, h_last = torch.empty(b, t, g, h, device=device), torch.empty(b, g, h, device=device)
        times = {name: [] for name in CUTS}
        for _ in range(2):
            for name, lib in libs.items():
                fn = lib.gru_sequence_f32
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def launch():
                    err = fn(*(a.data_ptr() for a in (x, h0, w_t, bias, y, h_last)), b, t, g, h, r, stream)
                    if err:
                        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")

                times[name].append(events_ms(launch, REPS))
        rows += [{"shape": [b, t, g, h], "rows": r, "cut": name, "ms": ms, "us_a_step": sum(ms) / len(ms) / t * 1e3}
                 for name, ms in times.items()]
        del x, h0, w, bias, w_t, y, h_last
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--sweep", action="store_true", help="time both routes over SWEEP")
    parser.add_argument("--breakdown", action="store_true", help="time the row-tiled kernel with parts cut out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gru_timing: no CUDA device")
    smi = card()
    device = torch.device("cuda:0")
    rows = []
    if args.sweep:
        rows += sweep(device)
        for row in rows:
            unit, scale = ("ms", 1) if row["t"] > 1 else ("us (device)", 1e3)
            print(f"gru forward H={row['h']} T={row['t']} B={row['b']}: resident "
                  f"{', '.join(f'{ms * scale:.3f}' for ms in row['resident_ms'])} {unit} ({row['clusters']} clusters "
                  f"of 16, {row['co_resident']} at once); row-tiled R={row['rows']} "
                  f"{', '.join(f'{ms * scale:.3f}' for ms in row['row_tiled_ms'])} {unit} ({row['blocks']} blocks); "
                  f"plan: {row['plan']} on {smi}", flush=True)
    if args.breakdown:
        parts = breakdown(device)
        for row in parts:
            b, t, g, h = row["shape"]
            print(f"gru_rows_kernel B={b} T={t} G={g} H={h} R={row['rows']}, {row['cut']}: "
                  f"{', '.join(f'{ms:.3f}' for ms in row['ms'])} ms ({row['us_a_step']:.2f} us a step) on {smi}",
                  flush=True)
        rows += parts
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
