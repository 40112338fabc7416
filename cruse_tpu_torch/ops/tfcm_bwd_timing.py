"""Time the TFCM backward's kernels, ``tail_bwd`` and ``mid_bwd``, on one CUDA
card at config 5b's four TFCM stage shapes (B=16 x 10 s: [16,64,24,626],
[16,32,32,626], [16,16,48,626], [16,128,4,626]) and d = 1, 2, 4, 8.

    python3 -m cruse_tpu_torch.ops.tfcm_bwd_timing [--out rows.json] [--sweep]

For each case it prints the wrapper's time (CUDA events around back-to-back
calls), the device time of the hand-written kernels alone and the device
launches a call (a torch.profiler trace of a few calls), the least bytes
(both inputs read once, the gradient written once), the bound those bytes
give at 3.35 TB/s, and the rate. ``tail_bwd`` does not depend on d and is
timed once a shape. The script calls only ``tail_bwd`` and ``mid_bwd``, so it
times whichever ``cruse_tpu_torch`` Python imports: from the root of another
checkout, ``PYTHONPATH=. python3 <this file>`` times that checkout's kernels.

``--sweep`` times instead ``mid_bwd``'s two kernels at each stage, d = 1 and
8, over a grid of tiles (band groups x frames, ``mid_plan``'s choice marked),
with CUDA events.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile

import torch

from cruse_tpu_torch.ops.tfcm_bwd_kernels import mid_bwd, tail_bwd

STAGES = ((16, 64, 24, 626), (16, 32, 32, 626), (16, 16, 48, 626), (16, 128, 4, 626))
DILATIONS = (1, 2, 4, 8)
PEAK_BYTES, PEAK_FMA = 3.35e12, 33.5e12  # an H100 SXM's HBM3 bytes/s and f32 multiply-adds/s (67 TFLOP/s)
EPS = 1e-5
KERNEL_NAME = re.compile(r"\b(tail|mid)_\w*kernel\b")  # the hand-written kernels of both phases
MARKER_NAME = re.compile(r"\bspin_kernel\b")  # torch.cuda._sleep's kernel: marks where the traced calls start and end
MARKERS, MARKER_CYCLES = 16, 1000  # markers a side, and the clock cycles each spins
TRIES = 6  # traces taken of one case before one that missed launches is accepted or refused


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def stage_inputs(shape, device, seed: int = 0):
    """Seeded (gradient, activation, wd, (mean, var, scale, bias, slope)) at
    one shape, the BatchNorm and PReLU off their defaults."""
    b, k, c, t = shape
    gen = torch.Generator(device).manual_seed(seed)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device=device) * scale

    stats = (randn(c, scale=0.3), torch.rand(c, generator=gen, device=device) + 0.5,
             1 + randn(c, scale=0.2), randn(c, scale=0.2),
             torch.rand((), generator=gen, device=device) * 0.25 + 0.05)
    return randn(b, k, c, t), randn(b, k, c, t), randn(3, 3, c, scale=1 / 3), stats


def bound(nbytes: float, fmas: float) -> dict:
    """The least time (ms) the card could take: the larger of the bytes over
    its memory rate and the multiply-adds over its f32 rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, fmas / PEAK_FMA * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def events_ms(fn, reps: int) -> float:
    """Mean time (ms) of fn() over reps back-to-back calls, after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_events(fn, calls: int) -> list:
    """The kernel events of a torch.profiler trace of `calls` calls of fn:
    the kernels the card ran between two markers (``torch.cuda._sleep``'s
    ``spin_kernel``) launched on the same stream just before and just after
    the calls (``marked_kernels``), or none where the trace lost a marker.
    The device's own timestamps order them, so neither a host clock that
    disagrees with the device's nor kernels an earlier trace left behind can
    move a kernel in or out of the calls. The trace holds host activity too:
    inside chip_smoke.py, traces of the device alone came back empty now and
    then."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        for _ in range(calls):
            fn()
        for _ in range(MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    kernels = marked_kernels(events)
    if kernels is None:
        held = [bool(MARKER_NAME.search(e["name"])) for e in sorted(
            (e for e in events if e.get("cat") == "kernel" and "dur" in e), key=lambda e: e["ts"])]
        at = [i for i, marker in enumerate(held) if marker]
        print(f"a trace of {calls} calls held {len(held)} kernels and no pair of markers around them: "
              f"{len(at)} markers, at {at[:1] + at[-1:]} of its kernels in the device's order", flush=True)
    return kernels or []


def marked_kernels(events: list) -> list | None:
    """The kernel events between the last marker that a non-marker kernel
    follows and the next marker after that, in the device's order; None
    where there is no such pair. The markers before and after the calls
    come in runs of ``MARKERS``, so a trace that lost its first or its last
    few events still opens and closes the calls (inside chip_smoke.py a trace
    lost 3 of 3 markers a side on six tries in a row)."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and "dur" in e), key=lambda e: e["ts"])
    marker = [bool(MARKER_NAME.search(e["name"])) for e in kernels]
    opening = max((i for i in range(len(kernels) - 1) if marker[i] and not marker[i + 1]), default=None)
    if opening is None:
        return None
    closing = next((i for i in range(opening + 1, len(kernels)) if marker[i]), None)
    return None if closing is None else kernels[opening + 1:closing]


def profiled(fn, calls: int, tries: int = TRIES, name: re.Pattern = KERNEL_NAME) -> tuple[float, float, dict]:
    """(device ms a call of the hand-written kernels, device launches a call,
    {kernel: ms a call}) from a torch.profiler trace of `calls` calls; the
    hand-written kernels are those `name` finds (by default both TFCM
    backward phases'). A trace may miss launches, now and then all of them,
    so a trace with fewer than `calls` hand-written launches is taken again
    (up to `tries` times), and the time a call is the median of each kernel's
    launches times its launches a call in the trace."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        events = kernel_events(fn, calls)
        seen = sum(bool(name.search(e["name"])) for e in events)
        if seen >= calls:
            break
        print(f"profile {attempt + 1} of {calls} calls saw {seen} hand-written launches "
              f"({tries - attempt - 1} tries left)", flush=True)
    else:
        raise RuntimeError(f"{tries} profiles of {calls} calls missed the hand-written kernels")
    by_kernel: dict = {}
    for e in events:
        match = name.search(e["name"])
        if match:
            by_kernel.setdefault(match.group(0), []).append(e["dur"])
    per_call = {}
    for name, durations in by_kernel.items():
        durations.sort()
        per_call[name] = durations[len(durations) // 2] * max(1, round(len(durations) / calls)) / 1e3
    return sum(per_call.values()), len(events) / calls, per_call


def time_tfcm_bwd(device, shapes=STAGES, dilations=DILATIONS, reps: int = 20, calls: int = 10) -> list:
    """One row a case: kernel, shape, d, wrapper ms, kernel-alone ms, device
    launches a call, least bytes, bound ms."""
    rows = []
    for shape in shapes:
        g, h, wd, (m, v, ga, be, a) = stage_inputs(shape, device)
        nbytes = 3 * g.numel() * 4
        cases = [("tail_bwd", None, lambda: tail_bwd(g, h, m, v, ga, be, a, EPS))]
        cases += [("mid_bwd", d, lambda d=d: mid_bwd(g, h, wd, m, v, ga, be, a, d, EPS)) for d in dilations]
        with torch.inference_mode():
            for name, d, fn in cases:
                wrapper = events_ms(fn, reps)
                kernel, launches, parts = profiled(fn, calls)
                rows.append({"kernel": name, "shape": list(shape), "d": d, "wrapper_ms": wrapper,
                             "kernel_ms": kernel, "kernels": parts, "launches_per_call": launches,
                             "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3})
        del g, h
    return rows


def sweep(device, shapes=STAGES, dilations=(1, 8), bands=(8, 4, 2), frames=(None, 320),
          reps: int = 20) -> list:
    """mid_bwd's two kernels (``launch_mid``) at each shape and d over the
    tiles bands x frames (None: all of T); one row each, ms by CUDA events."""
    from cruse_tpu_torch.ops.tfcm_bwd_kernels import launch_mid, mid_buffers, mid_plan

    rows = []
    for shape in shapes:
        g, h, wd, (m, v, ga, be, a) = stage_inputs(shape, device)
        for d in dilations:
            chosen = mid_plan(*shape, d)
            for kb in bands:
                for tt in frames:
                    plan = mid_plan(*shape, d, kb, tt)
                    buffers = mid_buffers(h, plan)
                    with torch.inference_mode():
                        ms = events_ms(lambda: launch_mid(g, h, wd, m, v, ga, be, a, d, EPS, plan, *buffers), reps)
                    rows.append({"shape": list(shape), "d": d, "kb": plan.kb, "tt": plan.tt, "smem": plan.smem,
                                 "ms": ms, "planned": plan == chosen})
        del g, h
    return rows


def describe(row: dict) -> str:
    gbs = row["bytes"] / row["kernel_ms"] / 1e6
    parts = ", ".join(f"{name} {ms:.4f}" for name, ms in sorted(row["kernels"].items()))
    return (f"{row['kernel']} {row['shape']} d={row['d']}: wrapper {row['wrapper_ms']:.4f} ms, kernels "
            f"alone {row['kernel_ms']:.4f} ms ({parts}) = {gbs:.1f} GB/s = "
            f"{row['bound_ms'] / row['kernel_ms']:.1%} of the bound {row['bound_ms']:.4f} ms "
            f"({row['bytes'] / 1e6:.1f} MB), {row['launches_per_call']:.1f} device launches a call")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--sweep", action="store_true", help="time mid_bwd over a grid of tiles instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tfcm_bwd_timing: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    if args.sweep:
        rows = sweep(torch.device("cuda:0"))
        for row in rows:
            print(f"mid_bwd {row['shape']} d={row['d']}, tile {row['kb']} bands x {row['tt']} frames "
                  f"({row['smem']} B): {row['ms']:.4f} ms{' (mid_plan)' if row['planned'] else ''} on {smi}")
    else:
        rows = time_tfcm_bwd(torch.device("cuda:0"))
        for row in rows:
            print(f"{describe(row)} on {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
