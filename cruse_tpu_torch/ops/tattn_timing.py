"""Time the temporal-attention forward (``flash_tattn_tm`` without a gradient:
one launch of ``csrc/tattn.cu``) on one CUDA card at config 5b's three
stage geometries (B=16 x 10 s: BF = 1024, 512, 256; c = 6, 8, 12; C = 24,
32, 48; T = 626), with window 126 and without one.

    python3 -m cruse_tpu_torch.ops.tattn_timing [--out rows.json]

For each case it prints the wrapper's time (CUDA events around back-to-back
calls), the kernel's device time alone and the device launches a call (a
torch.profiler trace of a few calls), the bound (the larger of q, k, v read
and out written once at 3.35 TB/s, and the band's pairs x (c + C)
multiply-adds at 33.5 TFMA/s) and its share, the time of
``scaled_dot_product_attention`` with the band mask on the same inputs (the
library call: timed here, used nowhere in the port), and the instance's
registers, spills, blocks an SM and shared memory as the card reports them
(``tattn_fwd_info``). The script calls only the wrapper (and the info entry,
where the checkout has one), so it times whichever ``cruse_tpu_torch`` Python
imports: from the root of another checkout, ``PYTHONPATH=. python3 <this
file>`` times that checkout's kernel.

``--source FILE.cu`` (repeatable) builds each file as the port builds its
kernels and times its ``tattn_fwd_f32`` (the C interface of
``csrc/tattn.cu``) beside the wrapper's kernel, by CUDA events, in turns (the
wrapper's, the files', then back): an edited copy of ``csrc/tattn.cu`` with
one part cut out shows what that part costs. ``--sass FILE`` writes the SASS
of every ``tattn_fwd_kernel`` instance of the libraries timed
(``cuobjdump -sass``).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.asa_kernel import band_mask, flash_tattn_tm
from cruse_tpu_torch.ops.tfcm_bwd_timing import TRIES, bound, card, events_ms, kernel_events

STAGES = ((1024, 6, 24), (512, 8, 32), (256, 12, 48))  # BF, c, C
T = 626
WINDOWS = (126, None)
KERNEL_NAME = re.compile(r"\btattn_fwd_kernel\b")


def band_pairs(t: int, window) -> int:
    """(query, key) pairs of one row of the causal band."""
    return sum(min(i + 1, window or t) for i in range(t))


def attn_bound(bf: int, c: int, cv: int, t: int, window) -> dict:
    """The forward's bytes (q, k, v read once, out written once), the band's
    multiply-adds, and the least time the card could take for them."""
    nbytes, fmas = 4 * bf * t * (2 * c + 2 * cv), bf * band_pairs(t, window) * (c + cv)
    return {"bytes": nbytes, "fmas": fmas, **bound(nbytes, fmas)}


def attn_inputs(bf, c, cv, t, device, seed: int = 1):
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device) for shape in ((bf, c, t), (bf, c, t), (bf, cv, t))]


def kernel_alone(fn, calls: int, tries: int = TRIES) -> tuple[float, float, int]:
    """(device ms of the forward kernel a call, device launches a call, the
    forward launches the trace saw) from a torch.profiler trace of `calls`
    calls: the median launch. A trace may miss launches, so it is taken
    again (up to `tries` times) until one sees all `calls`; else the trace
    that saw most is used, and the launches a call are those it saw."""
    fn()
    torch.cuda.synchronize()
    events, mine = [], []
    for attempt in range(tries):
        trace = kernel_events(fn, calls)
        launches = sorted(e["dur"] for e in trace if KERNEL_NAME.search(e["name"]))
        if len(launches) > len(mine):
            events, mine = trace, launches
        if len(mine) >= calls:
            break
        print(f"profile {attempt + 1} of {calls} calls saw {len(launches)} forward launches "
              f"({tries - attempt - 1} tries left)", flush=True)
    if not mine:
        raise RuntimeError(f"{tries} profiles of {calls} calls saw no tattn_fwd_kernel")
    return mine[len(mine) // 2] / 1e3, len(events) / calls, len(mine)


def instance_info(c: int, cv: int):
    """What the card reports of the instance (c, C) launches, or None for a
    checkout without ``tattn_fwd_info``."""
    try:
        from cruse_tpu_torch.ops.asa_kernel import tattn_fwd_info
    except ImportError:
        return None
    return tattn_fwd_info(c, cv)


def time_tattn_fwd(device, stages=STAGES, windows=WINDOWS, t: int = T, reps: int = 20, calls: int = 10) -> list:
    """One row a case: BF, c, C, T, window, wrapper ms, kernel-alone ms,
    device launches a call, the bound, the library call's ms and the
    instance's registers, spills and occupancy."""
    import torch.nn.functional as F

    rows = []
    for bf, c, cv in stages:
        q, k, v = attn_inputs(bf, c, cv, t, device)
        q4, k4, v4 = (u.transpose(1, 2)[:, None].contiguous() for u in (q, k, v))  # [BF, 1, T, c]
        for window in windows:
            fn = lambda: flash_tattn_tm(q, k, v, window)  # noqa: E731
            with torch.inference_mode():
                wrapper = events_ms(fn, reps)
                kernel, launches, seen = kernel_alone(fn, calls)
                mask = band_mask(t, window, device)
                got = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)[:, 0].transpose(1, 2)
                err = float((got - fn()).abs().max())
                if not err <= 1e-4 * max(1.0, float(got.abs().max())):
                    raise RuntimeError(f"scaled_dot_product_attention differs by {err:.3g} "
                                       f"(BF={bf}, c={c}, C={cv}, window={window})")
                lib_ms = events_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
                                   max(3, reps // 4))
            rows.append({"bf": bf, "c": c, "C": cv, "t": t, "window": window, "wrapper_ms": wrapper,
                         "kernel_ms": kernel, "launches_per_call": launches, "traced": seen, "calls": calls,
                         **attn_bound(bf, c, cv, t, window),
                         "library_ms": lib_ms, "info": instance_info(c, cv)})
        del q, k, v, q4, k4, v4
    return rows


def build_source(source: Path) -> Path:
    """``source`` built with the port's nvcc flags into the build directory
    (under a hash of its text), its ptxas report printed; the library."""
    text = source.read_bytes()
    library = _build.BUILD_DIR / "sources" / f"lib{source.stem}-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not library.is_file():
        library.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(_build.nvcc_command(_build.find_nvcc(), source, library), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source}:\n{proc.stdout}{proc.stderr}")
        print(f"built {source}:\n{(proc.stdout + proc.stderr).strip()}", flush=True)
    return library


def forward_entry(library: Path):
    """The library's ``tattn_fwd_f32``, bound as the wrapper binds it."""
    fn = ctypes.CDLL(str(library)).tattn_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_sources(device, sources: list, stages=STAGES, windows=WINDOWS, t: int = T, reps: int = 20) -> list:
    """The wrapper's kernel and each source's ``tattn_fwd_f32`` at the stages,
    causal, by CUDA events in turns (wrapper, sources, sources reversed,
    wrapper): one row a case, ``{"ms": {name: [ms, ms]}}``."""
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libraries = list(pool.map(build_source, map(Path, sources)))
    entries = [(str(path), forward_entry(library)) for path, library in zip(sources, libraries)]
    rows = []
    for bf, c, cv in stages:
        q, k, v = attn_inputs(bf, c, cv, t, device)
        out = torch.empty_like(v)
        stream = torch.cuda.current_stream(device).cuda_stream
        for window in windows:
            def launch(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, bf, c, cv, t,
                         window or 0, 1, stream)
                if err != 0:
                    raise RuntimeError(f"tattn_fwd_f32 failed with CUDA error {err}")
            turns = [("wrapper", lambda: flash_tattn_tm(q, k, v, window))]
            turns += [(name, lambda fn=fn: launch(fn)) for name, fn in entries]
            ms: dict = {}
            with torch.inference_mode():
                for name, fn in turns + turns[::-1]:
                    ms.setdefault(name, []).append(events_ms(fn, reps))
            rows.append({"bf": bf, "c": c, "C": cv, "t": t, "window": window, "ms": ms,
                         **attn_bound(bf, c, cv, t, window)})
        del q, k, v, out
    return rows


def write_sass(path: str, libraries: list) -> None:
    """The SASS of every ``tattn_fwd_kernel`` instance of the libraries."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    with open(path, "w") as fh:
        for library in libraries:
            sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True, text=True,
                                  check=True).stdout
            for function in sass.split("Function : ")[1:]:
                if "tattn_fwd_kernel" in function.split()[0]:
                    fh.write(f"// {library}\nFunction : {function}\n")


def describe(row: dict) -> str:
    info = row["info"]
    held = ("" if info is None else
            f"; {info['registers']} registers, {info['spill_bytes']} B spilled, {info['blocks_per_sm']} blocks "
            f"of {info['threads']} threads an SM, {info['smem_bytes']} B of shared memory a block")
    return (f"tattn forward BF={row['bf']} c={row['c']} C={row['C']} T={row['t']} window={row['window']}: "
            f"kernel alone {row['kernel_ms']:.4f} ms, wrapper {row['wrapper_ms']:.4f} ms, "
            f"{row['launches_per_call']:.1f} device launches a call (the trace saw {row['traced']} of "
            f"{row['calls']} forward launches); bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {row['fmas'] / 1e9:.3f} GFMA) = {row['bound_ms'] / row['kernel_ms']:.1%} "
            f"of the kernel's time; scaled_dot_product_attention with the band mask {row['library_ms']:.4f} ms{held}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--source", action="append", default=[],
                        help="also time this CUDA source's tattn_fwd_f32, in turns with the wrapper's kernel")
    parser.add_argument("--sass", help="write the SASS of the tattn_fwd_kernel instances here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tattn_timing: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    device = torch.device("cuda:0")
    if args.source:
        rows = time_sources(device, args.source)
        for row in rows:
            times = "; ".join(f"{name} {', '.join(f'{ms:.4f}' for ms in turns)}"
                              for name, turns in row["ms"].items())
            print(f"tattn forward BF={row['bf']} c={row['c']} C={row['C']} T={row['t']} window={row['window']} "
                  f"(bound {row['bound_ms']:.4f} ms), ms in turns: {times} on {smi}", flush=True)
    else:
        rows = time_tattn_fwd(device)
        for row in rows:
            print(f"{describe(row)} on {smi}", flush=True)
    if args.sass:
        libraries = [Path(_build.load_library("tattn")._name)]  # the wrapper's
        libraries += [build_source(Path(path)) for path in args.source]
        write_sass(args.sass, libraries)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
