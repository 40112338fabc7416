"""Time the temporal attention's kernels on one CUDA card at config 5b's three
stage geometries (B=16 x 10 s: BF = 1024, 512, 256; c = 6, 8, 12; C = 24,
32, 48; T = 626), with window 126 and without one: the forward
(``flash_tattn_tm`` without a gradient: one launch of ``csrc/tattn.cu``) and
the backward's two kernels, ``tattn_dkv`` and ``tattn_dq``
(``csrc/tattn_bwd.cu``), fed by the forward kernel's output and logsumexp.

    python3 -m cruse_tpu_torch.ops.tattn_timing [--out rows.json]

For each case and kernel it prints the wrapper's time (CUDA events around
back-to-back calls), the kernel's device time alone and the device launches
a call (a torch.profiler trace of a few calls between marker kernels), the
bound (the larger of the operands read and the results written once at 3.35
TB/s, and the band's pairs x the kernel's multiply-adds a pair at 33.5
TFMA/s: c + C for the forward, 2 c + C for dq, 2 (c + C) for dk/dv) and its
share, the library call on the same inputs (timed here, used nowhere in the
port): ``scaled_dot_product_attention`` with the band mask, and for the
backward the gradient of that call, one call that returns dq, dk and dv
together and is checked to agree with the kernels; and the instance's
registers, spills, blocks an SM and shared memory as the card reports them
(``tattn_fwd_info``, ``tattn_dq_info``, ``tattn_dkv_info``). The script calls only the wrappers
(and the info entries, where the checkout has them), so it times whichever
``cruse_tpu_torch`` Python imports: from the root of another checkout,
``PYTHONPATH=. python3 <this file>`` times that checkout's kernels.

``--source FILE.cu`` (repeatable) builds each file as the port builds its
kernels and times whichever of ``tattn_fwd_f32``, ``tattn_dq_f32`` and
``tattn_dkv_f32`` (the C interfaces of ``csrc/tattn.cu`` and
``csrc/tattn_bwd.cu``) it defines beside the wrapper's kernel, by CUDA
events, in turns (the wrapper's, the files', then back): another checkout's
``tattn_bwd.cu`` against this one's, or an edited copy with one part cut
out, which shows what that part costs. ``--sass FILE`` writes the SASS of
every ``tattn_fwd_kernel``, ``tattn_dq_kernel`` and ``tattn_dkv_kernel``
instance of the libraries timed (``cuobjdump -sass``).
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
from cruse_tpu_torch.ops.asa_kernel import _launch_fwd, band_mask, flash_tattn_tm, tattn_dkv, tattn_dq
from cruse_tpu_torch.ops.tfcm_bwd_timing import TRIES, bound, card, events_ms, kernel_events

STAGES = ((1024, 6, 24), (512, 8, 32), (256, 12, 48))  # BF, c, C
T = 626
WINDOWS = (126, None)
# each kernel: its name in a profile, and its C entry's ctypes arguments (pointers, ints)
KERNELS = {"forward": (re.compile(r"\btattn_fwd_kernel\b"), "tattn_fwd_f32", 5, 6),
           "dq": (re.compile(r"\btattn_dq_kernel\b"), "tattn_dq_f32", 7, 5),
           "dkv": (re.compile(r"\btattn_dkv_kernel\b"), "tattn_dkv_f32", 8, 5)}
LABELS = {"forward": "tattn forward", "dq": "tattn_dq", "dkv": "tattn_dkv"}
# floats a frame each kernel must read and write (q, k, v, out; + dout, lse, D
# and the gradients), in units of (c, C, 1), and multiply-adds a band pair
FRAME_FLOATS = {"forward": (2, 2, 0), "dq": (3, 2, 2), "dkv": (3, 3, 2)}
PAIR_FMAS = {"forward": (1, 1), "dq": (2, 1), "dkv": (2, 2)}


def band_pairs(t: int, window) -> int:
    """(query, key) pairs of one row of the causal band."""
    return sum(min(i + 1, window or t) for i in range(t))


def attn_bound(bf: int, c: int, cv: int, t: int, window, kind: str = "forward") -> dict:
    """A kernel's bytes (each operand read once, each result written once),
    the band's multiply-adds, and the least time the card could take for
    them; `kind` is "forward", "dq" or "dkv"."""
    (fc, fv, f1), (mc, mv) = FRAME_FLOATS[kind], PAIR_FMAS[kind]
    nbytes, fmas = 4 * bf * t * (fc * c + fv * cv + f1), bf * band_pairs(t, window) * (mc * c + mv * cv)
    return {"bytes": nbytes, "fmas": fmas, **bound(nbytes, fmas)}


def attn_inputs(bf, c, cv, t, device, seed: int = 1):
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device) for shape in ((bf, c, t), (bf, c, t), (bf, cv, t))]


def bwd_inputs(bf, c, cv, t, window, device):
    """q, k, v, dout, and the forward kernel's logsumexp and D = sum_C dout * out."""
    q, k, v = attn_inputs(bf, c, cv, t, device)
    dout = attn_inputs(bf, c, cv, t, device, seed=2)[2]
    with torch.inference_mode():
        out, lse = _launch_fwd(q, k, v, window, True, with_lse=True)
        return q, k, v, dout, lse, (dout * out).sum(dim=1)


def kernel_alone(fn, calls: int, kind: str = "forward", tries: int = TRIES) -> tuple[float, float, int]:
    """(device ms of the `kind` kernel a call, device launches a call, the
    launches of that kernel the trace saw) from a torch.profiler trace of
    `calls` calls: the median launch. A trace may miss launches, so it is
    taken again (up to `tries` times) until one sees all `calls`; else the
    trace that saw most is used, and the launches a call are those it saw."""
    name = KERNELS[kind][0]
    fn()
    torch.cuda.synchronize()
    events, mine = [], []
    for attempt in range(tries):
        trace = kernel_events(fn, calls)
        launches = sorted(e["dur"] for e in trace if name.search(e["name"]))
        if len(launches) > len(mine):
            events, mine = trace, launches
        if len(mine) >= calls:
            break
        print(f"profile {attempt + 1} of {calls} calls saw {len(launches)} {LABELS[kind]} launches "
              f"({tries - attempt - 1} tries left)", flush=True)
    if not mine:
        raise RuntimeError(f"{tries} profiles of {calls} calls saw no {name.pattern}")
    return mine[len(mine) // 2] / 1e3, len(events) / calls, len(mine)


def instance_info(c: int, cv: int, kind: str = "forward"):
    """What the card reports of the instance (c, C) launches, or None for a
    checkout without the kernel's info entry."""
    from cruse_tpu_torch.ops import asa_kernel

    info = getattr(asa_kernel, {"forward": "tattn_fwd_info", "dq": "tattn_dq_info", "dkv": "tattn_dkv_info"}[kind],
                   None)
    return None if info is None else info(c, cv)


def library_check(ours, library, what: str) -> None:
    """The library call computes what the kernel does: within 1e-4 x max(1, max|library|)."""
    err = float((ours - library).abs().max())
    if not err <= 1e-4 * max(1.0, float(library.abs().max())):
        raise RuntimeError(f"scaled_dot_product_attention differs by {err:.3g} ({what})")


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
                library_check(fn(), F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)[:, 0].transpose(1, 2),
                              f"BF={bf}, c={c}, C={cv}, window={window}")
                lib_ms = events_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
                                   max(3, reps // 4))
            rows.append({"kind": "forward", "bf": bf, "c": c, "C": cv, "t": t, "window": window,
                         "wrapper_ms": wrapper, "kernel_ms": kernel, "launches_per_call": launches, "traced": seen,
                         "calls": calls, **attn_bound(bf, c, cv, t, window),
                         "library_ms": lib_ms, "info": instance_info(c, cv)})
        del q, k, v, q4, k4, v4
    return rows


def time_tattn_bwd(device, stages=STAGES, windows=WINDOWS, t: int = T, reps: int = 20, calls: int = 10) -> list:
    """As ``time_tattn_fwd`` for ``tattn_dkv`` and ``tattn_dq`` (a row each a
    case, ``kind`` "dkv" or "dq"); their library time is that of one
    ``autograd.grad`` through ``scaled_dot_product_attention``, which returns
    dq, dk and dv together."""
    import torch.nn.functional as F

    rows = []
    for bf, c, cv in stages:
        for window in windows:
            q, k, v, dout, lse, dd = bwd_inputs(bf, c, cv, t, window, device)
            fns = {"dkv": lambda: tattn_dkv(q, k, v, dout, lse, dd, window),
                   "dq": lambda: tattn_dq(q, k, v, dout, lse, dd, window)}
            mask = band_mask(t, window, device)
            q4, k4, v4 = (u.transpose(1, 2)[:, None].contiguous().requires_grad_() for u in (q, k, v))
            g4 = dout.transpose(1, 2)[:, None].contiguous()
            out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
            lib = lambda: torch.autograd.grad(out4, (q4, k4, v4), g4, retain_graph=True)  # noqa: E731
            what = f"backward BF={bf}, c={c}, C={cv}, window={window}"
            with torch.inference_mode():
                ours = (fns["dq"](), *fns["dkv"]())
            for mine, theirs in zip(ours, lib()):
                library_check(mine, theirs[:, 0].transpose(1, 2), what)
            lib_ms = events_ms(lib, max(3, reps // 4))
            del out4, q4, k4, v4, g4
            for kind, fn in fns.items():
                with torch.inference_mode():
                    wrapper = events_ms(fn, reps)
                    kernel, launches, seen = kernel_alone(fn, calls, kind)
                rows.append({"kind": kind, "bf": bf, "c": c, "C": cv, "t": t, "window": window,
                             "wrapper_ms": wrapper, "kernel_ms": kernel, "launches_per_call": launches,
                             "traced": seen, "calls": calls, **attn_bound(bf, c, cv, t, window, kind),
                             "library_ms": lib_ms, "info": instance_info(c, cv, kind)})
            del q, k, v, dout, lse, dd
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


def entries(library: Path) -> dict:
    """The library's C entries among ``KERNELS``' (kind: function), bound as the wrappers bind them."""
    lib, found = ctypes.CDLL(str(library)), {}
    for kind, (_, symbol, pointers, ints) in KERNELS.items():
        if hasattr(lib, symbol):
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            found[kind] = fn
    return found


def time_sources(device, sources: list, stages=STAGES, windows=WINDOWS, t: int = T, reps: int = 20) -> list:
    """The wrapper's kernels and each source's entries at the stages, causal,
    by CUDA events in turns (wrapper, sources, sources reversed, wrapper):
    one row a case and kernel that some source defines, ``{"ms": {name: [ms, ms]}}``."""
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libraries = list(pool.map(build_source, map(Path, sources)))
    by_source = [(str(path), entries(library)) for path, library in zip(sources, libraries)]
    kinds = [kind for kind in KERNELS if any(kind in found for _, found in by_source)]
    rows = []
    for bf, c, cv in stages:
        for window in windows:
            q, k, v, dout, lse, dd = bwd_inputs(bf, c, cv, t, window, device)
            out, dq, dk, dv = torch.empty_like(v), torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            stream = torch.cuda.current_stream(device).cuda_stream
            ptr = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
            args = {"forward": (*ptr(q, k, v, out), None, bf, c, cv, t, window or 0, 1, stream),
                    "dq": (*ptr(q, k, v, dout, lse, dd, dq), bf, c, cv, t, window or 0, stream),
                    "dkv": (*ptr(q, k, v, dout, lse, dd, dk, dv), bf, c, cv, t, window or 0, stream)}
            wrappers = {"forward": lambda: flash_tattn_tm(q, k, v, window),
                        "dq": lambda: tattn_dq(q, k, v, dout, lse, dd, window),
                        "dkv": lambda: tattn_dkv(q, k, v, dout, lse, dd, window)}

            def launch(fn, kind):
                err = fn(*args[kind])
                if err != 0:
                    raise RuntimeError(f"{KERNELS[kind][1]} failed with CUDA error {err}")
            for kind in kinds:
                turns = [("wrapper", wrappers[kind])]
                turns += [(name, lambda fn=found[kind], kind=kind: launch(fn, kind))
                          for name, found in by_source if kind in found]
                ms: dict = {}
                with torch.inference_mode():
                    for name, fn in turns + turns[::-1]:
                        ms.setdefault(name, []).append(events_ms(fn, reps))
                rows.append({"kind": kind, "bf": bf, "c": c, "C": cv, "t": t, "window": window, "ms": ms,
                             **attn_bound(bf, c, cv, t, window, kind)})
            del q, k, v, dout, lse, dd, out, dq, dk, dv
    return rows


def write_sass(path: str, libraries: list) -> None:
    """The SASS of every instance of the three attention kernels of the libraries."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    with open(path, "w") as fh:
        for library in libraries:
            sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True, text=True,
                                  check=True).stdout
            for function in sass.split("Function : ")[1:]:
                if re.search(r"tattn_(fwd|dq|dkv)_kernel", function.split()[0]):
                    fh.write(f"// {library}\nFunction : {function}\n")


def describe(row: dict) -> str:
    info = row["info"]
    held = ("" if info is None else
            f"; {info['registers']} registers, {info['spill_bytes']} B spilled, {info['blocks_per_sm']} blocks "
            f"of {info['threads']} threads an SM, {info['smem_bytes']} B of shared memory a block")
    library = ("scaled_dot_product_attention with the band mask" if row["kind"] == "forward" else
               "the gradient of scaled_dot_product_attention with the band mask (one call: dq, dk and dv)")
    return (f"{LABELS[row['kind']]} BF={row['bf']} c={row['c']} C={row['C']} T={row['t']} window={row['window']}: "
            f"kernel alone {row['kernel_ms']:.4f} ms, wrapper {row['wrapper_ms']:.4f} ms, "
            f"{row['launches_per_call']:.1f} device launches a call (the trace saw {row['traced']} of "
            f"{row['calls']} {LABELS[row['kind']]} launches); bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {row['fmas'] / 1e9:.3f} GFMA) = {row['bound_ms'] / row['kernel_ms']:.1%} "
            f"of the kernel's time; {library} {row['library_ms']:.4f} ms{held}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--source", action="append", default=[],
                        help="also time this CUDA source's tattn entries, in turns with the wrapper's kernels")
    parser.add_argument("--sass", help="write the SASS of the attention kernels' instances here")
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
            print(f"{LABELS[row['kind']]} BF={row['bf']} c={row['c']} C={row['C']} T={row['t']} "
                  f"window={row['window']} (bound {row['bound_ms']:.4f} ms), ms in turns: {times} on {smi}",
                  flush=True)
    else:
        rows = time_tattn_fwd(device) + time_tattn_bwd(device)
        for row in rows:
            print(f"{describe(row)} on {smi}", flush=True)
    if args.sass:
        libraries = [Path(_build.load_library(name)._name) for name in ("tattn", "tattn_bwd")]  # the wrappers'
        libraries += [build_source(Path(path)) for path in args.source]
        write_sass(args.sass, libraries)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
