"""Where a step of the resident grouped-GRU kernel spends its time.

    python3 -m cruse_tpu_torch.ops.gru_breakdown        # one CUDA card

A measurement script, used nowhere in the port. It needs a CUDA device and
nvcc, and prints, with the card's name and power limit, the time of
``gru_resident_kernel`` at config 1's shape (B=256, T=1001, G=4, H=176, f32)
as it is and with one part cut out of a copy of ``csrc/gru_sequence.cu`` (the
product, the gates, the traffic between the blocks of the cluster, the x
loads and y stores, another unroll of the k loop). A cut copy computes wrong
values: only its time is read, and the difference to the whole kernel is what
the part costs. The copies are built beside the port's libraries, under
``build/``. (One-step times of both kernels are chip_smoke.py's.)
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cruse_tpu_torch.ops import _build
from cruse_tpu_torch.ops.gru_kernel import cluster_fit, packed_weight

CONFIG1 = (256, 1001, 4, 176)  # B, T, G, H

_GATES = """        const float rg = sigmoid(xr[r] + (sum_r[r] + bias_r));
        const float zg = sigmoid(xz[r] + (sum_z[r] + bias_z));
        const float ng = tanhf(xn[r] + rg * (sum_n[r] + bias_n));
        h[r] = (1.f - zg) * ng + zg * h[r];"""
_LOOP = "#pragma unroll (kUnroll)  // ROWS = 16, measured: 2 is 1 % slower, 4 is 35 % slower\n"
_K = "      for (int k = part; k < H; k += kSplit) {"
_PEERS = "      for (int c = 0; c < CS; ++c) {\n        if constexpr (CS <= 8) {\n          put(peers[c] + at, out);"
_ARRIVE = "    if constexpr (CS > 1) cluster_arrive();\n    if (active) {"
_WAIT = ("    if constexpr (CS > 1) {\n      cluster_wait();\n    } else {\n      __syncthreads();\n    }\n  }\n\n"
         "  if (active) {")
_XY = "        if (b < B) {\n          y[((static_cast<size_t>(b) * T + t) * G + g) * H + j] = h[r];"
# name: (old, new) pairs applied to the source; every old text must occur exactly once
CUTS = {
    "whole kernel": (),
    "no product": ((_K, "      for (int k = part; k < (T < 0 ? H : 0); k += kSplit) {"),),
    "no gates": ((_GATES, "        h[r] = 0.025f * (xr[r] + sum_r[r] + bias_r + xz[r] + sum_z[r] + bias_z + xn[r] "
                  "+ sum_n[r] + bias_n) + 0.5f * h[r];"),),
    "block barrier, no store into the peer": (
        (_PEERS, "      for (int c = 0; c < 1; ++c) {\n        if constexpr (CS <= 8) {\n          put(hq + at, out);"),
        (_ARRIVE, "    if (active) {"), (_WAIT, "    __syncthreads();\n  }\n\n  if (active) {")),
    "no x loads, y stored at the last step only": (
        (_XY, _XY.replace("if (b < B) {", "if (b < B && t == T - 1) {")),),
    "k loop unrolled by 2": ((_LOOP, "#pragma unroll 2\n"),),
    "k loop unrolled by 4": ((_LOOP, "#pragma unroll 4\n"),),
}


def gru_inputs(b, t, g, h, device, seed=1):
    rng = np.random.default_rng(seed)
    bound = h ** -0.5
    arrays = (rng.standard_normal((b, t, g, 3 * h)), rng.standard_normal((b, g, h)) * 0.5,
              rng.uniform(-bound, bound, (g, 3 * h, h)), rng.uniform(-bound, bound, (g, 3 * h)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def build_cut(name: str) -> ctypes.CDLL:
    """A copy of the source with the named part cut out, as a library."""
    source = (_build.SRC_DIR / "gru_sequence.cu").read_text()
    for old, new in CUTS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"cut {name!r}: the source no longer holds exactly one {old[:50]!r}...")
        source = source.replace(old, new)
    out = _build.BUILD_DIR / "gru_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    (out / f"{stem}.cu").write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-o", str(out / f"lib{stem}.so"), str(out / f"{stem}.cu")],
                   check=True)
    return ctypes.CDLL(str(out / f"lib{stem}.so"))


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cuts(device, smi: str) -> None:
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(build_cut, CUTS)))
    b, t, g, h = CONFIG1
    x, h0, w, bias = gru_inputs(b, t, g, h, device)
    cs, rows = cluster_fit(h).cs, cluster_fit(h).rows
    packed = packed_weight(w, torch.float32, cs)
    y, h_last = torch.empty(b, t, g, h, device=device), torch.empty(b, g, h, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for turn in range(2):
        for name, lib in libs.items():
            fn = lib.gru_resident_f32
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def launch():
                err = fn(x.data_ptr(), h0.data_ptr(), packed.data_ptr(), bias.data_ptr(), y.data_ptr(),
                         h_last.data_ptr(), b, t, g, h, cs, rows, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed with CUDA error {err}")

            ms = event_ms(launch, reps=3)
            print(f"gru_resident_kernel B={b} T={t} G={g} H={h} f32 on {smi}, turn {turn}, {name}: "
                  f"{ms:.3f} ms = {ms / t * 1e3:.2f} us a step", flush=True)
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip()
        print(f"SM clock and power draw right after turn {turn}: {clocks}")


def main() -> int:
    if not torch.cuda.is_available():
        print("gru_breakdown: no CUDA device; this measurement runs only on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {smi}", flush=True)
    time_cuts(device, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
