"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources are the ``*.cu`` files in ``cruse_tpu_torch/ops/csrc/``; each is
compiled on first use into one shared library with a plain C interface,
under ``build/cruse_tpu_torch/`` at the root of the checkout. The library's
file name carries a hash of its source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. A failed build raises:
nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cruse_tpu_torch"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register, shared-memory and spill report of every kernel
)


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then DEFAULT_NVCC; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), DEFAULT_NVCC]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it; the build report
    (ptxas registers and spills) is printed when it is built."""
    source = SRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise RuntimeError(f"kernel source missing: {source}")
    headers = b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    library = BUILD_DIR / f"lib{name}-{digest}.so"
    if not library.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = BUILD_DIR / f"tmp{os.getpid()}-{library.name}"
        cmd = nvcc_command(find_nvcc(), source, partial)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        report = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {source}:\n{report}")
        print(f"built {library.name}: {' '.join(cmd)}\n{report}", flush=True)
        os.replace(partial, library)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(library))
