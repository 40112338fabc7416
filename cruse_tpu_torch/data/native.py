"""ctypes bindings of the native I/O core (``native/cruseio.cc``; counterpart
of ``cruse_tpu/data/native.py``).

The library is built on first use by the host C++ compiler, called directly
(``$CXX`` or ``g++``), into ``build/cruse_tpu_torch/`` at the root of the
checkout, under a name that carries a hash of the source and the flags. A
failed build raises: nothing here falls back to Python I/O, so a dataset that
asks for the native path gets it or an error. ``assemble_batch.calls``
counts the batches assembled natively.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "cruseio.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cruse_tpu_torch"
# no -march=native (the JAX package's Makefile has it): the library stays
# loadable on another host of the same architecture
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")


def _compiler() -> str:
    for candidate in (os.environ.get("CXX"), "g++", "c++"):
        path = candidate and shutil.which(candidate)
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX): native/cruseio.cc cannot be built")


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """Build ``native/cruseio.cc`` if needed and load it; raises on failure."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native I/O source missing: {SOURCE}")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    library = BUILD_DIR / f"libcruseio-{digest}.so"
    if not library.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = BUILD_DIR / f"tmp{os.getpid()}-{library.name}"
        proc = subprocess.run([_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(partial)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(partial, library)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(library))
    lib.cruseio_decode.restype = ctypes.c_int
    lib.cruseio_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    lib.cruseio_load_batch.restype = None
    lib.cruseio_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long)]
    lib.cruseio_assemble_batch.restype = None
    lib.cruseio_assemble_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    return lib


def library_path() -> str:
    return get_lib()._name


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode(path: str, sr: int | None = None, max_seconds: float = 120.0):
    """Decode one wav natively: (float32 mono array, sample rate); raises
    on failure."""
    lib = get_lib()
    cap = int(max_seconds * (sr or 48000))
    out = np.zeros(cap, np.float32)
    found = ctypes.c_long(0)
    sr_io = ctypes.c_int(sr or 0)
    n = lib.cruseio_decode(path.encode(), _floats(out), cap, ctypes.byref(found), ctypes.byref(sr_io))
    if n < 0:
        raise IOError(f"native decode failed: {path}")
    return out[:n].copy(), sr_io.value


def load_batch(paths: List[str], target_len: int, target_sr: int, seed: int = 0, threads: int = 8):
    """Decode, resample and random-crop a batch on the thread pool. Returns
    (batch [N, target_len] float32, ok [N] bool, lens [N] int64: each row's
    decoded length, so that a short file zero-padded rather than cropped
    shows)."""
    lib = get_lib()
    n = len(paths)
    out = np.zeros((n, target_len), np.float32)
    ok = np.zeros(n, np.int32)
    lens = np.zeros(n, np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.cruseio_load_batch(arr, n, _floats(out), target_len, target_sr, seed, threads,
                           ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                           lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    return out, ok.astype(bool), lens


def assemble_batch(pool: List[str], batch_size: int, target_len: int, gap_len: int, target_sr: int,
                   seed: int = 0, threads: int = 8):
    """The reference's selection natively: per row, random files from ``pool``
    with ``gap_len`` samples of silence between them until >= target_len,
    then a random crop. Returns (batch [B, target_len] float32, ok [B] bool)."""
    lib = get_lib()
    out = np.zeros((batch_size, target_len), np.float32)
    ok = np.zeros(batch_size, np.int32)
    arr = (ctypes.c_char_p * len(pool))(*[p.encode() for p in pool])
    lib.cruseio_assemble_batch(arr, len(pool), batch_size, _floats(out), target_len, gap_len, target_sr,
                               seed, threads, ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    assemble_batch.calls += 1
    return out, ok.astype(bool)


assemble_batch.calls = 0
