"""WAV read/write with the stdlib `wave` module: a copy of the numpy-only
``cruse_tpu/data/wavio.py`` (the port must not import ``cruse_tpu.data``,
whose package imports jax). Supports PCM 16/24/32-bit and IEEE float32,
mono/multichannel, plus polyphase resampling via scipy.
"""
from __future__ import annotations

import os
import struct
import wave

import numpy as np

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3


def read_wav(path: str, sr: int | None = None, mono: bool = True):
    """Returns (waveform float32 in [-1, 1], sample_rate). If `sr` is given
    and differs from the file rate, resamples (scipy polyphase)."""
    path = os.path.abspath(os.path.expanduser(path))
    with open(path, "rb") as fh:
        header = fh.read(12)
        assert header[:4] == b"RIFF" and header[8:12] == b"WAVE", f"not a wav: {path}"
        fmt = None
        data = None
        while True:
            chunk_header = fh.read(8)
            if len(chunk_header) < 8:
                break
            cid, csize = struct.unpack("<4sI", chunk_header)
            payload = fh.read(csize + (csize & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload[:csize]
        assert fmt is not None and data is not None, f"malformed wav: {path}"
    audio_format, n_channels, frame_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        y = np.frombuffer(data, dtype=np.float32).astype(np.float32)
    elif bits == 16:
        y = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
    elif bits == 32:
        y = np.frombuffer(data, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        vals = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        y = vals.astype(np.float32) / float(1 << 23)
    elif bits == 8:
        y = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav: format={audio_format} bits={bits}")
    if n_channels > 1:
        y = y.reshape(-1, n_channels).T  # [C, L]
        if mono:
            y = y.mean(axis=0)
    if sr is not None and sr != frame_rate:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(sr, frame_rate)
        y = resample_poly(y, sr // g, frame_rate // g, axis=-1).astype(np.float32)
        frame_rate = sr
    return np.ascontiguousarray(y, dtype=np.float32), frame_rate


def write_wav(path: str, y: np.ndarray, sr: int, subtype: str = "int16"):
    """Write mono/multichannel float [-1, 1] (or int16) audio."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    y = np.asarray(y)
    n_channels = 1
    if y.ndim == 2:  # [C, L] -> interleaved frames
        n_channels = y.shape[0]
        y = y.T.reshape(-1)
    if y.dtype != np.int16:
        assert subtype == "int16", f"unsupported write subtype {subtype}"
        y = (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(n_channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(y.astype("<i2").tobytes())


def to_int16_scaled(y: np.ndarray, headroom: float = 0.8) -> np.ndarray:
    """Reference inferencer output scaling (base_inferencer.py:183-185):
    int16 at `headroom` full scale of the max amplitude."""
    amp = np.iinfo(np.int16).max
    return np.int16(headroom * amp * y / (np.max(np.abs(y)) + 1e-12))
