"""Synthetic-mixing dataset: host-side selection and crop, on-card mixing
(counterpart of ``cruse_tpu/data/dataset.py``).

The host side is the JAX package's, call for call: the same
``np.random.default_rng(seed)`` draws in the same order, so that a host batch
(clean, noise, RIRs) here equals the JAX package's bit for bit, through
Python I/O or through the native assembler (``data/native.py``, which must
build when ``use_native_io`` asks for it: nothing falls back to Python I/O).
A batch then crosses to the device in one pinned host-to-device copy and is
mixed there by ``data/mixer.py::mix_batch``, with draws from a
``torch.Generator`` on the device seeded from ``(seed, epoch)``.

Multi-channel batches (``num_mics > 1`` and the ``mc_*`` fields, for
McCruse) are refused by name.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np
import torch

from cruse_tpu_torch.data import native
from cruse_tpu_torch.data.manifest import load_manifest, offset_and_limit, parse_snr_range
from cruse_tpu_torch.data.mixer import MixerConfig, draw_mix, mix_batch
from cruse_tpu_torch.data.wavio import read_wav

_MC_FIELDS = ("mc_max_delay", "mc_room", "mc_rir_manifest", "mc_rir_noise_manifest", "mc_room_t60",
              "mc_room_max_order", "mc_mic_spacing", "mc_array_geometry", "mc_array_radius",
              "mc_mic_positions")


@dataclasses.dataclass
class SynMixConfig:
    clean_manifest: str = ""
    noise_manifest: str = ""
    rir_manifest: str = ""
    rir_noise_manifest: str = ""
    clean_offset: int = 0
    clean_limit: Optional[int] = None
    noise_offset: int = 0
    noise_limit: Optional[int] = None
    rir_offset: int = 0
    rir_limit: Optional[int] = None
    snr_range: tuple = (-5, 20)
    reverb_proportion: float = 0.0
    reverb_noise_proportion: float = 0.0
    silence_length: float = 0.2  # seconds between concatenated clips
    target_db_fs: float = -25.0
    target_db_fs_floating: float = 10.0
    sub_sample_seconds: float = 3.0
    sr: int = 16000
    dataset_length: Optional[int] = None
    batch_size: int = 32
    rir_max_seconds: float = 0.5  # RIRs padded or cut to one length for device batching
    eq_proportion: float = 0.0
    # multi-channel (McCruse): accepted so that one config builds both
    # packages; setting one raises
    num_mics: int = 1
    mc_max_delay: float = 8.0
    mc_room: bool = False
    mc_rir_manifest: str = ""
    mc_rir_noise_manifest: str = ""
    mc_room_t60: tuple = (0.2, 0.6)
    mc_room_max_order: int = 1
    mc_mic_spacing: float = 0.05
    mc_array_geometry: str = "linear"
    mc_array_radius: float = 0.05
    mc_mic_positions: tuple = ()
    seed: int = 0
    valid_mode: bool = False
    use_native_io: bool = True  # the threaded C++ decode/resample/crop
    native_threads: int = 8

    def __post_init__(self):
        defaults = SynMixConfig.__dataclass_fields__
        changed = [name for name in ("num_mics",) + _MC_FIELDS
                   if _normalised(getattr(self, name)) != _normalised(defaults[name].default)]
        if changed:
            raise NotImplementedError(
                f"SynMixConfig: {', '.join(changed)} select multi-channel mixing (McCruse), "
                "which is not ported")


def _normalised(value):
    return tuple(_normalised(v) for v in value) if isinstance(value, (list, tuple)) else value


def mixing_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's mixing generator."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint32)[0])


class SynMixDataset:
    """Iterable over device batches {"noisy", "clean"} ([B, L] float32 on
    ``device``; "name" too in valid mode). ``device`` is the card unless the
    caller asks for the CPU."""

    def __init__(self, config: SynMixConfig, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device is available "
                               "(pass device='cpu' to mix on the CPU)")
        self.cfg = c = config
        self.clean_list = offset_and_limit(load_manifest(c.clean_manifest), c.clean_offset, c.clean_limit)
        self.noise_list = offset_and_limit(load_manifest(c.noise_manifest), c.noise_offset, c.noise_limit)
        self.rir_list = (offset_and_limit(load_manifest(c.rir_manifest), c.rir_offset, c.rir_limit)
                         if c.rir_manifest else [])
        self.rir_noise_list = load_manifest(c.rir_noise_manifest) if c.rir_noise_manifest else []
        if not self.clean_list or not self.noise_list:
            raise ValueError(f"empty manifest: {c.clean_manifest if not self.clean_list else c.noise_manifest}")
        parse_snr_range(c.snr_range)
        self.length = int(c.dataset_length) if c.dataset_length else len(self.clean_list)
        self._epoch = 0  # advances the default mixing seed across epochs
        self.rng = np.random.default_rng(c.seed)
        self.sub_len = int(c.sub_sample_seconds * c.sr)
        self.rir_len = int(c.rir_max_seconds * c.sr)
        self.mixer_cfg = MixerConfig(
            sr=c.sr, snr_range=tuple(c.snr_range), target_db_fs=c.target_db_fs,
            target_db_fs_floating=c.target_db_fs_floating, reverb_proportion=c.reverb_proportion,
            reverb_noise_proportion=c.reverb_noise_proportion, eq_proportion=c.eq_proportion)

    def set_snr_range(self, snr_range) -> None:
        """Point-in-training SNR override (curriculum learning)."""
        parse_snr_range(snr_range)
        self.mixer_cfg = dataclasses.replace(self.mixer_cfg, snr_range=tuple(snr_range))

    def __len__(self):
        return self.length

    # ---- host-side selection ----

    def _select_concat(self, file_list: List[str], target_length: int, start=None) -> np.ndarray:
        """Concatenate random files with silence gaps to >= target_length,
        then random-crop to target_length."""
        silence = np.zeros(int(self.cfg.sr * self.cfg.silence_length), np.float32)
        pieces = [] if start is None else [start]
        total = 0 if start is None else len(start)
        while total < target_length:
            f = file_list[self.rng.integers(len(file_list))]
            wav, _ = read_wav(f, sr=self.cfg.sr)
            if wav.ndim == 2:
                wav = wav[self.rng.integers(wav.shape[0])]
            pieces.append(wav)
            total += len(wav)
            if total < target_length:
                gap = silence[: min(len(silence), target_length - total)]
                pieces.append(gap)
                total += len(gap)
        y = np.concatenate(pieces)
        if len(y) > target_length:
            idx = self.rng.integers(len(y) - target_length + 1)
            y = y[idx : idx + target_length]
        return y.astype(np.float32)

    def _select_rir(self, rir_list: List[str]) -> np.ndarray:
        """Pad or cut a random RIR to the device length; zeros = none."""
        rir = np.zeros(self.rir_len, np.float32)
        if rir_list:
            wav, _ = read_wav(rir_list[self.rng.integers(len(rir_list))], sr=self.cfg.sr)
            if wav.ndim == 2:
                wav = wav[0]
            n = min(len(wav), self.rir_len)
            rir[:n] = wav[:n]
        return rir

    def _native_select(self, file_list: List[str], b: int):
        """The C++ assembler does the whole selection (random files, silence
        gaps, random crop) on its thread pool; a row it could not read at all
        is selected again in Python, where an unreadable file raises."""
        gap_len = int(self.cfg.sr * self.cfg.silence_length)
        batch, ok = native.assemble_batch(file_list, b, self.sub_len, gap_len, self.cfg.sr,
                                          seed=int(self.rng.integers(2**62)),
                                          threads=self.cfg.native_threads)
        for i in range(b):
            if not ok[i]:
                batch[i] = self._select_concat(file_list, self.sub_len)
        return batch

    def host_batch(self):
        """One host batch of raw (clean, noise, rir, rir_noise) arrays; the
        RIRs are None when unused."""
        b = self.cfg.batch_size
        if self.cfg.use_native_io:
            clean = self._native_select(self.clean_list, b)
            noise = self._native_select(self.noise_list, b)
        else:
            clean = np.stack([self._select_concat(self.clean_list, self.sub_len) for _ in range(b)])
            noise = np.stack([self._select_concat(self.noise_list, self.sub_len) for _ in range(b)])
        rir = (np.stack([self._select_rir(self.rir_list) for _ in range(b)])
               if self.rir_list and self.cfg.reverb_proportion > 0 else None)
        rir_noise = (np.stack([self._select_rir(self.rir_noise_list) for _ in range(b)])
                     if self.rir_noise_list and self.cfg.reverb_noise_proportion > 0 else None)
        return clean, noise, rir, rir_noise

    def to_device(self, arrays):
        """Host arrays (None passes through) -> tensors on the device, in one
        host-to-device copy from pinned memory on the card's path."""
        present = [a for a in arrays if a is not None]
        sizes = [a.size for a in present]
        host = torch.empty(sum(sizes), dtype=torch.float32, pin_memory=self.device.type == "cuda")
        flat = host.numpy()
        offset = 0
        for a, n in zip(present, sizes):
            flat[offset : offset + n] = a.reshape(-1)
            offset += n
        parts = iter(host.to(self.device, non_blocking=True).split(sizes))
        return [None if a is None else next(parts).view(a.shape) for a in arrays]

    def batches(self, num_batches: Optional[int] = None,
                generator: torch.Generator | None = None) -> Iterator[dict]:
        """Yield mixed device batches. Without a generator, the mixing draws
        come from one seeded from (seed, epoch), the epoch counting this
        dataset's calls."""
        steps = num_batches if num_batches is not None else max(1, self.length // self.cfg.batch_size)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                mixing_seed(self.cfg.seed, self._epoch))
            self._epoch += 1
        for i in range(steps):
            clean, noise, rir, rir_noise = self.to_device(self.host_batch())
            draws = draw_mix(generator, self.cfg.batch_size, self.mixer_cfg)
            noisy, target = mix_batch(clean, noise, self.mixer_cfg, draws, rir, rir_noise)
            batch = {"noisy": noisy, "clean": target}
            if self.cfg.valid_mode:
                batch["name"] = [f"synth_{i:05d}_{j:03d}" for j in range(self.cfg.batch_size)]
            yield batch
