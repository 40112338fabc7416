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

With ``num_mics > 1`` the batches are multi-channel, ``{"noisy": [B, M, L],
"clean": [B, L]}`` (McCruse): through measured array RIRs
(``mix_batch_mc_rir``) when ``mc_rir_manifest`` lists any, else through the
image-source room (``mix_batch_mc_room``) with ``mc_room``, else through
free-field delays (``mix_batch_mc``, ``mc_max_delay``). As in the JAX
package, that path ignores ``reverb_proportion``, the single-channel RIR
manifests (whose draws ``host_batch`` still makes, call for call) and
``eq_proportion``. The measured RIRs are drawn after the batch's audio, the
speech's for all B rows and then the noise's, and travel in the same pinned
copy.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np
import torch

from cruse_tpu_torch.data import native
from cruse_tpu_torch.data.manifest import load_manifest, offset_and_limit, parse_snr_range
from cruse_tpu_torch.data.mixer import (MixerConfig, RoomConfig, draw_mc, draw_mc_rir, draw_mc_room, draw_mix,
                                         mix_batch, mix_batch_mc, mix_batch_mc_rir, mix_batch_mc_room)
from cruse_tpu_torch.data.wavio import read_wav

RIR_CACHE_BYTES = 512 * 1024 * 1024  # the decoded measured RIRs kept, per dataset


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
    num_mics: int = 1  # > 1: multi-channel batches, noisy [B, M, L] (McCruse)
    mc_max_delay: float = 8.0  # the free-field mixer's largest delay, samples
    mc_room: bool = False  # the image-source room instead of free-field delays
    # measured array RIRs ([num_mics, R] wavs, extra channels dropped); the
    # noise's manifest defaults to the speech's; they take precedence over mc_room
    mc_rir_manifest: str = ""
    mc_rir_noise_manifest: str = ""
    mc_room_t60: tuple = (0.2, 0.6)
    mc_room_max_order: int = 1
    mc_mic_spacing: float = 0.05
    mc_array_geometry: str = "linear"  # "linear" | "circular" | "custom"
    mc_array_radius: float = 0.05
    mc_mic_positions: tuple = ()  # custom: ((x, y, z), ...) from the array's centre, metres
    seed: int = 0
    valid_mode: bool = False
    use_native_io: bool = True  # the threaded C++ decode/resample/crop
    native_threads: int = 8


def mixing_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's mixing generator."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint32)[0])


class SynMixDataset:
    """Iterable over device batches {"noisy", "clean"} (float32 on
    ``device``: [B, L] each, or noisy [B, M, L] with ``num_mics > 1``; "name"
    too in valid mode). ``device`` is the card unless the caller asks for
    the CPU."""

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
        self.mc_rir_list = load_manifest(c.mc_rir_manifest) if c.mc_rir_manifest else []
        self.mc_rir_noise_list = (load_manifest(c.mc_rir_noise_manifest) if c.mc_rir_noise_manifest
                                  else self.mc_rir_list)
        self._mc_measured = bool(self.mc_rir_list) and c.num_mics > 1
        self._rir_cache: dict = {}  # path -> decoded [num_mics, rir_len], read-only
        self._rir_cache_bytes = 0
        self.room = RoomConfig(sr=c.sr, t60=tuple(c.mc_room_t60), max_order=int(c.mc_room_max_order),
                               mic_spacing=c.mc_mic_spacing, array_geometry=c.mc_array_geometry,
                               array_radius=c.mc_array_radius,
                               mic_positions=tuple(tuple(p) for p in c.mc_mic_positions))

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

    def _select_rir_mc(self, rir_list: List[str]) -> np.ndarray:
        """A random measured array RIR, padded or cut to [num_mics, rir_len];
        the file must hold at least num_mics channels, and extra ones are
        dropped. Decoded RIRs are cached by path up to RIR_CACHE_BYTES (every
        batch draws 2 B of them from a small corpus); the draw comes first,
        so that the cache leaves the generator's sequence as it is."""
        path = rir_list[self.rng.integers(len(rir_list))]
        cached = self._rir_cache.get(path)
        if cached is not None:
            return cached
        m = self.cfg.num_mics
        out = np.zeros((m, self.rir_len), np.float32)
        wav, _ = read_wav(path, sr=self.cfg.sr, mono=False)
        if wav.ndim == 1:
            wav = wav[None, :]
        if wav.shape[0] < m:
            raise ValueError(f"measured RIR {path} has {wav.shape[0]} channels < num_mics={m}")
        n = min(wav.shape[1], self.rir_len)
        out[:, :n] = wav[:m, :n]
        out.setflags(write=False)
        if self._rir_cache_bytes + out.nbytes <= RIR_CACHE_BYTES:
            self._rir_cache[path] = out
            self._rir_cache_bytes += out.nbytes
        return out

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

    def host_arrays(self):
        """One batch's host arrays as the mixing takes them, drawn in the JAX
        package's order: (clean, noise, rir, rir_noise) single-channel;
        (clean, noise, rir_c, rir_n) [B, M, R] through measured array RIRs,
        the single-channel RIRs drawn and dropped; (clean, noise, None,
        None) through the room or free field."""
        clean, noise, rir, rir_noise = self.host_batch()
        if self.cfg.num_mics == 1:
            return clean, noise, rir, rir_noise
        if not self._mc_measured:
            return clean, noise, None, None
        b = self.cfg.batch_size
        rir_c = np.stack([self._select_rir_mc(self.mc_rir_list) for _ in range(b)])
        return clean, noise, rir_c, np.stack([self._select_rir_mc(self.mc_rir_noise_list) for _ in range(b)])

    def draw(self, generator: torch.Generator):
        """One batch's mixing draws from ``generator``, for the configured mixer."""
        c, b = self.cfg, self.cfg.batch_size
        if c.num_mics == 1:
            return draw_mix(generator, b, self.mixer_cfg)
        if self._mc_measured:
            return draw_mc_rir(generator, b, self.mixer_cfg)
        if c.mc_room:
            return draw_mc_room(generator, b, c.num_mics, self.room, self.mixer_cfg)
        return draw_mc(generator, b, c.num_mics, self.mixer_cfg, c.mc_max_delay)

    def mix(self, arrays, draws):
        """Device arrays (``host_arrays``'s, on the device) and ``draws`` ->
        (noisy, target)."""
        clean, noise, rir, rir_noise = arrays
        c = self.cfg
        if c.num_mics == 1:
            return mix_batch(clean, noise, self.mixer_cfg, draws, rir, rir_noise)
        if self._mc_measured:
            return mix_batch_mc_rir(clean, noise, self.mixer_cfg, draws, rir, rir_noise)
        if c.mc_room:
            return mix_batch_mc_room(clean, noise, self.mixer_cfg, self.room, c.num_mics, draws)
        return mix_batch_mc(clean, noise, self.mixer_cfg, draws)

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
            arrays = self.to_device(self.host_arrays())
            noisy, target = self.mix(arrays, self.draw(generator))
            batch = {"noisy": noisy, "clean": target}
            if self.cfg.valid_mode:
                batch["name"] = [f"synth_{i:05d}_{j:03d}" for j in range(self.cfg.batch_size)]
            yield batch
