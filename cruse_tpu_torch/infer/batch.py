"""Batch inferencer (counterpart of ``cruse_tpu/infer/batch.py``), single device.

Enhances (noisy, name) pairs with one of two strategies:

- ``mag_to_mag``: STFT -> compressed magnitude -> model mask -> masked
  magnitude with the noisy phase -> iSTFT (mask models: CRUSE);
- ``auto``: STFT -> the model family's forward adapter
  (``train.step.forward_for_model``) on the RI spectrum -> iSTFT (CRUSE;
  CRUSE+DF, whose deep filter runs on the low bins; MTFAA, which emits the
  enhanced complex spectrum).

Outputs are scaled to int16 at 0.8 of full scale, logged with their
real-time factor and optionally written as wavs.

Not ported yet, and refused rather than ignored: the complex and
multi-channel strategies, mask post-filters, the device mesh,
``enhance_long`` and int8 weights.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from cruse_tpu_torch.data.wavio import to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.stft import StftConfig, istft, istft_mag_phase, stft
from cruse_tpu_torch.models.cruse_df import CruseDfNet
from cruse_tpu_torch.models.mtfaa import MtfaaNet
from cruse_tpu_torch.train.step import forward_for_model
from cruse_tpu_torch.utils.config import log


@dataclasses.dataclass
class InferencerConfig:
    type: str = "mag_to_mag"  # strategy method name: "mag_to_mag" or "auto"
    sr: int = 16000
    stft: StftConfig = StftConfig(n_fft=320, hop_length=160)
    output_dir: str = "enhanced"
    postfilter: Optional[str] = None


class BatchInferencer:
    """Enhance utterances with a model on one ``device``: the card unless the
    caller asks for the CPU (``device="cpu"``); a CUDA device that is not
    there is an error. The model is moved there and put in eval mode
    (BatchNorm uses its running stats)."""

    def __init__(self, model: torch.nn.Module, config: InferencerConfig,
                 device: torch.device | str = "cuda"):
        if config.type not in ("mag_to_mag", "auto"):
            raise NotImplementedError(f"inferencer strategy {config.type!r} is not ported "
                                      "(ported: mag_to_mag, auto)")
        if config.postfilter is not None:
            raise NotImplementedError(f"mask post-filter {config.postfilter!r} is not ported")
        if config.type == "mag_to_mag" and isinstance(model, (CruseDfNet, MtfaaNet)):
            raise ValueError(f"mag_to_mag takes a mask model; {type(model).__name__} runs "
                             "with type='auto'")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        self.model = model.to(self.device).eval()
        self._forward = forward_for_model(self.model) if config.type == "auto" else None
        self._strategy = getattr(self, config.type)
        self.cfg = config
        self.enhanced_dir = Path(config.output_dir).expanduser().absolute()
        self.rtf_history: list[float] = []

    @torch.inference_mode()
    def mag_to_mag(self, noisy: torch.Tensor) -> torch.Tensor:
        """[B, L] noisy -> [B, L] enhanced: magnitude mask, noisy phase."""
        spec = stft(noisy, self.cfg.stft)
        mask, _ = self.model(self.model.compress(spec.abs()))
        return istft_mag_phase(spec.abs() * mask, spec.angle(), self.cfg.stft,
                               length=noisy.shape[-1])

    @torch.inference_mode()
    def auto(self, noisy: torch.Tensor) -> torch.Tensor:
        """[B, L] noisy -> [B, L] enhanced through the model family's
        forward adapter (mask models, CRUSE+DF and MTFAA)."""
        spec = stft(noisy, self.cfg.stft)
        enhanced_ri = self._forward(torch.stack([spec.real, spec.imag], dim=-1))
        return istft((enhanced_ri[..., 0], enhanced_ri[..., 1]), self.cfg.stft,
                     length=noisy.shape[-1])

    def _enhance(self, noisy: np.ndarray) -> tuple[np.ndarray, float]:
        """Enhance on the device; returns (enhanced, wall seconds)."""
        x = torch.from_numpy(np.ascontiguousarray(noisy, np.float32)).to(self.device)
        t1 = time.perf_counter()
        enhanced = self._strategy(x).cpu().numpy()  # the copy waits for the device
        return enhanced, time.perf_counter() - t1

    def _emit(self, name: str, out: np.ndarray, rtf: float, write: bool):
        if (np.abs(out) > 1).any():
            log(f"Warning: enhanced is not in the range [-1, 1], {name}")
        scaled = to_int16_scaled(out)
        if write:
            write_wav(str(self.enhanced_dir / f"{name}.wav"), scaled, self.cfg.sr)
        return name, scaled, rtf

    def run_batched(self, wavs: list, names: list, batch_size: Optional[int] = None,
                    write: bool = True) -> list:
        """Throughput mode: pad utterances to one hop-aligned length, stack
        them into fixed-size batches (a ragged tail repeats its last row) and
        trim each output back to its utterance's length. Returns (name,
        enhanced int16, rtf) tuples, rtf being the batch's wall time over its
        summed audio seconds."""
        if len(wavs) != len(names) or not wavs:
            raise ValueError("need as many names as wavs, and at least one")
        batch_size = batch_size or min(len(wavs), 8)
        hop = self.cfg.stft.hop_length
        lengths = [w.shape[-1] for w in wavs]
        padded_len = -(-max(lengths) // hop) * hop
        stacked = np.stack([np.pad(np.asarray(w, np.float32), (0, padded_len - w.shape[-1]))
                            for w in wavs])
        results = []
        for start in range(0, len(wavs), batch_size):
            chunk = stacked[start : start + batch_size]
            real = chunk.shape[0]
            if real < batch_size:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - real, axis=0)])
            enhanced, seconds = self._enhance(chunk)
            rtf = seconds / (sum(lengths[start : start + real]) / self.cfg.sr)
            self.rtf_history.append(rtf)
            log(f"batch [{start}:{start + real}] x{padded_len / self.cfg.sr:.1f}s, rtf: {rtf}")
            for i in range(real):
                results.append(self._emit(names[start + i], enhanced[i, : lengths[start + i]],
                                          rtf, write))
        return results

    def __call__(self, dataloader: Iterable, write: bool = True) -> list:
        """dataloader yields dicts {"noisy": [1, L], "name": [str]}, one
        utterance per forward. Returns (name, enhanced int16, rtf) tuples."""
        results = []
        for batch in dataloader:
            name = batch["name"][0] if isinstance(batch.get("name"), (list, tuple)) \
                else batch.get("name", "utt")
            enhanced, seconds = self._enhance(batch["noisy"])
            enhanced = enhanced[0]
            rtf = seconds / (len(enhanced) / self.cfg.sr)
            self.rtf_history.append(rtf)
            log(f"{name}, rtf: {rtf}")
            results.append(self._emit(name, enhanced, rtf, write))
        return results
