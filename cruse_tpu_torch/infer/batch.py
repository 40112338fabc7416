"""Batch inferencer (counterpart of ``cruse_tpu/infer/batch.py``), single device.

Enhances (noisy, name) pairs with one of five strategies:

- ``mag_to_mag``: STFT -> compressed magnitude -> model mask -> masked
  magnitude with the noisy phase -> iSTFT (mask models: CRUSE, DFSMN);
- ``complex_mask``: STFT -> ``compress(|X|)`` -> the model's compressed
  cIRM, decompressed -> the noisy spectrum times the complex mask -> iSTFT
  (FullSubNet);
- ``auto``: STFT -> the model family's forward adapter
  (``train.step.forward_for_model``) on the RI spectrum -> iSTFT (CRUSE and
  DFSMN, whose mask multiplies the noisy spectrum;
  CRUSE+DF, whose deep filter runs on the low bins; MTFAA and BSRNN, which
  emit the enhanced complex spectrum; FullSubNet, whose cIRM multiplies it; McCruse,
  on ``[B, M, L]``, through the multi-channel adapter);
- ``multi_channel_directional``: ``[B, M, L]`` -> the multi-channel STFT ->
  the directional features (``dsp/features.py``) -> McCruse's mask on the
  reference mic's spectrum (``McCruseConfig.reference_channel``) -> iSTFT;
- ``multi_channel_mag_to_mag``: ``[B, C, L]`` -> every channel's compressed
  magnitude ``[B, C, T, F]`` -> the model's enhanced magnitude -> with the
  phase of channel ``InferencerConfig.reference_channel`` -> iSTFT (no zoo
  model of either package takes this input; the strategy is the JAX
  package's, for a model that does).

``mag_to_mag`` and ``multi_channel_directional`` apply the optional mask
post-filter (``sin`` or ``envelope``, ``dsp/mask.py``); the other strategies
ignore it, as the JAX package does, and say so once. ``enhance_long``
enhances long audio as 50 % overlapping chunks, one strategy call a chunk,
stitched by ``overlap_cat``. Outputs are scaled to int16 at 0.8 of full
scale, logged with their real-time factor and optionally written as wavs;
a multi-channel strategy's output is one channel.

Int8 weights are loaded dequantized (``nn.quantize.load_dequantized``):
the inferencer runs float32 weights. Not ported yet, and refused rather
than ignored: the device mesh.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from cruse_tpu_torch.data.wavio import to_int16_scaled, write_wav
from cruse_tpu_torch.dsp.features import overlap_cat
from cruse_tpu_torch.dsp.mask import complex_mul, decompress_cirm, envelope_postfilter, postfilter_sin
from cruse_tpu_torch.dsp.features import directional_features_from_ri
from cruse_tpu_torch.dsp.stft import StftConfig, istft, istft_mag_phase, mc_stft, stft
from cruse_tpu_torch.models.bsrnn import BSRNN
from cruse_tpu_torch.models.cruse_df import CruseDfNet
from cruse_tpu_torch.models.fullsubnet import FullSubNet
from cruse_tpu_torch.models.mc_cruse import McCruseNet
from cruse_tpu_torch.models.mtfaa import MtfaaNet
from cruse_tpu_torch.train.step import forward_for_model
from cruse_tpu_torch.utils.config import log


@dataclasses.dataclass
class InferencerConfig:
    type: str = "mag_to_mag"  # strategy method name: one of STRATEGIES
    sr: int = 16000
    stft: StftConfig = StftConfig(n_fft=320, hop_length=160)
    output_dir: str = "enhanced"
    reference_channel: int = 0  # multi_channel_mag_to_mag: the channel whose phase the output takes
    postfilter: Optional[str] = None  # mask post-filter: "sin" or "envelope"


STRATEGIES = ("mag_to_mag", "complex_mask", "auto", "multi_channel_directional", "multi_channel_mag_to_mag")
POSTFILTERS = {"sin": postfilter_sin, "envelope": envelope_postfilter}
MASK_STRATEGIES = ("mag_to_mag", "multi_channel_directional")  # the strategies that apply a post-filter


class BatchInferencer:
    """Enhance utterances with a model on one ``device``: the card unless the
    caller asks for the CPU (``device="cpu"``); a CUDA device that is not
    there is an error. The model is moved there and put in eval mode
    (BatchNorm uses its running stats)."""

    def __init__(self, model: torch.nn.Module, config: InferencerConfig,
                 device: torch.device | str = "cuda"):
        if config.type not in STRATEGIES:
            raise ValueError(f"unknown inferencer strategy {config.type!r} ({', '.join(STRATEGIES)})")
        if config.postfilter is not None and config.postfilter not in POSTFILTERS:
            raise ValueError(f"unknown postfilter {config.postfilter!r} (known: {', '.join(POSTFILTERS)})")
        if config.postfilter is not None and config.type not in MASK_STRATEGIES:
            log(f"postfilter {config.postfilter!r} is ignored by the {config.type} strategy "
                f"({' and '.join(MASK_STRATEGIES)} apply it)")
        if config.type == "mag_to_mag" and isinstance(model, (CruseDfNet, MtfaaNet, BSRNN, FullSubNet, McCruseNet)):
            raise ValueError(f"mag_to_mag takes a mask model; {type(model).__name__} runs with type='"
                             + {FullSubNet: "complex_mask", McCruseNet: "multi_channel_directional"}.get(
                                 type(model), "auto") + "'")
        if config.type == "complex_mask" and not isinstance(model, FullSubNet):
            raise ValueError(f"complex_mask takes a cIRM model (FullSubNet); {type(model).__name__} "
                             "runs with type='auto'")
        if config.type == "multi_channel_directional" and not isinstance(model, McCruseNet):
            raise ValueError(f"multi_channel_directional takes the multi-channel McCruseNet; "
                             f"{type(model).__name__} runs with a single-channel strategy")
        if config.type == "multi_channel_mag_to_mag" and isinstance(model, McCruseNet):
            raise ValueError("McCruseNet takes directional features, not magnitudes: it runs with "
                             "type='multi_channel_directional' or 'auto'")
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
        return self._mag_to_mag_impl(noisy)

    @torch.inference_mode()
    def complex_mask(self, noisy: torch.Tensor) -> torch.Tensor:
        """[B, L] noisy -> [B, L] enhanced: the model's compressed cIRM,
        decompressed, times the noisy spectrum."""
        return self._complex_mask_impl(noisy)

    @torch.inference_mode()
    def auto(self, noisy: torch.Tensor) -> torch.Tensor:
        """[B, L] noisy ([B, M, L] for McCruse) -> [B, L] enhanced through the
        model family's forward adapter."""
        return self._auto_impl(noisy)

    @torch.inference_mode()
    def multi_channel_directional(self, noisy: torch.Tensor) -> torch.Tensor:
        """[B, M, L] noisy -> [B, L] enhanced: McCruse's mask, from the
        directional features, on the reference mic's spectrum."""
        return self._multi_channel_directional_impl(noisy)

    @torch.inference_mode()
    def multi_channel_mag_to_mag(self, noisy: torch.Tensor) -> torch.Tensor:
        """[B, C, L] noisy -> [B, L] enhanced: the model's magnitude from all
        channels' magnitudes, with the reference channel's phase."""
        return self._multi_channel_mag_to_mag_impl(noisy)

    # the strategies' bodies without their inference mode, for torch.export
    # (infer/export.py traces them under torch.no_grad())

    def _mag_to_mag_impl(self, noisy: torch.Tensor) -> torch.Tensor:
        spec = stft(noisy, self.cfg.stft)
        mask, _ = self.model(self.model.compress(spec.abs()))
        if self.cfg.postfilter is not None:
            mask = POSTFILTERS[self.cfg.postfilter](mask)
        return istft_mag_phase(spec.abs() * mask, spec.angle(), self.cfg.stft,
                               length=noisy.shape[-1])

    def _complex_mask_impl(self, noisy: torch.Tensor) -> torch.Tensor:
        spec = stft(noisy, self.cfg.stft)
        crm, _ = self.model(self.model.compress(spec.abs()))
        crm = decompress_cirm(crm)
        r, i = complex_mul(spec.real, spec.imag, crm[..., 0], crm[..., 1])
        return istft((r, i), self.cfg.stft, length=noisy.shape[-1])

    def _auto_impl(self, noisy: torch.Tensor) -> torch.Tensor:
        spec = mc_stft(noisy, self.cfg.stft) if noisy.dim() == 3 else stft(noisy, self.cfg.stft)
        enhanced_ri = self._forward(torch.stack([spec.real, spec.imag], dim=-1))
        return istft((enhanced_ri[..., 0], enhanced_ri[..., 1]), self.cfg.stft,
                     length=noisy.shape[-1])

    def _multi_channel_directional_impl(self, noisy: torch.Tensor) -> torch.Tensor:
        cfg = self.model.config
        specs = mc_stft(noisy, self.cfg.stft)  # [B, M, T, F]
        feats = directional_features_from_ri(torch.stack([specs.real, specs.imag], dim=-1), cfg.mic_pairs,
                                             cfg.reference_channel, cfg.use_sin_ipd)
        mask, _ = self.model(feats)
        if self.cfg.postfilter is not None:
            mask = POSTFILTERS[self.cfg.postfilter](mask)
        return istft(specs[:, cfg.reference_channel] * mask, self.cfg.stft, length=noisy.shape[-1])

    def _multi_channel_mag_to_mag_impl(self, noisy: torch.Tensor) -> torch.Tensor:
        specs = mc_stft(noisy, self.cfg.stft)  # [B, C, T, F]
        enhanced_mag, _ = self.model(self.model.compress(specs.abs()))
        return istft_mag_phase(enhanced_mag, specs[:, self.cfg.reference_channel].angle(), self.cfg.stft,
                               length=noisy.shape[-1])

    @torch.inference_mode()
    def enhance_long(self, noisy: torch.Tensor, chunk_seconds: float = 30.0) -> torch.Tensor:
        """[B, L] ([B, M, L] for a multi-channel strategy) -> [B, L] with bounded memory: the strategy on 50 %
        overlapping chunks of ``chunk_seconds`` (cut to an even number of
        hops), the audio zero-padded to whole half-chunks, the chunks stitched
        by ``overlap_cat`` (their shared halves averaged) and trimmed to L.
        Audio no longer than a chunk takes one strategy call."""
        chunk = int(chunk_seconds * self.cfg.sr)
        chunk -= chunk % (2 * self.cfg.stft.hop_length)  # even and hop-aligned
        if chunk <= 0:
            raise ValueError(f"chunk_seconds={chunk_seconds} is shorter than two hops")
        noisy = noisy.to(self.device)
        length = noisy.shape[-1]
        if length <= chunk:
            return self._strategy(noisy)
        half = chunk // 2
        num_halves = -(-(length - chunk) // half)
        noisy = torch.nn.functional.pad(noisy, (0, num_halves * half + chunk - length))
        outs = [self._strategy(noisy[..., i * half : i * half + chunk]) for i in range(num_halves + 1)]
        return overlap_cat(outs)[..., :length]

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
        trim each output back to its utterance's length (a wav is [L], or
        [M, L] for a multi-channel strategy). Returns (name,
        enhanced int16, rtf) tuples, rtf being the batch's wall time over its
        summed audio seconds."""
        if len(wavs) != len(names) or not wavs:
            raise ValueError("need as many names as wavs, and at least one")
        batch_size = batch_size or min(len(wavs), 8)
        hop = self.cfg.stft.hop_length
        lengths = [w.shape[-1] for w in wavs]
        padded_len = -(-max(lengths) // hop) * hop
        stacked = np.stack([np.pad(np.asarray(w, np.float32),
                                   [(0, 0)] * (w.ndim - 1) + [(0, padded_len - w.shape[-1])]) for w in wavs])
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
        """dataloader yields dicts {"noisy": [1, L] (or [1, M, L]), "name":
        [str]}, one utterance per forward. Returns (name, enhanced int16, rtf) tuples."""
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
