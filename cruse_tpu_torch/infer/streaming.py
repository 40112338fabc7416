"""Frame-by-frame streaming enhancement (counterpart of
``cruse_tpu/infer/streaming.py``), the low-latency causal path.

Each hop carries:

- the last ``n_fft - hop`` input samples (the analysis frame; every mic's,
  ``[B, M, n_fft - hop]``, for the multi-mic McCruse);
- the model's state (CRUSE: conv histories and GRU states, and for CRUSE+DF
  the deep filter's last ``2*t_dim`` masked low-bin frames; DFSMN: each
  block's left context; windowed MTFAA: its conv and TFCM histories, rolling
  attention caches and deep-filter frames; FullSubNet: its GRU states, the
  sub-band ones ``[B·F, H]``, and the cumulative norms' running sums;
  McCruse: CRUSE's; a causal BSRNN: its 74 cumulative norms' running
  sums ``[B]`` and its time LSTMs' ``(h, c)``, ``[B·31, 1, 2N]``);
- the overlap-add tail of the synthesis frames.

A step assembles the frame, takes its windowed DFT (one small matrix
product), runs the model at T = 1, applies the mask (and, for CRUSE+DF, the
deep filter over the carried frames; MTFAA takes the RI frame and returns
the enhanced one itself, and so does BSRNN; FullSubNet's decompressed cIRM
multiplies the frame's spectrum; McCruse takes every mic's frame, ``[B, M,
hop]`` in, and its mask, from the frame's directional features, multiplies
the reference mic's spectrum), takes the windowed inverse DFT, overlap-adds,
and emits ``hop`` samples (one channel) divided by the steady-state window
envelope. Primed with the first ``n_fft - hop`` samples, the stream equals
the offline ``center=False`` path after the overlap-add warm-up.

On the card a hop launches, for CRUSE and McCruse, the grouped-GRU kernel
twice (one per bank) and, for CRUSE+DF, the deep-filter kernel once; for a windowed MTFAA
the stencil kernel once a TFCM block (24 at config 5b) and the deep-filter
kernel once; for FullSubNet the grouped-GRU kernel four times at its
published depth (one a GRU layer); DFSMN has no kernel of its own, and
BSRNN's LSTMs are cuDNN's. The rest is PyTorch's own kernels. ``run`` is a
host loop over hops (the JAX package runs it as one ``lax.scan`` dispatch,
which eager PyTorch has no counterpart of).

Ported for CruseNet, CruseDfNet, DfsmnNet, a windowed MtfaaNet,
FullSubNet with the cumulative norm, McCruseNet and a causal BSRNN.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from cruse_tpu_torch.dsp.features import directional_features_from_ri
from cruse_tpu_torch.dsp.stft import StftConfig, _analysis_kernel, _padded_window, _synthesis_kernel
# the carry's type lives with the artifact loader, which must read it without the models
from cruse_tpu_torch.infer.artifact import StreamState
from cruse_tpu_torch.models.bsrnn import BSRNN, NUM_BINS as BSRNN_BINS
from cruse_tpu_torch.models.cruse import CruseNet, cruse_init_state
from cruse_tpu_torch.models.cruse_df import CruseDfNet, apply_cruse_df_streaming, df_stream_init
from cruse_tpu_torch.dsp.mask import complex_mul, decompress_cirm
from cruse_tpu_torch.models.dfsmn import DfsmnNet
from cruse_tpu_torch.models.fullsubnet import FullSubNet
from cruse_tpu_torch.models.mc_cruse import McCruseNet
from cruse_tpu_torch.models.mtfaa import MtfaaNet

STREAMING_MODELS = (CruseNet, CruseDfNet, DfsmnNet, MtfaaNet, FullSubNet, McCruseNet, BSRNN)


def _steady_envelope(cfg: StftConfig) -> np.ndarray:
    """Steady-state overlap-add of the squared window, periodic over one hop."""
    w2 = _padded_window(cfg) ** 2
    env = np.array([w2[j :: cfg.hop_length].sum() for j in range(cfg.hop_length)])
    return np.where(env > 1e-11, env, 1.0).astype(np.float32)


class StreamingEnhancer:
    """Drives a causal model frame by frame on the device its weights are
    on: CruseNet and DfsmnNet apply their magnitude mask per frame (DFSMN is
    benchmark config 4); CruseDfNet also runs its complex deep filter over the
    rolling masked-spectrum history (config 3's streaming path); a windowed
    MtfaaNet (config 5b) enhances the RI spectrum through its own carried
    state; FullSubNet (cumulative norm, no look-ahead) applies its complex
    mask per frame; McCruseNet takes ``[B, M, hop]`` hops and emits the
    enhanced reference mic; a causal BSRNN (cumulative norms, carried time
    LSTMs) takes the RI frame and returns the enhanced one."""

    def __init__(self, model: torch.nn.Module, cfg: StftConfig):
        if cfg.center:
            raise ValueError("the streaming path takes a center=False StftConfig")
        if isinstance(model, CruseNet) and model.config.emit_features:
            raise ValueError("stream CRUSE+DF as a CruseDfNet, not as its emit_features trunk")
        if not isinstance(model, STREAMING_MODELS):
            raise NotImplementedError(
                f"streaming {type(model).__name__} is not ported (ported: "
                f"{', '.join(m.__name__ for m in STREAMING_MODELS)})")
        if isinstance(model, MtfaaNet) and model.config.attention_window is None:
            raise ValueError("MTFAA streaming needs a finite attention_window (the full-causal "
                             "configuration cannot carry ASA state)")
        if isinstance(model, FullSubNet) and model.config.norm != "cumulative_laplace_norm":
            raise ValueError("FullSubNet streaming needs norm='cumulative_laplace_norm' "
                             "(the offline norms read the whole utterance by construction)")
        if isinstance(model, FullSubNet) and model.config.look_ahead != 0:
            raise ValueError("FullSubNet streaming needs look_ahead=0 (the look-ahead "
                             "variant delays the output by future frames)")
        if isinstance(model, BSRNN) and not model.config.causal:
            raise ValueError("BSRNN streaming needs causal=True (the offline variant's GroupNorm(1, C) "
                             "layers read the whole time axis)")
        if isinstance(model, BSRNN) and cfg.num_bins != BSRNN_BINS:
            raise ValueError(f"BSRNN's band table covers {BSRNN_BINS} bins; the STFT config has "
                             f"{cfg.num_bins} (use n_fft={2 * (BSRNN_BINS - 1)})")
        if isinstance(model, DfsmnNet) and model.config.right_frames > 0:
            raise ValueError("DFSMN streaming needs right_frames=0 (a look-ahead DfsmnNet reads "
                             "future frames)")
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self._is_df = isinstance(model, CruseDfNet)
        self._is_complex = isinstance(model, MtfaaNet)
        self._is_bsrnn = isinstance(model, BSRNN)
        self._is_cirm = isinstance(model, FullSubNet)
        self.mics = model.config.num_mics if isinstance(model, McCruseNet) else 0  # 0: one channel
        self._num_bins = cfg.num_bins
        self._ana = torch.from_numpy(_analysis_kernel(cfg).T.copy()).to(self.device)  # [N, 2F]
        self._syn = torch.from_numpy(_synthesis_kernel(cfg)).to(self.device)  # [2F, N]
        self._env_hop = torch.from_numpy(_steady_envelope(cfg)).to(self.device)

    def init_state(self, batch_size: int) -> StreamState:
        keep = self.cfg.n_fft - self.cfg.hop_length
        if self._is_df:
            model_state = (self.model.init_state(batch_size, self.device),
                           df_stream_init(batch_size, self.model.config, self.device))
        elif isinstance(self.model, CruseNet):
            model_state = cruse_init_state(self.model.config, batch_size, self.device)
        else:
            model_state = self.model.init_state(batch_size, self.device)
        tail = (batch_size, self.mics, keep) if self.mics else (batch_size, keep)
        return StreamState(input_tail=torch.zeros(tail, device=self.device),
                           ola_tail=torch.zeros(batch_size, keep, device=self.device),
                           model_state=model_state)

    def prime(self, state: StreamState, samples: torch.Tensor) -> StreamState:
        """Pre-fill the analysis buffer with the utterance's first
        ``n_fft - hop`` samples (``[B, M, n_fft - hop]`` multi-mic). After priming, the stream equals the offline
        center=False path (without it, the stream starts from a zero buffer
        and its output is one hop late, the usual real-time behaviour)."""
        keep = self.cfg.n_fft - self.cfg.hop_length
        if samples.shape[-1] != keep:
            raise ValueError(f"prime takes the first {keep} samples, got {samples.shape[-1]}")
        return state._replace(input_tail=samples.to(state.input_tail))

    @torch.inference_mode()
    def step(self, state: StreamState, hop_samples: torch.Tensor):
        """One real-time hop: hop_samples [B, hop] ([B, M, hop] for McCruse)
        -> ([B, hop], new state)."""
        return self._step_impl(state, hop_samples)

    def _step_impl(self, state: StreamState, hop_samples: torch.Tensor):
        """``step`` without its inference mode, for ``torch.export``
        (``infer/export.py`` traces it under ``torch.no_grad()``)."""
        f = self._num_bins
        frame = torch.cat([state.input_tail, hop_samples.to(state.input_tail)], dim=-1)  # [B(, M), n]
        ri = frame @ self._ana  # [B(, M), 2F] windowed DFT
        if self.mics:
            cfg = self.model.config
            # one frame's features: the layer norm runs over frequency, so they are the offline frame's
            ri5 = torch.stack([ri[..., :f], ri[..., f:]], dim=-1)[:, :, None]  # [B, M, 1, F, 2]
            feats = directional_features_from_ri(ri5, cfg.mic_pairs, cfg.reference_channel, cfg.use_sin_ipd)
            mask, model_state = self.model(feats, state.model_state)
            m, ref = mask[:, 0], ri[:, cfg.reference_channel]
            return self._finish(state, frame, torch.cat([ref[:, :f] * m, ref[:, f:] * m], dim=-1), model_state)
        real, imag = ri[:, :f], ri[:, f:]
        if self._is_complex:
            cspec = torch.stack([real, imag], dim=-1)[:, None]  # [B, 1, F, 2]
            (enhanced, _mask), model_state = self.model(cspec, state.model_state)
            enh_ri = torch.cat([enhanced[:, 0].real, enhanced[:, 0].imag], dim=-1)
            return self._finish(state, frame, enh_ri, model_state)
        if self._is_bsrnn:
            enhanced, model_state = self.model(torch.stack([real, imag], dim=-1)[:, None], state.model_state)
            enh_ri = torch.cat([enhanced[:, 0].real, enhanced[:, 0].imag], dim=-1)
            return self._finish(state, frame, enh_ri, model_state)
        mag = torch.sqrt(real ** 2 + imag ** 2 + 1e-12)
        feat = self.model.compress(mag)[:, None, :]  # [B, 1, F]
        if self._is_cirm:
            crm, model_state = self.model(feat, state.model_state)
            crm = decompress_cirm(crm)[:, 0]  # [B, F, 2]
            r, i = complex_mul(real, imag, crm[..., 0], crm[..., 1])
            return self._finish(state, frame, torch.cat([r, i], dim=-1), model_state)
        if self._is_df:
            net_state, df_state = state.model_state
            (mask, coefs), net_state = self.model(feat, net_state)
            enhanced, df_state = apply_cruse_df_streaming(
                df_state, torch.complex(real, imag), mask[:, 0], coefs[:, 0], self.model.config,
                self.model.filter_fn)
            enh_ri = torch.cat([enhanced.real, enhanced.imag], dim=-1)
            model_state = (net_state, df_state)
        else:
            mask, model_state = self.model(feat, state.model_state)
            m = mask[:, 0]
            enh_ri = torch.cat([real * m, imag * m], dim=-1)  # [B, 2F]
        return self._finish(state, frame, enh_ri, model_state)

    def _finish(self, state, frame, enh_ri, model_state):
        """Windowed inverse frame, overlap-add, and the hop's output; frame is
        [B, n] or [B, M, n], the output and the overlap-add tail one channel."""
        hop = self.cfg.hop_length
        synth = enh_ri @ self._syn  # [B, n]
        ola = torch.nn.functional.pad(state.ola_tail, (0, hop)) + synth
        out = ola[:, :hop] / self._env_hop
        return out, StreamState(input_tail=frame[..., hop:], ola_tail=ola[:, hop:],
                                model_state=model_state)

    def step_multi(self, state: StreamState, samples: torch.Tensor):
        """k consecutive hops, samples [B(, M), k*hop] -> ([B, k*hop], new state):
        the same as k ``step`` calls (the JAX package makes them one
        dispatch; here they are k steps)."""
        hop = self.cfg.hop_length
        if samples.shape[-1] % hop:
            raise ValueError(f"{samples.shape[-1]} samples are not whole {hop}-sample hops")
        outs = []
        for i in range(samples.shape[-1] // hop):
            out, state = self.step(state, samples[..., i * hop : (i + 1) * hop])
            outs.append(out)
        return torch.cat(outs, dim=-1), state

    def run(self, wav: torch.Tensor) -> torch.Tensor:
        """Enhance whole utterances [B, L] ([B, M, L] multi-mic) hop by hop, primed with the first
        ``n_fft - hop`` samples so that the output aligns with the offline
        center=False path. Returns [B, hop * num_hops], num_hops =
        (L - (n_fft - hop)) // hop."""
        keep = self.cfg.n_fft - self.cfg.hop_length
        wav = wav.to(self.device)
        state = self.prime(self.init_state(wav.shape[0]), wav[..., :keep])
        num_hops = (wav.shape[-1] - keep) // self.cfg.hop_length
        out, _ = self.step_multi(state, wav[..., keep : keep + num_hops * self.cfg.hop_length])
        return out

    def measure_rtf(self, wav: np.ndarray, sr: int = 16000, num_frames: int = 50) -> float:
        """Per-hop real-time factor of the streaming step: wall time per hop,
        device synchronised, over the hop's audio duration (< 1 is faster
        than real time). The first hop is a warm-up."""
        hop = self.cfg.hop_length
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(self.device)
        state = self.init_state(x.shape[0])
        out, state = self.step(state, x[..., :hop])
        self._synchronize()
        num = min(num_frames, x.shape[-1] // hop - 1)
        t0 = time.perf_counter()
        for i in range(1, num + 1):
            out, state = self.step(state, x[..., i * hop : (i + 1) * hop])
        self._synchronize()
        return (time.perf_counter() - t0) / num / (hop / sr)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
