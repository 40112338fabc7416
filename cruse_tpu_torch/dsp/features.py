"""Feature helpers of the port (counterpart of parts of
``cruse_tpu/dsp/features.py``): ``overlap_cat``, the stitch of
``BatchInferencer.enhance_long``, ``frame_vad``, the SDNR loss's voice
activity, ``drop_band``, FullSubNet's frequency subsampling, and the
multi-channel front end of McCruse: ``log_power_spectrum``,
``channelwise_layer_norm``, ``ipd_features``, ``directional_features_from_ri``
and ``DirectionalFeatureComputer``."""
from __future__ import annotations

from typing import Sequence

import torch

from cruse_tpu_torch.dsp.stft import StftConfig, mc_stft


def overlap_cat(chunks: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Stitch 50 %-overlapping chunks of one length along ``dim``, averaging
    the halves that two neighbours share."""
    pieces = []
    for i, chunk in enumerate(chunks):
        half = chunk.shape[dim] // 2
        first, last = chunk.narrow(dim, 0, half), chunk.narrow(dim, half, chunk.shape[dim] - half)
        if i == 0:
            pieces += [first, last]
        else:
            pieces[-1] = (pieces[-1] + first) / 2.0
            pieces.append(last)
    return torch.cat(pieces, dim=dim)


def frame_vad(mag: torch.Tensor, threshold_db: float = -60.0) -> torch.Tensor:
    """Per-frame binary voice activity of a magnitude spectrogram
    ``[..., T, F]``: a frame is active when its energy is within
    ``threshold_db`` of the utterance's loudest frame. Returns ``[..., T, 1]``."""
    frame_energy = (mag ** 2).sum(dim=-1)
    peak = frame_energy.amax(dim=-1, keepdim=True)
    db = 10.0 * torch.log10(frame_energy / (peak + 1e-12) + 1e-12)
    return (db > threshold_db).to(mag.dtype)[..., None]


def drop_band(x: torch.Tensor, num_groups: int = 2) -> torch.Tensor:
    """FullSubNet's frequency subsampling: ``[B, C, F, T] -> [B, C, F //
    num_groups, T]``, batch rows g, g + n, ... keeping bins g, g + n, ...
    (n = ``num_groups``), the groups stacked in order; F is first cut to a
    multiple of n. Needs B > n."""
    batch_size, _, num_freqs, _ = x.shape
    if batch_size <= num_groups:
        raise ValueError(f"batch {batch_size} must exceed num_groups={num_groups}")
    if num_groups <= 1:
        return x
    x = x[:, :, : num_freqs - num_freqs % num_groups]
    return torch.cat([x[g::num_groups, :, g::num_groups] for g in range(num_groups)], dim=0)


# ----------------------- multi-channel features -----------------------


def log_power_spectrum(mag: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return torch.log(mag ** 2 + eps)


def channelwise_layer_norm(x: torch.Tensor, scale=None, bias=None, eps: float = 1e-5,
                           dim: int = -1) -> torch.Tensor:
    """LayerNorm over ``dim`` at every other position, without parameters
    unless ``scale`` / ``bias`` are given (the biased variance)."""
    mu = x.mean(dim=dim, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=dim, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def ipd_features(phase: torch.Tensor, mic_pairs, use_sin: bool = False) -> torch.Tensor:
    """cos (and sin) of the inter-channel phase difference of each mic pair:
    ``phase [B, M, T, F] -> [B, P, T, F]`` (``[B, 2P, T, F]`` with sin, the
    cosines first)."""
    diff = torch.stack([phase[:, left] - phase[:, right] for left, right in mic_pairs], dim=1)
    return torch.cat([torch.cos(diff), torch.sin(diff)] if use_sin else [torch.cos(diff)], dim=1)


def directional_features_from_ri(ri: torch.Tensor, mic_pairs, lps_channel: int = 0,
                                 use_sin_ipd: bool = False, eps: float = 1e-8) -> torch.Tensor:
    """Directional features of a multi-channel RI spectrum ``[B, M, T, F, 2]``
    -> ``[B, T, F + P·F (+ P·F)]``: the log power of channel ``lps_channel``
    normalized over frequency at each frame, then each pair's cos (and sin)
    IPD, pair-major. The magnitude is ``sqrt(re² + im² + eps)`` and the log
    power ``log(mag² + eps)``; the phase is ``atan2(im, re)`` (0 at an exact
    zero bin)."""
    real, imag = ri[..., 0], ri[..., 1]
    mag = torch.sqrt(real ** 2 + imag ** 2 + eps)
    phase = torch.atan2(imag, real)
    lps = channelwise_layer_norm(log_power_spectrum(mag[:, lps_channel], eps), dim=-1)
    ipds = ipd_features(phase, mic_pairs, use_sin=use_sin_ipd)  # [B, P, T, F]
    b, p, t, f = ipds.shape
    return torch.cat([lps, ipds.permute(0, 2, 1, 3).reshape(b, t, p * f)], dim=-1)


class DirectionalFeatureComputer:
    """The multi-channel spatial front end from waveforms: ``[B, M, L] ->
    (features, magnitude, phase, real, imag)``, the last four ``[B, M, T,
    F]``. The features are ``[B, T, D]``, the normalized log power of
    ``lps_channel`` and each pair's IPDs as ``directional_features_from_ri``
    stacks them; with ``channel_stacked=True`` they are ``[B, 1 + P (+ P), T,
    F]`` channel-major instead, the log power unnormalized. The cos IPDs are
    always there (the JAX package's ``use_cos_ipd`` selects nothing)."""

    def __init__(self, stft_config: StftConfig, mic_pairs, lps_channel: int = 0, use_sin_ipd: bool = False,
                 channel_stacked: bool = False, eps: float = 1e-8):
        self.cfg = stft_config
        self.mic_pairs = [tuple(p) for p in mic_pairs]
        self.lps_channel = lps_channel
        self.use_sin_ipd = use_sin_ipd
        self.channel_stacked = channel_stacked
        self.eps = eps

    @property
    def directional_feature_dim(self) -> int:
        per_pair = 1 + int(self.use_sin_ipd)
        if self.channel_stacked:
            return 1 + len(self.mic_pairs) * per_pair
        f = self.cfg.num_bins
        return f + len(self.mic_pairs) * f * per_pair

    def __call__(self, y: torch.Tensor):
        if y.dim() != 3:
            raise ValueError(f"[B, M, L] expected, got {tuple(y.shape)}")
        spec = mc_stft(y, self.cfg)  # [B, M, T, F]
        real, imag = spec.real, spec.imag
        mag = torch.sqrt(real ** 2 + imag ** 2 + self.eps)
        phase = torch.atan2(imag, real)
        lps = log_power_spectrum(mag[:, self.lps_channel], self.eps)  # [B, T, F]
        ipds = ipd_features(phase, self.mic_pairs, use_sin=self.use_sin_ipd)  # [B, P, T, F]
        if self.channel_stacked:
            feats = torch.cat([lps[:, None], ipds], dim=1)
        else:
            b, p, t, f = ipds.shape
            feats = torch.cat([channelwise_layer_norm(lps, dim=-1),
                               ipds.permute(0, 2, 1, 3).reshape(b, t, p * f)], dim=-1)
        return feats, mag, phase, real, imag
