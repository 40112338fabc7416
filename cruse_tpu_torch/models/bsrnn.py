"""BSRNN: the band-split RNN with a per-bin three-tap complex mask
(counterpart of ``cruse_tpu/models/bsrnn.py:1-245``).

- Band split: the complex spectrum ``[B, T, 257]`` as RI, cut into the 31
  bands of ``BAND_WIDTHS``; each band normalized (``GroupNorm1``, or
  ``CausalNorm1`` in the causal variant) and projected by its own Linear to
  N channels -> ``[B, T, K=31, N]``.
- ``num_layer`` residual time blocks: norm -> a unidirectional LSTM over
  time (hidden 2N) on the bands folded into the batch (``[B·K, T, N]``) ->
  a Linear back to N.
- ``num_layer`` residual band blocks: norm -> a bidirectional LSTM over the
  31 bands of each frame (``[B·T, K, N]``; no time state) -> a Linear to N.
- Mask decoder: per band norm -> Linear 4N -> tanh -> Linear 12w -> GLU ->
  ``[B, T, F, 3, 2]``, three complex taps a bin, applied across adjacent
  bins (``apply_three_tap_mask``).

Every LSTM is ``nn/lstm.py::LSTM``, cuDNN's RNN on the card; the per-band
Linears and norms are 31 small PyTorch ops each, as the JAX package keeps
them a Python loop. The reference prototype has no Pallas kernel on this
path, so the port has none either.

``causal=True`` swaps every ``GroupNorm1`` (which reads the whole utterance)
for ``CausalNorm1``, a cumulative layer norm with the same affine, so the
model streams: its state carries the norms' running (sum, power, count)
``[B]`` (31 + L + L + 31 of them) and the time LSTMs' ``(h, c)``, each
``[B·31, 1, 2N]``; a chunked call continues where the last one stopped.

MetricGAN+'s pieces (``cruse_tpu/models/bsrnn.py:248-308``) live here too:
``Discriminator``, which regresses a quality score from a (clean, estimate)
magnitude pair, with its ``SpectralNorm`` (flax's, not torch's) and
``LearnableSigmoid``, and ``batch_quality_scores``, the normalized PESQ it
learns. ``train/metricgan.py`` trains the two nets in turn.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cruse_tpu_torch.models.dfsmn import _linear
from cruse_tpu_torch.nn.lstm import LSTM
from cruse_tpu_torch.nn.norms import cumulative_layer_norm_carry

# band widths over 257 bins (the reference prototype's table)
BAND_WIDTHS: Tuple[int, ...] = (
    2, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
    16, 16, 16, 16, 16, 16, 16, 17,
)
NUM_BINS = sum(BAND_WIDTHS)  # 257: n_fft = 512


@dataclasses.dataclass(frozen=True)
class BsrnnConfig:
    num_channel: int = 128
    num_layer: int = 6
    causal: bool = False


class _Affine(nn.Module):
    """The learnable per-channel affine of a norm, on the last axis (flax
    names: ``scale``, ``bias``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class GroupNorm1(_Affine):
    """torch's GroupNorm(1, C) over channels-last input: every non-batch
    axis normalized together (time too), biased variance, eps 1e-5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim()))
        mu = x.mean(dim=axes, keepdim=True)
        var = torch.square(x - mu).mean(dim=axes, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.scale + self.bias


class CausalNorm1(_Affine):
    """The causal GroupNorm(1, C): each frame normalized by the cumulative
    mean and variance of every feature of the frames up to it
    (``cumulative_layer_norm_carry``). ``x [B, T, ...]``, ``carry`` None
    (a fresh utterance) or (sum, power, count) ``[B]`` -> ``(y, carry)``."""

    def forward(self, x: torch.Tensor, carry=None):
        b, t = x.shape[:2]
        y, new_carry = cumulative_layer_norm_carry(x.reshape(b, t, -1), carry)
        return y.reshape(x.shape) * self.scale + self.bias, new_carry


def _norm(causal: bool, channels: int) -> nn.Module:
    return CausalNorm1(channels) if causal else GroupNorm1(channels)


def _apply_norm(norm: nn.Module, x: torch.Tensor, carry, new_carries: list) -> torch.Tensor:
    """A norm of either kind; a causal one's carry goes to ``new_carries``."""
    if isinstance(norm, CausalNorm1):
        x, c = norm(x, carry)
        new_carries.append(c)
        return x
    return norm(x)


class BandSplit(nn.Module):
    """RI spectrum ``[B, T, F, 2]`` -> band features ``[B, T, K, N]`` (and
    the norms' carries, causal)."""

    def __init__(self, channels: int, causal: bool, generator: torch.Generator):
        super().__init__()
        for i, w in enumerate(BAND_WIDTHS):
            setattr(self, f"norm_{i}", _norm(causal, 2 * w))
            setattr(self, f"fc_{i}", _linear(generator, 2 * w, channels))

    def forward(self, x_ri: torch.Tensor, carries=None):
        outs, new_carries, start = [], [], 0
        for i, w in enumerate(BAND_WIDTHS):
            xb = x_ri[:, :, start : start + w].reshape(*x_ri.shape[:2], 2 * w)
            xb = _apply_norm(getattr(self, f"norm_{i}"), xb, None if carries is None else carries[i], new_carries)
            outs.append(getattr(self, f"fc_{i}")(xb))
            start += w
        return torch.stack(outs, dim=2), tuple(new_carries)


class MaskDecoder(nn.Module):
    """``[B, T, K, N]`` -> three complex taps a bin ``[B, T, F, 3, 2]`` (and
    the norms' carries, causal)."""

    def __init__(self, channels: int, causal: bool, generator: torch.Generator):
        super().__init__()
        for i, w in enumerate(BAND_WIDTHS):
            setattr(self, f"norm_{i}", _norm(causal, channels))
            setattr(self, f"fc1_{i}", _linear(generator, channels, 4 * channels))
            setattr(self, f"fc2_{i}", _linear(generator, 4 * channels, 12 * w))

    def forward(self, z: torch.Tensor, carries=None):
        outs, new_carries = [], []
        for i, w in enumerate(BAND_WIDTHS):
            xb = _apply_norm(getattr(self, f"norm_{i}"), z[:, :, i], None if carries is None else carries[i],
                             new_carries)
            xb = getattr(self, f"fc2_{i}")(torch.tanh(getattr(self, f"fc1_{i}")(xb)))
            a, gate = xb.chunk(2, dim=-1)
            outs.append((a * torch.sigmoid(gate)).reshape(*xb.shape[:-1], w, 3, 2))  # GLU -> 6w
        return torch.cat(outs, dim=2), tuple(new_carries)


def apply_three_tap_mask(x_ri: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """s[f] = m[f,0] x[f-1] + m[f,1] x[f] + m[f,2] x[f+1], complex, in RI
    arithmetic: ``x_ri [B, T, F, 2]``, ``m [B, T, F, 3, 2]`` -> ``[B, T, F,
    2]``. The first bin has no x[f-1] tap and the last no x[f+1]: the
    spectrum is padded with a zero bin each side, whose products add 0."""
    xp = torch.nn.functional.pad(x_ri, (0, 0, 1, 1))
    f = x_ri.shape[2]
    re = im = 0.0
    for tap in range(3):
        xr, xi = xp[:, :, tap : tap + f, 0], xp[:, :, tap : tap + f, 1]
        mr, mi = m[:, :, :, tap, 0], m[:, :, :, tap, 1]
        re = re + (mr * xr - mi * xi)
        im = im + (mr * xi + mi * xr)
    return torch.stack([re, im], dim=-1)


class BSRNN(nn.Module):
    """The complex spectrum ``[B, T, 257]`` (or its RI ``[B, T, 257, 2]``) ->
    ``(enhanced complex spectrum [B, T, 257], state)``; the state is None
    offline, the carried dict causal (``init_state``'s keys). Weights made
    from ``generator``: the LSTMs uniform in ±1/√H, the Linears
    lecun-normal with zero biases, the norms' affine 1 and 0."""

    def __init__(self, config: BsrnnConfig = BsrnnConfig(), generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
        gen = generator or torch.Generator().manual_seed(0)
        n, causal = cfg.num_channel, cfg.causal
        self.band_split = BandSplit(n, causal, gen)
        for i in range(cfg.num_layer):
            setattr(self, f"norm_t_{i}", _norm(causal, n))
            setattr(self, f"lstm_t_{i}", LSTM(n, 2 * n))
            setattr(self, f"fc_t_{i}", _linear(gen, 2 * n, n))
        for i in range(cfg.num_layer):
            setattr(self, f"norm_k_{i}", _norm(causal, n))
            setattr(self, f"lstm_k_{i}", LSTM(n, 2 * n, bidirectional=True))
            setattr(self, f"fc_k_{i}", _linear(gen, 4 * n, n))
        self.mask_decoder = MaskDecoder(n, causal, gen)
        for m in self.modules():
            if isinstance(m, LSTM):
                m.reset_parameters(gen)

    def compress(self, mag: torch.Tensor) -> torch.Tensor:
        """The identity (the uniform model API; BSRNN reads the spectrum)."""
        return mag

    def forward(self, spec: torch.Tensor, state: Optional[dict] = None, train: bool = False):
        """``train`` changes no arithmetic (the net has no BatchNorm or
        dropout), but a gradient through cuDNN's RNN needs training mode."""
        if train and not self.training:
            raise ValueError("train=True needs the model in training mode (model.train()): "
                             "cuDNN's RNN backward runs only from a training-mode forward")
        x_ri = torch.stack([spec.real, spec.imag], dim=-1) if spec.is_complex() else spec
        if x_ri.shape[-2:] != (NUM_BINS, 2):
            raise ValueError(f"BSRNN takes [B, T, {NUM_BINS}] complex or [B, T, {NUM_BINS}, 2] RI "
                             f"(n_fft = 512), got {tuple(spec.shape)}")
        cfg = self.config
        st = state if cfg.causal else None

        def carry(key, i):
            return None if st is None else st[key][i]

        z, split_c = self.band_split(x_ri, None if st is None else st["split"])
        b, t, k, n = z.shape
        skip = z
        time_norm_c, time_lstm_c, band_norm_c = [], [], []
        for i in range(cfg.num_layer):
            out = _apply_norm(getattr(self, f"norm_t_{i}"), skip, carry("time_norm", i), time_norm_c)
            out, lc = getattr(self, f"lstm_t_{i}")(out.transpose(1, 2).reshape(b * k, t, n),
                                                    carry("time_lstm", i))
            time_lstm_c.append(lc)
            out = getattr(self, f"fc_t_{i}")(out).reshape(b, k, t, n).transpose(1, 2)
            skip = skip + out
        for i in range(cfg.num_layer):
            out = _apply_norm(getattr(self, f"norm_k_{i}"), skip, carry("band_norm", i), band_norm_c)
            # over the 31 bands of one frame: no time state, so it streams as it is
            out, _ = getattr(self, f"lstm_k_{i}")(out.reshape(b * t, k, n))
            skip = skip + getattr(self, f"fc_k_{i}")(out).reshape(b, t, k, n)
        m, dec_c = self.mask_decoder(skip, None if st is None else st["dec"])
        enhanced = apply_three_tap_mask(x_ri, m)
        new_state = {"split": split_c, "time_norm": tuple(time_norm_c), "time_lstm": tuple(time_lstm_c),
                     "band_norm": tuple(band_norm_c), "dec": dec_c} if cfg.causal else None
        return torch.complex(enhanced[..., 0], enhanced[..., 1]), new_state

    def init_state(self, batch_size: int, device: torch.device | str = "cpu") -> dict:
        """Fresh streaming state (the causal variant only): zero running sums
        and counts for every norm, zero ``(h, c)`` for every time LSTM."""
        cfg = self.config
        if not cfg.causal:
            raise ValueError("only the causal BSRNN (causal=True) carries a streaming state")

        def norm_carry():
            return tuple(torch.zeros(batch_size, device=device) for _ in range(3))

        def lstm_state():
            return tuple(torch.zeros(batch_size * len(BAND_WIDTHS), 1, 2 * cfg.num_channel, device=device)
                         for _ in range(2))

        return {"split": tuple(norm_carry() for _ in BAND_WIDTHS),
                "time_norm": tuple(norm_carry() for _ in range(cfg.num_layer)),
                "time_lstm": tuple(lstm_state() for _ in range(cfg.num_layer)),
                "band_norm": tuple(norm_carry() for _ in range(cfg.num_layer)),
                "dec": tuple(norm_carry() for _ in BAND_WIDTHS)}


# ---------------- MetricGAN+'s discriminator ----------------


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's ``_l2_normalize``: ``x / sqrt(sum(x^2) + eps)`` over every entry."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """flax's ``linen.SpectralNorm`` (one power iteration, eps 1e-12) for the
    weight of one layer with ``out`` output channels: the weight divided by
    its largest singular value, estimated by one power-iteration step from
    the stored ``u`` ``[1, out]`` at every call, training or not. With
    ``update_stats`` the call stores its ``u`` and ``sigma``; ``u`` and the
    iteration's ``v`` take no gradient, ``sigma`` does (through the weight).

    It is not ``torch.nn.utils.parametrizations.spectral_norm``, which skips
    the iteration in eval mode, runs 15 when it is registered, and divides by
    ``max(norm, eps)`` where flax multiplies by ``rsqrt(norm^2 + eps)``. The
    weight is taken as ``[out, -1]`` in torch's layout: flax's ``[-1, out]``
    transposed, its rows in another order, which moves no singular value."""

    EPS = 1e-12

    def __init__(self, out: int, generator: torch.Generator):
        super().__init__()
        self.register_buffer("u", torch.randn(1, out, generator=generator))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, weight: torch.Tensor, update_stats: bool) -> torch.Tensor:
        w = weight.reshape(weight.shape[0], -1)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w, self.EPS)
            u = _l2_normalize(v @ w.T, self.EPS)
        sigma = (v @ w.T @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class PReLU(nn.Module):
    """flax's ``PReLU``: one slope for every channel, 0.01 at first."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


class LearnableSigmoid(nn.Module):
    """``beta * sigmoid(slope * x)``, ``slope`` learnable (``[features]``, 1 at first)."""

    def __init__(self, features: int = 1, beta: float = 1.2):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.beta * torch.sigmoid(self.slope * x)


class _SpectralConv(nn.Module):
    """A spectral-normed 4x4 convolution, stride 2, padding 1, no bias
    (flax's ``SpectralNorm(Conv(...))``); ``weight`` ``[out, in, 4, 4]``."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, 4, 4, generator=generator) * (16 * cin) ** -0.5)
        self.norm = SpectralNorm(cout, generator)

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        return F.conv2d(x, self.norm(self.weight, update_stats), stride=2, padding=1)


class _SpectralLinear(nn.Module):
    """A spectral-normed Dense layer (its bias is not normed); ``weight``
    ``[out, in]``."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, generator=generator) * cin ** -0.5)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.norm = SpectralNorm(cout, generator)

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        return F.linear(x, self.norm(self.weight, update_stats), self.bias)


class Discriminator(nn.Module):
    """MetricGAN+'s discriminator on (clean, estimate) magnitude pairs: two
    ``[B, T, F]`` magnitudes -> a quality in ``[0, 1.2]``, ``[B, 1]``. Four
    spectral-normed stride-2 convolutions (``ndf`` x 1, 2, 4, 8 channels),
    each followed by an instance norm (per channel over T and F, the
    population variance, eps 1e-5) and a PReLU; a max over T and F; then
    ``fc1`` (4 ``ndf``), a PReLU, ``fc2`` (1) and ``LearnableSigmoid``.
    ``update_stats`` stores each spectral norm's ``u`` and ``sigma`` (the
    flax call's ``train``). Weights made from ``generator``: lecun-normal
    kernels, zero biases, ``u`` standard normal."""

    def __init__(self, ndf: int = 16, generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.ndf = ndf
        cin = 2
        for i, mult in enumerate((1, 2, 4, 8)):
            setattr(self, f"conv_{i}", _SpectralConv(cin, ndf * mult, gen))
            setattr(self, f"PReLU_{i}", PReLU())
            cin = ndf * mult
        self.fc1 = _SpectralLinear(cin, 4 * ndf, gen)
        self.PReLU_4 = PReLU()
        self.fc2 = _SpectralLinear(4 * ndf, 1, gen)
        self.lsig = LearnableSigmoid(1)

    def forward(self, x_mag: torch.Tensor, y_mag: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        x = torch.stack([x_mag, y_mag], dim=1)  # [B, 2, T, F]
        for i in range(4):
            x = getattr(self, f"conv_{i}")(x, update_stats)
            mu = x.mean(dim=(2, 3), keepdim=True)
            var = torch.square(x - mu).mean(dim=(2, 3), keepdim=True)
            x = getattr(self, f"PReLU_{i}")((x - mu) / torch.sqrt(var + 1e-5))
        x = x.amax(dim=(2, 3))  # [B, C]
        x = self.PReLU_4(self.fc1(x, update_stats))
        return self.lsig(self.fc2(x, update_stats))


def batch_quality_scores(clean_list, est_list, sr: int = 16000):
    """MetricGAN's target scores, ``(wideband PESQ + 0.5) / 5`` a pair, as a
    float32 array: the ``pesq`` package's when it imports (None when it
    refuses a pair, as on silence), else ``metrics/pesq_native.py``'s."""
    try:
        from pesq import pesq as _pesq
    except ImportError:
        from cruse_tpu_torch.metrics.pesq_native import wb_pesq_native

        return np.asarray([(wb_pesq_native(c, e, sr) + 0.5) / 5.0 for c, e in zip(clean_list, est_list)],
                          np.float32)
    scores = []
    for c, e in zip(clean_list, est_list):
        try:
            scores.append((_pesq(sr, np.asarray(c), np.asarray(e), "wb") + 0.5) / 5.0)
        except Exception:
            return None
    return np.asarray(scores, np.float32)
