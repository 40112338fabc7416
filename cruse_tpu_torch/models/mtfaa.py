"""MTFAA: multi-scale temporal-frequency axial attention (counterpart of
``cruse_tpu/models/mtfaa.py``), offline: the eval forward and the training
forward with its backward.

cspec ``[B, T, F, 2]`` -> phase encoder -> linear band split -> encoder stages
(band-downsampling conv, BatchNorm, PReLU, TFCM stack, axial self-attention)
-> mirrored decoder with skips -> sigmoid magnitude mask at full resolution,
refined by a causal deep filter (benchmark config 5 and, with
``attention_window``, its deployable variant 5b).

Layout: the reference's T-minor ``[B, K(bands), C(channels), T]`` inside the
network. On the card a warp's lanes run along T (626 frames at 10 s), so the
T-minor loads are coalesced and a time shift of the stencil or of the
attention band is a plain address offset; C is only 4..48. The parameters
keep the flax shapes and names (``pconv1_kernel [Cin, C]``,
``dw_kernel [3, 3, C]``, ``kernel [2, 3, Cin, Cout]``, BatchNorm ``scale``,
``bias`` and buffers ``mean``, ``var``, 0-d PReLU ``negative_slope``), which
the kernels read directly and the weight bridge maps path for path.

On the card a forward launches the TFCM stack kernel once per stack (six),
the temporal-attention kernel once per encoder stage (three) and the deep
filter once; the 1x1 projections, the frequency attention, the band convs,
the filterbank products and the heads are PyTorch's own matmuls. Each module
keeps the kernel's wrapper as an attribute (``stack_fn``, ``block_fn``,
``attn_fn``, ``filter_fn``), so the plain versions can be put in its place
to check the kernels.

Training (``model.train()`` and ``train=True``; the two must agree):
BatchNorm normalises with the batch statistics over B, K, T (biased variance
``E[x^2] - mean^2``) and moves its running statistics in place by
``0.9 * old + 0.1 * batch``, with no gradient into them. A TFCM block takes
one of two routes, after the reference's ``tfcm_dw_impl``: any ``fused*``
value (the default) runs ``ops/tfcm_train.py::tfcm_block_train`` (``train_fn``:
the stencil's forward kernel, and a backward through the ``tail_bwd`` and
``mid_bwd`` kernels); ``"pallas"`` or ``"xla"`` run the unfused block under
autograd with the stencil as ``ops/dw_kernel.py::dw_causal_tm`` (``dw_fn``:
forward and backward kernels). The temporal attention under a gradient is the
forward kernel with its logsumexp and the dq and dk/dv kernels
(``ops/asa_kernel.py``). The deep filter in training is the differentiable
plain shift-MAC (``deep_filter_reference``), as the reference trains through
its plain version too: the deep-filter kernel has no backward.

Not ported yet, and refused by name: streaming with carried state (the MTFAA
streaming slice). ``asa_impl``, ``tfcm_remat`` and ``asa_remat`` are accepted
so that one config file builds both packages; the port has one
implementation per device, so they change nothing.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cruse_tpu_torch.ops.asa_kernel import flash_tattn_tm
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter, deep_filter_reference
from cruse_tpu_torch.ops.dw_kernel import dw_causal_tm
from cruse_tpu_torch.ops.tfcm_kernel import (
    fold_eval_params, fused_tfcm_block_eval, fused_tfcm_stack_eval)
from cruse_tpu_torch.ops.tfcm_train import batch_stats, tfcm_block_train

_STREAMING = ("streaming MTFAA with carried state (conv and TFCM histories, rolling "
              "attention K/V caches) comes with the MTFAA streaming slice; only state=None runs")
BN_MOMENTUM = 0.9  # running = 0.9 * running + 0.1 * batch


# ---------------- linear filterbank ----------------


@functools.lru_cache(maxsize=None)
def linear_filter_banks(nfilts: int, nfft: int, fs: int) -> np.ndarray:
    """Triangular filters linearly spaced in Hz from 0 to fs/2,
    [nfilts, nfft//2+1] float32: the reference's numpy construction."""
    centers = np.linspace(0.0, fs / 2, nfilts + 2)
    bins = np.floor((nfft + 1) * centers / fs).astype(int)
    fbank = np.zeros((nfilts, nfft // 2 + 1))
    for i in range(nfilts):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        for k in range(l, c):
            if c != l:
                fbank[i, k] = (k - l) / (c - l)
        for k in range(c, r):
            if r != c:
                fbank[i, k] = (r - k) / (r - c)
    return fbank.astype(np.float32)


class Banks(nn.Module):
    """amp <-> band transforms through the filter matrix (scaled by 1.3) and
    the numpy pseudo-inverse of the unscaled one, as the reference builds
    them. Held as non-persistent buffers: they are not weights."""

    def __init__(self, nfilters: int, nfft: int, fs: int):
        super().__init__()
        filt = linear_filter_banks(nfilters, nfft, fs)
        self.register_buffer("filter", torch.from_numpy(filt * 1.3), persistent=False)  # [K, F]
        self.register_buffer("filter_inv", torch.from_numpy(np.linalg.pinv(filt).astype(np.float32)),
                             persistent=False)  # [F, K]

    def amp2bank_tm(self, amp: torch.Tensor) -> torch.Tensor:
        """[B, F, C, T] -> [B, K, C, T]."""
        return torch.einsum("kf,bfct->bkct", self.filter, amp)

    def bank2amp_tm(self, bands: torch.Tensor) -> torch.Tensor:
        """[B, K, T] -> [B, F, T]."""
        return torch.einsum("fk,bkt->bft", self.filter_inv, bands)


# ---------------- helpers ----------------


def causal_ext(x: torch.Tensor, ctx: int) -> torch.Tensor:
    """Prepend ``ctx`` zero frames on the minor (time) axis."""
    return F.pad(x, (ctx, 0)) if ctx else x


def _bias_tm(b: torch.Tensor) -> torch.Tensor:
    """[C] bias broadcast for [B, K, C, T]."""
    return b[:, None]


def complex_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split real||imag halves on the channel axis (axis 2 of [B, F, C, T])."""
    c = x.shape[2] // 2
    return x[:, :, :c], x[:, :, c:]


def _conv_tm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv in the T-minor layout: [B, K, Cin, T] x [Cin, Cout] ->
    [B, K, Cout, T], one batched product whose result is contiguous."""
    return torch.matmul(w.t(), x)


def _param(generator: torch.Generator, *shape, std: float | None = None) -> nn.Parameter:
    """Seeded normal weight; lecun-normal (std fan_in^-1/2, fan_in = all but
    the last axis) unless ``std`` is given."""
    if std is None:
        std = math.prod(shape[:-1]) ** -0.5
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def _zeros(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _check_no_state(state) -> None:
    if state is not None:
        raise NotImplementedError(_STREAMING)


def _check_mode(module: nn.Module, state, train: bool) -> None:
    _check_no_state(state)
    if train != module.training:
        raise ValueError(f"train={train} but the module is in "
                         f"{'training' if module.training else 'eval'} mode: call "
                         f"{'.train()' if train else '.eval()'} first (BatchNorm follows the mode)")


# ---------------- complex convs / phase encoder ----------------


class ComplexConv(nn.Module):
    """Split-channel complex conv (r2r - i2i, r2i + i2r), causal in time;
    channel counts include both halves. One [Cin/2, Cout/2] product per
    (time, freq) tap, as the reference."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(1, 1),
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.kernel_size = tuple(kernel_size)
        kt, kf = self.kernel_size
        cin2, cout2 = in_channels // 2, out_channels // 2
        self.real_kernel = _param(gen, kt, kf, cin2, cout2, std=0.05)
        self.real_bias = _zeros(cout2)
        self.imag_kernel = _param(gen, kt, kf, cin2, cout2, std=0.05)
        self.imag_bias = _zeros(cout2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kf = self.kernel_size
        x = causal_ext(x, kt - 1)
        real, imag = complex_split(x)
        t_out = x.shape[-1] - (kt - 1)
        f_out = x.shape[1] - (kf - 1)

        def conv(u, w):
            acc = None
            for dt in range(kt):
                for df in range(kf):
                    term = _conv_tm(u[:, df : df + f_out, :, dt : dt + t_out], w[dt, df])
                    acc = term if acc is None else acc + term
            return acc

        br, bi = _bias_tm(self.real_bias), _bias_tm(self.imag_bias)
        r2r = conv(real, self.real_kernel) + br
        i2i = conv(imag, self.imag_kernel) + bi
        r2i = conv(real, self.imag_kernel) + bi
        i2r = conv(imag, self.real_kernel) + br
        return torch.cat([r2r - i2i, r2i + i2r], dim=2)


class PhaseEncoder(nn.Module):
    """Complex (3, 1) conv of the spectrum -> complex linear projection ->
    magnitude -> power-law compression (alpha 0.5). The reference takes a
    list of signals; the model passes one, so this takes its [B, F, 2, T]."""

    def __init__(self, cout: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.cconv_0 = ComplexConv(2, cout * 2, (3, 1), generator=gen)
        self.clp = ComplexConv(cout * 2, cout * 2, (1, 1), generator=gen)

    def forward(self, cspec: torch.Tensor) -> torch.Tensor:
        pr, pi = complex_split(self.clp(self.cconv_0(cspec)))
        return torch.sqrt(pr ** 2 + pi ** 2 + 1e-8) ** 0.5


# ---------------- normalization ----------------


class BatchNormC(nn.Module):
    """BatchNorm over the channel axis of [B, K, C, T]:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` with the running
    statistics in eval mode and the batch's (over B, K, T; biased variance) in
    training mode, which also moves the running ones (``update_running``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = _zeros(channels)
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = 0.9 * running + 0.1 * batch, in place."""
        self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        self.var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_stats(x)  # the gradient flows through them
            self.update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - _bias_tm(mean)) * _bias_tm(inv) + _bias_tm(self.bias)


class PReLUc(nn.Module):
    """PReLU with one learnable slope (a 0-d parameter)."""

    def __init__(self, init: float = 0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


# ---------------- TFCM ----------------


class TFCMBlock(nn.Module):
    """Residual temporal-frequency conv block: 1x1 conv + BN + PReLU ->
    depthwise (3, 3) conv, time-dilated and causal -> BN + PReLU -> 1x1 conv,
    + input. In eval mode the whole block is one launch of the TFCM kernel on
    the card (``block_fn``, with the BatchNorms folded into the convs). In
    training ``dw_impl`` picks the route (see the module doc): ``fused*`` ->
    ``train_fn``, else the unfused block with the stencil ``dw_fn``."""

    def __init__(self, channels: int, dilation: int = 1, dw_impl: str = "fused_fold",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        c = channels
        self.channels, self.dilation, self.dw_impl = c, dilation, dw_impl
        self.pconv1_kernel = _param(gen, c, c)
        self.pconv1_bias = _zeros(c)
        self.bn1 = BatchNormC(c)
        self.prelu1 = PReLUc()
        self.dw_kernel = _param(gen, 3, 3, c)
        self.dw_bias = _zeros(c)
        self.bn2 = BatchNormC(c)
        self.prelu2 = PReLUc()
        self.pconv2_kernel = _param(gen, c, c)
        self.pconv2_bias = _zeros(c)
        self.block_fn = fused_tfcm_block_eval
        self.train_fn = tfcm_block_train
        self.dw_fn = dw_causal_tm

    def eval_params(self) -> dict:
        """The block's weights and statistics under the kernel's keys."""
        return {"w1": self.pconv1_kernel, "b1": self.pconv1_bias,
                "g1": self.bn1.scale, "be1": self.bn1.bias, "m1": self.bn1.mean, "v1": self.bn1.var,
                "a1": self.prelu1.negative_slope, "wd": self.dw_kernel, "bd": self.dw_bias,
                "g2": self.bn2.scale, "be2": self.bn2.bias, "m2": self.bn2.mean, "v2": self.bn2.var,
                "a2": self.prelu2.negative_slope, "w2": self.pconv2_kernel, "b2": self.pconv2_bias}

    def forward(self, x: torch.Tensor, hist=None, train: bool = False) -> torch.Tensor:
        _check_mode(self, hist, train)
        if not train:
            return self.block_fn(x.contiguous(), _folded(self, [self]), dilation=self.dilation)
        if self.dw_impl.startswith("fused"):
            params = (self.pconv1_kernel, self.pconv1_bias, self.bn1.scale, self.bn1.bias,
                      self.prelu1.negative_slope, self.dw_kernel, self.dw_bias, self.bn2.scale,
                      self.bn2.bias, self.prelu2.negative_slope, self.pconv2_kernel,
                      self.pconv2_bias)
            y, _hist, m1, v1, m2, v2 = self.train_fn(x.contiguous(), params, self.dilation,
                                                     self.bn1.eps)
            self.bn1.update_running(m1, v1)
            self.bn2.update_running(m2, v2)
            return y
        h = self.prelu1(self.bn1(_conv_tm(x, self.pconv1_kernel) + _bias_tm(self.pconv1_bias)))
        h = self.dw_fn(causal_ext(h, 2 * self.dilation), self.dw_kernel, self.dilation)
        h = self.prelu2(self.bn2(h + _bias_tm(self.dw_bias)))
        return _conv_tm(h, self.pconv2_kernel) + _bias_tm(self.pconv2_bias) + x


class TFCM(nn.Module):
    """Stack of TFCM blocks with dilations 2^idx. In eval mode the whole
    ladder is one launch of the TFCM kernel on the card (``stack_fn``); in
    training the blocks run one after another, each by its ``dw_impl`` route."""

    def __init__(self, channels: int, num_layers: int = 6, dw_impl: str = "fused_fold",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        for idx in range(num_layers):
            setattr(self, f"block_{idx}", TFCMBlock(channels, 2 ** idx, dw_impl, generator=gen))
        self.stack_fn = fused_tfcm_stack_eval

    def blocks(self):
        return [getattr(self, f"block_{idx}") for idx in range(self.num_layers)]

    def forward(self, x: torch.Tensor, state=None, train: bool = False) -> torch.Tensor:
        _check_mode(self, state, train)
        blocks = self.blocks()
        if train:
            for block in blocks:
                x = block(x, train=True)
            return x
        return self.stack_fn(x.contiguous(), _folded(self, blocks),
                             dilations=tuple(b.dilation for b in blocks))


def _folded(owner: nn.Module, blocks) -> torch.Tensor:
    """``fold_eval_params`` of ``blocks``, kept on ``owner`` until one of the
    tensors it folds is replaced or changed in place (a load, a move, an
    optimizer step), so a forward folds nothing."""
    params = [b.eval_params() for b in blocks]
    key = tuple((t.data_ptr(), t._version) for p in params for t in p.values())
    cached = getattr(owner, "_folded_cache", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():  # the folded copy is a constant of the eval forward
            cached = (key, fold_eval_params(params))
        owner._folded_cache = cached
    return cached[1]


# ---------------- ASA ----------------


class AxialSelfAttention(nn.Module):
    """Frequency attention, then temporal attention, each residual; 1x1
    projections to q/k at ``c_att = max(channels // 4, 1)`` and v at
    ``channels``. The temporal branch is one launch of the attention kernel
    on the card (``attn_fn``): causal, optionally windowed, or with
    ``causal=False`` over every frame (the window is then unused). Under a
    gradient ``attn_fn`` also runs its backward kernels."""

    def __init__(self, channels: int, causal: bool = True, window: Optional[int] = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.channels, self.causal, self.window = channels, causal, window
        self.c_att = max(channels // 4, 1)
        for name, cout in (("q_f", self.c_att), ("k_f", self.c_att), ("v_f", channels),
                           ("q_t", self.c_att), ("k_t", self.c_att), ("v_t", channels)):
            setattr(self, f"{name}_kernel", _param(gen, channels, cout))
            setattr(self, f"{name}_bias", _zeros(cout))
        self.attn_fn = flash_tattn_tm

    def _proj(self, u: torch.Tensor, name: str) -> torch.Tensor:
        return _conv_tm(u, getattr(self, f"{name}_kernel")) + _bias_tm(getattr(self, f"{name}_bias"))

    def forward(self, x: torch.Tensor, state=None) -> torch.Tensor:
        _check_no_state(state)
        b, f, c, t = x.shape
        inv_scale = 1.0 / math.sqrt(self.c_att)
        # frequency attention
        qf, kf, vf = self._proj(x, "q_f"), self._proj(x, "k_f"), self._proj(x, "v_f")
        attn = torch.softmax(torch.einsum("bkct,bqct->bkqt", qf, kf) * inv_scale, dim=2)
        x = x + torch.einsum("bkqt,bqct->bkct", attn, vf)
        # temporal attention
        qt, kt, vt = self._proj(x, "q_t"), self._proj(x, "k_t"), self._proj(x, "v_t")
        xt = self.attn_fn(*(u.reshape(b * f, -1, t).contiguous() for u in (qt, kt, vt)),
                          self.window if self.causal else None, causal=self.causal)
        return x + xt.reshape(b, f, c, t)


# ---------------- band up/down sampling convs ----------------


class BandDownConv(nn.Module):
    """Causal (2, 3) conv with band stride ``s``: the encoder stage conv.
    out[k, t] = sum_{dt<=1, dk<3, c} W[dt, dk, c, o] x_ext[s*k + dk - 1, c, t - 1 + dt]
    (previous and current frame; one zero band at each edge)."""

    def __init__(self, in_channels: int, channels: int, stride: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.stride = stride
        self.kernel = _param(gen, 2, 3, in_channels, channels)
        self.bias = _zeros(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_in = x.shape[1]
        s, w = self.stride, self.kernel
        k_out = (k_in - 1) // s + 1
        x = causal_ext(x, 1)
        xp = F.pad(x, (0, 0, 0, 0, 1, 1))
        t_out = x.shape[-1] - 1
        if s == 2 and k_in % 2 == 0:
            # the same sum with the six taps side by side on C: one product
            r = xp.reshape(x.shape[0], (k_in + 2) // 2, 2, x.shape[2], x.shape[-1])
            views = (r[:, :k_out, 0], r[:, :k_out, 1], r[:, 1 : k_out + 1, 0])
            xcat = torch.cat([v[..., dt : dt + t_out] for v in views for dt in range(2)], dim=2)
            wf = torch.cat([w[dt, dk] for dk in range(3) for dt in range(2)], dim=0)
            return _conv_tm(xcat, wf) + _bias_tm(self.bias)
        acc = None
        for dt in range(2):
            for dk in range(3):
                term = _conv_tm(xp[:, dk : dk + s * (k_out - 1) + 1 : s, :, dt : dt + t_out], w[dt, dk])
                acc = term if acc is None else acc + term
        return acc + _bias_tm(self.bias)


class BandUpConv(nn.Module):
    """Causal transposed (2, 3) conv with band stride 2: the decoder stage.
    Output band 2k takes the centre tap of input band k; band 2k+1 the outer
    taps of bands k and k+1 (zero past the top). Time taps: the previous and
    the current frame."""

    def __init__(self, in_channels: int, channels: int, generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.channels = channels
        self.kernel = _param(gen, 2, 3, in_channels, channels)
        self.bias = _zeros(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, k_in = x.shape[0], x.shape[1]
        w = self.kernel
        x = causal_ext(x, 1)
        t_out = x.shape[-1] - 1

        def tap(u, dt, dk):
            return _conv_tm(u[..., dt : dt + t_out], w[dt, dk])

        x_next = F.pad(x, (0, 0, 0, 0, 0, 1))[:, 1:]
        even = tap(x, 0, 1) + tap(x, 1, 1)
        odd = (tap(x, 0, 2) + tap(x, 1, 2)) + (tap(x_next, 0, 0) + tap(x_next, 1, 0))
        y = torch.stack([even, odd], dim=2).reshape(b, 2 * k_in, self.channels, t_out)
        return y + _bias_tm(self.bias)


# ---------------- full network ----------------


@dataclasses.dataclass(frozen=True)
class MtfaaConfig:
    n_fft: int = 512
    sr: int = 16000
    n_bands: int = 128
    phase_channels: int = 4
    channels: Tuple[int, ...] = (24, 32, 48)
    band_strides: Tuple[int, ...] = (2, 2, 2)
    tfcm_layers: int = 4
    tfcm_remat: bool = False  # accepted; no effect in the port
    tfcm_dw_impl: str = "fused_fold"  # training route of a TFCM block: "fused*" -> the
    # kernel-backed block backward; "pallas" / "xla" -> the unfused block, stencil kernels
    attention_window: Optional[int] = None  # None: full causal attention
    asa_impl: str = "auto"  # accepted; no effect in the port
    asa_enabled: bool = True
    asa_remat: bool = False  # accepted; no effect in the port
    mask_activation: str = "sigmoid"
    use_deep_filter: bool = True
    df_taps_t: int = 1
    df_taps_f: int = 1

    def __post_init__(self):
        # the T-minor BandUpConv decoder stage is specialised to stride-2
        # up-sampling; another encoder stride would mis-shape the decoder
        assert all(s == 2 for s in self.band_strides), (
            f"band_strides must all be 2 (got {self.band_strides}): the "
            "T-minor BandUpConv decoder only implements stride-2 upsampling"
        )

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1


class MtfaaNet(nn.Module):
    """cspec [B, T, F, 2] -> ((enhanced complex64 [B, T, F], mask [B, T, F]), None).

    ``train`` must agree with the module's mode (``.train()`` / ``.eval()``).
    With ``train=True`` BatchNorm uses and records batch statistics, the TFCM
    blocks and the attention run their differentiable routes, and the deep
    filter is the plain differentiable shift-MAC in place of ``filter_fn``
    (whose kernel has no backward). A carried ``state`` raises."""

    def __init__(self, config: MtfaaConfig = MtfaaConfig(), generator: torch.Generator | None = None):
        super().__init__()
        cfg = self.config = config
        gen = generator or torch.Generator().manual_seed(0)
        self.banks = Banks(cfg.n_bands, cfg.n_fft, cfg.sr)
        self.phase_enc = PhaseEncoder(cout=cfg.phase_channels, generator=gen)
        bands = [cfg.n_bands]
        c_in = cfg.phase_channels
        for si, ch in enumerate(cfg.channels):
            bands.append((bands[-1] - 1) // cfg.band_strides[si] + 1)
            setattr(self, f"enc_conv_{si}", BandDownConv(c_in, ch, cfg.band_strides[si], generator=gen))
            setattr(self, f"enc_bn_{si}", BatchNormC(ch))
            setattr(self, f"enc_prelu_{si}", PReLUc())
            setattr(self, f"enc_tfcm_{si}", TFCM(ch, cfg.tfcm_layers, cfg.tfcm_dw_impl, generator=gen))
            if cfg.asa_enabled:
                setattr(self, f"enc_asa_{si}",
                        AxialSelfAttention(ch, window=cfg.attention_window, generator=gen))
            c_in = ch
        for si in reversed(range(len(cfg.channels))):
            ch_out = cfg.channels[si - 1] if si > 0 else cfg.phase_channels
            setattr(self, f"dec_conv_{si}", BandUpConv(cfg.channels[si], ch_out, generator=gen))
            setattr(self, f"dec_bn_{si}", BatchNormC(ch_out))
            setattr(self, f"dec_prelu_{si}", PReLUc())
            setattr(self, f"dec_tfcm_{si}",
                    TFCM(ch_out, cfg.tfcm_layers, cfg.tfcm_dw_impl, generator=gen))
        self.mask_head_kernel = _param(gen, cfg.phase_channels, 1)
        self.mask_head_bias = _zeros(1)
        if cfg.use_deep_filter:
            out_bands = 2 * bands[1]  # the decoder's last stage doubles stage 0's bands
            d = cfg.num_bins * self.num_taps * 2
            self.df_coef_kernel = _param(gen, out_bands * cfg.phase_channels, d)
            self.df_coef_bias = _zeros(d)
        # the function that applies the deep filter (the kernel's wrapper); the
        # plain version may be put in its place to check the kernel against it
        self.filter_fn = deep_filter

    @property
    def num_taps(self) -> int:
        """Deep-filter taps (the reference's ``_df_taps``)."""
        return (2 * self.config.df_taps_t + 1) * (2 * self.config.df_taps_f + 1)

    def compress(self, mag: torch.Tensor) -> torch.Tensor:
        return torch.clamp(mag, min=1e-12) ** 0.5

    def forward(self, cspec: torch.Tensor, state=None, train: bool = False):
        _check_mode(self, state, train)
        cfg = self.config
        if cspec.dim() != 4 or cspec.shape[-1] != 2 or cspec.shape[-2] != cfg.num_bins:
            raise ValueError(f"cspec must be [B, T, {cfg.num_bins}, 2], got {tuple(cspec.shape)}")

        cspec_tm = cspec.permute(0, 2, 3, 1)  # [B, F, 2, T]
        x = self.banks.amp2bank_tm(self.phase_enc(cspec_tm))  # [B, K, C, T]
        skips = []
        for si in range(len(cfg.channels)):
            x = getattr(self, f"enc_conv_{si}")(x)
            x = getattr(self, f"enc_prelu_{si}")(getattr(self, f"enc_bn_{si}")(x))
            x = getattr(self, f"enc_tfcm_{si}")(x, train=train)
            if cfg.asa_enabled:
                x = getattr(self, f"enc_asa_{si}")(x)
            skips.append(x)
        for si in reversed(range(len(cfg.channels))):
            x = getattr(self, f"dec_conv_{si}")(x + skips[si])
            x = getattr(self, f"dec_prelu_{si}")(getattr(self, f"dec_bn_{si}")(x))
            x = getattr(self, f"dec_tfcm_{si}")(x, train=train)

        # magnitude mask at band resolution -> full bins
        band_mask = _conv_tm(x, self.mask_head_kernel)[:, :, 0] + self.mask_head_bias  # [B, K, T]
        mask_tm = self.banks.bank2amp_tm(band_mask)  # [B, F, T]
        mask_tm = torch.sigmoid(mask_tm) if cfg.mask_activation == "sigmoid" else torch.relu(mask_tm)
        mask = mask_tm.transpose(1, 2).contiguous()  # [B, T, F]
        spec = torch.complex(cspec[..., 0].float(), cspec[..., 1].float())
        enhanced = spec * mask
        if cfg.use_deep_filter:
            # coefficient head T-major: [B, T, K*C] @ [K*C, F*taps*2]; its
            # output index decomposes bin-major, then tap, then re/im, so the
            # view is the deep filter's [B, T, F, taps, 2]
            b, _, _, t = x.shape
            feats = x.reshape(b, -1, t).transpose(1, 2)
            taps = self.num_taps
            coefs = (feats @ self.df_coef_kernel + self.df_coef_bias) / taps
            coefs = coefs.view(b, t, cfg.num_bins, taps, 2)
            filter_fn = deep_filter_reference if train else self.filter_fn
            enhanced = filter_fn(enhanced, coefs, cfg.df_taps_t, cfg.df_taps_f, causal=True)
        return (enhanced, mask), None
