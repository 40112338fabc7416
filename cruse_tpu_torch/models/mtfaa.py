"""MTFAA: multi-scale temporal-frequency axial attention (counterpart of
``cruse_tpu/models/mtfaa.py``): the eval forward, the training forward with
its backward, and, with ``attention_window`` set, streaming with carried state.

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
(``ops/asa_kernel.py``). The deep filter under a gradient is the forward
kernel and the backward kernel (``ops/deep_filter_kernel.py::deep_filter``,
through its ``torch.autograd.Function``); the reference trains through its
plain shift-MAC, whose autodiff the backward kernel computes.

Streaming (a windowed model, ``attention_window`` set): ``forward(cspec,
state)`` takes a chunk of T >= 1 frames after the frames whose state it
carries and returns the new state, a dict with the JAX package's keys and
shapes (``init_state``): the phase encoder's and each band conv's last input
frames, each TFCM block's last 2d stencil inputs, each attention's rolling
key/value caches of ``window - 1`` frames with a per-stream count of the
frames they hold, and the deep filter's last ``2 * df_taps_t`` masked
frames. Every stateful module has ``carry(x, state) -> (y, new_state)``
beside its ``forward``. With a carried state a TFCM block runs unfused, the
route the JAX package streams through: PyTorch's 1x1 products and PReLUs on
the block's folded parameters (the BatchNorms folded in as for the kernels)
around the stencil kernel (``dw_fn``, ``ops/dw_kernel.py``) on its history and
the chunk; the temporal attention over the cache is
PyTorch's (einsum, band and validity mask, softmax), as the JAX package's is;
the deep filter is the kernel with its ``history`` argument. A windowed call
with ``state=None`` runs the offline kernels and returns the state too: the
band-conv histories, the attention caches and the deep-filter history are
tails of tensors the forward has, and a TFCM stack's histories come from its
unfused blocks re-run over the last ``2 (2^L - 1)`` frames of its input,
which is all they depend on. A full-causal model (no window) returns no state
and refuses one; no path trains through a carried state.

Export (``infer/export.py``): each kernel's wrapper reaches it through a
custom op (``torch.ops.cruse_tpu_torch.tfcm_eval``, ``tattn_fwd``,
``dw_fwd``, ``deep_filter``), which ``torch.export`` traces; the trace runs
inside ``frozen_folds``, which hands each TFCM stack and block whose weights
hold no int8 leaf its folded parameters as a constant of the program, and
``_folded`` neither reads nor writes the eager cache under a trace.

``asa_impl``, ``tfcm_remat`` and ``asa_remat`` are accepted so that one
config file builds both packages; the port has one implementation per device,
so they change nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from cruse_tpu_torch.ops.asa_kernel import flash_tattn_tm
from cruse_tpu_torch.ops.deep_filter_kernel import deep_filter
from cruse_tpu_torch.ops.dw_kernel import dw_causal_tm
from cruse_tpu_torch.ops.tfcm_kernel import (
    _unfold_layer, fold_eval_params, fused_tfcm_block_eval, fused_tfcm_stack_eval)
from cruse_tpu_torch.ops.tfcm_train import batch_stats, tfcm_block_train

_NO_STATE_TRAINING = ("no path trains through a carried state: stream in eval mode "
                      "(model.eval(), train=False)")
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


def causal_ext(x: torch.Tensor, ctx: int, hist: torch.Tensor | None = None):
    """Prepend ``ctx`` frames of time context on the minor axis: the carried
    ``hist [..., ctx]`` when streaming, zeros otherwise. Returns ``(x_ext [...,
    T + ctx], new_hist)``, the new history being x_ext's last ``ctx`` frames
    (None where ctx is 0)."""
    if ctx == 0:
        return x, None
    x_ext = F.pad(x, (ctx, 0)) if hist is None else torch.cat([hist, x], dim=-1)
    return x_ext, x_ext[..., x_ext.shape[-1] - ctx :]


def _tail(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """The last ``n`` entries of ``x`` along ``dim``, zero-filled in front where x has fewer."""
    size = x.shape[dim]
    tail = x.narrow(dim, max(size - n, 0), min(size, n))
    if size >= n:
        return tail
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [n - size, 0]
    return F.pad(tail, pad)


def _detached(tree):
    """Every tensor of a state tree (tuples, dicts) cut from autograd."""
    if isinstance(tree, dict):
        return {key: _detached(value) for key, value in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_detached(value) for value in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


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


def _check_mode(module: nn.Module, train: bool) -> None:
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
        return self.carry(x)[0]

    def carry(self, x: torch.Tensor, hist: torch.Tensor | None = None):
        """``x [B, F, Cin, T]`` after the frames whose last ``kt - 1`` ``hist``
        holds (zeros without) -> ``(y [B, F, Cout, T], new_hist)``."""
        kt, kf = self.kernel_size
        x, new_hist = causal_ext(x, kt - 1, hist)
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
        return torch.cat([r2r - i2i, r2i + i2r], dim=2), new_hist


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
        return self.carry(cspec)[0]

    def carry(self, cspec: torch.Tensor, state=None):
        """-> ``(amp, (new_hist [B, F, 2, 2],))``: the (3, 1) conv's history,
        as the JAX package's one-signal state tuple."""
        h, hist = self.cconv_0.carry(cspec, None if state is None else state[0])
        pr, pi = complex_split(self.clp(h))
        return torch.sqrt(pr ** 2 + pi ** 2 + 1e-8) ** 0.5, (hist,)


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
    ``train_fn``, else the unfused block with the stencil ``dw_fn``. ``carry``
    streams: the unfused block in eval mode over a carried history."""

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_mode(self, train)
        if not train:
            return self.block_fn(x.contiguous(), _folded(self, [self]), dilation=self.dilation)
        return self.train_forward(x)[0]

    def carry(self, x: torch.Tensor, hist: torch.Tensor | None = None):
        """Eval: ``x [B, K, C, T]`` after the frames whose last 2d stencil
        inputs ``hist`` holds (zeros without) -> ``(y, new_hist [B, K, C, 2d])``,
        through the unfused block: PyTorch's ops on the folded parameters
        around the stencil kernel (``dw_fn``)."""
        _check_mode(self, False)
        layer = self.eval_layer()
        p_ext, new_hist = causal_ext(self.stencil_input(x, layer), 2 * self.dilation, hist)
        return self.finish(p_ext, x, layer), new_hist

    def eval_layer(self) -> tuple:
        """The folded eval parameters ``(w1, b1, wd, bd, w2, b2, a1, a2)``: the
        BatchNorms folded into the 1x1 conv and the stencil, as the kernel reads them."""
        return _unfold_layer(_folded(self, [self])[0], self.channels)

    @staticmethod
    def stencil_input(x: torch.Tensor, layer: tuple) -> torch.Tensor:
        """pconv1, BN1, PReLU1 (folded ``layer``), frame by frame."""
        w1, b1, _, _, _, _, a1, _ = layer
        h = _conv_tm(x, w1) + _bias_tm(b1)
        return torch.where(h >= 0, h, a1 * h)

    def finish(self, p_ext: torch.Tensor, x: torch.Tensor, layer: tuple) -> torch.Tensor:
        """The stencil (``dw_fn``) over ``p_ext [B, K, C, T + 2d]``, BN2, PReLU2,
        pconv2 (folded ``layer``) and the residual ``x``."""
        _, _, wd, bd, w2, b2, _, a2 = layer
        z = self.dw_fn(p_ext, wd, self.dilation) + _bias_tm(bd)
        return _conv_tm(torch.where(z >= 0, z, a2 * z), w2) + _bias_tm(b2) + x

    def train_forward(self, x: torch.Tensor):
        """The training forward by the ``dw_impl`` route -> ``(y, the stencil
        input's last 2d frames, cut from autograd)``."""
        if self.dw_impl.startswith("fused"):
            params = (self.pconv1_kernel, self.pconv1_bias, self.bn1.scale, self.bn1.bias,
                      self.prelu1.negative_slope, self.dw_kernel, self.dw_bias, self.bn2.scale,
                      self.bn2.bias, self.prelu2.negative_slope, self.pconv2_kernel,
                      self.pconv2_bias)
            y, hist, m1, v1, m2, v2 = self.train_fn(x.contiguous(), params, self.dilation,
                                                    self.bn1.eps)
            self.bn1.update_running(m1, v1)
            self.bn2.update_running(m2, v2)
            return y, hist
        h = self.prelu1(self.bn1(_conv_tm(x, self.pconv1_kernel) + _bias_tm(self.pconv1_bias)))
        h_ext, hist = causal_ext(h, 2 * self.dilation)
        h = self.prelu2(self.bn2(self.dw_fn(h_ext, self.dw_kernel, self.dilation) + _bias_tm(self.dw_bias)))
        return _conv_tm(h, self.pconv2_kernel) + _bias_tm(self.pconv2_bias) + x, hist.detach()


class TFCM(nn.Module):
    """Stack of TFCM blocks with dilations 2^idx. In eval mode the whole
    ladder is one launch of the TFCM kernel on the card (``stack_fn``); in
    training the blocks run one after another, each by its ``dw_impl`` route.
    ``carry`` also returns the per-layer histories (see the module doc)."""

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_mode(self, train)
        if train:
            return self.carry(x, train=True)[0]
        blocks = self.blocks()
        return self.stack_fn(x.contiguous(), _folded(self, blocks),
                             dilations=tuple(b.dilation for b in blocks))

    def carry(self, x: torch.Tensor, state=None, train: bool = False):
        """``x`` after the frames whose per-layer histories ``state`` holds ->
        ``(y, new histories)``. A carried state runs the blocks' ``carry`` one
        after another; without one, the stack's forward runs and the
        histories come from ``histories``."""
        _check_mode(self, train)
        blocks = self.blocks()
        if state is not None:
            if train:
                raise NotImplementedError(_NO_STATE_TRAINING)
            hists = []
            for block, hist in zip(blocks, state, strict=True):
                x, hist = block.carry(x, hist)
                hists.append(hist)
            return x, tuple(hists)
        if train:
            hists = []
            for block in blocks:
                x, hist = block.train_forward(x)
                hists.append(hist)
            return x, tuple(hists)
        return self(x), self.histories(x)

    @torch.no_grad()
    def histories(self, x: torch.Tensor) -> tuple:
        """The per-layer histories that a chunk ``x`` leaves (eval), without a
        second pass over it: layer l's are its stencil inputs at the last
        2 d_l frames, which depend on the stack's input at its last 2 (d_0 +
        ... + d_l) frames only. So the unfused blocks run over the input's
        last 2 (2^L - 1) frames, each layer's output losing the first 2d
        frames it cannot know; a chunk no longer than that runs whole, from
        the zero history."""
        blocks = self.blocks()
        need = 2 * sum(block.dilation for block in blocks)
        whole = x.shape[-1] <= need
        u = x if whole else x[..., x.shape[-1] - need :]
        hists = []
        for i, block in enumerate(blocks):
            layer = block.eval_layer()
            p_ext, hist = causal_ext(block.stencil_input(u, layer), 2 * block.dilation)
            hists.append(hist)
            if i + 1 < len(blocks):
                u = block.finish(p_ext, u, layer)
                if not whole:
                    u = u[..., 2 * block.dilation :]
        return tuple(hists)


def _folded(owner: nn.Module, blocks) -> torch.Tensor:
    """``fold_eval_params`` of ``blocks``. Eager: kept on ``owner`` until one
    of the tensors it folds is replaced or changed in place (a load, a move,
    an optimizer step), so a forward folds nothing. Under ``torch.export``:
    the owner's frozen fold (``frozen_folds``), a constant of the program, or
    where it has none (int8 leaves) the fold of the weights as the program
    dequantizes them, on every call; a trace reads no cache and writes none."""
    frozen = owner.__dict__.get("_frozen_fold")
    if frozen is not None:
        return frozen
    params = [b.eval_params() for b in blocks]
    if torch.compiler.is_compiling():
        return fold_eval_params(params)
    key = tuple((t.data_ptr(), t._version) for p in params for t in p.values())
    cached = getattr(owner, "_folded_cache", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():  # the folded copy is a constant of the eval forward
            cached = (key, fold_eval_params(params))
        owner._folded_cache = cached
    return cached[1]


@contextlib.contextmanager
def frozen_folds(model: nn.Module):
    """For ``torch.export``: every TFCM stack and block of ``model`` whose
    weights hold no int8 leaf (``nn.quantize.attach_int8``'s
    parametrizations) gets its folded parameters, folded once here, which a
    program that reads them lifts as a constant, so that a float32 program
    folds nothing per call; a stack or block with int8 leaves folds in the
    program after the dequantize, as the JAX package's export does. The
    folds go when the block ends, and the eager path keeps its own cache."""
    owners = [m for m in model.modules() if isinstance(m, (TFCM, TFCMBlock))]
    try:
        for owner in owners:
            blocks = owner.blocks() if isinstance(owner, TFCM) else [owner]
            if not any(parametrize.is_parametrized(b) for b in blocks):
                with torch.no_grad():
                    folded = fold_eval_params([b.eval_params() for b in blocks])
                owner.__dict__["_frozen_fold"] = folded
        yield model
    finally:
        for owner in owners:
            owner.__dict__.pop("_frozen_fold", None)


# ---------------- ASA ----------------


class AxialSelfAttention(nn.Module):
    """Frequency attention, then temporal attention, each residual; 1x1
    projections to q/k at ``c_att = max(channels // 4, 1)`` and v at
    ``channels``. The temporal branch is one launch of the attention kernel
    on the card (``attn_fn``): causal, optionally windowed, or with
    ``causal=False`` over every frame (the window is then unused). Under a
    gradient ``attn_fn`` also runs its backward kernels. ``carry`` streams a
    causal, windowed attention over rolling key/value caches
    ``(k_cache [B, F, c_att, window - 1], v_cache [B, F, C, window - 1],
    count [B])``, ``count`` being the frames each stream's caches hold (the
    rest are zeros no query may see), so that the streams of a batch may be
    at different points."""

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

    def _frequency(self, x: torch.Tensor):
        """The frequency attention (each frame on its own), then the temporal
        branch's projections: ``(x, qt, kt, vt)``."""
        qf, kf, vf = self._proj(x, "q_f"), self._proj(x, "k_f"), self._proj(x, "v_f")
        attn = torch.softmax(torch.einsum("bkct,bqct->bkqt", qf, kf) * (1.0 / math.sqrt(self.c_att)), dim=2)
        x = x + torch.einsum("bkqt,bqct->bkct", attn, vf)
        return x, self._proj(x, "q_t"), self._proj(x, "k_t"), self._proj(x, "v_t")

    def _attend(self, x: torch.Tensor):
        """-> (output, kt, vt): the temporal branch through ``attn_fn``."""
        b, f, c, t = x.shape
        x, qt, kt, vt = self._frequency(x)
        xt = self.attn_fn(*(u.reshape(b * f, -1, t).contiguous() for u in (qt, kt, vt)),
                          self.window if self.causal else None, causal=self.causal)
        return x + xt.reshape(b, f, c, t), kt, vt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._attend(x)[0]

    def carry(self, x: torch.Tensor, state=None):
        """``x [B, F, C, T]`` after the frames whose caches ``state`` holds ->
        ``(y, new caches)``. Without a state the kernel runs and the caches
        are the last window - 1 frames of its keys and values (zero-filled in
        front). Only a causal, windowed attention streams; another returns
        no state and refuses one."""
        w = self.window
        if w is None or not self.causal:
            if state is not None:
                raise ValueError("streaming attention needs a finite window and causal=True "
                                 f"(window={w}, causal={self.causal})")
            return self(x), None
        if state is None:
            y, kt, vt = self._attend(x)
            count = torch.full((x.shape[0],), min(x.shape[-1], w - 1), dtype=torch.int32, device=x.device)
            return y, (_tail(kt, w - 1).detach(), _tail(vt, w - 1).detach(), count)
        k_cache, v_cache, count = state
        t = x.shape[-1]
        x, qt, kt, vt = self._frequency(x)
        keys, vals = torch.cat([k_cache, kt], dim=-1), torch.cat([v_cache, vt], dim=-1)
        s = keys.shape[-1]
        logits = torch.einsum("bfct,bfcs->bfts", qt, keys) * (1.0 / math.sqrt(self.c_att))
        # query i sits at slot w - 1 + i and sees slots i .. w - 1 + i; a cache
        # slot below w - 1 - count holds no frame of its stream yet
        qi = torch.arange(t, device=x.device)[:, None]
        si = torch.arange(s, device=x.device)[None, :]
        band = (si >= qi) & (si <= qi + w - 1)  # [T, S]
        valid = si[None] >= (w - 1 - count).clamp(min=0)[:, None, None]  # [B, 1, S]
        logits = logits.masked_fill(~(band & valid)[:, None], -1e9)
        xt = torch.einsum("bfts,bfcs->bfct", torch.softmax(logits, dim=-1), vals)
        return x + xt, (keys[..., s - (w - 1) :], vals[..., s - (w - 1) :], (count + t).clamp(max=w - 1))

    def init_stream_state(self, batch_size: int, f: int, device: torch.device | str = "cpu"):
        """Empty caches for ``batch_size`` streams over ``f`` bands."""
        if self.window is None:
            raise ValueError("streaming attention needs a finite window")
        w = self.window
        return (torch.zeros(batch_size, f, self.c_att, w - 1, device=device),
                torch.zeros(batch_size, f, self.channels, w - 1, device=device),
                torch.zeros(batch_size, dtype=torch.int32, device=device))


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
        return self.carry(x)[0]

    def carry(self, x: torch.Tensor, hist: torch.Tensor | None = None):
        """``x`` after the frame ``hist [B, K, Cin, 1]`` (zeros without) ->
        ``(y, new_hist)``."""
        k_in = x.shape[1]
        s, w = self.stride, self.kernel
        k_out = (k_in - 1) // s + 1
        x, new_hist = causal_ext(x, 1, hist)
        xp = F.pad(x, (0, 0, 0, 0, 1, 1))
        t_out = x.shape[-1] - 1
        if s == 2 and k_in % 2 == 0:
            # the same sum with the six taps side by side on C: one product
            r = xp.reshape(x.shape[0], (k_in + 2) // 2, 2, x.shape[2], x.shape[-1])
            views = (r[:, :k_out, 0], r[:, :k_out, 1], r[:, 1 : k_out + 1, 0])
            xcat = torch.cat([v[..., dt : dt + t_out] for v in views for dt in range(2)], dim=2)
            wf = torch.cat([w[dt, dk] for dk in range(3) for dt in range(2)], dim=0)
            return _conv_tm(xcat, wf) + _bias_tm(self.bias), new_hist
        acc = None
        for dt in range(2):
            for dk in range(3):
                term = _conv_tm(xp[:, dk : dk + s * (k_out - 1) + 1 : s, :, dt : dt + t_out], w[dt, dk])
                acc = term if acc is None else acc + term
        return acc + _bias_tm(self.bias), new_hist


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
        return self.carry(x)[0]

    def carry(self, x: torch.Tensor, hist: torch.Tensor | None = None):
        """``x`` after the frame ``hist [B, K, Cin, 1]`` (zeros without) ->
        ``(y, new_hist)``."""
        b, k_in = x.shape[0], x.shape[1]
        w = self.kernel
        x, new_hist = causal_ext(x, 1, hist)
        t_out = x.shape[-1] - 1

        def tap(u, dt, dk):
            return _conv_tm(u[..., dt : dt + t_out], w[dt, dk])

        x_next = F.pad(x, (0, 0, 0, 0, 0, 1))[:, 1:]
        even = tap(x, 0, 1) + tap(x, 1, 1)
        odd = (tap(x, 0, 2) + tap(x, 1, 2)) + (tap(x_next, 0, 0) + tap(x_next, 1, 0))
        y = torch.stack([even, odd], dim=2).reshape(b, 2 * k_in, self.channels, t_out)
        return y + _bias_tm(self.bias), new_hist


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
    """cspec [B, T, F, 2] -> ((enhanced complex64 [B, T, F], mask [B, T, F]), state).

    ``train`` must agree with the module's mode (``.train()`` / ``.eval()``).
    With ``train=True`` BatchNorm uses and records batch statistics, and the
    TFCM blocks, the attention and the deep filter (``filter_fn``) run their
    differentiable routes. A windowed model (``attention_window`` set) takes
    and returns the streaming state (see the module doc; ``init_state``), in
    training too, cut from autograd; a full-causal one returns None and
    refuses a state."""

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

    def forward(self, cspec: torch.Tensor, state=None, train: bool = False, with_state: bool = True):
        """``with_state=False`` is for callers that drop the state (the
        offline adapters): a ``state=None`` call then returns None and skips
        the state's work, as the JAX package's jitted forward drops a state
        its caller does not use."""
        _check_mode(self, train)
        cfg = self.config
        stateful = cfg.attention_window is not None and (with_state or state is not None)
        if state is not None and train:
            raise NotImplementedError(_NO_STATE_TRAINING)
        if state is not None and cfg.attention_window is None:
            raise ValueError("MTFAA streaming needs a finite attention_window (the full-causal "
                             "configuration cannot carry ASA state)")
        if state is not None and set(state) != set(self.state_keys()):
            raise ValueError(f"state must be a dict of init_state's keys {self.state_keys()}, "
                             f"got {sorted(state)}")
        if cspec.dim() != 4 or cspec.shape[-1] != 2 or cspec.shape[-2] != cfg.num_bins:
            raise ValueError(f"cspec must be [B, T, {cfg.num_bins}, 2], got {tuple(cspec.shape)}")
        st, new_state = state or {}, {}

        def run(name, x, **kw):
            """The named module's forward, or its carry with its state."""
            module = getattr(self, name)
            if not stateful:
                return module(x, **kw)
            y, new_state[name] = module.carry(x, st.get(name), **kw)
            return y

        cspec_tm = cspec.permute(0, 2, 3, 1)  # [B, F, 2, T]
        if stateful:
            amp, new_state["pe"] = self.phase_enc.carry(cspec_tm, st.get("pe"))
        else:
            amp = self.phase_enc(cspec_tm)
        x = self.banks.amp2bank_tm(amp)  # [B, K, C, T]
        skips = []
        for si in range(len(cfg.channels)):
            x = run(f"enc_conv_{si}", x)
            x = getattr(self, f"enc_prelu_{si}")(getattr(self, f"enc_bn_{si}")(x))
            x = run(f"enc_tfcm_{si}", x, train=train)
            if cfg.asa_enabled:
                x = run(f"enc_asa_{si}", x)
            skips.append(x)
        for si in reversed(range(len(cfg.channels))):
            x = run(f"dec_conv_{si}", x + skips[si])
            x = getattr(self, f"dec_prelu_{si}")(getattr(self, f"dec_bn_{si}")(x))
            x = run(f"dec_tfcm_{si}", x, train=train)

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
            # a carried history holds the masked spectrum's last 2 t_dim frames
            history = None if state is None else torch.complex(*st["df"])
            filtered = self.filter_fn(enhanced, coefs, cfg.df_taps_t, cfg.df_taps_f, causal=True,
                                      history=history)
            if stateful:
                past = enhanced if history is None else torch.cat([history, enhanced], dim=1)
                new_state["df"] = tuple(_tail(part, 2 * cfg.df_taps_t, dim=1) for part in (past.real, past.imag))
            enhanced = filtered
        return (enhanced, mask), (_detached(new_state) if stateful else None)

    def state_keys(self) -> list:
        """The keys of the streaming state, in the order the forward fills them."""
        cfg = self.config
        stages = range(len(cfg.channels))
        return (["pe"] + [f"enc_{part}_{si}" for si in stages
                          for part in ("conv", "tfcm", "asa")[: 3 if cfg.asa_enabled else 2]]
                + [f"dec_{part}_{si}" for si in reversed(stages) for part in ("conv", "tfcm")]
                + (["df"] if cfg.use_deep_filter else []))

    def init_state(self, batch_size: int, device: torch.device | str = "cpu") -> dict:
        """A fresh streaming state (a windowed model only), with the JAX
        package's keys and shapes: every conv and TFCM history ``[B, K, C,
        ctx]``, each attention's caches ``[B, K, c, window - 1]`` and count
        ``[B]``, the deep filter's ``(real, imag) [B, 2 t_dim, F]``."""
        cfg = self.config
        if cfg.attention_window is None:
            raise ValueError("MTFAA streaming needs a finite attention_window (the full-causal "
                             "configuration cannot carry ASA state)")

        def zeros(*shape):
            return torch.zeros(shape, device=device)

        bands = [cfg.n_bands]
        for stride in cfg.band_strides:
            bands.append((bands[-1] - 1) // stride + 1)
        st = {"pe": (zeros(batch_size, cfg.num_bins, 2, 2),)}
        ch_in = cfg.phase_channels
        for si, ch in enumerate(cfg.channels):
            st[f"enc_conv_{si}"] = zeros(batch_size, bands[si], ch_in, 1)
            st[f"enc_tfcm_{si}"] = tuple(zeros(batch_size, bands[si + 1], ch, 2 * 2 ** idx)
                                         for idx in range(cfg.tfcm_layers))
            if cfg.asa_enabled:
                st[f"enc_asa_{si}"] = getattr(self, f"enc_asa_{si}").init_stream_state(
                    batch_size, bands[si + 1], device)
            ch_in = ch
        for si in reversed(range(len(cfg.channels))):
            ch_out = cfg.channels[si - 1] if si > 0 else cfg.phase_channels
            st[f"dec_conv_{si}"] = zeros(batch_size, bands[si + 1], cfg.channels[si], 1)
            st[f"dec_tfcm_{si}"] = tuple(zeros(batch_size, bands[si], ch_out, 2 * 2 ** idx)
                                         for idx in range(cfg.tfcm_layers))
        if cfg.use_deep_filter:
            st["df"] = (zeros(batch_size, 2 * cfg.df_taps_t, cfg.num_bins),
                        zeros(batch_size, 2 * cfg.df_taps_t, cfg.num_bins))
        return st
