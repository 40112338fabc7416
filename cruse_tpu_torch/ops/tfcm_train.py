"""One train-mode TFCM block with a three-phase backward through the CUDA
kernels, and its plain version.

Counterpart of ``cruse_tpu/ops/tfcm_train.py::tfcm_block_train`` (forward
``_fwd`` without the fold, backward ``_vjp_bwd_kernels``). With batch
statistics over B, K, T (biased variance ``E[h^2] - mean^2``), T-minor
``x [B, K, C, T]`` float32::

    h1 = x @ w1 + b1;   h1a = prelu(bn(h1; g1, be1), a1)
    h2 = dw(h1a) + bd;  h2a = prelu(bn(h2; g2, be2), a2)
    y  = h2a @ w2 + b2 + x

where ``dw`` is the (3, 3) depthwise stencil, causal and dilated by ``d`` in
time over ``h1a`` extended by 2d zero frames. ``params`` is the tuple
``(w1, b1, g1, be1, a1, wd, bd, g2, be2, a2, w2, b2)`` in the model's shapes
(``w [Cin, Cout]``, ``wd [3, 3, C]``, 0-d slopes). Both functions return
``(y, new_hist [B, K, C, 2d], m1, v1, m2, v2)``: the output, the last 2d
frames of the stencil's input (the streaming history), and the four batch
statistics for the caller's running averages. Only ``y`` carries a gradient.

``tfcm_block_train`` keeps ``x, h1, h2`` and the statistics for its
backward, which is the reference's: phase A ``tail_bwd``, BN2's backward
applied, phase B ``mid_bwd``, then BN1's backward, ``dw1``, ``db1`` and
``dx``. The 1x1 products are ``torch.matmul`` in both directions (the
reference leaves them to its compiler too); the stencil and the two
reduction-heavy phases are the kernels of ``ops/dw_kernel.py`` and
``ops/tfcm_bwd_kernels.py``, which run their plain versions on CPU tensors.
``tfcm_block_reference`` is the same forward in plain PyTorch under autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cruse_tpu_torch.ops.dw_kernel import dw_stencil_fwd, dw_taps_reference
from cruse_tpu_torch.ops.tfcm_bwd_kernels import mid_bwd, tail_bwd

PARAM_NAMES = ("w1", "b1", "g1", "be1", "a1", "wd", "bd", "g2", "be2", "a2", "w2", "b2")


def _conv_tm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv, [B, K, Cin, T] x [Cin, Cout] -> [B, K, Cout, T]."""
    return torch.matmul(w.t(), x)


def batch_stats(h: torch.Tensor):
    """Per-channel mean and biased variance ``E[h^2] - mean^2`` over B, K, T."""
    mean = h.mean(dim=(0, 1, 3))
    return mean, (h * h).mean(dim=(0, 1, 3)) - mean * mean


def _bn(h, mean, var, scale, bias, eps):
    inv = torch.rsqrt(var + eps) * scale
    return (h - mean[:, None]) * inv[:, None] + bias[:, None]


def _prelu(h, a):
    return torch.where(h >= 0, h, a * h)


def _forward(x, params, d, eps, stencil):
    w1, b1, g1, be1, a1, wd, bd, g2, be2, a2, w2, b2 = params
    h1 = _conv_tm(x, w1) + b1[:, None]
    m1, v1 = batch_stats(h1)
    xe = F.pad(_prelu(_bn(h1, m1, v1, g1, be1, eps), a1), (2 * d, 0))
    h2 = stencil(xe, wd, d) + bd[:, None]
    m2, v2 = batch_stats(h2)
    y = _conv_tm(_prelu(_bn(h2, m2, v2, g2, be2, eps), a2), w2) + b2[:, None] + x
    return y, xe[..., xe.shape[-1] - 2 * d :], h1, h2, m1, v1, m2, v2


def tfcm_block_reference(x, params, d: int, eps: float = 1e-5):
    """The block in plain PyTorch; autograd gives its backward."""
    y, hist, _, _, m1, v1, m2, v2 = _forward(x, params, d, eps, dw_taps_reference)
    return y, hist.detach(), m1.detach(), v1.detach(), m2.detach(), v2.detach()


def _bn_backward(dn, xh, dgamma, dbeta, var, scale, eps, n):
    """BatchNorm's input gradient from the gradient of its normalised output."""
    s = torch.rsqrt(var + eps) * scale
    return s[:, None] * (dn - (dbeta / n)[:, None] - xh * (dgamma / n)[:, None])


class _TfcmBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, eps, *params):
        y, hist, h1, h2, m1, v1, m2, v2 = _forward(x, params, d, eps, dw_stencil_fwd)
        ctx.save_for_backward(x, h1, h2, m1, v1, m2, v2, *params)
        ctx.d, ctx.eps = d, eps
        ctx.mark_non_differentiable(hist, m1, v1, m2, v2)
        return y, hist, m1, v1, m2, v2

    @staticmethod
    def backward(ctx, g, *_unused):
        x, h1, h2, m1, v1, m2, v2, *params = ctx.saved_tensors
        w1, b1, g1, be1, a1, wd, bd, g2, be2, a2, w2, b2 = params
        d, eps = ctx.d, ctx.eps
        n = x.shape[0] * x.shape[1] * x.shape[3]
        g = g.contiguous()

        # phase A: tail
        dh2a = torch.matmul(w2, g)  # g @ w2^T over the channel axis
        db2 = g.sum(dim=(0, 1, 3))
        dh2n, dg2, dbe2, da2 = tail_bwd(dh2a, h2, m2, v2, g2, be2, a2, eps)
        xh2 = (h2 - m2[:, None]) * torch.rsqrt(v2 + eps)[:, None]
        h2a = _prelu(xh2 * g2[:, None] + be2[:, None], a2)
        dw2 = torch.einsum("bkct,bkot->co", h2a, g)

        # phase B: BN2 applied, then the stencil's backward with BN1 / PReLU1
        dh2 = _bn_backward(dh2n, xh2, dg2, dbe2, v2, g2, eps, n)
        dh1n, dwd, dg1, dbe1, da1, dbd = mid_bwd(dh2, h1, wd, m1, v1, g1, be1, a1, d, eps)

        # phase C: BN1 applied, then the first 1x1 conv
        xh1 = (h1 - m1[:, None]) * torch.rsqrt(v1 + eps)[:, None]
        dh1 = _bn_backward(dh1n, xh1, dg1, dbe1, v1, g1, eps, n)
        db1 = dh1.sum(dim=(0, 1, 3))
        dw1 = torch.einsum("bkct,bkot->co", x, dh1)
        dx = torch.matmul(w1, dh1) + g
        return (dx, None, None, dw1, db1, dg1, dbe1, da1, dwd, dbd, dg2, dbe2, da2, dw2, db2)


def tfcm_block_train(x, params, d: int, eps: float = 1e-5):
    """The block with the kernel-backed backward (see the module doc)."""
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"params must be the {len(PARAM_NAMES)} tensors {PARAM_NAMES}, "
                         f"got {len(params)}")
    return _TfcmBlockTrain.apply(x, d, eps, *params)
