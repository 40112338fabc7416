"""Forward adapters (counterpart of ``cruse_tpu/train/step.py:184-249,
312-328``): noisy RI spectrum ``[B, T, F, 2]`` -> enhanced RI spectrum, one
adapter per model family, shared by the ``auto`` inference strategy and, in
a later slice, by the train step.

Only the eval forward is ported: the model's BatchNorm layers use their
running statistics, so the model must be in eval mode. ``train=True``
raises until the train step is ported. The JAX adapters take and return
``(params, batch_stats)``; here the weights and statistics live in the
module, so an adapter takes the spectrum alone and returns the enhanced one.
"""
from __future__ import annotations

from typing import Callable

import torch


def _magnitude_features(model, noisy_ri: torch.Tensor) -> torch.Tensor:
    mag = torch.sqrt(noisy_ri[..., 0] ** 2 + noisy_ri[..., 1] ** 2 + 1e-12)
    return model.compress(mag)


def _check_eval(model, train: bool) -> None:
    if train:
        raise NotImplementedError("the training forward is ported with the train step; "
                                  "only train=False runs")
    if model.training:
        raise ValueError("train=False needs the model in eval mode (model.eval()): "
                         "BatchNorm must use its running statistics")


def mask_model_forward(model) -> Callable:
    """Model consumes compressed magnitude features and emits a magnitude
    mask applied to the noisy spectrum."""

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_eval(model, train)
        mask, _ = model(_magnitude_features(model, noisy_ri))
        return noisy_ri * mask[..., None]

    return forward


def cruse_df_model_forward(model) -> Callable:
    """CruseDfNet: mask + deep-filter coefficients -> enhanced RI."""
    from cruse_tpu_torch.models.cruse_df import apply_cruse_df

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_eval(model, train)
        (mask, coefs), _ = model(_magnitude_features(model, noisy_ri))
        spec = torch.complex(noisy_ri[..., 0], noisy_ri[..., 1])
        enhanced = apply_cruse_df(spec, mask, coefs, model.config, model.filter_fn)
        return torch.stack([enhanced.real, enhanced.imag], dim=-1)

    return forward


def complex_model_forward(model) -> Callable:
    """Models that take the RI spectrum and emit the enhanced complex
    spectrum directly (MtfaaNet): enhanced RI [B, T, F, 2]."""

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_eval(model, train)
        (enhanced, _mask), _ = model(noisy_ri)
        return torch.stack([enhanced.real, enhanced.imag], dim=-1)

    return forward


def forward_for_model(model) -> Callable:
    """The forward adapter for a ported model."""
    from cruse_tpu_torch.models.cruse import CruseNet
    from cruse_tpu_torch.models.cruse_df import CruseDfNet
    from cruse_tpu_torch.models.mtfaa import MtfaaNet

    if isinstance(model, MtfaaNet):
        return complex_model_forward(model)
    if isinstance(model, CruseDfNet):
        return cruse_df_model_forward(model)
    if isinstance(model, CruseNet) and not model.config.emit_features:
        return mask_model_forward(model)
    raise NotImplementedError(f"no forward adapter for {type(model).__name__} is ported "
                              "(ported: CruseNet, CruseDfNet, MtfaaNet)")
