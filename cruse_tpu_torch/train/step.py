"""The train step and the forward adapters (counterpart of
``cruse_tpu/train/step.py``).

**Forward adapters**: noisy RI spectrum ``[B, T, F, 2]`` -> enhanced RI
spectrum, one per model family, shared by the ``auto`` inference strategy and
the train step. The JAX adapters take and return ``(params, batch_stats)``;
here the weights and statistics live in the module, so an adapter takes the
spectrum alone and returns the enhanced one. ``train`` must agree with the
module's mode. With ``train=True`` every adapter runs the model's training
forward (BatchNorm on the batch's statistics, which it records in place),
and the result carries the gradient: for CRUSE and CRUSE+DF through the GRU
recurrence's backward kernel, for CRUSE+DF and MTFAA through the deep
filter's.

**The train step** (``make_train_step``): STFT of noisy and clean -> the
model's training forward -> the losses on the enhanced spectrum (``si_snr``
through the differentiable iSTFT, ``spec``) -> the balancer's combined
cotangent -> one backward through the model -> clip by global norm -> Adam
-> BatchNorm running statistics, with the non-finite guard.

Where it differs from the JAX step, which is a pure function of an immutable
state: the model's parameters, its BatchNorm statistics and the optimiser's
moments are updated in place, and the returned ``TrainState`` holds the same
objects. The step reads the gradient norm and the losses on the host once
(one wait for the device a step) to decide the clip and the non-finite
guard; a non-finite step restores the BatchNorm statistics it snapshotted
and leaves parameters, moments, the optimiser's count and the balancer state
as they were. The optimiser is optax's ``chain(clip_by_global_norm, adam)``
written out: the clip scales by ``max_norm / norm`` only when ``norm >=
max_norm``; Adam's update is ``-lr(count) * m_hat / (sqrt(v_hat) + 1e-8)`` with
the schedule's count starting at 0 and advancing only with an applied
update. Everything is float32.

Accepted for config compatibility and refused by name when set:
``weight_decay``, ``freeze``, ``remat``, ``compute_dtype``, ``ema_decay``,
``grad_accum_steps``, ``flatten_optimizer``, a teacher, multi-channel
batches, and losses other than ``si_snr`` and ``spec``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from cruse_tpu_torch.dsp.stft import StftConfig, istft, stft
from cruse_tpu_torch.losses.balancer import Balancer, BalancerState
from cruse_tpu_torch.losses.sisnr import si_snr_loss
from cruse_tpu_torch.losses.spectral import compressed_spectral_loss

ADAM_EPS = 1e-8
PORTED_LOSSES = ("si_snr", "spec")


def _magnitude_features(model, noisy_ri: torch.Tensor) -> torch.Tensor:
    mag = torch.sqrt(noisy_ri[..., 0] ** 2 + noisy_ri[..., 1] ** 2 + 1e-12)
    return model.compress(mag)


def _check_eval(model, train: bool) -> None:
    if not train and model.training:
        raise ValueError("train=False needs the model in eval mode (model.eval()): "
                         "BatchNorm must use its running statistics")


def mask_model_forward(model) -> Callable:
    """Model consumes compressed magnitude features and emits a magnitude
    mask applied to the noisy spectrum."""

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_eval(model, train)
        mask, _ = model(_magnitude_features(model, noisy_ri), None, train)
        return noisy_ri * mask[..., None]

    return forward


def cruse_df_model_forward(model) -> Callable:
    """CruseDfNet: mask + deep-filter coefficients -> enhanced RI."""
    from cruse_tpu_torch.models.cruse_df import apply_cruse_df

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_eval(model, train)
        (mask, coefs), _ = model(_magnitude_features(model, noisy_ri), None, train)
        spec = torch.complex(noisy_ri[..., 0], noisy_ri[..., 1])
        enhanced = apply_cruse_df(spec, mask, coefs, model.config, model.filter_fn)
        return torch.stack([enhanced.real, enhanced.imag], dim=-1)

    return forward


def complex_model_forward(model) -> Callable:
    """Models that take the RI spectrum and emit the enhanced complex
    spectrum directly (MtfaaNet): enhanced RI [B, T, F, 2]. With
    ``train=True`` the model runs its training forward (batch statistics,
    which it records in place) and the result carries the gradient. A
    windowed model's streaming state is not asked for."""

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        (enhanced, _mask), _ = model(noisy_ri, None, train, with_state=False)
        return torch.stack([enhanced.real, enhanced.imag], dim=-1)

    return forward


def forward_for_model(model) -> Callable:
    """The forward adapter for a ported model."""
    from cruse_tpu_torch.models.cruse import CruseNet
    from cruse_tpu_torch.models.cruse_df import CruseDfNet
    from cruse_tpu_torch.models.dfsmn import DfsmnNet
    from cruse_tpu_torch.models.mtfaa import MtfaaNet

    if isinstance(model, MtfaaNet):
        return complex_model_forward(model)
    if isinstance(model, CruseDfNet):
        return cruse_df_model_forward(model)
    if isinstance(model, DfsmnNet) or (isinstance(model, CruseNet) and not model.config.emit_features):
        return mask_model_forward(model)
    raise NotImplementedError(f"no forward adapter for {type(model).__name__} is ported "
                              "(ported: CruseNet, CruseDfNet, DfsmnNet, MtfaaNet)")


# ---------------- the train step ----------------


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX package's step configuration. The fields after ``final_lr_scale``
    exist so that one config builds both packages; setting one raises."""

    stft: StftConfig = StftConfig(n_fft=320, hop_length=160)
    learning_rate: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    clip_grad_norm: float = 10.0
    loss_weights: tuple = (("si_snr", 1.0), ("spec", 1.0))
    balancer_ema: float = 0.999
    rescale_grads: bool = True
    skip_nonfinite_updates: bool = True  # drop the update of a step with a NaN/Inf
    lr_schedule: Optional[str] = None  # None / "constant" | "cosine" (warmup, then cosine decay)
    warmup_steps: int = 0
    decay_steps: Optional[int] = None  # the whole horizon, warmup included; needed for "cosine"
    final_lr_scale: float = 0.0
    weight_decay: float = 0.0
    freeze: tuple = ()
    remat: Optional[str] = None
    compute_dtype: Optional[str] = None
    ema_decay: Optional[float] = None
    grad_accum_steps: int = 1
    flatten_optimizer: bool = False
    sr: int = 16000

    def __post_init__(self):
        unported = {"weight_decay": self.weight_decay > 0, "freeze": bool(self.freeze),
                    "remat": self.remat is not None,
                    "compute_dtype": self.compute_dtype is not None,
                    "ema_decay": self.ema_decay is not None,
                    "grad_accum_steps": self.grad_accum_steps != 1,
                    "flatten_optimizer": self.flatten_optimizer}
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(
                    f"StepConfig.{name}={getattr(self, name)!r} is not ported: the train step "
                    "is float32 Adam with a global-norm clip, one update a step")
        for name, _ in self.loss_weights:
            if name not in PORTED_LOSSES:
                raise NotImplementedError(f"loss {name!r} is not ported (ported: {PORTED_LOSSES})")
        make_lr(self)  # an unknown schedule raises here


def make_lr(cfg: StepConfig) -> Callable[[int], float]:
    """The learning rate as a function of the optimiser's count (optax's
    ``linear_schedule`` and ``warmup_cosine_decay_schedule``, on the host)."""
    lr, warmup = cfg.learning_rate, cfg.warmup_steps

    def linear_warmup(count: int) -> float:
        return lr * min(count, warmup) / warmup

    if cfg.lr_schedule in (None, "constant"):
        return linear_warmup if warmup > 0 else (lambda count: lr)
    if cfg.lr_schedule == "cosine":
        if cfg.decay_steps is None:
            raise ValueError("the cosine schedule needs decay_steps")
        # decay_steps is the whole horizon; keep the cosine span positive for tiny runs
        span = max(cfg.decay_steps, warmup + 1) - warmup
        alpha = cfg.final_lr_scale if lr != 0.0 else 0.0

        def cosine(count: int) -> float:
            if count < warmup:
                return linear_warmup(count)
            decay = 0.5 * (1 + math.cos(math.pi * min(count - warmup, span) / span))
            return lr * ((1 - alpha) * decay + alpha)

        return cosine
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


@dataclasses.dataclass
class AdamState:
    """Adam's moments, one tensor per trainable parameter in
    ``model.parameters()`` order, and the count of applied updates."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """What a step carries. ``model`` holds the parameters and the BatchNorm
    statistics; ``step`` counts the steps taken, applied or skipped."""

    model: torch.nn.Module
    opt_state: AdamState
    balancer_state: BalancerState
    step: int = 0


def _trainable(model) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def _balancer(cfg: StepConfig) -> Balancer:
    return Balancer.make(dict(cfg.loss_weights), ema_decay=cfg.balancer_ema,
                         rescale_grads=cfg.rescale_grads)


def init_train_state(model, cfg: StepConfig, device: torch.device | str = "cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for the
    CPU; a CUDA device that is not there is an error), put it in training
    mode and start the optimiser and the balancer at zero."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to train on the CPU)")
    model = model.to(device).train()
    params = _trainable(model)
    return TrainState(model=model,
                      opt_state=AdamState(0, [torch.zeros_like(p) for p in params],
                                          [torch.zeros_like(p) for p in params]),
                      balancer_state=_balancer(cfg).init_state(device))


def _adam_update(params, grads, opt: AdamState, cfg: StepConfig, lr: float) -> None:
    """One in-place Adam update (optax's ``scale_by_adam`` and ``-lr``)."""
    count = opt.count + 1
    torch._foreach_mul_(opt.mu, cfg.beta1)
    torch._foreach_add_(opt.mu, grads, alpha=1 - cfg.beta1)
    torch._foreach_mul_(opt.nu, cfg.beta2)
    torch._foreach_addcmul_(opt.nu, grads, grads, value=1 - cfg.beta2)
    denom = torch._foreach_sqrt(torch._foreach_div(opt.nu, 1 - cfg.beta2 ** count))
    torch._foreach_add_(denom, ADAM_EPS)
    torch._foreach_addcdiv_(params, opt.mu, denom, value=-lr / (1 - cfg.beta1 ** count))
    opt.count = count


def _ri(spec: torch.Tensor) -> torch.Tensor:
    return torch.stack([spec.real, spec.imag], dim=-1)


def make_loss_gradients(model, cfg: StepConfig, forward: Callable | None = None) -> Callable:
    """The step's forward and backward without the update:
    ``loss_gradients(balancer_state, batch)`` -> ``(grads, losses,
    new_balancer_state)``, ``grads`` being one tensor per trainable parameter
    in ``model.parameters()`` order (the balancer-weighted sum of the losses'
    gradients, before the clip). It runs the model's training forward, so the
    BatchNorm running statistics move."""
    forward = forward if forward is not None else forward_for_model(model)
    balancer = _balancer(cfg)
    scfg = cfg.stft

    def loss_gradients(balancer_state: BalancerState, batch: Dict[str, torch.Tensor]):
        noisy, clean = batch["noisy"], batch["clean"]
        if noisy.dim() != 2 or clean.shape != noisy.shape:
            raise NotImplementedError(
                f"the train step takes single-channel [B, L] noisy and clean of one shape, got "
                f"{tuple(noisy.shape)} and {tuple(clean.shape)} (multi-channel is not ported)")
        length = noisy.shape[-1]
        model.train()
        params = _trainable(model)
        with torch.no_grad():
            noisy_ri, clean_ri = _ri(stft(noisy, scfg)), _ri(stft(clean, scfg))
        norm = clean_ri.shape[0] * clean_ri.shape[1] * clean_ri.shape[2]
        enhanced_ri = forward(noisy_ri, train=True)
        available = {
            "si_snr": lambda out: si_snr_loss(
                istft((out[..., 0], out[..., 1]), scfg, length=length), clean),
            "spec": lambda out: compressed_spectral_loss(out, clean_ri) / norm,
        }
        loss_fns = {name: available[name] for name, _ in cfg.loss_weights}
        out_grad, losses, new_balancer_state, _ = balancer.output_cotangent(
            loss_fns, enhanced_ri, balancer_state)
        grads = torch.autograd.grad(enhanced_ri, params, out_grad, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads, losses, new_balancer_state

    return loss_gradients


def make_train_step(model, cfg: StepConfig, forward: Callable | None = None,
                    teacher: Any = None) -> Callable:
    """Build the train step for ``model``.

    ``train_step(state, batch)`` takes ``batch = {"noisy": [B, L], "clean":
    [B, L]}`` waveforms on the model's device and returns ``(state, metrics)``
    with ``loss_<name>`` per loss, ``grad_norm`` (before the clip) and, with
    the guard on, ``nonfinite_skipped`` (0-d tensors). ``forward`` adapts the
    model (default: ``forward_for_model(model)``)."""
    if teacher is not None:
        raise NotImplementedError("distillation (a teacher) is not ported")
    loss_gradients = make_loss_gradients(model, cfg, forward)
    lr_at = make_lr(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.model is not model:
            raise ValueError("the state belongs to another model than this step was made for")
        # the forward moves the BatchNorm statistics in place: keep what a skipped step restores
        buffers = list(model.buffers())
        kept = [b.clone() for b in buffers] if cfg.skip_nonfinite_updates else None
        grads, losses, new_balancer_state = loss_gradients(state.balancer_state, batch)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        metrics = {f"loss_{name}": value for name, value in losses.items()}
        metrics["grad_norm"] = grad_norm

        # the one wait for the device: the norm decides the clip, and with the
        # losses whether anything of this step may be kept
        norm_value, *loss_values = torch.stack([grad_norm, *losses.values()]).tolist()
        finite = all(math.isfinite(v) for v in (norm_value, *loss_values))
        if cfg.skip_nonfinite_updates:
            metrics["nonfinite_skipped"] = torch.tensor(0.0 if finite else 1.0,
                                                        device=grad_norm.device)
            if not finite:
                with torch.no_grad():
                    for buffer, old in zip(buffers, kept):
                        buffer.copy_(old)
                return dataclasses.replace(state, step=state.step + 1), metrics
        with torch.no_grad():
            if norm_value >= cfg.clip_grad_norm:
                torch._foreach_mul_(grads, cfg.clip_grad_norm / norm_value)
            _adam_update(_trainable(model), grads, state.opt_state, cfg,
                         lr_at(state.opt_state.count))
        return TrainState(model=model, opt_state=state.opt_state,
                          balancer_state=new_balancer_state, step=state.step + 1), metrics

    return train_step
