"""The train step and the forward adapters (counterpart of
``cruse_tpu/train/step.py``).

**Forward adapters**: noisy RI spectrum ``[B, T, F, 2]`` -> enhanced RI
spectrum, one per model family (CRUSE and DFSMN, CRUSE+DF, MTFAA and BSRNN,
FullSubNet, McCruse), shared by the ``auto`` inference strategy and the
train step. The JAX adapters take and return ``(params, batch_stats)``;
here the weights and statistics live in the module, so an adapter takes the
spectrum alone and returns the enhanced one. ``train`` must agree with the
module's mode. With ``train=True`` every adapter runs the model's training
forward (BatchNorm on the batch's statistics, which it records in place),
and the result carries the gradient: for CRUSE, CRUSE+DF and FullSubNet
through the GRU recurrence's backward kernel, for CRUSE+DF and MTFAA through
the deep filter's, for BSRNN through cuDNN's LSTM backward.

**The train step** (``make_train_step``): STFT of noisy and clean -> (with
a teacher) the teacher's eval forward under ``torch.no_grad`` -> the
model's training forward -> the losses on the enhanced spectrum (``si_snr``
and ``multi_res`` through the differentiable iSTFT, ``spec``, ``wo_male``,
``sdnr``, ``cirm``, ``pmsqe``, and ``distill`` against the teacher's
spectrum) -> the balancer's combined cotangent -> one backward through the
model -> the optimiser -> the EMA of the parameters, with the non-finite
guard. A multi-channel batch (noisy ``[B, M, L]``, clean ``[B, L]``, the
reference mic's target) goes to a multi-channel adapter as the RI of
``mc_stft`` ``[B, M, T, F, 2]``, the teacher's input too; the losses read
the reference mic's (``model.config.reference_channel``) noisy spectrum and
waveform. There ``sdnr`` takes noise = the reference mic's noisy waveform -
clean, where the JAX step subtracts ``[B, L]`` from ``[B, M, L]`` (which
raises unless M = B, and is wrong when M = B).

Where it differs from the JAX step, which is a pure function of an immutable
state: the model's parameters, its BatchNorm statistics, the optimiser's
moments and accumulator and the EMA are updated in place, and the returned
``TrainState`` holds the same objects. The step reads the gradient norms and
the losses on the host once (one wait for the device a step) to decide the
clip and the non-finite guard; a non-finite step restores the BatchNorm
statistics it snapshotted and leaves parameters, moments, accumulator, EMA,
the optimiser's count and the balancer state as they were.

The optimiser is optax's chain as the JAX package's ``make_optimizer``
composes it, written out: zero the ``freeze`` leaves' gradients -> clip by
global norm (scale by ``max_norm / norm`` only when ``norm >= max_norm``) ->
Adam, ``-lr(count) * m_hat / (sqrt(v_hat) + 1e-8)``, or AdamW when
``weight_decay > 0``, which adds ``weight_decay * p`` to the direction of
every leaf whose flax counterpart has two dimensions or more -> no update
for the ``freeze`` leaves. With ``grad_accum_steps = k > 1`` (optax's
``MultiSteps``) a step adds its gradients to a running mean and the chain
runs on that mean once every k steps; the optimiser's count, and so the
schedule, advances once an update. ``freeze`` patterns and the decay mask
are read on the JAX package's parameter tree (``utils/weights.py::
flax_param_paths``), so that a pattern freezes the same tensors in both.
``grad_norm`` is the step's own gradients' norm before any of this. With
``ema_decay = d`` the EMA moves every step, ``e = d e + (1 - d) p``, the
parameters moved or not. Everything is float32.

Accepted for config compatibility and refused by name when set: ``remat``,
``compute_dtype`` and ``flatten_optimizer``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from cruse_tpu_torch.dsp.stft import StftConfig, istft, mc_stft, stft
from cruse_tpu_torch.losses.balancer import Balancer, BalancerState
from cruse_tpu_torch.losses.pmsqe import pmsqe_loss
from cruse_tpu_torch.losses.sisnr import si_snr_loss
from cruse_tpu_torch.losses.spectral import (cirm_mse_loss, compressed_spectral_loss, multi_res_spectral_loss,
                                             sdnr_loss, weighted_male_loss)

ADAM_EPS = 1e-8
STEP_LOSSES = ("si_snr", "spec", "wo_male", "multi_res", "sdnr", "cirm", "pmsqe", "distill")


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
    spectrum directly (MtfaaNet, whose model returns ``((enhanced, mask),
    state)``, and BSRNN, ``(enhanced, state)``): enhanced RI [B, T, F, 2].
    With ``train=True`` the model runs its training forward (MTFAA's batch
    statistics, which it records in place) and the result carries the
    gradient. A windowed MTFAA's streaming state is not asked for; a causal
    BSRNN's is returned and dropped."""
    from cruse_tpu_torch.models.bsrnn import BSRNN

    bsrnn = isinstance(model, BSRNN)

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        if bsrnn:
            enhanced, _ = model(noisy_ri, None, train)
        else:
            (enhanced, _mask), _ = model(noisy_ri, None, train, with_state=False)
        return torch.stack([enhanced.real, enhanced.imag], dim=-1)

    return forward


def fullsubnet_model_forward(model) -> Callable:
    """FullSubNet: the magnitude ``sqrt(re^2 + im^2 + 1e-12)`` in, the
    compressed cIRM out; each component decompressed and the noisy spectrum
    multiplied by the mask -> enhanced RI."""
    from cruse_tpu_torch.dsp.mask import complex_mul, decompress_cirm

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_eval(model, train)
        mag = torch.sqrt(noisy_ri[..., 0] ** 2 + noisy_ri[..., 1] ** 2 + 1e-12)
        cirm, _ = model(mag, None, train)
        er, ei = complex_mul(noisy_ri[..., 0], noisy_ri[..., 1], decompress_cirm(cirm[..., 0]),
                             decompress_cirm(cirm[..., 1]))
        return torch.stack([er, ei], dim=-1)

    return forward


def mc_model_forward(model) -> Callable:
    """Multi-channel models (McCruseNet): ``noisy_ri`` is the multi-channel RI
    spectrum ``[B, M, T, F, 2]``; its directional features feed the model
    and the mask multiplies the reference channel -> enhanced RI ``[B, T, F,
    2]``."""
    from cruse_tpu_torch.dsp.features import directional_features_from_ri

    cfg = model.config

    def forward(noisy_ri: torch.Tensor, train: bool = False) -> torch.Tensor:
        _check_eval(model, train)
        if noisy_ri.dim() != 5:
            raise ValueError(f"the multi-channel adapter takes [B, M, T, F, 2], got {tuple(noisy_ri.shape)}")
        feats = directional_features_from_ri(noisy_ri, cfg.mic_pairs, cfg.reference_channel, cfg.use_sin_ipd)
        mask, _ = model(feats, None, train)
        return noisy_ri[:, cfg.reference_channel] * mask[..., None]

    forward.multi_channel = True  # the step hands it [B, M, L] batches
    return forward


def forward_for_model(model) -> Callable:
    """The forward adapter for a ported model."""
    from cruse_tpu_torch.models.bsrnn import BSRNN
    from cruse_tpu_torch.models.cruse import CruseNet
    from cruse_tpu_torch.models.cruse_df import CruseDfNet
    from cruse_tpu_torch.models.dfsmn import DfsmnNet
    from cruse_tpu_torch.models.fullsubnet import FullSubNet
    from cruse_tpu_torch.models.mc_cruse import McCruseNet
    from cruse_tpu_torch.models.mtfaa import MtfaaNet

    if isinstance(model, McCruseNet):
        return mc_model_forward(model)
    if isinstance(model, (MtfaaNet, BSRNN)):
        return complex_model_forward(model)
    if isinstance(model, CruseDfNet):
        return cruse_df_model_forward(model)
    if isinstance(model, FullSubNet):
        return fullsubnet_model_forward(model)
    if isinstance(model, DfsmnNet) or (isinstance(model, CruseNet) and not model.config.emit_features):
        return mask_model_forward(model)
    raise NotImplementedError(f"no forward adapter for {type(model).__name__} is ported "
                              "(ported: CruseNet, CruseDfNet, DfsmnNet, MtfaaNet, FullSubNet, McCruseNet, BSRNN)")


# ---------------- the train step ----------------


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX package's step configuration. ``remat``, ``compute_dtype`` and
    ``flatten_optimizer`` exist so that one config builds both packages;
    setting one raises."""

    stft: StftConfig = StftConfig(n_fft=320, hop_length=160)
    learning_rate: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0  # > 0: AdamW, decaying the leaves of two dimensions or more
    freeze: tuple = ()  # substrings of parameter paths whose gradients and updates are zeroed
    clip_grad_norm: float = 10.0
    loss_weights: tuple = (("si_snr", 1.0), ("spec", 1.0))
    balancer_ema: float = 0.999
    rescale_grads: bool = True
    skip_nonfinite_updates: bool = True  # drop the update of a step with a NaN/Inf
    remat: Optional[str] = None
    compute_dtype: Optional[str] = None
    lr_schedule: Optional[str] = None  # None / "constant" | "cosine" (warmup, then cosine decay)
    warmup_steps: int = 0
    decay_steps: Optional[int] = None  # the whole horizon, warmup included; needed for "cosine"
    final_lr_scale: float = 0.0
    ema_decay: Optional[float] = None  # keep an EMA of the parameters; validation scores it
    grad_accum_steps: int = 1  # > 1: one update from the mean of k steps' gradients
    flatten_optimizer: bool = False
    sr: int = 16000  # sizes the Bark tables of the pmsqe loss

    def __post_init__(self):
        unported = {"remat": self.remat is not None, "compute_dtype": self.compute_dtype is not None,
                    "flatten_optimizer": self.flatten_optimizer}
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(
                    f"StepConfig.{name}={getattr(self, name)!r} is not ported: the train step "
                    "runs float32, saves every residual and updates leaf by leaf")
        if isinstance(self.freeze, str):
            raise ValueError("freeze must be a list or tuple of path substrings, not a string "
                             "(a bare string would match per character and pin everything)")
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps={self.grad_accum_steps} must be at least 1")
        for name, _ in self.loss_weights:
            if name not in STEP_LOSSES:
                raise ValueError(f"unknown loss {name!r} (the step's losses: {STEP_LOSSES})")
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
    ``model.parameters()`` order, and the count of applied updates; with
    gradient accumulation also the running mean ``acc`` of the gradients of
    the ``mini_step`` steps taken since the last update (optax's
    ``MultiStepsState``)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None


@dataclasses.dataclass
class TrainState:
    """What a step carries. ``model`` holds the parameters and the BatchNorm
    statistics; ``step`` counts the steps taken, applied or skipped; ``ema``
    is the EMA of the trainable parameters (``StepConfig.ema_decay``), in
    the order of ``opt_state.mu``, or None."""

    model: torch.nn.Module
    opt_state: AdamState
    balancer_state: BalancerState
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None


def _trainable(model) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def _balancer(cfg: StepConfig) -> Balancer:
    return Balancer.make(dict(cfg.loss_weights), ema_decay=cfg.balancer_ema,
                         rescale_grads=cfg.rescale_grads)


def init_train_state(model, cfg: StepConfig, device: torch.device | str = "cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for the
    CPU; a CUDA device that is not there is an error), put it in training
    mode and start the optimiser and the balancer at zero, the accumulator
    at zero and the EMA at the parameters when the config asks for them."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to train on the CPU)")
    model = model.to(device).train()
    params = _trainable(model)
    zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
    return TrainState(model=model,
                      opt_state=AdamState(0, zeros(), zeros(),
                                          acc=zeros() if cfg.grad_accum_steps > 1 else None),
                      balancer_state=_balancer(cfg).init_state(device),
                      ema=[p.detach().clone() for p in params] if cfg.ema_decay is not None else None)


def param_masks(model, cfg: StepConfig):
    """(frozen, decayed): a flag per trainable parameter, in the optimiser's
    order. ``frozen``: a ``freeze`` pattern is a substring of the
    parameter's path in the JAX package's tree (``jax.tree_util.keystr``
    form, ``['enc_0']['conv']['kernel']``); ``decayed``: AdamW decays it,
    its flax leaf having two dimensions or more."""
    from cruse_tpu_torch.utils.weights import flax_param_paths, jax_keystr

    paths = flax_param_paths(model)
    names = [name for name, p in model.named_parameters() if p.requires_grad]
    frozen = [any(pat in jax_keystr(paths[n][0]) for pat in cfg.freeze) for n in names]
    decayed = [cfg.weight_decay > 0 and paths[n][1] >= 2 for n in names]
    return frozen, decayed


def _adam_update(params, grads, opt: AdamState, cfg: StepConfig, lr: float,
                 frozen: Optional[List[bool]] = None, decayed: Optional[List[bool]] = None) -> None:
    """One in-place update: optax's ``scale_by_adam``, AdamW's
    ``add_decayed_weights`` on the ``decayed`` leaves, ``-lr``. Every leaf's
    moments move (a frozen leaf's with the zero gradient it was given); the
    ``frozen`` leaves themselves do not."""
    count = opt.count + 1
    torch._foreach_mul_(opt.mu, cfg.beta1)
    torch._foreach_add_(opt.mu, grads, alpha=1 - cfg.beta1)
    torch._foreach_mul_(opt.nu, cfg.beta2)
    torch._foreach_addcmul_(opt.nu, grads, grads, value=1 - cfg.beta2)
    denom = torch._foreach_sqrt(torch._foreach_div(opt.nu, 1 - cfg.beta2 ** count))
    torch._foreach_add_(denom, ADAM_EPS)
    live = [i for i in range(len(params)) if not (frozen and frozen[i])]
    decay = [params[i] for i in live if decayed and decayed[i]]
    if decay:  # p - lr (dir + wd p): the decay reads p before the step, as optax's does
        torch._foreach_mul_(decay, 1 - lr * cfg.weight_decay)
    torch._foreach_addcdiv_([params[i] for i in live], [opt.mu[i] for i in live], [denom[i] for i in live],
                            value=-lr / (1 - cfg.beta1 ** count))
    opt.count = count


def _ri(spec: torch.Tensor) -> torch.Tensor:
    return torch.stack([spec.real, spec.imag], dim=-1)


def step_losses(cfg: StepConfig, noisy: torch.Tensor, clean: torch.Tensor, noisy_spec: torch.Tensor,
                clean_spec: torch.Tensor, teacher_ri: torch.Tensor | None = None) -> Dict[str, Callable]:
    """The step's losses as functions of the enhanced RI spectrum ``[B, T, F,
    2]`` alone (the balancer's form), given the batch's waveforms ``[B, L]``
    and their complex spectra ``[B, T, F]`` (of a multi-channel batch, the
    reference mic's noisy waveform and spectrum): every loss of
    ``STEP_LOSSES``, ``distill`` only with the teacher's enhanced
    spectrum."""
    scfg, length = cfg.stft, noisy.shape[-1]
    noisy_ri, clean_ri = _ri(noisy_spec), _ri(clean_spec)
    norm = clean_ri.shape[0] * clean_ri.shape[1] * clean_ri.shape[2]

    def wave(out):
        return istft((out[..., 0], out[..., 1]), scfg, length=length)

    def sdnr(out):
        # VAD-gated and SNR-weighted: the gain from the enhanced magnitude,
        # noise = noisy - clean, each utterance's SNR from the waveforms
        noisy_mag = torch.sqrt(noisy_ri[..., 0] ** 2 + noisy_ri[..., 1] ** 2 + 1e-12)
        enh_mag = torch.sqrt(out[..., 0] ** 2 + out[..., 1] ** 2 + 1e-12)
        gain = torch.clamp(enh_mag / (noisy_mag + 1e-8), 0.0, 1.0)
        snr_db = 10.0 * torch.log10((clean ** 2).sum(-1) / (((noisy - clean) ** 2).sum(-1) + 1e-10) + 1e-10)
        return sdnr_loss(clean_spec, gain, noisy_spec - clean_spec, snr_db) / norm

    losses = {
        "si_snr": lambda out: si_snr_loss(wave(out), clean),
        "spec": lambda out: compressed_spectral_loss(out, clean_ri) / norm,
        "wo_male": lambda out: weighted_male_loss(out, clean_ri, noisy_ri),
        "multi_res": lambda out: multi_res_spectral_loss(wave(out), clean),
        "sdnr": sdnr,
        "cirm": lambda out: cirm_mse_loss(out, noisy_ri, clean_ri),
        "pmsqe": lambda out: pmsqe_loss(out, clean_ri, sr=cfg.sr),
    }
    if teacher_ri is not None:
        losses["distill"] = lambda out: compressed_spectral_loss(out, teacher_ri) / norm
    return losses


def make_loss_gradients(model, cfg: StepConfig, forward: Callable | None = None,
                        teacher: tuple | None = None) -> Callable:
    """The step's forward and backward without the update:
    ``loss_gradients(balancer_state, batch)`` -> ``(grads, losses,
    new_balancer_state)``, ``grads`` being one tensor per trainable parameter
    in ``model.parameters()`` order (the balancer-weighted sum of the losses'
    gradients, before the clip). It runs the model's training forward, so the
    BatchNorm running statistics move. ``teacher``: ``(teacher_forward,
    teacher_model)``, run in eval mode without a gradient on the same noisy
    spectrum; the ``distill`` loss needs it."""
    forward = forward if forward is not None else forward_for_model(model)
    if any(name == "distill" for name, _ in cfg.loss_weights) and teacher is None:
        raise ValueError(
            "loss_weights includes 'distill' but no teacher was given: pass "
            "teacher=(forward_for_model(teacher_model), teacher_model) to make_train_step / "
            "Trainer(teacher=teacher_model), or configure [trainer.distillation] with config= "
            "and checkpoint= in the TOML")
    balancer = _balancer(cfg)
    scfg = cfg.stft

    multi_channel = getattr(forward, "multi_channel", False)
    reference = getattr(getattr(model, "config", None), "reference_channel", 0)

    def loss_gradients(balancer_state: BalancerState, batch: Dict[str, torch.Tensor]):
        noisy, clean = batch["noisy"], batch["clean"]
        if noisy.dim() == 3 and multi_channel:
            if clean.shape != (noisy.shape[0], noisy.shape[2]):
                raise ValueError(f"a multi-channel batch takes noisy [B, M, L] and clean [B, L], got "
                                 f"{tuple(noisy.shape)} and {tuple(clean.shape)}")
        elif noisy.dim() != 2 or clean.shape != noisy.shape:
            raise ValueError(
                f"noisy {tuple(noisy.shape)} and clean {tuple(clean.shape)}: the step takes [B, L] noisy and "
                f"clean of one shape, or [B, M, L] and [B, L] for a multi-channel model, which "
                f"{type(model).__name__} is not")
        model.train()
        params = _trainable(model)
        with torch.no_grad():
            clean_spec = stft(clean, scfg)
            if noisy.dim() == 3:
                spec = mc_stft(noisy, scfg)
                model_ri, noisy_spec, noisy = _ri(spec), spec[:, reference], noisy[:, reference]
            else:
                noisy_spec = stft(noisy, scfg)
                model_ri = _ri(noisy_spec)
        teacher_ri = None
        if teacher is not None:
            # the frozen teacher on the same input, once a step: a constant of the student's graph
            teacher_forward, teacher_model = teacher
            teacher_model.eval()
            with torch.no_grad():
                teacher_ri = teacher_forward(model_ri, train=False)
        enhanced_ri = forward(model_ri, train=True)
        available = step_losses(cfg, noisy, clean, noisy_spec, clean_spec, teacher_ri)
        loss_fns = {name: available[name] for name, _ in cfg.loss_weights}
        out_grad, losses, new_balancer_state, _ = balancer.output_cotangent(
            loss_fns, enhanced_ri, balancer_state)
        grads = torch.autograd.grad(enhanced_ri, params, out_grad, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads, losses, new_balancer_state

    return loss_gradients


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class OptimizerChain:
    """The step's optimiser as the JAX package's ``make_optimizer`` composes it
    (see the module doc), on ``model``'s trainable parameters, in two halves
    around the step's one host read: ``prepare(opt, grads)`` -> ``(grad_norm,
    clip_norm, direction, emit)``, the tensors whose values the host reads
    and the direction the update takes (the running mean under accumulation,
    the frozen leaves zeroed); ``apply(state, direction, clip_value, emit)``
    clips by the host value, updates Adam / AdamW, the accumulator, the
    mini-step count and the EMA in place. MetricGAN+'s generator step
    (``train/metricgan.py``) runs the same chain on its own gradients."""

    def __init__(self, model, cfg: StepConfig):
        self.model, self.cfg = model, cfg
        self.lr_at = make_lr(cfg)
        self.frozen, self.decayed = param_masks(model, cfg)

    def prepare(self, opt: AdamState, grads: List[torch.Tensor]):
        cfg, frozen, k = self.cfg, self.frozen, self.cfg.grad_accum_steps
        grad_norm = _global_norm(grads)
        emit = opt.mini_step == k - 1
        with torch.no_grad():
            if k > 1:  # optax's MultiSteps: a running mean, acc + (g - acc) / (n + 1)
                mean = torch._foreach_add(opt.acc, torch._foreach_div(torch._foreach_sub(grads, opt.acc),
                                                                      float(opt.mini_step + 1)))
            else:
                mean = grads
            if emit and any(frozen):  # the frozen leaves' gradients are zero before the clip
                mean = [torch.zeros_like(g) if f else g for g, f in zip(mean, frozen)]
            clip_norm = _global_norm(mean) if emit and (k > 1 or any(frozen)) else grad_norm
        return grad_norm, clip_norm, mean, emit

    def apply(self, state: TrainState, mean: List[torch.Tensor], clip_value: float, emit: bool) -> None:
        cfg, opt, k = self.cfg, state.opt_state, self.cfg.grad_accum_steps
        params = _trainable(self.model)
        with torch.no_grad():
            if emit:
                if clip_value >= cfg.clip_grad_norm:
                    torch._foreach_mul_(mean, cfg.clip_grad_norm / clip_value)
                _adam_update(params, mean, opt, cfg, self.lr_at(opt.count), self.frozen, self.decayed)
                if k > 1:
                    torch._foreach_zero_(opt.acc)
            else:
                torch._foreach_copy_(opt.acc, mean)
            opt.mini_step = 0 if emit else opt.mini_step + 1
            if state.ema is not None:
                torch._foreach_mul_(state.ema, cfg.ema_decay)
                torch._foreach_add_(state.ema, params, alpha=1.0 - cfg.ema_decay)


def check_state(state: TrainState, model, cfg: StepConfig) -> None:
    """Raise unless ``state`` is ``model``'s and made from ``cfg``."""
    if state.model is not model:
        raise ValueError("the state belongs to another model than this step was made for")
    if (state.ema is None) != (cfg.ema_decay is None) or (state.opt_state.acc is None) != (cfg.grad_accum_steps == 1):
        raise ValueError("the state's EMA or accumulator does not match the step config "
                         "(make the state with init_train_state from the same config)")


def make_train_step(model, cfg: StepConfig, forward: Callable | None = None,
                    teacher: tuple | None = None) -> Callable:
    """Build the train step for ``model``.

    ``train_step(state, batch)`` takes ``batch = {"noisy": [B, L], "clean":
    [B, L]}`` waveforms on the model's device (for a multi-channel model
    noisy ``[B, M, L]``) and returns ``(state, metrics)``
    with ``loss_<name>`` per loss, ``grad_norm`` (the step's own gradients,
    before the freeze, the accumulation and the clip) and, with the guard on,
    ``nonfinite_skipped`` (0-d tensors). ``forward`` adapts the model
    (default: ``forward_for_model(model)``). ``teacher``: ``(teacher_forward,
    teacher_model)`` for the ``distill`` loss (knowledge distillation: the
    compressed spectral distance to the frozen teacher's enhanced spectrum,
    e.g. a large offline model teaching a small streaming one)."""
    loss_gradients = make_loss_gradients(model, cfg, forward, teacher)
    chain = OptimizerChain(model, cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        check_state(state, model, cfg)
        # the forward moves the BatchNorm statistics in place: keep what a skipped step restores
        buffers = list(model.buffers())
        kept = [b.clone() for b in buffers] if cfg.skip_nonfinite_updates else None
        grads, losses, new_balancer_state = loss_gradients(state.balancer_state, batch)
        grad_norm, clip_norm, mean, emit = chain.prepare(state.opt_state, grads)
        metrics = {f"loss_{name}": value for name, value in losses.items()}
        metrics["grad_norm"] = grad_norm

        # the one wait for the device: the norms decide the clip, and with the
        # losses whether anything of this step may be kept
        norm_value, clip_value, *loss_values = torch.stack([grad_norm, clip_norm, *losses.values()]).tolist()
        finite = all(math.isfinite(v) for v in (norm_value, *loss_values))
        if cfg.skip_nonfinite_updates:
            metrics["nonfinite_skipped"] = torch.tensor(0.0 if finite else 1.0, device=grad_norm.device)
            if not finite:
                with torch.no_grad():
                    for buffer, old in zip(buffers, kept):
                        buffer.copy_(old)
                return dataclasses.replace(state, step=state.step + 1), metrics
        chain.apply(state, mean, clip_value, emit)
        return TrainState(model=model, opt_state=state.opt_state, balancer_state=new_balancer_state,
                          step=state.step + 1, ema=state.ema), metrics

    return train_step
