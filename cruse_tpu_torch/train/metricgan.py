"""MetricGAN+ training (counterpart of ``cruse_tpu/train/metricgan.py``): a
discriminator regresses an objective quality score, and the generator
chases the perfect score.

- The D step: ``mean((D(clean, clean) - 1)^2) + mean((D(clean, enhanced) -
  s)^2)``, where ``s`` is the measured quality of ``enhanced`` (normalized
  PESQ, ``models/bsrnn.py::batch_quality_scores``, scored on the host). D
  runs twice in one autograd graph: first on (clean, clean), storing its
  spectral norms' ``u`` and ``sigma``, then on (clean, enhanced) from the
  ``u`` the first call stored. Plain Adam at ``disc_lr`` (optax's
  ``adam``: no clip, no decay).
- Replay: past (clean, enhanced, score) triples re-enter D's training, one
  past batch after each fresh one (``ReplayBuffer``, a bounded FIFO whose
  draws come from ``np.random.default_rng(seed)``, the JAX package's).
- D pretraining: before the alternation, D regresses the scores of the
  noisy mixtures themselves (``pretrain_discriminator``).
- The G step: the generator's training forward through its family adapter
  (so any ported generator trains this way: CRUSE's through the GRU
  kernels), the iSTFT at the noisy length, ``si_snr_loss`` (the task; as
  in the JAX package, neither ``[loss.weights]`` nor the balancer is read)
  + ``adv_weight * mean((D(clean, enhanced) - 1)^2)``, D's power iteration
  run but not stored and D's parameters not updated; then the generator's
  optimiser chain as ``make_train_step`` builds it from the ``StepConfig``
  (freeze, clip, Adam or AdamW, accumulation) and the EMA. Like the JAX G
  step, it has no non-finite guard.

The state is updated in place (the generator's ``TrainState`` as the train
step does it, D's parameters, statistics and Adam moments in their module
and tensors), and each step returns the same objects. A ``None`` score list
(the ``pesq`` package refusing a pair) skips the D update and reports
``disc_loss = nan``. The JAX package's multi-process scoring (a mesh) is not
ported: the port trains on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable

import numpy as np
import torch

from cruse_tpu_torch.dsp.stft import istft, stft
from cruse_tpu_torch.losses.sisnr import si_snr_loss
from cruse_tpu_torch.models.bsrnn import Discriminator, batch_quality_scores
from cruse_tpu_torch.train.step import (AdamState, OptimizerChain, StepConfig, TrainState, _adam_update,
                                        check_state, forward_for_model, init_train_state)


@dataclasses.dataclass(frozen=True)
class MetricGanConfig:
    step: StepConfig = StepConfig()
    disc_lr: float = 1e-4
    adv_weight: float = 1.0
    ndf: int = 16


@dataclasses.dataclass
class MetricGanState:
    """The generator's train state, the discriminator (its parameters and its
    spectral norms' ``u`` / ``sigma`` buffers) and D's Adam state."""

    gen: TrainState
    disc: Discriminator
    disc_opt: AdamState


def disc_adam_state(disc: Discriminator) -> AdamState:
    """D's Adam moments at zero, one a parameter of ``disc``."""
    params = list(disc.parameters())
    return AdamState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


def init_metricgan_state(gen_model, disc: Discriminator, cfg: MetricGanConfig,
                         device: torch.device | str = "cuda") -> MetricGanState:
    """Both nets on ``device`` (the card unless the caller asks for the CPU),
    the generator's state as ``init_train_state`` makes it, D's Adam at zero."""
    gen = init_train_state(gen_model, cfg.step, device)
    disc.to(torch.device(device)).train()
    return MetricGanState(gen=gen, disc=disc, disc_opt=disc_adam_state(disc))


def _mags(wav: torch.Tensor, scfg) -> torch.Tensor:
    return stft(wav, scfg).abs()


def make_metricgan_steps(gen_model, disc: Discriminator, cfg: MetricGanConfig):
    """``(enhance, disc_step, gen_step)``:

    - ``enhance(state, noisy [B, L])`` -> the enhanced ``[B, L]``, the
      generator's eval forward without a gradient;
    - ``disc_step(state, clean, enhanced, scores [B])`` -> ``(state,
      {"disc_loss"})``;
    - ``gen_step(state, {"noisy", "clean"})`` -> ``(state, {"gen_loss",
      "task_loss", "adv_loss"})``.

    The generator runs through its family adapter,
    ``forward_for_model(gen_model)``."""
    scfg = cfg.step.stft
    forward = forward_for_model(gen_model)
    chain = OptimizerChain(gen_model, cfg.step)
    disc_adam = StepConfig()  # optax.adam's b1 = 0.9, b2 = 0.999, no decay
    gen_params = [p for p in gen_model.parameters() if p.requires_grad]

    def enhanced_wav(noisy: torch.Tensor, train: bool) -> torch.Tensor:
        spec = stft(noisy, scfg)
        out = forward(torch.stack([spec.real, spec.imag], dim=-1), train=train)
        return istft((out[..., 0], out[..., 1]), scfg, length=noisy.shape[-1])

    def enhance(state: MetricGanState, noisy: torch.Tensor) -> torch.Tensor:
        gen_model.eval()
        try:
            with torch.no_grad():
                return enhanced_wav(noisy, train=False)
        finally:
            gen_model.train()

    def disc_step(state: MetricGanState, clean: torch.Tensor, enhanced: torch.Tensor, scores: torch.Tensor):
        d = state.disc
        with torch.no_grad():
            clean_mag, enh_mag = _mags(clean, scfg), _mags(enhanced, scfg)
        d_clean = d(clean_mag, clean_mag, update_stats=True)
        d_enh = d(clean_mag, enh_mag, update_stats=True)  # from the u the first call stored
        loss = torch.mean(torch.square(d_clean - 1.0)) + torch.mean(torch.square(d_enh - scores[:, None]))
        params = list(d.parameters())
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            _adam_update(params, list(grads), state.disc_opt, disc_adam, cfg.disc_lr)
        return state, {"disc_loss": loss.detach()}

    def gen_step(state: MetricGanState, batch: Dict[str, torch.Tensor]):
        check_state(state.gen, gen_model, cfg.step)
        noisy, clean = batch["noisy"], batch["clean"]
        gen_model.train()
        with torch.no_grad():
            clean_mag = _mags(clean, scfg)
        enhanced = enhanced_wav(noisy, train=True)
        task = si_snr_loss(enhanced, clean)
        d_enh = state.disc(clean_mag, _mags(enhanced, scfg), update_stats=False)
        adv = torch.mean(torch.square(d_enh - 1.0))
        loss = task + cfg.adv_weight * adv
        grads = torch.autograd.grad(loss, gen_params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(gen_params, grads)]
        _, clip_norm, direction, emit = chain.prepare(state.gen.opt_state, grads)
        clip_value = float(clip_norm)  # the host reads the norm for the clip, as the train step does
        chain.apply(state.gen, direction, clip_value, emit)
        state.gen = dataclasses.replace(state.gen, step=state.gen.step + 1)
        return state, {"gen_loss": loss.detach(), "task_loss": task.detach(), "adv_loss": adv.detach()}

    return enhance, disc_step, gen_step


class ReplayBuffer:
    """Historical (clean, enhanced, score) triples for D's replay, on the
    host: a FIFO of at most ``capacity`` batches; ``sample`` draws one
    entry with ``np.random.default_rng(seed)``, so that it draws what the
    JAX package's buffer draws."""

    def __init__(self, capacity: int = 32, seed: int = 0):
        self.capacity = capacity
        self._items: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._items)

    def add(self, clean, enhanced, scores) -> None:
        self._items.append((_host(clean), _host(enhanced), np.asarray(scores, np.float32)))
        if len(self._items) > self.capacity:
            self._items.pop(0)

    def sample(self):
        if not self._items:
            return None
        return self._items[self._rng.integers(len(self._items))]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on_disc(state: MetricGanState, x) -> torch.Tensor:
    """A host array (as a float32 tensor) or a tensor, on D's device."""
    device = next(state.disc.parameters()).device
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32), device=device)


def pretrain_discriminator(state: MetricGanState, steps, batches: Iterable, sr: int = 16000,
                           replay: ReplayBuffer | None = None):
    """D pretraining on metric-scored degradations: for each ``{"noisy",
    "clean"}`` batch the noisy mixture itself is the degraded signal (its
    SNRs spread its scores), so that D learns the quality surface before G
    produces anything; each scored batch enters ``replay``. Returns
    ``(state, mean D loss)`` (nan when no batch was scored)."""
    _, disc_step, _ = steps
    losses = []
    for batch in batches:
        clean, noisy = batch["clean"], batch["noisy"]
        scores = batch_quality_scores(list(_host(clean)), list(_host(noisy)), sr=sr)
        if scores is None:
            continue
        state, m = disc_step(state, *(_on_disc(state, x) for x in (clean, noisy, scores)))
        if replay is not None:
            replay.add(clean, noisy, scores)
        losses.append(float(m["disc_loss"]))
    return state, float(np.mean(losses)) if losses else float("nan")


def metricgan_train_batch(state: MetricGanState, batch: Dict[str, torch.Tensor], steps, sr: int = 16000,
                          replay: ReplayBuffer | None = None):
    """One alternation: enhance -> host quality scoring -> the D step on the
    fresh batch, then on one past batch from ``replay`` (which then takes
    the fresh one) -> the G step. Returns ``(state, metrics)``."""
    enhance, disc_step, gen_step = steps
    enhanced = enhance(state, batch["noisy"])
    scores = batch_quality_scores(list(_host(batch["clean"])), list(_host(enhanced)), sr=sr)
    if scores is None:  # PESQ refused a pair (silence): no D update this round
        metrics_d = {"disc_loss": math.nan}
    else:
        state, metrics_d = disc_step(state, batch["clean"], enhanced, _on_disc(state, scores))
        if replay is not None:
            past = replay.sample()
            if past is not None:
                state, _ = disc_step(state, *(_on_disc(state, x) for x in past))
            replay.add(batch["clean"], enhanced, scores)
    state, metrics_g = gen_step(state, batch)
    return state, {**metrics_d, **metrics_g}
