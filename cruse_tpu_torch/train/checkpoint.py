"""Checkpoint trio: latest / best / per-epoch weights, written with
``torch.save`` (counterpart of ``cruse_tpu/train/checkpoint.py``, whose files
orbax writes).

Under a run's ``checkpoints/`` directory:

- ``latest``: the whole train state -- the model's ``state_dict`` (weights
  and BatchNorm statistics), Adam's ``count``, ``mu`` and ``nu``, the
  gradient accumulator and its mini-step count, the balancer's state,
  ``step``, the EMA of the parameters (None without one) -- with ``epoch``
  and ``best_score``; overwritten at every save;
- ``model_NNNN``: that epoch's ``state_dict`` alone, or with an EMA
  ``{"model": state_dict, "ema": {name: tensor}}``, and beside it
  ``model_NNNN.npz``, the same weights in the flax layout
  (``utils/weights.py::flax_from_state_dict``, ``save_flax_npz``) with the
  EMA as an ``ema_params`` subtree, as the JAX package's snapshot holds it;
  ``python -m cruse_tpu_torch.infer --weights`` serves it, the EMA weights
  where they are;
- ``best``: the whole state, overwritten on a new best composite score.

- ``disc_latest`` (MetricGAN+ training): the discriminator's ``state_dict``
  (its parameters and its spectral norms' ``u`` and ``sigma``) and its
  Adam state, written beside ``latest`` (``save_discriminator``) and read
  back on resume (``restore_discriminator``).

A file is written to a temporary name and renamed, so that a run stopped in
the middle of a save leaves the previous file whole. ``restore_checkpoint``
loads ``latest`` into a train state in place; ``preload_params`` warm-starts
a model's parameters from a snapshot, tolerating missing entries and
preferring the EMA weights where the snapshot has them.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from cruse_tpu_torch.train.step import TrainState
from cruse_tpu_torch.utils.logger import log
from cruse_tpu_torch.utils.weights import (flax_from_state_dict, load_flax_npz, save_flax_npz,
                                           state_dict_from_flax)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def state_to_host(state: TrainState) -> Dict[str, Any]:
    """A CPU copy of the train state (the parameters are updated in place
    on the device, so a snapshot must be a copy)."""
    opt = state.opt_state
    return {
        "model": {k: _host(v) for k, v in state.model.state_dict().items()},
        "opt_count": int(opt.count),
        "opt_mu": [_host(m) for m in opt.mu],
        "opt_nu": [_host(v) for v in opt.nu],
        "opt_mini_step": int(opt.mini_step),
        "opt_acc": None if opt.acc is None else [_host(a) for a in opt.acc],
        "balancer_total": {k: _host(v) for k, v in state.balancer_state.total.items()},
        "balancer_fix": {k: _host(v) for k, v in state.balancer_state.fix.items()},
        "step": int(state.step),
        "ema": None if state.ema is None else [_host(e) for e in state.ema],
    }


def _trainable_names(model) -> List[str]:
    return [name for name, p in model.named_parameters() if p.requires_grad]


def _write(obj, path: Path) -> None:
    partial = path.with_name(f".{path.name}.tmp{os.getpid()}")
    torch.save(obj, partial)
    os.replace(partial, path)


def save_checkpoint(ckpt_dir: str | Path, state: TrainState | Dict[str, Any], epoch: int,
                    best_score: float, is_best_epoch: bool = False, model=None) -> None:
    """Write ``latest``, ``model_NNNN`` (+ ``.npz``) and, on a best epoch,
    ``best``. ``state`` is a train state, or a ``state_to_host`` snapshot of
    one, whose model ``model`` names (for the flax layout)."""
    ckpt_dir = Path(ckpt_dir).expanduser().absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(state, TrainState):
        model = state.model
        state = state_to_host(state)
    tree = {**state, "epoch": int(epoch), "best_score": float(best_score)}
    _write(tree, ckpt_dir / "latest")
    # with an EMA, validation scored the EMA weights: the deployable snapshot carries them
    ema = None if tree.get("ema") is None else dict(zip(_trainable_names(model), tree["ema"]))
    _write(tree["model"] if ema is None else {"model": tree["model"], "ema": ema}, ckpt_dir / f"model_{epoch:04d}")
    npz = ckpt_dir / f"model_{epoch:04d}.npz"
    partial = ckpt_dir / f".{npz.stem}.tmp{os.getpid()}.npz"
    variables = flax_from_state_dict(model, tree["model"])
    if ema is not None:  # the BatchNorm statistics as they are, the EMA in place of the parameters
        variables["ema_params"] = flax_from_state_dict(model, {**tree["model"], **ema})["params"]
    save_flax_npz(variables, str(partial))
    os.replace(partial, npz)
    if is_best_epoch:
        _write(tree, ckpt_dir / "best")


def save_discriminator(ckpt_dir: str | Path, disc, disc_opt) -> None:
    """Write ``disc_latest``: ``disc``'s state_dict and ``disc_opt`` (an
    ``AdamState``), on the host."""
    ckpt_dir = Path(ckpt_dir).expanduser().absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    _write({"disc": {k: _host(v) for k, v in disc.state_dict().items()}, "opt_count": int(disc_opt.count),
            "opt_mu": [_host(m) for m in disc_opt.mu], "opt_nu": [_host(v) for v in disc_opt.nu]},
           ckpt_dir / "disc_latest")


def restore_discriminator(ckpt_dir: str | Path, disc, disc_opt) -> None:
    """Load ``disc_latest`` into ``disc`` and ``disc_opt`` in place."""
    tree = load_checkpoint(Path(ckpt_dir).expanduser() / "disc_latest")
    disc.load_state_dict(tree["disc"], strict=True)
    if len(tree["opt_mu"]) != len(disc_opt.mu):
        raise ValueError(f"disc_latest: {len(tree['opt_mu'])} Adam moments for a discriminator with "
                         f"{len(disc_opt.mu)} parameters")
    with torch.no_grad():
        torch._foreach_copy_(disc_opt.mu + disc_opt.nu, tree["opt_mu"] + tree["opt_nu"])
    disc_opt.count = int(tree["opt_count"])


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """A checkpoint file's contents (tensors on the CPU)."""
    path = Path(path).expanduser().absolute()
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist, can not load checkpoint.")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str | Path, state: TrainState,
                       which: str = "latest") -> Tuple[TrainState, int, float]:
    """Load ``which`` into ``state`` in place (model, Adam's moments and
    count, the accumulator, balancer, step, EMA). Returns (state, saved
    epoch + 1, best_score).

    A checkpoint written without an EMA (it holds ``"ema": None``, or no
    such entry) restored into a state that keeps one starts the EMA from
    the restored parameters; that case alone -- an EMA entry that does not
    fit the model raises, as any other mismatch does. A checkpoint without
    an accumulator restored into a state that accumulates starts it at zero."""
    tree = load_checkpoint(Path(ckpt_dir).expanduser() / which)
    state.model.load_state_dict(tree["model"], strict=True)
    opt = state.opt_state

    def copy_into(mine, saved, what):
        if len(saved) != len(mine):
            raise ValueError(f"checkpoint {which}: {len(saved)} {what} for a model "
                             f"with {len(mine)} trainable parameters")
        with torch.no_grad():
            for m, v in zip(mine, saved):
                if m.shape != v.shape:
                    raise ValueError(f"checkpoint {which}: {what} of shape {tuple(v.shape)} "
                                     f"for a parameter of shape {tuple(m.shape)}")
                m.copy_(v)

    copy_into(opt.mu + opt.nu, tree["opt_mu"] + tree["opt_nu"], "Adam moments")
    opt.count = int(tree["opt_count"])
    if opt.acc is not None:
        if tree.get("opt_acc") is not None:
            copy_into(opt.acc, tree["opt_acc"], "accumulated gradients")
            opt.mini_step = int(tree["opt_mini_step"])
        else:
            torch._foreach_zero_(opt.acc)
            opt.mini_step = 0
    if state.ema is not None:
        if tree.get("ema") is not None:
            copy_into(state.ema, tree["ema"], "EMA tensors")
        else:
            with torch.no_grad():
                torch._foreach_copy_(state.ema, [p.detach() for p in state.model.parameters() if p.requires_grad])
            log(f"checkpoint {which} predates EMA; initialized the EMA from the parameters")
    device = opt.mu[0].device if opt.mu else None
    balancer = state.balancer_state
    balancer.total = {k: v.to(device) for k, v in tree["balancer_total"].items()}
    balancer.fix = {k: v.to(device) for k, v in tree["balancer_fix"].items()}
    state.step = int(tree["step"])
    return state, int(tree["epoch"]) + 1, float(tree["best_score"])


def _read_weights(path: Path, model) -> Dict[str, torch.Tensor]:
    """A snapshot's tensors by the port's names: a checkpoint file (the
    whole state, or ``model_NNNN``'s) or a flax-layout ``.npz``; where the
    snapshot holds an EMA of the parameters, the EMA in their place (the
    weights that validation scored), as the JAX package's loader prefers it."""
    if path.suffix == ".npz":
        return state_dict_from_flax(load_flax_npz(str(path)), model)
    tree = load_checkpoint(path)
    if "model" not in tree:
        return tree
    ema = tree.get("ema")
    if ema is None:
        return tree["model"]
    log(f"loading EMA weights from {path.name} (an EMA present)")
    return {**tree["model"], **(ema if isinstance(ema, dict) else dict(zip(_trainable_names(model), ema)))}


def preload_params(ckpt_path: str | Path, model, statistics: bool = False) -> Dict[str, int]:
    """Warm-start: copy a snapshot's parameters into ``model``, the EMA
    weights where the snapshot has them. The BatchNorm statistics stay as
    they are, as the JAX package's preload keeps its batch_stats, unless
    ``statistics`` (its ``preload_variables``, which loads a distillation
    teacher) asks for them too. A parameter the snapshot lacks keeps its
    value; a parameter of another shape, or a snapshot that matches none of
    the model's parameters (a stale layout), raises. Returns the counts of
    parameters merged and kept."""
    ckpt_path = Path(ckpt_path).expanduser().absolute()
    if not ckpt_path.is_file():
        raise FileNotFoundError(f"The file {ckpt_path} does not exist.")
    restored = _read_weights(ckpt_path, model)
    merged, kept = 0, 0
    with torch.no_grad():
        if statistics:
            for name, buffer in model.named_buffers():
                if name in restored and tuple(restored[name].shape) == tuple(buffer.shape):
                    buffer.copy_(restored[name])
        for name, param in model.named_parameters():
            value = restored.get(name)
            if value is None:
                kept += 1
                continue
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"checkpoint params: {name} has shape {tuple(value.shape)}, the model's "
                                 f"is {tuple(param.shape)}")
            param.copy_(value)
            merged += 1
    if merged == 0 and kept > 0 and restored:
        raise ValueError(
            f"checkpoint params: 0 of {kept} template leaves matched the {len(restored)} restored "
            "leaves — the checkpoint's parameter layout does not correspond to this model (stale snapshot?)")
    if kept:
        log(f"checkpoint params: merged {merged} leaves, kept {kept} template leaves")
    return {"merged": merged, "kept": kept}
