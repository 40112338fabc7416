"""Checkpoint trio: latest / best / per-epoch weights, written with
``torch.save`` (counterpart of ``cruse_tpu/train/checkpoint.py``, whose files
orbax writes).

Under a run's ``checkpoints/`` directory:

- ``latest``: the whole train state -- the model's ``state_dict`` (weights
  and BatchNorm statistics), Adam's ``count``, ``mu`` and ``nu``, the
  balancer's state, ``step`` -- with ``epoch`` and ``best_score``;
  overwritten at every save;
- ``model_NNNN``: that epoch's ``state_dict`` alone, and beside it
  ``model_NNNN.npz``, the same weights in the flax layout
  (``utils/weights.py::flax_from_state_dict``, ``save_flax_npz``), which
  ``python -m cruse_tpu_torch.infer --weights`` serves;
- ``best``: the whole state, overwritten on a new best composite score.

A file is written to a temporary name and renamed, so that a run stopped in
the middle of a save leaves the previous file whole. ``restore_checkpoint``
loads ``latest`` into a train state in place; ``preload_params`` warm-starts
a model's parameters from a snapshot, tolerating missing entries.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Tuple

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
    return {
        "model": {k: _host(v) for k, v in state.model.state_dict().items()},
        "opt_count": int(state.opt_state.count),
        "opt_mu": [_host(m) for m in state.opt_state.mu],
        "opt_nu": [_host(v) for v in state.opt_state.nu],
        "balancer_total": {k: _host(v) for k, v in state.balancer_state.total.items()},
        "balancer_fix": {k: _host(v) for k, v in state.balancer_state.fix.items()},
        "step": int(state.step),
    }


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
    _write(tree["model"], ckpt_dir / f"model_{epoch:04d}")
    npz = ckpt_dir / f"model_{epoch:04d}.npz"
    partial = ckpt_dir / f".{npz.stem}.tmp{os.getpid()}.npz"
    save_flax_npz(flax_from_state_dict(model, tree["model"]), str(partial))
    os.replace(partial, npz)
    if is_best_epoch:
        _write(tree, ckpt_dir / "best")


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """A checkpoint file's contents (tensors on the CPU)."""
    path = Path(path).expanduser().absolute()
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist, can not load checkpoint.")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str | Path, state: TrainState,
                       which: str = "latest") -> Tuple[TrainState, int, float]:
    """Load ``which`` into ``state`` in place (model, Adam's moments and
    count, balancer, step). Returns (state, saved epoch + 1, best_score)."""
    tree = load_checkpoint(Path(ckpt_dir).expanduser() / which)
    state.model.load_state_dict(tree["model"], strict=True)
    opt = state.opt_state
    if len(tree["opt_mu"]) != len(opt.mu):
        raise ValueError(f"checkpoint {which}: {len(tree['opt_mu'])} Adam moments for a model "
                         f"with {len(opt.mu)} trainable parameters")
    with torch.no_grad():
        for mine, saved in zip(opt.mu + opt.nu, tree["opt_mu"] + tree["opt_nu"]):
            if mine.shape != saved.shape:
                raise ValueError(f"checkpoint {which}: an Adam moment of shape {tuple(saved.shape)} "
                                 f"for a parameter of shape {tuple(mine.shape)}")
            mine.copy_(saved)
    opt.count = int(tree["opt_count"])
    device = opt.mu[0].device if opt.mu else None
    balancer = state.balancer_state
    balancer.total = {k: v.to(device) for k, v in tree["balancer_total"].items()}
    balancer.fix = {k: v.to(device) for k, v in tree["balancer_fix"].items()}
    state.step = int(tree["step"])
    return state, int(tree["epoch"]) + 1, float(tree["best_score"])


def _read_weights(path: Path, model) -> Dict[str, torch.Tensor]:
    """A snapshot's tensors by the port's names: a checkpoint file (the
    whole state, or ``model_NNNN``'s state_dict) or a flax-layout ``.npz``."""
    if path.suffix == ".npz":
        return state_dict_from_flax(load_flax_npz(str(path)), model)
    tree = load_checkpoint(path)
    return tree["model"] if "model" in tree else tree


def preload_params(ckpt_path: str | Path, model) -> Dict[str, int]:
    """Warm-start: copy a snapshot's parameters into ``model`` (its BatchNorm
    statistics stay as they are, as the JAX package's preload keeps its
    batch_stats). A parameter the snapshot lacks keeps its value; a
    parameter of another shape, or a snapshot that matches none of the
    model's parameters (a stale layout), raises. Returns the counts of
    parameters merged and kept."""
    ckpt_path = Path(ckpt_path).expanduser().absolute()
    if not ckpt_path.is_file():
        raise FileNotFoundError(f"The file {ckpt_path} does not exist.")
    restored = _read_weights(ckpt_path, model)
    merged, kept = 0, 0
    with torch.no_grad():
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
