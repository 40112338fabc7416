"""Training CLI of the port (counterpart of ``tools/train.py``):

    python -m cruse_tpu_torch.train -C configs/cruse_base.toml [-R] [-V] \\
        [-P snapshot] [--device cpu]

Config layout (TOML, see ``configs/cruse_base.toml``): ``[meta]`` seed,
save_dir, experiment_name; ``[acoustics]``; ``[model]`` path + args (the
class named by the path's last component); ``[train_dataset]`` /
``[validation_dataset]`` path + args of ``SynMixConfig`` (``path`` names the
dataset class by its last component; ``SynMixDataset`` is ported; with
``num_mics`` > 1 and the ``mc_*`` fields it makes McCruse's multi-channel
batches, as ``configs/tiny_mc.toml`` and ``tiny_mc_rir.toml`` ask), and
``[train_dataset.curriculum]``; ``[optimizer]`` (lr, betas, ``weight_decay``
for AdamW, ``freeze`` patterns, ``ema_decay``, the schedule);
``[trainer.train]`` (``grad_accum_steps`` among its fields),
``[trainer.validation]``, ``[trainer.profiling]``,
``[trainer.distillation]``, ``[trainer.adversarial]``; ``[loss.weights]``.

The model's weights are made from ``[meta] seed``. Training batches are
assembled on the host and mixed on the device, two batches ahead of the
step (``PrefetchingLoader(size=2)``); validation reads two batches, made
once. ``-R`` resumes from ``latest``; ``-P`` warm-starts the parameters from
a snapshot (a checkpoint file or a flax-layout ``.npz``); ``-V`` only
validates. ``[trainer.distillation]`` loads a frozen teacher for the
``distill`` loss: ``config`` names the teacher's TOML (its ``[model]``),
``checkpoint`` its weights -- a port checkpoint or a flax-layout ``.npz``,
the EMA weights where it holds them -- with its BatchNorm statistics.
``[trainer.adversarial]`` (``adv_weight``, ``disc_lr``, ``ndf``,
``replay_capacity``, ``pretrain_steps``) trains by MetricGAN+ (a
discriminator, its pretraining and the D/G alternation with replay; D's
state in ``disc_latest`` beside ``latest``), as ``configs/tiny_bsrnn_gan.toml``
asks. The run trains on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the CPU; a CUDA device that is not there is an
error. ``-N`` / ``-M`` above 1 (a device mesh) and the step options the
port refuses (bf16 via ``use_amp``, ``flatten_optimizer``) stop the run
with their names.
"""
from __future__ import annotations

import argparse
import os
import random


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m cruse_tpu_torch.train",
                                     description="cruse_tpu_torch trainer")
    parser.add_argument("-C", "--configuration", required=True, type=str, help="Configuration (*.toml).")
    parser.add_argument("-R", "--resume", action="store_true", help="Resume the experiment from latest checkpoint.")
    parser.add_argument("-V", "--only_validation", action="store_true", help="Only run validation (debug).")
    parser.add_argument("-N", "--num_devices", type=int, default=0, help="Devices (only 1 is ported).")
    parser.add_argument("-M", "--model_parallel", type=int, default=1, help="Model-axis devices (only 1).")
    parser.add_argument("-P", "--preloaded_model_path", type=str, default=None, help="Warm-start params path.")
    parser.add_argument("--device", default="cuda", help="cuda (the default), cuda:N, or cpu.")
    return parser.parse_args(argv)


def step_config_from(config: dict):
    """``StepConfig`` from a config, field for field as ``tools/train.py``
    builds it; the port's ``StepConfig`` refuses the options it lacks."""
    from cruse_tpu_torch.dsp.stft import StftConfig
    from cruse_tpu_torch.train.step import StepConfig

    ac = config["acoustics"]
    opt = config.get("optimizer", {})
    tr = config.get("trainer", {}).get("train", {})
    return StepConfig(
        stft=StftConfig(n_fft=int(ac["n_fft"]), hop_length=int(ac["hop_length"]),
                        win_length=int(ac.get("win_length", ac["n_fft"]))),
        learning_rate=float(opt.get("lr", 5e-4)),
        beta1=float(opt.get("beta1", 0.9)),
        beta2=float(opt.get("beta2", 0.999)),
        weight_decay=float(opt.get("weight_decay", 0.0)),
        freeze=((opt["freeze"],) if isinstance(opt.get("freeze"), str) else tuple(opt.get("freeze", ()))),
        clip_grad_norm=float(tr.get("clip_grad_norm_value", 10.0)),
        loss_weights=tuple(config.get("loss", {}).get("weights", {"si_snr": 1.0, "spec": 1.0}).items()),
        lr_schedule=opt.get("schedule"),
        warmup_steps=int(opt.get("warmup_steps", 0)),
        decay_steps=(int(opt["decay_steps"]) if "decay_steps" in opt
                     else int(tr.get("epochs", 100)) * int(tr.get("steps_per_epoch", 100))
                     if opt.get("schedule") == "cosine" else None),
        final_lr_scale=float(opt.get("final_lr_scale", 0.0)),
        ema_decay=(float(opt["ema_decay"]) if "ema_decay" in opt else None),
        grad_accum_steps=int(tr.get("grad_accum_steps", 1)),
        flatten_optimizer=bool(opt.get("flatten_optimizer", False)),
        sr=int(ac.get("sr", 16000)),
        compute_dtype="bfloat16" if bool(config["meta"].get("use_amp", False)) else None,
    )


def _tuples(value):
    """A TOML value with its lists made tuples, nested ones too."""
    return tuple(_tuples(v) for v in value) if isinstance(value, list) else value


def dataset_from(section: dict, device, **overrides):
    """A ``[*_dataset]`` table -> the port's dataset; ``path`` names the
    class by its last component and is never imported. Lists become tuples
    (``mc_mic_positions``, a list of lists, a tuple of tuples)."""
    from cruse_tpu_torch.data.dataset import SynMixConfig, SynMixDataset

    name = section.get("path", "SynMixDataset").rsplit(".", 1)[-1]
    if name != "SynMixDataset":
        raise NotImplementedError(f"dataset {name!r} is not ported (ported: SynMixDataset)")
    args = {k: _tuples(v) for k, v in section.get("args", {}).items()}
    return SynMixDataset(SynMixConfig(**{**args, **overrides}), device=device)


def load_teacher(section: dict | None):
    """``[trainer.distillation]`` -> the teacher model with its weights and
    BatchNorm statistics (None without the table), as ``tools/train.py``
    loads it: ``config`` names the teacher's TOML, ``checkpoint`` its
    weights. Parameters the checkpoint lacks keep their seed-0 values."""
    if not section:
        return None
    import torch

    from cruse_tpu_torch.models import build_from_config
    from cruse_tpu_torch.train.checkpoint import preload_params
    from cruse_tpu_torch.utils.config import load_config
    from cruse_tpu_torch.utils.logger import log

    t_config = load_config(section["config"])
    teacher = build_from_config(t_config["model"], generator=torch.Generator().manual_seed(0))
    preload_params(section["checkpoint"], teacher, statistics=True)
    log(f"distillation teacher: {t_config['model']['path']} from {section['checkpoint']}")
    return teacher


def build_trainer(args: argparse.Namespace):
    """The trainer that ``main`` runs, built from the parsed arguments."""
    import numpy as np
    import torch

    from cruse_tpu_torch.data.prefetch import PrefetchingLoader
    from cruse_tpu_torch.models import build_from_config
    from cruse_tpu_torch.train.trainer import Trainer, TrainerConfig
    from cruse_tpu_torch.utils.config import load_config
    from cruse_tpu_torch.utils.logger import init as log_init, log

    if args.num_devices > 1 or args.model_parallel > 1:
        raise SystemExit(f"-N {args.num_devices} -M {args.model_parallel}: training on several devices is not "
                         "ported (torch.distributed, ROADMAP.md queue 1 item 9); the port trains on one")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    config = load_config(args.configuration)
    exp_name = config["meta"].get("experiment_name",
                                  os.path.splitext(os.path.basename(args.configuration))[0])
    trainer_section = config.get("trainer", {})
    seed = int(config["meta"].get("seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    save_dir = os.path.join(os.path.expanduser(config["meta"].get("save_dir", "runs")), exp_name)
    os.makedirs(save_dir, exist_ok=True)
    log_init(os.path.join(save_dir, "train.log"))
    log(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    step_cfg = step_config_from(config)
    model = build_from_config(config["model"], generator=torch.Generator().manual_seed(seed))
    tr, va = trainer_section.get("train", {}), trainer_section.get("validation", {})
    sr = int(config["acoustics"].get("sr", 16000))
    tcfg = TrainerConfig(
        epochs=int(tr.get("epochs", 100)),
        steps_per_epoch=int(tr.get("steps_per_epoch", 100)),
        save_checkpoint_interval=int(tr.get("save_checkpoint_interval", 1)),
        validation_interval=int(va.get("validation_interval", 1)),
        save_max_metric_score=bool(va.get("save_max_metric_score", True)),
        patience=int(va.get("patience", 0)),
        sr=sr,
        save_dir=config["meta"].get("save_dir", "runs"),
        experiment_name=exp_name,
        only_validation=args.only_validation,
        # [trainer.adversarial]: the MetricGAN+ alternation (replay, D pretraining, D checkpoints)
        adversarial=trainer_section.get("adversarial"),
        profiling=trainer_section.get("profiling"),
    )
    train_ds = dataset_from(config["train_dataset"], device)
    valid_ds = dataset_from(config["validation_dataset"], device, valid_mode=True)

    # [train_dataset.curriculum]: SNR annealing from snr_start to snr_end
    # (default: the configured snr_range) over `epochs` (default: the run)
    cur = config.get("train_dataset", {}).get("curriculum")
    if cur:
        s0 = tuple(float(v) for v in cur["snr_start"])
        s1 = tuple(float(v) for v in cur.get(
            "snr_end", config["train_dataset"]["args"].get("snr_range", (-5, 20))))
        horizon = max(int(cur.get("epochs", tcfg.epochs)), 1)

        def make_train_batches(epoch: int = 1):
            t = min(max(epoch - 1, 0) / max(horizon - 1, 1), 1.0)
            lo = round(s0[0] + t * (s1[0] - s0[0]))
            hi = round(s0[1] + t * (s1[1] - s0[1]))
            train_ds.set_snr_range((lo, hi))
            log(f"curriculum: epoch {epoch} SNR range [{lo}, {hi}] dB")
            return train_ds.batches(num_batches=tcfg.steps_per_epoch)
    else:
        def make_train_batches():
            return train_ds.batches(num_batches=tcfg.steps_per_epoch)

    return Trainer(
        model, step_cfg, tcfg, teacher=load_teacher(trainer_section.get("distillation")),
        train_batches=PrefetchingLoader(make_train_batches, size=2, device=device),
        validation_batches=list(valid_ds.batches(num_batches=2)),
        resume=args.resume,
        preload_path=args.preloaded_model_path,
        device=device,
    )


def main(argv=None):
    """Parse, build and train; returns the trainer."""
    trainer = build_trainer(parse_args(argv))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
