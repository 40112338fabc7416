"""The trainer: epoch loop, validation scoring, checkpoints, TensorBoard
(counterpart of ``cruse_tpu/train/trainer.py``).

Train an epoch of ``make_train_step`` -> harvest the previous validation ->
periodic checkpoint -> periodic validation -> best tracking by the composite
score; ``only_validation`` skips training. Validation is asynchronous as in
the JAX package: at an epoch's end the card enhances the validation batches
(STFT -> the model's forward adapter in eval mode -> iSTFT), then the host
scores them (STOI, SI-SDR, WB-PESQ, PMOS; the utterances spread over a pool
of worker processes, where the JAX package uses threads) from a background
thread while the next epoch trains. The scores, and ``best`` when the epoch
is a new best, are harvested one boundary later from a CPU copy of the
weights that were scored (the port updates its parameters in place, so the
snapshot must be a copy). SIGTERM or SIGINT during training ends the epoch
early and saves ``latest`` (resume with ``-R``).

``timings`` keeps, for the run, the wall seconds of each step (the batch's
wait in ``data_wait``), of each validation's enhancement on the card and host
scoring, and of each checkpoint save.

Refused by name: MetricGAN+ (``adversarial``), a device mesh, and the
spectrogram figure of the TensorBoard samples (which needs the JAX package's
``utils/plot.py``; the audio is written).
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import signal
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import forkserver
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from cruse_tpu_torch.dsp.stft import istft, stft
from cruse_tpu_torch.metrics.registry import available_metrics, composite_score, compute_metric
from cruse_tpu_torch.train.checkpoint import (preload_params, restore_checkpoint, save_checkpoint,
                                              state_to_host)
from cruse_tpu_torch.train.step import StepConfig, forward_for_model, init_train_state, make_train_step
from cruse_tpu_torch.utils.logger import log
from cruse_tpu_torch.utils.timing import ExecutionTime, trace


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 100
    steps_per_epoch: int = 100
    save_checkpoint_interval: int = 1
    validation_interval: int = 1
    save_max_metric_score: bool = True
    patience: int = 0  # stop after N validations without a new best (0 = off)
    metrics: tuple = ("STOI", "SI_SDR", "WB_PESQ", "PMOS")
    sr: int = 16000  # validation scoring and TensorBoard audio sample rate
    save_dir: str = "runs/exp"
    experiment_name: str = "cruse"
    only_validation: bool = False
    visualization_examples: int = 3
    # scoring processes (the JAX package: 10 threads); 4 single-threaded
    # processes score config 2's validation set in under a second on an
    # 8-core host and leave the train step its core
    num_metric_workers: int = 4
    adversarial: Optional[dict] = None  # MetricGAN+: refused
    # [trainer.profiling]: a torch.profiler trace over a window of train
    # steps -- epoch (default 1), start_step (default 1), num_steps (default
    # 3), trace_dir (default <logs_dir>/profile); a Chrome trace
    profiling: Optional[dict] = None


_SCORER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def _environment(values: dict):
    """Set environment variables for the block, then put back what was there."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Trainer:
    """``train_batches``: a factory called each epoch (``epoch=`` when it
    takes it), or an iterable read across epochs; ``validation_batches``: an
    iterable (or factory) of batches read at each validation. A batch is
    {"noisy", "clean"} [B, L] (numpy or tensors; "name" optional). The model
    trains on ``device``, the card unless the caller asks for the CPU.
    ``writer``: None makes a TensorBoard writer when the package is there,
    False none, anything else is used."""

    def __init__(self, model, step_config: StepConfig, trainer_config: TrainerConfig,
                 train_batches: Optional[Iterable] = None, validation_batches: Optional[Iterable] = None,
                 resume: bool = False, preload_path: str | None = None,
                 device: torch.device | str = "cuda", writer=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("training on a device mesh is not ported (one device; "
                                      "torch.distributed is ROADMAP.md queue 1 item 9)")
        if trainer_config.adversarial:
            raise NotImplementedError("[trainer.adversarial] (MetricGAN+) is not ported")
        self.model = model
        self.step_cfg = step_config
        self.cfg = trainer_config
        self.train_batches = train_batches
        self.validation_batches = validation_batches
        self.scfg = step_config.stft

        self.save_dir = Path(trainer_config.save_dir).expanduser().absolute() / trainer_config.experiment_name
        self.checkpoints_dir = self.save_dir / "checkpoints"
        self.logs_dir = self.save_dir / "logs"
        self.checkpoints_dir.mkdir(parents=True, exist_ok=True)
        self.logs_dir.mkdir(parents=True, exist_ok=True)

        self.state = init_train_state(model, step_config, device)
        self.device = torch.device(device)
        self.start_epoch = 1
        self.best_score = -np.inf if trainer_config.save_max_metric_score else np.inf
        if resume:
            self.state, self.start_epoch, self.best_score = restore_checkpoint(self.checkpoints_dir, self.state)
            log(f"Checkpoint loaded; training resumes at epoch {self.start_epoch}.")
        elif preload_path:
            preload_params(preload_path, model)
            log(f"Model preloaded from {preload_path}.")
        self._train_step = make_train_step(model, step_config)
        self._forward = forward_for_model(model)

        if writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self.writer = None
            else:
                self.writer = SummaryWriter(self.logs_dir.as_posix(), max_queue=5, flush_secs=30)
        else:
            self.writer = writer or None
        self._figure_refused = False
        self._pool: Optional[ProcessPoolExecutor] = None
        self._preempted = {"flag": False}
        self.timings = {"step": [], "data_wait": [], "validation_enhance": [], "scoring": [], "save": []}

        n_params = sum(p.numel() for p in model.parameters())
        log(f"Model parameters: {n_params / 1e6:.3f} million.")

    # ---- epochs ----

    def _put(self, x) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return x.to(self.device)

    def _profile_window(self, epoch: int):
        """(start, stop) step indices of the configured trace window for this
        epoch, or None."""
        prof = self.cfg.profiling
        if not prof or epoch != int(prof.get("epoch", 1)):
            return None
        start = int(prof.get("start_step", 1))
        return start, start + int(prof.get("num_steps", 3))

    def _train_epoch(self, epoch: int) -> None:
        if self.train_batches is None:
            raise ValueError("no training data configured")
        # a factory is called each epoch (a fresh iterator, closed at the
        # epoch's end); a plain iterable is read across epochs
        fresh = callable(self.train_batches)
        if fresh:
            try:
                batches = self.train_batches(epoch=epoch)
            except TypeError:
                batches = self.train_batches()
        else:
            batches = self.train_batches
        running = {}  # metric -> (sum, finite count, non-finite count)
        window = self._profile_window(epoch)
        step_s, wait_s = [], []
        with contextlib.ExitStack() as tracing:
            batch_iter = iter(batches)
            for i in range(self.cfg.steps_per_epoch):
                if self._preempted["flag"]:
                    break  # finish the epoch early; the caller checkpoints
                if window and i == window[0]:
                    trace_dir = str(self.cfg.profiling.get("trace_dir") or self.logs_dir / "profile")
                    tracing.enter_context(trace(trace_dir, f"epoch{epoch}_steps{window[0]}-{window[1] - 1}.json"))
                    log(f"profiler: tracing steps {window[0]}..{window[1] - 1} -> {trace_dir}")
                t0 = time.perf_counter()
                try:
                    batch = next(batch_iter)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                batch = {"noisy": self._put(batch["noisy"]), "clean": self._put(batch["clean"])}
                self.state, metrics = self._train_step(self.state, batch)
                for k, v in metrics.items():
                    v = float(v)
                    tot, n, bad = running.get(k, (0.0, 0, 0))
                    if not np.isfinite(v):
                        # kept out of the mean but counted: the epoch log flags it
                        running[k] = (tot, n, bad + 1)
                        continue
                    running[k] = (tot + v, n + 1, bad)
                wait_s.append(t1 - t0)
                step_s.append(time.perf_counter() - t0)
                if window and i + 1 == window[1]:
                    tracing.close()
            if fresh and hasattr(batch_iter, "close"):
                batch_iter.close()  # stops a prefetching producer that is ahead
        self.timings["step"] += step_s
        self.timings["data_wait"] += wait_s
        for k, (tot, n, bad) in running.items():
            mean = tot / max(n, 1)
            if self.writer:
                self.writer.add_scalar(f"Train/{k}", mean, epoch)
            flag = f"  [{bad} NON-FINITE values skipped!]" if bad else ""
            log(f"  epoch {epoch} {k}: {mean:.5f}{flag}")
        if len(step_s) > 1:
            log(f"  epoch {epoch}: {len(step_s)} steps, {np.mean(step_s[1:]) * 1e3:.2f} ms a step after the "
                f"first ({np.mean(wait_s[1:]) * 1e3:.2f} ms of it waiting for data)")

    def _validation_epoch(self, epoch: int) -> float:
        """Synchronous validation: enhancement, scoring, emission (used by
        only_validation)."""
        noisy_list, clean_list, enhanced_list, names = self._validation_enhance()
        score = self.metrics_visualization(noisy_list, clean_list, enhanced_list, list(self.cfg.metrics), epoch)
        for j in range(min(self.cfg.visualization_examples, len(names))):
            self.spec_audio_visualization(noisy_list[j], enhanced_list[j], clean_list[j], names[j], epoch)
        return score

    def enhance(self, noisy: torch.Tensor) -> torch.Tensor:
        """[B, L] -> [B, L] on the device with the current weights: STFT, the
        model's forward adapter in eval mode (BatchNorm on its running
        statistics), iSTFT; the model is back in training mode after."""
        model = self.state.model
        model.eval()
        try:
            with torch.inference_mode():
                spec = stft(noisy, self.scfg)
                out = self._forward(torch.stack([spec.real, spec.imag], dim=-1), train=False)
                return istft((out[..., 0], out[..., 1]), self.scfg, length=noisy.shape[-1])
        finally:
            model.train()

    def _validation_enhance(self):
        """The device half of validation: enhance every batch and bring the
        audio to the host."""
        if self.validation_batches is None:
            raise ValueError("no validation data configured")
        t0 = time.perf_counter()
        vbatches = self.validation_batches() if callable(self.validation_batches) else self.validation_batches
        noisy_list, clean_list, enhanced_list, names = [], [], [], []
        for batch in vbatches:
            enh_np = _numpy(self.enhance(self._put(batch["noisy"])))
            noisy_np, clean_np = _numpy(batch["noisy"]), _numpy(batch["clean"])
            default_names = [f"v{len(names) + k}" for k in range(noisy_np.shape[0])]
            batch_names = batch.get("name", default_names)
            for j in range(noisy_np.shape[0]):
                noisy_list.append(noisy_np[j])
                clean_list.append(clean_np[j])
                enhanced_list.append(enh_np[j])
                names.append(batch_names[j])
        self.timings["validation_enhance"].append(time.perf_counter() - t0)
        return noisy_list, clean_list, enhanced_list, names

    # ---- scoring and visualization ----

    def _metric_pool(self) -> ProcessPoolExecutor:
        """The worker processes that score validation, made at the first
        validation and kept until ``close``. Processes, not threads: the
        metrics are mostly Python-level numpy code that holds the
        interpreter lock, and on threads they starved the train step
        (launch-bound, itself Python) while they ran -- 465 ms a config-2
        step at B=32 against 28 ms (chip_smoke.py, H100). The workers fork
        from a forkserver, a process that holds no thread and no CUDA
        context, started with one BLAS / OpenMP thread each
        (``_SCORER_ENV``): workers that each spread over every core ran the
        same scoring 30x slower."""
        if self._pool is None:
            with _environment(_SCORER_ENV):  # the server reads it once, when it starts
                forkserver.ensure_running()
            self._pool = ProcessPoolExecutor(max_workers=self.cfg.num_metric_workers,
                                             mp_context=multiprocessing.get_context("forkserver"))
        return self._pool

    def close(self) -> None:
        """Stop the scoring workers (``train`` does at its end); scoring not
        yet started is cancelled."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def _score_lists(self, noisy_list, clean_list, enhanced_list, metrics_list,
                     pool: ProcessPoolExecutor) -> dict:
        """Host scoring: {metric: (mean_noisy, mean_enhanced)}, each
        utterance's score taken by a worker process of ``pool``. Safe to run
        on a background thread (no writer or log side effects)."""
        t0 = time.perf_counter()
        avail = available_metrics()
        metrics_list = [m for m in metrics_list if avail.get(m, False)]
        if "STOI" not in metrics_list:
            raise ValueError("'STOI' must be among the metrics (it drives the best-model score)")
        n = len(clean_list)
        names = [m for m in metrics_list for _ in range(2 * n)]
        references = clean_list * (2 * len(metrics_list))
        estimates = (noisy_list + enhanced_list) * len(metrics_list)
        scores = list(pool.map(compute_metric, names, references, estimates, [self.cfg.sr] * len(names)))
        out = {}
        for i, metric_name in enumerate(metrics_list):
            mine = scores[2 * n * i : 2 * n * (i + 1)]
            out[metric_name] = (float(np.mean(mine[:n])), float(np.mean(mine[n:])))
        self.timings["scoring"].append(time.perf_counter() - t0)
        return out

    def _emit_validation(self, scores: dict, epoch: int) -> float:
        """Log and TensorBoard emission of the scored means -> composite score."""
        means = {}
        for metric_name, (mean_noisy, mean_enh) in scores.items():
            means[metric_name] = mean_enh
            if self.writer:
                self.writer.add_scalars(f"Validation/{metric_name}", {"Noisy": mean_noisy, "Enhanced": mean_enh},
                                        epoch)
            log(f"  {metric_name}: noisy {mean_noisy:.4f} -> enhanced {mean_enh:.4f}")
        score = composite_score(means)
        log(f"  validation epoch {epoch}: composite score {score:.4f}")
        return score

    def metrics_visualization(self, noisy_list, clean_list, enhanced_list, metrics_list, epoch) -> float:
        scores = self._score_lists(noisy_list, clean_list, enhanced_list, metrics_list, self._metric_pool())
        return self._emit_validation(scores, epoch)

    def spec_audio_visualization(self, noisy, enhanced, clean, name, epoch, mark="") -> None:
        if self.writer is None:
            return
        sr = self.cfg.sr
        self.writer.add_audio(f"{mark}Speech/{name}_Noisy", noisy[None], epoch, sample_rate=sr)
        self.writer.add_audio(f"{mark}Speech/{name}_Enhanced", enhanced[None], epoch, sample_rate=sr)
        self.writer.add_audio(f"{mark}Speech/{name}_Clean", clean[None], epoch, sample_rate=sr)
        if not self._figure_refused:
            self._figure_refused = True
            log("the spectrogram figure is not ported (it needs the JAX package's utils/plot.py); "
                "TensorBoard gets the audio alone")

    # ---- checkpoints ----

    def _save(self, epoch: int, best: bool = False, state=None) -> None:
        """Write the checkpoints; ``state`` (a ``state_to_host`` snapshot)
        overrides the current state -- the async validation saves the
        snapshot that was scored."""
        t0 = time.perf_counter()
        save_checkpoint(self.checkpoints_dir, state if state is not None else self.state, epoch,
                        self.best_score, best, model=self.state.model)
        self.timings["save"].append(time.perf_counter() - t0)

    def _is_best_epoch(self, score: float) -> bool:
        if self.cfg.save_max_metric_score and score >= self.best_score:
            self.best_score = score
            return True
        if not self.cfg.save_max_metric_score and score <= self.best_score:
            self.best_score = score
            return True
        return False

    def train(self) -> None:
        """The epoch loop, with a preemption save: SIGTERM or SIGINT during
        training ends the epoch early and writes ``latest`` before returning,
        so that ``-R`` resumes losing at most that epoch."""
        self._preempted = preempted = {"flag": False}

        def _on_term(signum, frame):
            preempted["flag"] = True
            log(f"signal {signum}: checkpointing before exit...")

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_term)
            except ValueError:  # not the main thread
                pass
        try:
            self._train_loop(preempted)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self.close()

    def _harvest_validation(self) -> None:
        """Finish a pending validation: emit its scores on this thread and
        write ``best`` from the snapshot that was scored."""
        if self._pending_val is None:
            return
        epoch, snapshot, future, vis = self._pending_val
        self._pending_val = None
        score = self._emit_validation(future.result(), epoch)
        noisy_list, clean_list, enhanced_list, names = vis
        for j in range(min(self.cfg.visualization_examples, len(names))):
            self.spec_audio_visualization(noisy_list[j], enhanced_list[j], clean_list[j], names[j], epoch)
        if self._is_best_epoch(score):
            self._save(epoch, best=True, state=snapshot)
            self._since_best = 0
        else:
            self._since_best += 1
            if self.cfg.patience and self._since_best >= self.cfg.patience:
                self._stop_early = True
                log(f"early stop: {self._since_best} validations without a new best "
                    f"(patience {self.cfg.patience})")

    def _train_loop(self, preempted) -> None:
        self._pending_val = None
        self._since_best = 0
        self._stop_early = False
        scorer = ThreadPoolExecutor(max_workers=1)
        try:
            for epoch in range(self.start_epoch, self.cfg.epochs + 1):
                if self._stop_early:
                    return
                log(f"{'=' * 15} {epoch} epoch {'=' * 15}")

                if self.cfg.only_validation:
                    score = self._validation_epoch(epoch)
                    if self._is_best_epoch(score):
                        self._save(epoch, best=True)
                    continue

                timer = ExecutionTime()
                self._train_epoch(epoch)

                # harvest before the periodic save, so that the saved
                # best_score is current
                self._harvest_validation()

                if self.cfg.save_checkpoint_interval and epoch % self.cfg.save_checkpoint_interval == 0:
                    self._save(epoch)

                if epoch % self.cfg.validation_interval == 0:
                    log(f"[{timer.duration()} seconds] Training finished, validation in progress...")
                    vis = self._validation_enhance()
                    future = scorer.submit(self._score_lists, vis[0], vis[1], vis[2], list(self.cfg.metrics),
                                           self._metric_pool())
                    # the CPU copy of the weights scored: the next epoch updates them in place
                    keep = self.cfg.visualization_examples
                    self._pending_val = (epoch, state_to_host(self.state), future,
                                         tuple(x[:keep] for x in vis))

                log(f"[{timer.duration()} seconds] Epoch {epoch} finished.")
                if preempted["flag"]:
                    self._harvest_validation()
                    self._save(epoch)
                    log(f"preemption checkpoint written at epoch {epoch}; resume with -R.")
                    return
        finally:
            if sys.exc_info()[0] is None:
                self._harvest_validation()
            else:
                # a crash: do not wait on (or raise from) pending scoring, so
                # that the original exception surfaces
                self._pending_val = None
            scorer.shutdown(wait=False)
