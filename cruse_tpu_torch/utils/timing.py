"""Wall-clock timing and profiler traces (counterpart of
``cruse_tpu/utils/timing.py``).

``ExecutionTime`` and ``step_timer`` are copies; ``trace`` runs
``torch.profiler`` (host and, where there is a card, device activity) and
writes a Chrome trace, where the JAX package starts ``jax.profiler``.
"""
from __future__ import annotations

import contextlib
import os
import time


class ExecutionTime:
    def __init__(self):
        self.start_time = time.time()

    def duration(self) -> int:
        return int(time.time() - self.start_time)

    def seconds(self) -> float:
        return time.time() - self.start_time


@contextlib.contextmanager
def trace(log_dir: str | None = None, name: str = "trace.json"):
    """torch.profiler over the block, its Chrome trace written to
    ``log_dir/name`` at the end (open it in chrome://tracing or Perfetto);
    yields the profiler, or None and does nothing when log_dir is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def step_timer(metrics: dict, key: str = "step_seconds"):
    t0 = time.perf_counter()
    yield
    metrics[key] = time.perf_counter() - t0
