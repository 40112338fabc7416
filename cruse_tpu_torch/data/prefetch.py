"""Background-thread batch prefetching (counterpart of
``cruse_tpu/data/prefetch.py``).

A daemon thread runs the batch-producing iterable -- for ``SynMixDataset``
the host-side file I/O and crop, the host-to-device copy and the on-card
mixing -- into a bounded queue, so that the consumer's train step overlaps
with the next batch's assembly and mixing. Exceptions in the producer are
raised in the consumer. When the consumer stops early (``break``, or the
generator closed), the producer stops at its next put.

On the card (``device`` a CUDA device) the producer enqueues its device work
on a stream of its own. It records an event after each batch; the consumer
makes its current stream wait for that event before it hands the batch on,
and marks each CUDA tensor of the batch as used on that stream
(``record_stream``), so that the caching allocator does not give the memory
back to the producer's stream while the step still reads it.
"""
from __future__ import annotations

import inspect
import queue
import threading
from typing import Any, Iterable, Iterator

import torch


class _Sentinel:
    pass


_DONE = _Sentinel()


def _cuda_tensors(batch):
    values = batch.values() if isinstance(batch, dict) else batch if isinstance(batch, (list, tuple)) \
        else (batch,)
    return [v for v in values if isinstance(v, torch.Tensor) and v.is_cuda]


def prefetch(batches: Iterable, size: int = 2, device: torch.device | str | None = None) -> Iterator:
    """Wrap a batch iterable with a producer thread and a queue of ``size``."""
    q: "queue.Queue[Any]" = queue.Queue(maxsize=size)
    stop = threading.Event()
    device = None if device is None else torch.device(device)
    stream = torch.cuda.Stream(device) if device is not None and device.type == "cuda" else None

    def put(item) -> bool:
        """A bounded put that re-checks the stop flag instead of blocking
        for ever on an abandoned queue; False once stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        for batch in batches:
            event = None
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
            if not put((batch, event)):
                return
        put(_DONE)

    def producer():
        try:
            if stream is None:
                produce()
            else:
                with torch.cuda.stream(stream):
                    produce()
        except BaseException as e:  # raised again on the consumer's side
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _Sentinel):
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for tensor in _cuda_tensors(batch):
                    tensor.record_stream(current)
            yield batch
    finally:
        # consumer done, normally or abandoned: release the producer
        stop.set()
        while True:  # drain so that a blocked put wakes at once
            try:
                q.get_nowait()
            except queue.Empty:
                break


class PrefetchingLoader:
    """Re-iterable wrapper: each epoch gets a fresh producer thread. A
    factory that takes an ``epoch`` keyword gets the trainer's epoch
    (curriculum schedules)."""

    def __init__(self, make_batches, size: int = 2, device: torch.device | str | None = None):
        self.make_batches = make_batches
        self.size = size
        self.device = device
        try:
            self._wants_epoch = "epoch" in inspect.signature(make_batches).parameters
        except (TypeError, ValueError):
            self._wants_epoch = False

    def __call__(self, epoch: int | None = None):
        made = self.make_batches(epoch=epoch) if epoch is not None and self._wants_epoch \
            else self.make_batches()
        return prefetch(made, self.size, self.device)

    def __iter__(self):
        return self()
