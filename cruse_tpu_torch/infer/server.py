"""Concurrent-stream serving (counterpart of ``cruse_tpu/infer/server.py``):
many live sessions, one batched step a hop.

``StreamingServer`` multiplexes up to ``max_streams`` independent sessions
into one ``StreamingEnhancer.step`` a hop, at the batch of its slots:

- a fixed slot layout: ``open`` claims the lowest free slot and resets its
  state, ``close`` frees it;
- ``feed(sid, samples)`` buffers any number of samples on the host (numpy;
  ``[M, samples]`` for a multi-mic McCruse pool, which emits the enhanced
  reference mic);
- ``step`` runs one hop for every session with a whole hop buffered; the
  other slots process zeros and keep their state;
- ``drain`` zero-pads a session's last partial hop, steps that session
  alone and returns exactly the samples that were still buffered.

A step makes one host-to-device copy (the hops, every mic's of a multi-mic
pool, and the active mask, packed into one pinned array on the card's host) and one device-to-host copy (the
outputs), which is its only wait on the device. The state is masked out of
place: every leaf of the new state is ``torch.where(active, new, old)``, so
idle slots keep theirs bit for bit and no inference tensor is written in
place. A leaf leads with ``slots · rep`` rows, a slot owning ``rep``
consecutive ones (FullSubNet folds its F sub-band units into the batch:
``[slots·F, H]``; a causal BSRNN its 31 bands into its time LSTMs' state,
``[slots·31, 1, 2N]``, beside its norms' ``[slots]`` carries), so the mask
repeats each slot's flag ``rep`` times. A slot
is reset out of place too: a fresh one-slot state's ``rep`` rows are copied
into rows ``[sid·rep, (sid+1)·rep)`` of a new leaf (``index_copy``).

``MultiModelServer`` keeps one such pool a model. When dispatches are
rationed it serves the pool with the most urgent ready session first and
breaks ties by the pool served least recently. Pools of different widths
(mono and multi-mic) sit side by side, each with its own staging array.

On the card a CRUSE or McCruse step launches the grouped-GRU kernel twice
(one a bank),
a CRUSE+DF step (config 3) also the deep-filter kernel once, and a windowed
MTFAA step (config 5b) the stencil kernel once a TFCM block (24) and the
deep filter once, a FullSubNet step the grouped-GRU kernel once a GRU layer
(4 at its published depth), all at the batch of the slots (the sub-band
layers at slots · F rows); DFSMN has no kernel, and a BSRNN step runs
cuDNN's LSTM and PyTorch's own kernels only.

Not ported: a device mesh (``mesh=`` raises; slots over several cards wait
for torch.distributed).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cruse_tpu_torch.dsp.stft import StftConfig
from cruse_tpu_torch.infer.streaming import StreamingEnhancer


def tree_map(fn: Callable, tree, *rest):
    """fn over the tensors of a state made of tuples, NamedTuples, lists and
    dicts (``rest`` has the same structure); the result keeps the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {key: tree_map(fn, value, *(r[key] for r in rest)) for key, value in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *leaves) for leaves in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    raise TypeError(f"a state leaf of type {type(tree).__name__} is not a tensor")


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state, in ``tree_map``'s order."""
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def _rows(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A [slots] mask shaped to select a slot-major leaf's rows, each slot's
    flag repeated for the ``rep = rows / slots`` rows the slot owns."""
    rep = leaf.shape[0] // mask.shape[0]
    return (mask.repeat_interleave(rep) if rep > 1 else mask).view(-1, *(1,) * (leaf.dim() - 1))


class StreamingServer:
    def __init__(self, model: torch.nn.Module, cfg: StftConfig, max_streams: int = 64,
                 device: torch.device | str = "cuda", mesh=None):
        """Serve up to ``max_streams`` sessions of ``model`` on ``device``: the
        card unless the caller asks for the CPU; a CUDA device that is not
        there is an error. The model is moved there."""
        if mesh is not None:
            raise NotImplementedError("serving over a device mesh is not ported: stream slots over "
                                      "several cards wait for torch.distributed")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        self.enhancer = StreamingEnhancer(model.to(device), cfg)
        self.device = self.enhancer.device
        self.max_streams = max_streams
        self.hop = cfg.hop_length
        self.mics = self.enhancer.mics  # 0: one channel; else a session buffers [M, samples]
        with torch.inference_mode():
            self._state = self.enhancer.init_state(max_streams)
            self._fresh = self.enhancer.init_state(1)  # the template of a slot reset
        for leaf, fresh in zip(tree_leaves(self._state), tree_leaves(self._fresh)):
            assert leaf.shape[0] % max_streams == 0 and leaf.shape[0] == max_streams * fresh.shape[0], (
                f"a state leaf of shape {tuple(leaf.shape)} does not lead with {fresh.shape[0]} rows "
                f"each of the {max_streams} slots")
        self._active = np.zeros(max_streams, bool)
        self._buffers: Dict[int, np.ndarray] = {}
        # the step's hops (M x hop a slot multi-mic), and the active mask in the last column: one copy to the card
        self._width = max(self.mics, 1) * self.hop
        self._staging = torch.zeros((max_streams, self._width + 1), dtype=torch.float32,
                                    pin_memory=self.device.type == "cuda")
        self.steps = 0  # batched steps run, drains included

    # ---- session management ----

    def open(self) -> int:
        free = np.flatnonzero(~self._active)
        if len(free) == 0:
            raise RuntimeError(f"all {self.max_streams} stream slots busy")
        sid = int(free[0])
        self._active[sid] = True
        self._buffers[sid] = np.zeros((self.mics, 0) if self.mics else 0, np.float32)
        self._reset(sid)
        return sid

    @torch.inference_mode()
    def _reset(self, sid: int) -> None:
        def reset(full, fresh):
            rep = fresh.shape[0]
            return full.index_copy(0, torch.arange(sid * rep, (sid + 1) * rep, device=full.device), fresh)

        self._state = tree_map(reset, self._state, self._fresh)

    def close(self, sid: int) -> None:
        self._active[sid] = False
        self._buffers.pop(sid, None)

    def drain(self, sid: int) -> np.ndarray:
        """Flush a session's buffered input: zero-pad the last partial hop,
        step this session alone until its buffer is empty, and return the
        enhanced samples of exactly the input that was still buffered. The
        session stays open."""
        assert self._active[sid], f"stream {sid} is not open"
        pending = self._buffers[sid].shape[-1]
        if pending == 0:
            return np.zeros(0, np.float32)
        pad = (-pending) % self.hop
        if pad:
            self.feed(sid, np.zeros((self.mics, pad) if self.mics else pad, np.float32))
        outs = []
        while self.ready(sid):
            outs.append(self.step(only=(sid,))[sid])  # the other sessions' hops stay queued
        return np.concatenate(outs)[:pending]

    def feed(self, sid: int, samples: np.ndarray) -> None:
        """Buffer samples: any shape of one channel, ``[M, k]`` multi-mic."""
        assert self._active[sid], f"stream {sid} is not open"
        samples = np.asarray(samples, np.float32)
        if not self.mics:
            samples = samples.ravel()
        elif samples.ndim != 2 or samples.shape[0] != self.mics:
            raise ValueError(f"a {self.mics}-mic stream takes [{self.mics}, k] samples, got {samples.shape}")
        self._buffers[sid] = np.concatenate([self._buffers[sid], samples], axis=-1)

    def ready(self, sid: int) -> bool:
        return bool(self._active[sid]) and self._buffers[sid].shape[-1] >= self.hop

    def ready_sessions(self) -> List[int]:
        """Session ids with at least one whole hop buffered."""
        return [sid for sid, buf in self._buffers.items() if buf.shape[-1] >= self.hop]

    # ---- the batched step ----

    def step(self, only=None) -> Dict[int, np.ndarray]:
        """One hop for every session with a whole hop buffered (of those in
        ``only``, when given: ``drain`` steps one session and leaves the
        others' queues alone). Returns {sid: enhanced hop}. The other slots
        process zeros, consume no input and keep their state."""
        packed = self._staging.numpy()
        packed.fill(0.0)
        stepped: List[int] = []
        for sid, buf in self._buffers.items():
            if only is not None and sid not in only:
                continue
            if buf.shape[-1] >= self.hop:
                packed[sid, : self._width] = buf[..., : self.hop].reshape(-1)
                self._buffers[sid] = buf[..., self.hop :]
                stepped.append(sid)
        if not stepped:
            return {}
        packed[stepped, self._width] = 1.0
        out = self._step(self._staging.to(self.device, non_blocking=True))
        return {sid: out[sid] for sid in stepped}

    @torch.inference_mode()
    def _step(self, packed: torch.Tensor) -> np.ndarray:
        hops, active = packed[:, : self._width], packed[:, self._width] > 0
        if self.mics:
            hops = hops.view(self.max_streams, self.mics, self.hop)
        out, new_state = self.enhancer.step(self._state, hops)
        self._state = tree_map(lambda new, old: torch.where(_rows(active, new), new, old),
                               new_state, self._state)
        self.steps += 1
        return out.cpu().numpy()  # the step's one wait on the device

    def run_session(self, wav: np.ndarray, sid: Optional[int] = None) -> np.ndarray:
        """Push one utterance ([L], or [M, L] multi-mic) through a (new)
        session and return everything enhanced so far (whole hops; ``drain``
        gives the rest). Other sessions step along unaffected."""
        own = sid is None
        if own:
            sid = self.open()
        self.feed(sid, wav)
        outs = []
        while self.ready(sid):
            res = self.step()
            if sid in res:
                outs.append(res[sid])
        if own:
            self.close(sid)
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)


class MultiModelServer:
    """Serve several enhancement models at once with priority-aware dispatch.

    Each registered model owns a ``StreamingServer`` pool; a session is opened
    against a model name with a priority. ``step`` steps the pools that have
    ready work in order of urgency (the most urgent ready session first, ties
    to the pool served least recently), and ``max_dispatches`` bounds how many
    pools step a call, so under load the high-priority sessions keep their
    hop cadence while best-effort ones absorb the backlog."""

    def __init__(self):
        self._pools: Dict[str, StreamingServer] = {}
        self._priority: Dict[tuple, int] = {}  # (model name, sid) -> priority
        self._last_served: Dict[str, int] = {}
        self._clock = 0

    def add_model(self, name: str, model: torch.nn.Module, cfg: StftConfig, max_streams: int = 16,
                  device: torch.device | str = "cuda") -> None:
        assert name not in self._pools, f"model {name!r} already registered"
        self._pools[name] = StreamingServer(model, cfg, max_streams, device=device)
        self._last_served[name] = 0

    @property
    def models(self) -> List[str]:
        return list(self._pools)

    def pool(self, name: str) -> StreamingServer:
        return self._pools[name]

    def open(self, model_name: str, priority: int = 0):
        """Claim a slot on ``model_name``'s pool. Higher priority is served
        first when dispatches are rationed. Returns an opaque handle."""
        sid = self._pools[model_name].open()
        handle = (model_name, sid)
        self._priority[handle] = priority
        return handle

    def close(self, handle) -> None:
        name, sid = handle
        self._pools[name].close(sid)
        self._priority.pop(handle, None)

    def feed(self, handle, samples: np.ndarray) -> None:
        name, sid = handle
        self._pools[name].feed(sid, samples)

    def ready(self, handle) -> bool:
        name, sid = handle
        return self._pools[name].ready(sid)

    def drain(self, handle) -> np.ndarray:
        name, sid = handle
        return self._pools[name].drain(sid)

    def _urgency(self, name: str):
        ready = self._pools[name].ready_sessions()
        if not ready:
            return None
        return max(self._priority.get((name, sid), 0) for sid in ready)

    def step(self, max_dispatches: Optional[int] = None) -> Dict[tuple, np.ndarray]:
        """Step up to ``max_dispatches`` pools with ready sessions (all of them
        when None), most urgent first. Returns {handle: enhanced hop} over
        every pool stepped."""
        self._clock += 1
        ranked = sorted(((u, name) for name in self._pools if (u := self._urgency(name)) is not None),
                        key=lambda t: (-t[0], self._last_served[t[1]]))
        if max_dispatches is not None:
            ranked = ranked[:max_dispatches]
        out: Dict[tuple, np.ndarray] = {}
        for _, name in ranked:
            self._last_served[name] = self._clock
            for sid, hop in self._pools[name].step().items():
                out[(name, sid)] = hop
        return out
