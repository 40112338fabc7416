"""Self-contained deployment artifacts (counterpart of
``cruse_tpu/infer/artifact.py``): a zip container around ``torch.export``
programs plus JSON metadata, so that a consumer needs only torch, the five
kernel ops' registrations (``cruse_tpu_torch.ops.gru_kernel``,
``deep_filter_kernel``, ``tfcm_kernel``, ``asa_kernel`` and ``dw_kernel``,
imported here) and this file: no model classes, no configs, no weight files.

  meta.json   {"format": "cruse-tpu-torch-artifact/1", "kind": "offline" |
               "streaming", "sr", "n_fft", "hop_length", "batch", "length"
               (offline), "num_mics" (streaming: M of a multi-mic model,
               else null), "quantized", "device", "model"}
  graph.pt2   offline:   enhanced [B, L]        = graph(noisy [B, L])
  step.pt2    streaming: (out [B, hop], state') = step(state, hop [B, hop]),
              hop [B, M, hop] where "num_mics" is M
  init.pt     streaming: the initial state's tensors (``torch.save`` of a
              list), which ``init_state`` puts back into a ``StreamState``

The carried state is a ``StreamState`` whose ``model_state`` is a flat tuple
of the model family's state tensors (``infer/export.py`` flattens the model's
own nested tuples and NamedTuples at the step's boundary), so that the only
type a saved program names is ``StreamState``. Its serialization is
registered HERE, so this file alone is enough to load ``step.pt2``; the
streaming path (``infer/streaming.py``) imports the type from here.

``torch.export`` fixes the device of every tensor a program makes, so an
artifact runs only on the device it was exported on: ``meta.json`` records
it and ``load`` raises when asked for another.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, NamedTuple

import torch
import torch.utils._pytree as pytree

import cruse_tpu_torch.ops.asa_kernel  # noqa: F401  registers torch.ops.cruse_tpu_torch.tattn_fwd
import cruse_tpu_torch.ops.deep_filter_kernel  # noqa: F401  registers torch.ops.cruse_tpu_torch.deep_filter
import cruse_tpu_torch.ops.dw_kernel  # noqa: F401  registers torch.ops.cruse_tpu_torch.dw_fwd
import cruse_tpu_torch.ops.gru_kernel  # noqa: F401  registers torch.ops.cruse_tpu_torch.gru_sequence
import cruse_tpu_torch.ops.tfcm_kernel  # noqa: F401  registers torch.ops.cruse_tpu_torch.tfcm_eval

FORMAT = "cruse-tpu-torch-artifact/1"


class StreamState(NamedTuple):
    """Per-hop streaming carry (built by ``cruse_tpu_torch.infer.streaming``;
    in a streaming artifact its ``model_state`` is a flat tuple of tensors)."""

    input_tail: Any  # [B(, M), n_fft - hop] analysis-buffer samples
    ola_tail: Any  # [B, n_fft - hop] synthesis overlap-add tail
    model_state: Any  # the model family's state


# what lets torch.export.save / load write and read a program whose inputs and outputs hold it
# (the tree spec), and read its example inputs with torch.load's weights_only
pytree._register_namedtuple(StreamState, serialized_type_name="cruse_tpu_torch.infer.artifact.StreamState")
torch.serialization.add_safe_globals([StreamState])


# ---------------- save ----------------


def _program_bytes(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_offline(path: str, program, meta: dict) -> None:
    """``program``: the ``torch.export`` program of enhanced = graph(noisy)."""
    _write_container(path, dict(meta, format=FORMAT, kind="offline"), {"graph.pt2": _program_bytes(program)})


def save_streaming(path: str, program, init_state: StreamState, meta: dict) -> None:
    """``program``: the exported step; ``init_state``: its initial carry."""
    buf = io.BytesIO()
    torch.save([t.detach().cpu() for t in pytree.tree_leaves(init_state)], buf)
    _write_container(path, dict(meta, format=FORMAT, kind="streaming"),
                     {"step.pt2": _program_bytes(program), "init.pt": buf.getvalue()})


def _write_container(path: str, meta: dict, blobs: dict) -> None:
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=1, sort_keys=True))
        for name, blob in blobs.items():
            zf.writestr(name, blob)


# ---------------- load ----------------


def _user_input_shapes(program) -> list:
    """The shapes of the program's user inputs, in order."""
    names = set(program.graph_signature.user_inputs)
    return [tuple(node.meta["val"].shape) for node in program.graph.nodes
            if node.op == "placeholder" and node.name in names]


class OfflineArtifact:
    """enhance(noisy [B, L]) -> enhanced [B, L], at the exported shape."""

    kind = "offline"

    def __init__(self, program, meta: dict):
        self.program = program
        self._graph = program.module()
        self.meta = meta

    @property
    def input_shape(self):
        return _user_input_shapes(self.program)[0]

    def enhance(self, noisy: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._graph(noisy)


class StreamingArtifact:
    """init_state() -> carry; step(carry, hop [B, hop] or [B, M, hop]) -> (out
    [B, hop], carry)."""

    kind = "streaming"

    def __init__(self, program, init_leaves: list, meta: dict):
        self.program = program
        self._step = program.module()
        self._init = init_leaves
        self.meta = meta

    @property
    def hop_shape(self):
        """(B, hop), or (B, M, hop) for a multi-mic artifact."""
        return _user_input_shapes(self.program)[-1]

    def init_state(self) -> StreamState:
        tail, ola, *model_state = self._init
        return StreamState(tail, ola, tuple(model_state))

    def prime(self, state: StreamState, samples: torch.Tensor) -> StreamState:
        """Pre-fill the analysis buffer with the utterance's first ``n_fft -
        hop`` samples so that the outputs line up with the offline path
        (``StreamingEnhancer.prime``; a replace, so it needs no program)."""
        tail = state.input_tail
        samples = torch.as_tensor(samples).to(tail)
        if samples.shape != tail.shape:
            raise ValueError(f"prime takes {tuple(tail.shape)} samples, got {tuple(samples.shape)}")
        return state._replace(input_tail=samples)

    def step(self, state: StreamState, hop_samples: torch.Tensor):
        with torch.inference_mode():
            return self._step(state, hop_samples)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def load(path: str, device: str | torch.device | None = None):
    """Load a container. ``device`` (None: the artifact's own) must be the
    device it was exported on; another raises, for the program's tensors
    are fixed to that device."""
    path = os.path.abspath(os.path.expanduser(path))
    if not zipfile.is_zipfile(path):
        raise ValueError(f"not a {FORMAT} container: {path}")
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json").decode("utf-8"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} container: {path} ({meta.get('format')!r})")
        exported_on = torch.device(meta["device"])
        if device is not None and not _same_device(torch.device(device), exported_on):
            raise ValueError(f"{path} was exported on {exported_on} and runs only there, not on {device} "
                             "(export it again on that device)")
        if exported_on.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} runs on {exported_on}: no CUDA device is available")
        kind = meta.get("kind")
        if kind == "offline":
            return OfflineArtifact(torch.export.load(io.BytesIO(zf.read("graph.pt2"))), meta)
        if kind == "streaming":
            leaves = torch.load(io.BytesIO(zf.read("init.pt")), map_location=exported_on)
            return StreamingArtifact(torch.export.load(io.BytesIO(zf.read("step.pt2"))), leaves, meta)
    raise ValueError(f"unknown artifact kind {kind!r} in {path}")
