"""Weight-only int8 quantization (counterpart of ``cruse_tpu/nn/quantize.py``).

The rule is the JAX package's, on the flax variables tree as numpy arrays
(as ``utils.weights.load_flax_npz`` gives it): every float leaf of the
``params`` collection with ndim >= 2 and at least ``DEFAULT_MIN_SIZE``
elements becomes symmetric int8 with one scale per index of the leaf's LAST
axis, ``scale = max(amax, 1e-12) / 127`` and ``codes = clip(rint(w / scale),
-127, 127)``; ``batch_stats`` and small leaves stay float32. That last axis
is the flax kernel's output channel for a Dense or a Conv, but not for the
grouped GRU's ``w_hh [G, 3H, H]``, whose scales run along the recurrent
input; the port keeps the JAX rule as it is, so that both packages hold the
same codes. A quantized leaf is ``{Q_KEY: int8 codes, SCALE_KEY: float32
scales}``, the scales shaped ``[1, ..., 1, C]``.

The port's side (``int8_state_dict``) runs that rule on the flax tree (a
bridge ``.npz``, or the model's own seeded weights mapped back by
``utils.weights.flax_from_state_dict``) and bridges codes and scales to the
model's layouts. A model then takes them one of two ways:

- ``load_dequantized`` (eager serving: ``BatchInferencer``,
  ``StreamingEnhancer``, the server) multiplies them out once, when the
  weights are loaded: the numbers of the JAX package's dequantize on every
  call, with the kernels and the GRU's cached weight layouts untouched. The
  card then holds float32 weights: the JAX package's ~4x smaller parameter
  residency comes from XLA fusing the dequantize into its consumers, which
  eager PyTorch does not do;
- ``attach_int8`` (export) keeps int8 codes and float32 scales in the
  module and dequantizes on every call (a ``torch.nn.utils.parametrize``
  parametrization, ``Int8Weight``), so that a ``torch.export`` graph holds
  the int8 bytes and the dequantize, as ``tools/export.py`` does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

Q_KEY = "__q8__"
SCALE_KEY = "__q8_scale__"

# Leaves smaller than this stay fp32: quantizing a 100-float bias saves
# nothing and risks precision where it is cheapest to keep.
DEFAULT_MIN_SIZE = 2048


def is_quantized_leaf(node: Any) -> bool:
    return isinstance(node, Mapping) and Q_KEY in node and SCALE_KEY in node


def _quantize_array(w: np.ndarray) -> dict:
    """Symmetric int8 with one scale per index of the last axis."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {Q_KEY: q, SCALE_KEY: scale.astype(np.float32)}


def quantize_tree(tree: Any, *, min_size: int = DEFAULT_MIN_SIZE) -> Any:
    """Quantize every float leaf with ndim >= 2 and size >= min_size; other
    leaves pass through as they are, and quantized leaves stay as they are."""
    if is_quantized_leaf(tree):
        return tree
    if isinstance(tree, Mapping):
        return {k: quantize_tree(v, min_size=min_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_tree(v, min_size=min_size) for v in tree)
    leaf = tree
    if hasattr(leaf, "ndim") and hasattr(leaf, "dtype"):
        if leaf.ndim >= 2 and leaf.size >= min_size and np.dtype(leaf.dtype).kind == "f":
            return _quantize_array(np.asarray(leaf))
    return leaf


def dequantize_tree(tree: Any, dtype=np.float32) -> Any:
    """The inverse: codes times scales; the identity on unquantized nodes."""
    if is_quantized_leaf(tree):
        return np.asarray(tree[Q_KEY]).astype(dtype) * np.asarray(tree[SCALE_KEY]).astype(dtype)
    if isinstance(tree, Mapping):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(dequantize_tree(v, dtype) for v in tree)
    return tree


def quantize_variables(variables: Mapping, *, min_size: int = DEFAULT_MIN_SIZE) -> dict:
    """Quantize the 'params' collection only; batch_stats and other
    collections keep full precision."""
    out = dict(variables)
    if "params" in out:
        out["params"] = quantize_tree(out["params"], min_size=min_size)
    return out


def quantization_report(tree: Any) -> dict:
    """{'leaves_quantized', 'leaves_kept', 'bytes_fp32', 'bytes_quantized'}
    of a (partly) quantized tree, for the log line."""
    report = {"leaves_quantized": 0, "leaves_kept": 0, "bytes_fp32": 0, "bytes_quantized": 0}

    def walk(node):
        if is_quantized_leaf(node):
            n = np.size(node[Q_KEY])
            report["leaves_quantized"] += 1
            report["bytes_fp32"] += 4 * n
            report["bytes_quantized"] += n + 4 * np.size(node[SCALE_KEY])
        elif isinstance(node, Mapping):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif hasattr(node, "size") and hasattr(node, "dtype"):
            nbytes = int(np.size(node)) * np.dtype(node.dtype).itemsize
            report["leaves_kept"] += 1
            report["bytes_fp32"] += nbytes
            report["bytes_quantized"] += nbytes

    walk(tree)
    return report


def report_line(report: dict) -> str:
    """The export log's line (``tools/export.py:22-30``)."""
    return (f"int8-quantized {report['leaves_quantized']} kernels ({report['leaves_kept']} small leaves "
            f"kept fp32): params {report['bytes_fp32'] / 1e6:.2f} -> {report['bytes_quantized'] / 1e6:.2f} MB")


# ---------------- the port's modules ----------------


def int8_state_dict(model: nn.Module, variables: Mapping | None = None, *,
                    min_size: int = DEFAULT_MIN_SIZE) -> tuple[Dict[str, Any], dict]:
    """(state dict, report): the JAX rule on ``variables`` (a flax tree as
    numpy; None: the model's own weights mapped back to one), bridged to the
    model's layouts. A quantized entry is ``{Q_KEY: int8 tensor, SCALE_KEY:
    float32 tensor}``, the scales holding their one channel axis where the
    flax leaf's last axis lands and 1 on every other; every other entry is a
    float32 tensor."""
    from cruse_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

    variables = flax_from_state_dict(model) if variables is None else variables
    quantized = quantize_variables(variables, min_size=min_size)
    return state_dict_from_flax(quantized, model), quantization_report(quantized["params"])


def dequantize_state_dict(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Codes times scales for every quantized entry, in float32."""
    return {k: v[Q_KEY].float() * v[SCALE_KEY] if is_quantized_leaf(v) else v for k, v in state.items()}


def load_dequantized(model: nn.Module, state: Mapping[str, Any]) -> None:
    """Eager serving: load the weights dequantized once (strict)."""
    model.load_state_dict(dequantize_state_dict(state), strict=True)


def load_int8_for_serving(model: nn.Module, variables: Mapping | None = None) -> str:
    """The CLIs' ``--quantize int8``: ``int8_state_dict`` of ``variables``
    (None: the model's own weights) loaded dequantized; returns the log line
    (``tools/infer.py:75-81``)."""
    state, rep = int8_state_dict(model, variables)
    load_dequantized(model, state)
    return (f"int8 weights: {rep['leaves_quantized']} kernels, params {rep['bytes_fp32'] / 1e6:.2f} -> "
            f"{rep['bytes_quantized'] / 1e6:.2f} MB (dequantized once: the device holds float32)")


class Int8Weight(nn.Module):
    """Parametrization ``weight = codes * scale`` over two originals, int8
    ``codes`` in the weight's shape and float32 ``scale`` broadcast over it.
    Assigning a float weight quantizes it symmetrically over the scale's axes
    of size 1 (``attach_int8`` then writes the bridged codes and scales in)."""

    def __init__(self, scale_shape):
        super().__init__()
        self.scale_shape = tuple(scale_shape)

    def forward(self, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return codes.float() * scale

    def right_inverse(self, weight: torch.Tensor):
        axes = tuple(a for a, n in enumerate(self.scale_shape) if n == 1)
        weight = weight.detach().float()
        amax = weight.abs().amax(dim=axes, keepdim=True) if axes else weight.abs()
        scale = amax.clamp_min(1e-12) / 127.0
        return torch.round(weight / scale).clamp(-127, 127).to(torch.int8), scale


def attach_int8(model: nn.Module, state: Mapping[str, Any]) -> None:
    """Export: load ``state`` (from ``int8_state_dict``) into ``model`` with
    each quantized weight kept as int8 codes and float32 scales, dequantized
    on every call through an ``Int8Weight`` parametrization. The model is for
    inference from then on: those weights take no gradient."""
    quantized = {k: v for k, v in state.items() if is_quantized_leaf(v)}
    model.load_state_dict(dequantize_state_dict(state), strict=True)
    for key, leaf in quantized.items():
        module_name, _, name = key.rpartition(".")
        module = model.get_submodule(module_name)
        getattr(module, name).requires_grad_(False)  # an int8 original cannot take a gradient
        parametrize.register_parametrization(module, name, Int8Weight(leaf[SCALE_KEY].shape), unsafe=True)
        originals = module.parametrizations[name]
        with torch.no_grad():
            originals.original0.copy_(leaf[Q_KEY])
            originals.original1.copy_(leaf[SCALE_KEY])
