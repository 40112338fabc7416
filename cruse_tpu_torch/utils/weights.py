"""Weight bridge: cruse_tpu flax variables -> the port's ``CruseNet``,
``CruseDfNet``, ``DfsmnNet`` and ``MtfaaNet`` state_dicts.

The JAX side's ``{"params", "batch_stats"}`` tree, as numpy arrays, maps onto
the port by path, because the port names its submodules after the flax ones
(``enc_0/conv/kernel`` -> ``enc_0.conv.weight``,
``cruse/enc_0/conv/kernel`` -> ``cruse.enc_0.conv.weight``). A kernel's
layout follows the module nearest the leaf that names it (so the same rule
holds at any depth), and four layouts differ:

- the encoder conv is a ``(1, kf)`` flax conv over ``kt`` time taps stacked on
  channels (kernel ``[1, kf, kt*cin, out]``, older tap first); it becomes one
  ``(kt, kf)`` ``Conv2d`` weight ``[out, cin, kt, kf]``;
- flax ``ConvTranspose`` kernels ``[kt, kf, in, out]`` are flipped in both
  spatial axes for ``ConvTranspose2d`` (``[in, out, kt, kf]``);
- ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``;
- a 2-D Dense kernel ``[in, out]`` becomes a ``Linear`` weight ``[out, in]``.

MTFAA keeps the flax shapes and names (its kernels read them as they are),
so its mapping is the path alone: ``/`` becomes ``.``, for the parameters
and the BatchNorm ``mean``/``var`` alike.

DFSMN (``dfsmn_state_dict_from_flax``) keeps its memory kernels and skip
weights in their flax shapes too; only its Dense kernels ``[in, out]`` become
``Linear`` weights ``[out, in]``.

``mtfaa_flax_from_named`` is MTFAA's mapping's inverse, for the parameters, their
gradients or the statistics of a trained port model, so that tests compare
the two packages leaf by leaf.

``save_flax_npz`` / ``load_flax_npz`` store such a tree in one ``.npz`` with
``/``-joined keys, so a weight file written next to JAX loads where there is
no JAX. Neither function imports JAX: ``np.asarray`` takes its arrays.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var", "kernel": "weight"}


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {"a/b/c": array}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """{"a/b/c": array} -> nested dicts."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_flax_npz(variables: Mapping[str, Any], path: str) -> None:
    """Write a flax variables tree (jax or numpy leaves) to one .npz."""
    np.savez(path, **flatten_tree(variables))


def load_flax_npz(path: str) -> Dict[str, Any]:
    """Read a tree written by ``save_flax_npz`` as nested numpy dicts."""
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def _convert(flax_path: str, value: np.ndarray, cfg) -> np.ndarray:
    """One flax leaf -> its torch layout; ``cfg`` is the CRUSE trunk's config."""
    if not flax_path.endswith("kernel"):
        return value
    if value.ndim == 2:  # Dense [in, out] -> Linear [out, in]
        return np.ascontiguousarray(value.T)
    modules = flax_path.split("/")[:-1]
    module = next((m for m in reversed(modules) if re.fullmatch(r"(enc|dec)_\d+", m)), "")
    if module.startswith("enc_"):  # [1, kf, kt*cin, out] -> [out, cin, kt, kf]
        kt = cfg.kernel[0]
        _, kf, kcin, out = value.shape
        taps = value[0].reshape(kf, kt, kcin // kt, out)  # channel index = tap*cin + c
        return np.ascontiguousarray(np.transpose(taps, (3, 2, 1, 0)))
    if module.startswith("dec_"):  # ConvTranspose: flip, [kt, kf, in, out] -> [in, out, kt, kf]
        return np.ascontiguousarray(np.transpose(value[::-1, ::-1], (2, 3, 0, 1)))
    return np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1)))  # Conv: -> [out, in, kh, kw]


def cruse_state_dict_from_flax(variables_np: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """cruse_tpu ``CruseNet`` variables -> state_dict of the port's
    ``CruseNet(cfg)``, BatchNorm running statistics included. Load it with
    ``load_state_dict(..., strict=True)`` to check that nothing is missing."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in flatten_tree(variables_np.get(collection, {})).items():
            *modules, leaf = path.split("/")
            key = ".".join(modules + [_LEAF_NAMES.get(leaf, leaf)])
            state[key] = torch.from_numpy(_convert(path, np.array(value, np.float32), cfg))
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0)
    return state


def mtfaa_state_dict_from_flax(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """cruse_tpu ``MtfaaNet`` variables -> state_dict of the port's
    ``MtfaaNet``: every leaf in its flax shape (0-d PReLU slopes included)
    under its flax path with ``/`` -> ``.``, BatchNorm statistics included."""
    return {path.replace("/", "."): torch.from_numpy(np.array(value, np.float32))
            for collection in ("params", "batch_stats")
            for path, value in flatten_tree(variables_np.get(collection, {})).items()}


def dfsmn_state_dict_from_flax(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """cruse_tpu ``DfsmnNet`` variables -> state_dict of the port's ``DfsmnNet``:
    ``proj_in``, ``block_i/{in_conv, out_conv}`` and ``mask_head`` Dense
    kernels transposed to ``Linear`` weights, their biases as they are, and
    ``block_i/{left_kernel, right_kernel, skip_weight}`` in their flax shapes."""
    state = {}
    for path, value in flatten_tree(variables_np.get("params", {})).items():
        value = np.array(value, np.float32)
        if path.endswith("/kernel"):  # Dense [in, out] -> Linear [out, in]
            path, value = path[: -len("kernel")] + "weight", np.ascontiguousarray(value.T)
        state[path.replace("/", ".")] = torch.from_numpy(value)
    return state


def mtfaa_flax_from_named(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``mtfaa_state_dict_from_flax``: tensors by the port's
    dotted names (a ``state_dict``, or gradients by parameter name) -> a
    flax-shaped ``{"params": ..., "batch_stats": ...}`` tree of numpy arrays.
    A BatchNorm's ``mean`` / ``var`` go to ``batch_stats``, every other leaf
    to ``params``."""
    flat: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for name, tensor in named.items():
        collection = "batch_stats" if name.rsplit(".", 1)[-1] in ("mean", "var") else "params"
        flat[collection][name.replace(".", "/")] = tensor.detach().cpu().numpy()
    return {collection: unflatten_tree(leaves) for collection, leaves in flat.items()}


def state_dict_from_flax(variables_np: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """cruse_tpu variables -> state_dict of the port's ``model``: an
    MtfaaNet, a DfsmnNet, a CruseNet, or a CruseDfNet, whose trunk is under
    ``cruse.`` and head is ``df_head``. The CRUSE trunk's config
    (``config.cruse`` of a CruseDfNet) fixes the encoder kernels' layout."""
    from cruse_tpu_torch.models.dfsmn import DfsmnNet
    from cruse_tpu_torch.models.mtfaa import MtfaaNet

    if isinstance(model, MtfaaNet):
        return mtfaa_state_dict_from_flax(variables_np)
    if isinstance(model, DfsmnNet):
        return dfsmn_state_dict_from_flax(variables_np)
    return cruse_state_dict_from_flax(variables_np, getattr(model.config, "cruse", model.config))
