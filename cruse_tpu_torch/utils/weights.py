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
the two packages leaf by leaf; ``flax_from_state_dict`` inverts every
family's mapping for a whole model.

An int8 leaf (``nn.quantize``: ``{"__q8__": codes, "__q8_scale__":
scales}``) crosses the bridge as one: its codes take the leaf's layout
without a cast to float, and its scales keep their one channel axis wherever
the leaf's last axis lands; the state_dict entry is then the same dict of
two tensors, which ``nn.quantize.load_dequantized`` or ``attach_int8`` load.

``save_flax_npz`` / ``load_flax_npz`` store such a tree in one ``.npz`` with
``/``-joined keys, so a weight file written next to JAX loads where there is
no JAX. Neither function imports JAX: ``np.asarray`` takes its arrays.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from cruse_tpu_torch.nn.quantize import Q_KEY, SCALE_KEY, is_quantized_leaf

_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var", "kernel": "weight"}


def flatten_tree(tree: Mapping[str, Any], prefix: str = "", keep_quantized: bool = False) -> Dict[str, Any]:
    """Nested mapping -> {"a/b/c": array}. With ``keep_quantized`` an int8
    leaf (``nn.quantize.is_quantized_leaf``) stays one entry, its dict of
    codes and scales."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if keep_quantized and is_quantized_leaf(value):
            out[path] = {k: np.asarray(v) for k, v in value.items()}
        elif isinstance(value, Mapping):
            out.update(flatten_tree(value, path, keep_quantized))
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


def _to_port(value, convert) -> Any:
    """One flax leaf -> a float32 tensor in the port's layout (``convert``
    takes the flax array to it); an int8 leaf -> its codes moved the same
    way, uncast, and its scales ``[1, ..., C]`` moved with them: C along the
    axis where the leaf's last axis lands, 1 along every other."""
    if not is_quantized_leaf(value):
        return torch.from_numpy(convert(np.array(value, np.float32)))
    codes = np.asarray(value[Q_KEY])
    scale = np.asarray(value[SCALE_KEY], np.float32).reshape(-1)
    channel = convert(np.broadcast_to(np.arange(scale.size), codes.shape).copy())
    for axis in range(channel.ndim):  # keep the axis along which the channel index varies
        first = channel.take([0], axis=axis)
        if (channel == first).all():
            channel = first
    return {Q_KEY: torch.from_numpy(np.ascontiguousarray(convert(codes))),
            SCALE_KEY: torch.from_numpy(np.ascontiguousarray(scale[channel]))}


def cruse_state_dict_from_flax(variables_np: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """cruse_tpu ``CruseNet`` variables -> state_dict of the port's
    ``CruseNet(cfg)``, BatchNorm running statistics included. Load it with
    ``load_state_dict(..., strict=True)`` to check that nothing is missing.
    An int8 leaf (``nn.quantize``) comes out as its codes and scales."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in flatten_tree(variables_np.get(collection, {}), keep_quantized=True).items():
            *modules, leaf = path.split("/")
            key = ".".join(modules + [_LEAF_NAMES.get(leaf, leaf)])
            state[key] = _to_port(value, lambda v, path=path: _convert(path, v, cfg))
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(0)
    return state


def mtfaa_state_dict_from_flax(variables_np: Mapping[str, Any]) -> Dict[str, Any]:
    """cruse_tpu ``MtfaaNet`` variables -> state_dict of the port's
    ``MtfaaNet``: every leaf in its flax shape (0-d PReLU slopes included)
    under its flax path with ``/`` -> ``.``, BatchNorm statistics included."""
    return {path.replace("/", "."): _to_port(value, lambda v: v)
            for collection in ("params", "batch_stats")
            for path, value in flatten_tree(variables_np.get(collection, {}), keep_quantized=True).items()}


def dfsmn_state_dict_from_flax(variables_np: Mapping[str, Any]) -> Dict[str, Any]:
    """cruse_tpu ``DfsmnNet`` variables -> state_dict of the port's ``DfsmnNet``:
    ``proj_in``, ``block_i/{in_conv, out_conv}`` and ``mask_head`` Dense
    kernels transposed to ``Linear`` weights, their biases as they are, and
    ``block_i/{left_kernel, right_kernel, skip_weight}`` in their flax shapes."""
    state = {}
    for path, value in flatten_tree(variables_np.get("params", {}), keep_quantized=True).items():
        if path.endswith("/kernel"):  # Dense [in, out] -> Linear [out, in]
            state[path[: -len("kernel")].replace("/", ".") + "weight"] = _to_port(
                value, lambda v: np.ascontiguousarray(v.T))
        else:
            state[path.replace("/", ".")] = _to_port(value, lambda v: v)
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


def _unconvert(flax_path: str, value: np.ndarray) -> np.ndarray:
    """``_convert``'s inverse: one port tensor -> its flax leaf's layout."""
    if not flax_path.endswith("kernel"):
        return value
    if value.ndim == 2:  # Linear [out, in] -> Dense [in, out]
        return np.ascontiguousarray(value.T)
    modules = flax_path.split("/")[:-1]
    module = next((m for m in reversed(modules) if re.fullmatch(r"(enc|dec)_\d+", m)), "")
    if module.startswith("enc_"):  # [out, cin, kt, kf] -> [1, kf, kt*cin, out]
        out, cin, kt, kf = value.shape
        return np.ascontiguousarray(np.transpose(value, (3, 2, 1, 0)).reshape(1, kf, kt * cin, out))
    if module.startswith("dec_"):  # [in, out, kt, kf] -> [kt, kf, in, out], flipped back
        return np.ascontiguousarray(np.transpose(value, (2, 3, 0, 1))[::-1, ::-1])
    return np.ascontiguousarray(np.transpose(value, (2, 3, 1, 0)))  # Conv [out, in, kh, kw] -> [kh, kw, in, out]


def flax_from_state_dict(model, state_dict: Mapping[str, torch.Tensor] | None = None) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_flax``: the port ``model``'s weights
    (or ``state_dict``, one of that model's, such as a trainer's snapshot)
    -> the cruse_tpu variables tree (``{"params", "batch_stats"}`` of numpy
    arrays) that the bridge maps onto them, so that a rule stated on the flax
    tree (int8 quantization) runs on seeded weights too."""
    from cruse_tpu_torch.models.dfsmn import DfsmnNet
    from cruse_tpu_torch.models.mtfaa import MtfaaNet

    state_dict = model.state_dict() if state_dict is None else state_dict
    if isinstance(model, MtfaaNet):
        return mtfaa_flax_from_named(state_dict)
    named = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    flat: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    if isinstance(model, DfsmnNet):
        for key, value in named.items():
            if key.endswith(".weight"):  # Linear [out, in] -> Dense [in, out]
                key, value = key[: -len("weight")] + "kernel", np.ascontiguousarray(value.T)
            flat["params"][key.replace(".", "/")] = value
        return {collection: unflatten_tree(leaves) for collection, leaves in flat.items()}
    inverse = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    for key, value in named.items():
        *modules, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight":  # a kernel, or a norm's 1-D scale
            leaf = "kernel" if value.ndim >= 2 else "scale"
        collection, leaf = inverse.get(leaf, ("params", leaf))
        path = "/".join(modules + [leaf])
        flat[collection][path] = _unconvert(path, value)
    return {collection: unflatten_tree(leaves) for collection, leaves in flat.items()}
