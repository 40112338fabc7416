"""Weight bridge: cruse_tpu flax variables -> the port's ``CruseNet``,
``CruseDfNet``, ``McCruseNet``, ``DfsmnNet``, ``MtfaaNet``, ``FullSubNet``
and ``BSRNN`` state_dicts.

The JAX side's ``{"params", "batch_stats"}`` tree, as numpy arrays, maps onto
the port by path, because the port names its submodules after the flax ones
(``enc_0/conv/kernel`` -> ``enc_0.conv.weight``,
``cruse/enc_0/conv/kernel`` -> ``cruse.enc_0.conv.weight``). A kernel's
layout follows the module nearest the leaf that names it (so the same rule
holds at any depth: CRUSE+DF's and McCruse's trunks under ``cruse/``, with
McCruse's ``spatial_proj/kernel`` a Dense and its ``PReLU_0/negative_slope``
a 0-d leaf), and four layouts differ:

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

DFSMN and FullSubNet (``dense_state_dict_from_flax``) keep every leaf in
its flax shape too (DFSMN's memory kernels and skip weights, FullSubNet's
GRU leaves ``…/layer/{w_ih, w_hh, b_ih, b_hh}``, ``[1, 3H, ·]``); only their
Dense kernels ``[in, out]`` become ``Linear`` weights ``[out, in]``.

BSRNN (``bsrnn_state_dict_from_flax``) keeps every leaf in its flax shape
under its path but for two renames: a Dense kernel becomes a transposed
``Linear`` weight, and an LSTM's leaves (``lstm_t_0/w_ih``, ``…/b_hh_reverse``,
already in torch's layout) become ``nn.LSTM``'s flat ones
(``lstm_t_0.rnn.weight_ih_l0``, ``….rnn.bias_hh_l0_reverse``); the norms'
``scale`` / ``bias`` keep their names.

MetricGAN+'s ``Discriminator`` (``discriminator_state_dict_from_flax`` and
its inverse) maps flax's ``Conv_i/kernel`` (HWIO) to ``conv_i.weight``
(OIHW), ``Dense_0`` / ``Dense_1`` to ``fc1`` / ``fc2``, the PReLU slopes and
``lsig/slope`` by name, and the spectral norms' statistics, which flax keeps
under ``batch_stats/conv_i/'Conv_i/kernel/u'`` (and ``…/sigma``; ``fc1`` /
``'Dense_0/kernel/u'`` for the Dense layers), to ``conv_i.norm.u`` and
``.sigma``.

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
    """Read a tree written by ``save_flax_npz`` as nested numpy dicts. A
    trainer's snapshot with an EMA of its weights (an ``ema_params``
    subtree) gives the EMA weights as ``params``: validation scored them,
    and the JAX package's loader prefers them in the same way."""
    with np.load(path) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    ema = tree.pop("ema_params", None)
    if ema:
        from cruse_tpu_torch.utils.logger import log

        log(f"loading EMA weights from {path} (ema_params present)")
        tree["params"] = ema
    return tree


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


def dense_state_dict_from_flax(variables_np: Mapping[str, Any]) -> Dict[str, Any]:
    """cruse_tpu ``DfsmnNet`` or ``FullSubNet`` variables -> state_dict of the
    port's model: every Dense kernel (DFSMN's ``proj_in``, ``block_i/{in_conv,
    out_conv}``, ``mask_head``; FullSubNet's ``fb_out``, ``sb_out``) transposed
    to a ``Linear`` weight, every other leaf (the biases, DFSMN's
    ``block_i/{left_kernel, right_kernel, skip_weight}``, FullSubNet's GRU
    leaves) in its flax shape under its path with ``/`` -> ``.``."""
    state = {}
    for path, value in flatten_tree(variables_np.get("params", {}), keep_quantized=True).items():
        if path.endswith("/kernel"):  # Dense [in, out] -> Linear [out, in]
            state[path[: -len("kernel")].replace("/", ".") + "weight"] = _to_port(
                value, lambda v: np.ascontiguousarray(v.T))
        else:
            state[path.replace("/", ".")] = _to_port(value, lambda v: v)
    return state


# the JAX LSTM's leaves -> nn.LSTM's (nn/lstm.py keeps it under ``rnn``)
_LSTM_LEAVES = {f"{jax_name}{sfx}": f"rnn.{torch_name}_l0{sfx}" for sfx in ("", "_reverse")
                for jax_name, torch_name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}
_LSTM_NAMES = {torch_name: jax_name for jax_name, torch_name in _LSTM_LEAVES.items()}


def bsrnn_state_dict_from_flax(variables_np: Mapping[str, Any]) -> Dict[str, Any]:
    """cruse_tpu ``BSRNN`` variables -> state_dict of the port's ``BSRNN``:
    the Dense kernels transposed to ``Linear`` weights, the LSTM leaves
    renamed to ``nn.LSTM``'s, every other leaf as it is under its path."""
    state = {}
    for path, value in flatten_tree(variables_np.get("params", {}), keep_quantized=True).items():
        *modules, leaf = path.split("/")
        if leaf == "kernel":  # Dense [in, out] -> Linear [out, in]
            state[".".join(modules + ["weight"])] = _to_port(value, lambda v: np.ascontiguousarray(v.T))
        else:
            state[".".join(modules + [_LSTM_LEAVES.get(leaf, leaf)])] = _to_port(value, lambda v: v)
    return state


# MetricGAN+'s discriminator: the port's spectral-normed layer -> (flax's wrapper, the flax layer inside it)
_DISC_LAYERS = {**{f"conv_{i}": (f"conv_{i}", f"Conv_{i}") for i in range(4)},
                "fc1": ("fc1", "Dense_0"), "fc2": ("fc2", "Dense_1")}
_DISC_SLOPES = ("PReLU_0", "PReLU_1", "PReLU_2", "PReLU_3", "PReLU_4")


def discriminator_state_dict_from_flax(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """cruse_tpu ``Discriminator`` variables (``params`` and the spectral
    norms' ``batch_stats``) -> state_dict of the port's ``Discriminator``."""
    params, stats = variables_np["params"], variables_np["batch_stats"]
    state = {}
    for name, (wrapper, layer) in _DISC_LAYERS.items():
        kernel = np.asarray(params[layer]["kernel"], np.float32)
        # Conv HWIO -> OIHW; Dense [in, out] -> Linear [out, in]
        state[f"{name}.weight"] = np.transpose(kernel, (3, 2, 0, 1)) if kernel.ndim == 4 else kernel.T
        if "bias" in params[layer]:
            state[f"{name}.bias"] = params[layer]["bias"]
        state[f"{name}.norm.u"] = stats[wrapper][f"{layer}/kernel/u"]
        state[f"{name}.norm.sigma"] = stats[wrapper][f"{layer}/kernel/sigma"]
    for name in _DISC_SLOPES:
        state[f"{name}.negative_slope"] = params[name]["negative_slope"]
    state["lsig.slope"] = params["lsig"]["slope"]
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in state.items()}


def discriminator_flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse: the port's ``Discriminator`` state_dict (or its
    gradients by parameter name, which fill ``params`` alone) -> the
    cruse_tpu ``{"params", "batch_stats"}`` tree of numpy arrays."""
    value = {k: np.array(v.detach().cpu()) for k, v in state_dict.items()}  # copies: the module moves in place
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, (wrapper, layer) in _DISC_LAYERS.items():
        weight = value[f"{name}.weight"]
        params[layer] = {"kernel": np.ascontiguousarray(np.transpose(weight, (2, 3, 1, 0)) if weight.ndim == 4
                                                        else weight.T)}
        if f"{name}.bias" in value:
            params[layer]["bias"] = value[f"{name}.bias"]
        if f"{name}.norm.u" in value:
            stats[wrapper] = {f"{layer}/kernel/u": value[f"{name}.norm.u"],
                              f"{layer}/kernel/sigma": value[f"{name}.norm.sigma"]}
    for name in _DISC_SLOPES:
        params[name] = {"negative_slope": value[f"{name}.negative_slope"]}
    params["lsig"] = {"slope": value["lsig.slope"]}
    return {"params": params, "batch_stats": stats}


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
    MtfaaNet, a DfsmnNet, a FullSubNet, a BSRNN, a CruseNet, a CruseDfNet, whose
    trunk is under ``cruse.`` and head is ``df_head``, or a McCruseNet,
    whose trunk is under ``cruse.`` behind ``spatial_proj`` and ``PReLU_0``.
    The CRUSE trunk's config (``config.cruse`` of a CruseDfNet or a
    McCruseNet) fixes the encoder kernels' layout."""
    family = _family(model)
    if family == "mtfaa":
        return mtfaa_state_dict_from_flax(variables_np)
    if family in ("dfsmn", "fullsubnet"):
        return dense_state_dict_from_flax(variables_np)
    if family == "bsrnn":
        return bsrnn_state_dict_from_flax(variables_np)
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


def _flax_leaf(family: str, key: str, value: np.ndarray):
    """One port tensor -> (collection, flax path, array in the flax layout),
    or None for a tensor flax does not hold; ``family`` is "mtfaa", "dfsmn",
    "fullsubnet", "bsrnn" or "cruse" (CRUSE and CRUSE+DF)."""
    if family == "mtfaa":
        collection = "batch_stats" if key.rsplit(".", 1)[-1] in ("mean", "var") else "params"
        return collection, key.replace(".", "/"), value
    if family == "bsrnn":
        module, rnn, name = key.rpartition(".rnn.")
        if rnn:  # an nn.LSTM leaf
            return "params", f"{module}/{_LSTM_NAMES['rnn.' + name]}".replace(".", "/"), value
        if key.endswith(".weight"):  # Linear [out, in] -> Dense [in, out]
            key, value = key[: -len("weight")] + "kernel", np.ascontiguousarray(value.T)
        return "params", key.replace(".", "/"), value
    if family in ("dfsmn", "fullsubnet"):
        if key.endswith(".weight"):  # Linear [out, in] -> Dense [in, out]
            key, value = key[: -len("weight")] + "kernel", np.ascontiguousarray(value.T)
        return "params", key.replace(".", "/"), value
    *modules, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    if leaf == "weight":  # a kernel, or a norm's 1-D scale
        leaf = "kernel" if value.ndim >= 2 else "scale"
    collection, leaf = {"running_mean": ("batch_stats", "mean"),
                        "running_var": ("batch_stats", "var")}.get(leaf, ("params", leaf))
    path = "/".join(modules + [leaf])
    return collection, path, _unconvert(path, value)


def _family(model) -> str:
    """The mapping of ``model``: "mtfaa", "dfsmn", "fullsubnet", "bsrnn", or
    "cruse" (CRUSE, CRUSE+DF and McCruse, whose leaves map by the CRUSE rules)."""
    from cruse_tpu_torch.models.bsrnn import BSRNN
    from cruse_tpu_torch.models.dfsmn import DfsmnNet
    from cruse_tpu_torch.models.fullsubnet import FullSubNet
    from cruse_tpu_torch.models.mtfaa import MtfaaNet

    families = ((MtfaaNet, "mtfaa"), (DfsmnNet, "dfsmn"), (FullSubNet, "fullsubnet"), (BSRNN, "bsrnn"))
    return next((name for cls, name in families if isinstance(model, cls)), "cruse")


def flax_from_state_dict(model, state_dict: Mapping[str, torch.Tensor] | None = None) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_flax``: the port ``model``'s weights
    (or ``state_dict``, one of that model's, such as a trainer's snapshot)
    -> the cruse_tpu variables tree (``{"params", "batch_stats"}`` of numpy
    arrays) that the bridge maps onto them, so that a rule stated on the flax
    tree (int8 quantization) runs on seeded weights too."""
    state_dict = model.state_dict() if state_dict is None else state_dict
    family = _family(model)
    flat: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        leaf = _flax_leaf(family, key, value.detach().cpu().numpy())
        if leaf is not None:
            collection, path, array = leaf
            flat[collection][path] = array
    return {collection: unflatten_tree(leaves) for collection, leaves in flat.items()}


def flax_param_paths(model) -> Dict[str, tuple]:
    """Each parameter of the port ``model``, by name -> (its flax leaf's
    path in the ``params`` tree, "/"-joined; that leaf's ``ndim``), by the
    mapping of ``flax_from_state_dict``. The train step decides ``freeze``
    and AdamW's decay mask on these, as the JAX package decides them on its
    tree: a pattern matches ``jax_keystr(path)``, and a leaf of two
    dimensions or more is decayed."""
    family = _family(model)
    out = {}
    for name, param in model.named_parameters():
        _, path, array = _flax_leaf(family, name, np.zeros(tuple(param.shape), np.float32))
        out[name] = (path, array.ndim)
    return out


def jax_keystr(path: str) -> str:
    """``jax.tree_util.keystr`` of a "/"-joined path of dict keys:
    ``"a/b"`` -> ``"['a']['b']"``."""
    return "".join(f"['{key}']" for key in path.split("/"))
