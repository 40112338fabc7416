"""Model zoo of the port. CRUSE, CRUSE+DF, DFSMN, MTFAA, FullSubNet, the
multi-channel McCruse, BSRNN and MetricGAN+'s discriminator are ported."""

from cruse_tpu_torch.models.bsrnn import BSRNN, BsrnnConfig, Discriminator  # noqa: F401
from cruse_tpu_torch.models.cruse import CruseConfig, CruseNet  # noqa: F401
from cruse_tpu_torch.models.cruse_df import CruseDfConfig, CruseDfNet  # noqa: F401
from cruse_tpu_torch.models.dfsmn import DfsmnBlock, DfsmnConfig, DfsmnNet  # noqa: F401
from cruse_tpu_torch.models.deep_filter import DeepFilterHead, deep_filter_apply  # noqa: F401
from cruse_tpu_torch.models.fullsubnet import FullSubNet, FullSubNetConfig  # noqa: F401
from cruse_tpu_torch.models.mc_cruse import McCruseConfig, McCruseNet  # noqa: F401
from cruse_tpu_torch.models.mtfaa import MtfaaConfig, MtfaaNet  # noqa: F401

_NETWORKS = {"CruseConfig": (CruseConfig, CruseNet), "CruseDfConfig": (CruseDfConfig, CruseDfNet),
             "MtfaaConfig": (MtfaaConfig, MtfaaNet), "FullSubNetConfig": (FullSubNetConfig, FullSubNet),
             "McCruseConfig": (McCruseConfig, McCruseNet),
             # the JAX DFSMN and BSRNN have no config dataclass: [model] names the network with its fields
             "DfsmnNet": (DfsmnConfig, DfsmnNet), "BSRNN": (BsrnnConfig, BSRNN)}


def build_from_config(model_section: dict, generator=None):
    """The ``[model]`` table of a config (``path`` + ``args``) -> network.

    The class named by the last component of ``path`` (for example
    ``cruse_tpu.models.cruse.CruseConfig``, or ``cruse_tpu.models.dfsmn.DfsmnNet``
    and ``cruse_tpu.models.bsrnn.BSRNN``, whose args are the network's own fields) selects the port's counterpart;
    the path itself is never imported. A nested table (CRUSE+DF's
    ``[model.args.cruse]``, McCruse's ``[model.args.cruse_args]``) arrives as
    a dict, which the config coerces.
    ``generator`` seeds the weights.
    """
    name = model_section["path"].rsplit(".", 1)[-1]
    if name not in _NETWORKS:
        raise NotImplementedError(f"model config {name!r} is not ported to PyTorch yet "
                                  f"(ported: {', '.join(_NETWORKS)})")
    config_cls, network_cls = _NETWORKS[name]
    args = {k: tuple(v) if isinstance(v, list) else v
            for k, v in (model_section.get("args") or {}).items()}
    return network_cls(config_cls(**args), generator=generator)
