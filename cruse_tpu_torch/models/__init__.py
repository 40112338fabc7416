"""Model zoo of the port. CRUSE is ported; the other families are not yet."""

from cruse_tpu_torch.models.cruse import CruseConfig, CruseNet  # noqa: F401


def build_from_config(model_section: dict, generator=None):
    """The ``[model]`` table of a config (``path`` + ``args``) -> network.

    The class named by the last component of ``path`` (for example
    ``cruse_tpu.models.cruse.CruseConfig``) selects the port's counterpart;
    the path itself is never imported. ``generator`` seeds the weights.
    """
    name = model_section["path"].rsplit(".", 1)[-1]
    if name != "CruseConfig":
        raise NotImplementedError(f"model config {name!r} is not ported to PyTorch yet "
                                  "(ported: CruseConfig)")
    args = {k: tuple(v) if isinstance(v, list) else v
            for k, v in (model_section.get("args") or {}).items()}
    return CruseNet(CruseConfig(**args), generator=generator)
