"""Config files and log lines of the port, without the JAX package.

``load_config`` reads the repo's TOML configs (``configs/*.toml``) into the
nested dict that ``cruse_tpu.utils.config.load_config`` gives; ``log`` is
``utils/logger.py``'s, re-exported here for the modules that import it from
this one.
"""
from __future__ import annotations

import tomllib
from typing import Any, Dict

from cruse_tpu_torch.utils.logger import log  # noqa: F401


def load_config(path: str) -> Dict[str, Any]:
    """A ``.toml`` config file -> nested dict."""
    with open(path, "rb") as f:
        return tomllib.load(f)

