"""Config files and log lines of the port, without the JAX package.

``load_config`` reads the repo's TOML configs (``configs/*.toml``) into the
nested dict that ``cruse_tpu.utils.config.load_config`` gives; ``log``
prints the same timestamped line as ``cruse_tpu.utils.logger.log``.
"""
from __future__ import annotations

import datetime
import tomllib
from typing import Any, Dict


def load_config(path: str) -> Dict[str, Any]:
    """A ``.toml`` config file -> nested dict."""
    with open(path, "rb") as f:
        return tomllib.load(f)


def log(*args) -> None:
    """Timestamped line to stdout."""
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    print(f"[{stamp}] " + " ".join(str(a) for a in args), flush=True)
