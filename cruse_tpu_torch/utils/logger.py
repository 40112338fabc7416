"""Console and file logger of the port (counterpart of
``cruse_tpu/utils/logger.py``).

``log`` prints a timestamped line to stdout and, after ``init(path)``, appends
it to that run's log file. Every module of the port logs through this one
function (``utils/config.py`` re-exports it). The JAX logger's optional Slack
push is not ported: the port sends nothing over the network.
"""
from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional, TextIO

_file: Optional[TextIO] = None


def init(save_path: str | None = None) -> None:
    """Open a per-run log file (appending); ``None`` logs to stdout only."""
    global _file
    close()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)) or ".", exist_ok=True)
        _file = open(save_path, "a")


def close() -> None:
    global _file
    if _file is not None:
        _file.close()
        _file = None


atexit.register(close)


def log(*args) -> None:
    """Timestamped line to stdout and, when open, the log file."""
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    line = f"[{stamp}] " + " ".join(str(a) for a in args)
    print(line, flush=True)
    if _file is not None:
        _file.write(line + "\n")
        _file.flush()


def get_logger():
    return log
