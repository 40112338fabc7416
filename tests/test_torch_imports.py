"""Import guard: every module of cruse_tpu_torch, and chip_smoke.py, imports
with jax, flax and the JAX package cruse_tpu blocked, as on a machine with a
GPU and no JAX.

One subprocess sets ``sys.modules["jax"] = None`` (and flax, jaxlib,
cruse_tpu), so any such import on a module's import chain raises, then
imports each module in turn; every module is its own test case.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "cruse_tpu_torch").rglob("*.py")
) + ["chip_smoke"]

_PROBE = """
import importlib, json, sys
for blocked in ("jax", "jaxlib", "flax", "cruse_tpu"):
    sys.modules[blocked] = None
sys.path.insert(0, sys.argv[1])
results = {}
for name in sys.argv[2:]:
    try:
        importlib.import_module(name)
        results[name] = "ok"
    except Exception as e:
        results[name] = f"{type(e).__name__}: {e}"
print(json.dumps(results))
"""


@pytest.fixture(scope="module")
def import_results():
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT), *MODULES], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(import_results, module):
    assert import_results[module] == "ok", import_results[module]
