"""paddle_tpu_torch stands alone: importing it, and every module in it,
brings in neither JAX nor any module of paddle_tpu, and no source file
of the port (nor chip_smoke.py) imports them."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "paddle_tpu_torch"

_CHILD = r"""
import importlib, json, pkgutil, sys
import paddle_tpu_torch
names = ["paddle_tpu_torch"]
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module.startswith("jaxlib")
            or module == "paddle_tpu" or module.startswith("paddle_tpu."))


def test_importing_every_module_loads_no_jax_or_paddle_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"paddle_tpu_torch." + ".".join(
        p.relative_to(PACKAGE).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py") if p.name != "__init__.py"}
    assert expected <= set(report["imported"])
    assert [m for m in report["modules"] if _forbidden(m)] == []


_IMPORT = re.compile(
    r"^\s*(?:import\s+(jax|jaxlib|paddle_tpu)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|paddle_tpu)\b(?!_torch)[\w.]*\s+import\b)",
    re.MULTILINE)


def test_no_source_imports_jax_or_paddle_tpu():
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = {str(p.relative_to(REPO)): m.group(0).strip()
                 for p in sources
                 for m in _IMPORT.finditer(p.read_text())}
    assert offenders == {}


def test_import_scan_catches_what_it_should():
    hits = ["import jax", "import jax.numpy as jnp", "from jax import lax",
            "    from paddle_tpu.ops import x", "import paddle_tpu",
            "from paddle_tpu import layers", "import jaxlib"]
    misses = ["import paddle_tpu_torch", "from paddle_tpu_torch import ops",
              "from paddle_tpu_torch.core import flags", "# import jax",
              "import jaxtyping_free_module"]
    for line in hits:
        assert _IMPORT.search(line), line
    for line in misses:
        assert not _IMPORT.search(line), line
