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


def test_the_training_slice_modules_are_in_the_scan():
    """The modules the training slices added (the fused optimizer update
    among them) are among those the two checks above import and scan."""
    names = {"paddle_tpu_torch." + ".".join(
        p.relative_to(PACKAGE).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py")}
    assert {"paddle_tpu_torch.backward", "paddle_tpu_torch.optimizer",
            "paddle_tpu_torch.regularizer", "paddle_tpu_torch.clip",
            "paddle_tpu_torch.layers.tensor",
            "paddle_tpu_torch.ops.flash_attention",
            "paddle_tpu_torch.ops.fused_optimizer"} <= names
    for source in ("flash_attention.cu", "fused_optimizer.cu"):
        assert (PACKAGE / "csrc" / source).exists()


def test_the_tuning_slice_modules_are_in_the_scan():
    """The tuning slice's modules (the tuning package, the compile-cache
    store it builds on, the tuning CLI) are among those the two checks
    above import and scan: none imports jax or paddle_tpu, not even the
    jax-free modules whose copies they are."""
    names = {"paddle_tpu_torch." + ".".join(
        p.relative_to(PACKAGE).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py")}
    assert {"paddle_tpu_torch.tuning.api", "paddle_tpu_torch.tuning.kernels",
            "paddle_tpu_torch.tuning.registry",
            "paddle_tpu_torch.tuning.store", "paddle_tpu_torch.tuning.sweep",
            "paddle_tpu_torch.compile_cache.store",
            "paddle_tpu_torch.tools.tuning"} <= names
    for module in ("tuning/store.py", "compile_cache/store.py",
                   "tools/tuning.py"):
        assert not _IMPORT.search((PACKAGE / module).read_text()), module


def test_the_compile_cache_and_observability_modules_are_in_the_scan():
    """The compile-cache and observability slice's modules (the
    fingerprint and runtime, the flight recorder, watchdogs and steplog,
    the timeline and the four CLIs) are among those the two checks above
    import and scan; none imports jax or paddle_tpu, though each is a
    counterpart of a jax-free module of the JAX package."""
    modules = ("compile_cache/fingerprint.py", "compile_cache/runtime.py",
               "obs/record.py", "obs/steplog.py", "obs/watch.py",
               "timeline.py", "profiler.py", "tools/cache.py",
               "tools/trace.py", "tools/postmortem.py", "tools/top.py")
    names = {"paddle_tpu_torch." + ".".join(
        p.relative_to(PACKAGE).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py")}
    assert {"paddle_tpu_torch." + m[:-3].replace("/", ".")
            for m in modules} <= names
    for module in modules:
        assert not _IMPORT.search((PACKAGE / module).read_text()), module
