"""Build and load the package's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` exports a plain C interface. At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/paddle_tpu_torch/`` at the repository root,
named by a hash of the source, of every header in ``csrc/`` (``*.cuh``,
which the sources include) and of the flags, so an edited source or
header never loads a stale library, and loaded with ``ctypes``. Nothing
is built on import.

Every kernel wrapper counts its launches in integer attributes (named
in its ``.counts``) and is registered here, so that a caller that
replays captured launches (``Executor.run_steps``' CUDA graphs) can
count what ran: :func:`launch_counts` and :func:`add_launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

from ..core.enforce import EnforceError

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ptxas resource report (registers, shared memory, spills) per kernel
# source, from the build in this process; empty when the library was
# already built
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise EnforceError(
            "nvcc not found (looked in %s and on PATH): the CUDA kernels "
            "are built from source at first use" % cand)
    return found


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives: named by a
    hash of the source, the headers of ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library exists:
    (library path, process or None, temporary output)."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> Path:
    if proc is None:
        return out
    try:
        log, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise EnforceError("nvcc timed out after 600 s on %s.cu" % name)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise EnforceError("nvcc failed for %s.cu (rc=%d):\n%s"
                           % (name, proc.returncode, log[-6000:]))
    os.replace(tmp, out)
    build_logs[name] = log.strip()
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path. Writes to a temporary name and renames, so a
    concurrent or interrupted build never leaves a torn library."""
    return _finish(name, *_start(name))


def build_all(names) -> Dict[str, Path]:
    """Build several sources at once: one nvcc per source, all started
    together, then waited for."""
    started = {name: _start(name) for name in names}
    built, errors = {}, []
    for name, job in started.items():  # wait for every process
        try:
            built[name] = _finish(name, *job)
        except EnforceError as e:
            errors.append(str(e))
    if errors:
        raise EnforceError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


# every registered kernel wrapper
LAUNCHERS: List = []


def register_launcher(fn, counts=("launches",)):
    """Register a kernel wrapper whose launch counts are the integer
    attributes ``counts`` (set to 0 here) and named in ``fn.counts``."""
    fn.counts = tuple(counts)
    for name in fn.counts:
        setattr(fn, name, 0)
    LAUNCHERS.append(fn)
    return fn


def launch_counts() -> Dict[tuple, int]:
    """{(wrapper, count name): value} of every registered wrapper."""
    return {(fn, name): getattr(fn, name)
            for fn in LAUNCHERS for name in fn.counts}


def add_launches(delta: Dict[tuple, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a difference of two
    :func:`launch_counts`) to the wrappers' counts."""
    for (fn, name), d in delta.items():
        if d:
            setattr(fn, name, getattr(fn, name) + d * times)
