"""Print the public API surface as stable one-line signatures
(counterpart of paddle_tpu/tools/print_signatures.py).

The reference CI freezes the public Python API and fails any change to
a signature that does not update the spec file. Same contract here:
``python -m paddle_tpu_torch.tools.print_signatures`` emits one sorted
line per public callable of the modules of the JAX package's list,
named ``paddle_tpu_torch.*``; ``tests/test_torch_api_freeze.py`` diffs
the output against the checked-in ``tests/torch_api_spec.txt``.
Modules the port does not have yet are skipped (``v2`` waits for a
later slice).
"""

from __future__ import annotations

import inspect

MODULES = [
    "paddle_tpu_torch",
    "paddle_tpu_torch.layers",
    "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.regularizer",
    "paddle_tpu_torch.clip",
    "paddle_tpu_torch.metrics",
    "paddle_tpu_torch.io",
    "paddle_tpu_torch.amp",
    "paddle_tpu_torch.analysis",
    "paddle_tpu_torch.compile_cache",
    "paddle_tpu_torch.executor",
    "paddle_tpu_torch.trainer",
    "paddle_tpu_torch.checkpoint",
    "paddle_tpu_torch.ckpt",
    "paddle_tpu_torch.inference",
    "paddle_tpu_torch.serving",
    "paddle_tpu_torch.decoding",
    "paddle_tpu_torch.fleet",
    "paddle_tpu_torch.sharding",
    "paddle_tpu_torch.passes",
    "paddle_tpu_torch.ops",
    "paddle_tpu_torch.tuning",
    "paddle_tpu_torch.resilience",
    "paddle_tpu_torch.obs",
    "paddle_tpu_torch.parallel",
    "paddle_tpu_torch.reader",
    "paddle_tpu_torch.reader.decorator",
    "paddle_tpu_torch.v2.layer",
    "paddle_tpu_torch.v2.networks",
]


def _sig(obj) -> str:
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    # normalize typing noise so the spec is stable across Python versions
    return s.replace("'", "")


def iter_public(module):
    import importlib

    m = importlib.import_module(module)
    names = getattr(m, "__all__", None) or [
        n for n in dir(m) if not n.startswith("_")]
    for n in sorted(set(names)):
        obj = getattr(m, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if inspect.isclass(obj):
            yield f"{module}.{n}{_sig(obj.__init__)}"
            continue
        if callable(obj):
            yield f"{module}.{n}{_sig(obj)}"


def _ported(module: str) -> bool:
    import importlib.util

    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:
        return False  # a parent package is not ported yet


def collect() -> list:
    lines = []
    for mod in MODULES:
        if _ported(mod):
            lines.extend(iter_public(mod))
    return sorted(set(lines))


def main():
    for line in collect():
        print(line)


if __name__ == "__main__":
    main()
