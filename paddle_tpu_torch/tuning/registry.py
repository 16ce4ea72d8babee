"""Declarative registry of tunable kernels (counterpart of
paddle_tpu/tuning/registry.py).

Each kernel the sweep engine can tune publishes ONE
:class:`TunableKernel` declaration: its parameter space (the launch
knobs the Hopper kernel reads), its validity constraints as
machine-checked predicates (a :class:`Constraint` with the reason a
candidate is refused, not a comment a later sweep can forget), its
defaults (the launch shape the kernel ran with before it was tunable),
how problems bucket into store keys, and how to build a measurable
closure for one candidate. The registry is the single source of truth
shared by:

* the kernels' launchers (``tuning.lookup`` consults defaults and
  constraints at launch, or at capture for a CUDA graph);
* the sweep engine (candidate enumeration = space product filtered by
  constraints — an invalid candidate is never measured);
* the store (``version`` is part of the content address, so a kernel
  revision orphans its stale configs instead of replaying them);
* the executor's graph-key stamp (``op_types``/``matches_op`` say which
  programs a kernel's tuned configs can influence).
"""

from __future__ import annotations

import hashlib
import inspect
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from ..core.enforce import EnforceError, enforce


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (>= lo) — the shape-bucket transform:
    a config tuned at T=2048 serves T in (1025, 2048] instead of
    keying one store entry per ragged length."""
    b = max(int(lo), 1)
    n = max(int(n), 1)
    while b < n:
        b *= 2
    return b


class Constraint:
    """One machine-checked validity predicate over a candidate config.

    ``check(config, problem) -> bool`` (True = valid). ``reason`` is
    the user-facing explanation quoted by ``validate_config`` errors
    and the sweep's skip log."""

    def __init__(self, name: str, reason: str,
                 check: Callable[[dict, Optional[dict]], bool]):
        self.name = name
        self.reason = reason
        self._check = check

    def ok(self, config: dict, problem: Optional[dict] = None) -> bool:
        return bool(self._check(config, problem))

    def __repr__(self):
        return f"Constraint({self.name!r})"


class TunableKernel:
    """Declaration of one tunable kernel.

    space: {param_name: ordered tuple of candidate values}.
    constraints: machine-checked validity predicates; a config that
        violates any is rejected by ``validate_config`` and never
        measured by the sweep.
    defaults: the config used when no tuned entry resolves: the launch
        shape the kernel had before it was tunable. Must itself satisfy
        every constraint.
    version: the kernel-version fingerprint folded into store keys
        (``source_version`` of the kernel's CUDA source and launcher),
        so an edited kernel misses its stale configs.
    op_types / matches_op: which Program-IR op types reach this kernel,
        for the executor's graph-key stamp and the manifest export.
    bucket: problem dict -> canonical shape-bucket dict (store key).
    default_problem: device_kind -> representative problem for CLI
        sweeps without an explicit --problem.
    build_measure(problem, config, dtype, iters, device) -> zero-arg
        callable queueing ``iters`` dependency-chained calls on
        ``device`` (sweep.py times it: CUDA events on the card, the
        host clock on the CPU).
    """

    def __init__(self, name: str, *, space: Dict[str, Sequence],
                 defaults: dict, version: str,
                 op_types: Sequence[str] = (),
                 matches_op: Optional[Callable[[str], bool]] = None,
                 constraints: Sequence[Constraint] = (),
                 bucket: Optional[Callable[[dict], dict]] = None,
                 default_problem: Optional[Callable[[str], dict]] = None,
                 build_measure: Optional[Callable] = None):
        self.name = name
        self.space = {k: tuple(v) for k, v in space.items()}
        self.defaults = dict(defaults)
        self.version = str(version)
        self.op_types = tuple(op_types)
        self._matches_op = matches_op
        self.constraints = tuple(constraints)
        self._bucket = bucket
        self._default_problem = default_problem
        self._build_measure = build_measure
        self.validate_config(self.defaults)  # defaults must be legal

    # -- config validity ----------------------------------------------
    def validate_config(self, config: dict,
                        problem: Optional[dict] = None) -> dict:
        """Normalize + validate one config against the space and every
        constraint; raises EnforceError naming the violated constraint.
        Returns the normalized config (space keys only)."""
        enforce(isinstance(config, dict),
                f"{self.name}: config must be a dict, got {config!r}")
        unknown = sorted(set(config) - set(self.space))
        enforce(not unknown,
                f"{self.name}: unknown tuning parameter(s) {unknown}; "
                f"space is {sorted(self.space)}")
        out = {}
        for k, choices in self.space.items():
            enforce(k in config,
                    f"{self.name}: config missing parameter {k!r}")
            v = config[k]
            enforce(any(v == c for c in choices),
                    f"{self.name}: {k}={v!r} outside the declared "
                    f"space {list(choices)}")
            out[k] = v
        for c in self.constraints:
            enforce(c.ok(out, problem),
                    f"{self.name}: config {out} violates constraint "
                    f"{c.name!r}: {c.reason}")
        return out

    def is_valid(self, config: dict,
                 problem: Optional[dict] = None) -> bool:
        try:
            self.validate_config(config, problem)
            return True
        except EnforceError:
            return False

    def candidates(self, problem: Optional[dict] = None,
                   subset: Optional[Dict[str, Sequence]] = None
                   ) -> List[dict]:
        """The sweep's worklist: the space product (optionally narrowed
        by ``subset``) with every constraint-violating combination
        dropped — invalid candidates are never measured."""
        space = dict(self.space)
        for k, vals in (subset or {}).items():
            enforce(k in space,
                    f"{self.name}: subset names unknown param {k!r}")
            vals = tuple(v for v in vals if any(v == c
                                                for c in space[k]))
            enforce(vals, f"{self.name}: subset for {k!r} has no "
                    "values inside the declared space")
            space[k] = vals
        keys = sorted(space)
        out: List[dict] = [{}]
        for k in keys:
            out = [dict(c, **{k: v}) for c in out for v in space[k]]
        return [c for c in out if self.is_valid(c, problem)]

    # -- keys ----------------------------------------------------------
    def matches_op(self, op_type: str) -> bool:
        if self._matches_op is not None:
            return bool(self._matches_op(op_type))
        return op_type in self.op_types

    def bucket_key(self, problem: Optional[dict]) -> dict:
        if problem is None:
            return {}
        return self._bucket(dict(problem)) if self._bucket \
            else dict(problem)

    def default_problem(self, device_kind: str) -> dict:
        enforce(self._default_problem is not None,
                f"{self.name} declares no default problem — pass an "
                "explicit --problem to sweep it")
        return self._default_problem(device_kind)

    def build_measure(self, problem: dict, config: dict, dtype: str,
                      iters: int, device):
        enforce(self._build_measure is not None,
                f"{self.name} declares no measurement harness")
        return self._build_measure(problem, config, dtype, iters, device)


def source_version(*sources) -> str:
    """A kernel-version fingerprint from its sources: each a file path
    (the ``.cu`` source, ``csrc/hopper.cuh``, the Python launcher), whose
    bytes are hashed, or a Python object, whose source is. Any edit to
    the kernel or its launch orphans the old store entries."""
    h = hashlib.sha256()
    for s in sources:
        if isinstance(s, Path):
            h.update(s.name.encode() + b"\0" + s.read_bytes())
            continue
        try:
            h.update(inspect.getsource(s).encode())
        except (OSError, TypeError):
            h.update(repr(s).encode())
    return h.hexdigest()[:12]


_REGISTRY: Dict[str, TunableKernel] = {}


def register_tunable(kernel: TunableKernel) -> TunableKernel:
    """Idempotent by name: re-registering replaces (module reloads in
    tests must not error)."""
    _REGISTRY[kernel.name] = kernel
    return kernel


def get_tunable(name: str) -> TunableKernel:
    _ensure_builtin()
    enforce(name in _REGISTRY,
            f"unknown tunable kernel {name!r}; registered: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_tunables() -> List[str]:
    _ensure_builtin()
    return sorted(_REGISTRY)


def tunables_for_ops(op_types) -> List[TunableKernel]:
    """Registered kernels any of whose consumer op types appears in
    ``op_types`` — the executor-stamp / manifest-export selector."""
    _ensure_builtin()
    ops = set(op_types)
    out = []
    for name in sorted(_REGISTRY):
        k = _REGISTRY[name]
        if any(k.matches_op(t) for t in ops):
            out.append(k)
    return out


def _ensure_builtin() -> None:
    # the four built-in declarations live in kernels.py; importing it
    # lazily avoids a registry<->ops import cycle at package import
    from . import kernels  # noqa: F401
