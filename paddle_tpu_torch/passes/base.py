"""The declarative pass API (counterpart of paddle_tpu/passes/base.py,
the same names and contracts): one base class and one registry for
every Program-IR rewrite.

Reference lineage: the C++ IR pass infrastructure (paddle/fluid/
framework/ir/pass.h — Pass::Apply over ir::Graph with REGISTER_PASS)
and the inference analysis manager (inference/analysis/analyzer.h).

A :class:`Pass` declares:

  * ``name``      — the registry key and the label every structured
    failure carries;
  * ``reads``     — op families the rewrite inspects (informational);
  * ``writes``    — op types the rewrite may INTRODUCE (the checked
    manager diffs the op-type set around each pass, passes/manager.py;
    ``None`` skips the check);
  * ``stamp_attr``— set by self-stamping passes;
  * ``fingerprint()`` — a stable content digest of the pass's
    parameters.

``apply(program, scope=None)`` performs the rewrite: return the input
program (in-place rewrites) or a fresh clone; passes that touch
parameter VALUES set ``mutates_scope`` so callers know a scope is
required.
"""

from __future__ import annotations

import hashlib
import json
from typing import Callable, Dict, FrozenSet, List, Optional, Type

from ..core.enforce import enforce
from ..core.program import Program


def _stable_value(v, depth=0) -> object:
    """JSON-able, PROCESS-STABLE canonical form of one constructor
    attr for the default fingerprint: no ``repr`` of bare objects
    (the default repr embeds a memory address, which would make two
    processes of the identical pipeline compose different stamps and
    silently miss every cross-process warm cache start)."""
    if depth > 4:
        return "<depth>"
    if isinstance(v, (str, int, float, bool, type(None))):
        return [type(v).__name__, v]
    if isinstance(v, (bytes, bytearray)):
        return ["bytes", hashlib.sha256(bytes(v)).hexdigest()[:16]]
    if isinstance(v, (list, tuple)):
        return ["seq", [_stable_value(x, depth + 1) for x in v]]
    if isinstance(v, (set, frozenset)):
        return ["set", sorted(
            json.dumps(_stable_value(x, depth + 1), default=str)
            for x in v)]
    if isinstance(v, dict):
        return ["map", [[str(k), _stable_value(x, depth + 1)]
                        for k, x in sorted(v.items(), key=lambda kv:
                                           str(kv[0]))]]
    try:
        import numpy as _np
        if isinstance(v, _np.ndarray):
            return ["ndarray", hashlib.sha256(
                _np.ascontiguousarray(v).tobytes()).hexdigest()[:16]]
    except ImportError:  # pragma: no cover
        pass
    for m in ("digest", "fingerprint"):
        f = getattr(v, m, None)
        if callable(f):
            try:
                return [type(v).__qualname__, str(f())]
            except Exception:
                pass
    cls = f"{type(v).__module__}.{type(v).__qualname__}"
    try:
        state = vars(v)
    except TypeError:
        return ["obj", cls]
    return ["obj", cls,
            [[k, _stable_value(x, depth + 1)]
             for k, x in sorted(state.items())
             if not k.startswith("_")]]


class Pass:
    """Base pass (reference: framework/ir/pass.h Pass; MLIR Pass).

    Subclasses implement :meth:`apply` and declare the class attrs
    documented in the module docstring. The legacy name
    ``ProgramPass`` (core/passes.py) aliases this class.
    """

    name: str = "pass"
    #: op families the rewrite inspects (informational; CLI `explain`)
    reads: Optional[FrozenSet[str]] = None
    #: op types the rewrite may introduce; None disables the manager's
    #: undeclared-write check (legacy/user passes)
    writes: Optional[FrozenSet[str]] = None
    #: program attr a self-stamping pass sets (e.g. "_amp_stamp");
    #: None means the manager composes fingerprint() into _passes_stamp
    stamp_attr: Optional[str] = None
    mutates_scope: bool = False
    #: the pass only makes sense on TRAINING programs (it reads the
    #: backward op / optimizer state); CLI pipelines over loaded
    #: inference artifacts refuse it with a usage error up front
    requires_backward: bool = False

    def apply(self, program: Program, scope=None) -> Program:
        raise NotImplementedError

    def fingerprint(self) -> str:
        """Stable short digest of the pass's parameters. The default
        hashes the class identity + public constructor state through
        :func:`_stable_value` (process-stable: no id()-bearing reprs,
        sets sorted, objects keyed by class + public attrs or their
        own ``digest()``); passes with parameters that matter for
        compiled output should still override with an explicit,
        canonical digest."""
        state = {k: _stable_value(v) for k, v in sorted(vars(self)
                                                        .items())
                 if not k.startswith("_")}
        text = json.dumps([type(self).__module__,
                           type(self).__qualname__, self.name, state],
                          sort_keys=True, default=str)
        return hashlib.sha256(text.encode()).hexdigest()[:16]

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class PassError(RuntimeError):
    """A structured pass-pipeline failure: carries the failing pass's
    name, the defect kind, and (for diagnostic failures) the offending
    :class:`~paddle_tpu.analysis.Diagnostic` records — so tooling can
    report *which pass* broke *which op* without string-parsing."""

    #: defect kinds
    UNDECLARED_WRITE = "undeclared-write"
    DIAGNOSTICS = "introduced-diagnostics"
    STAMP_OMISSION = "stamp-omission"
    BAD_FINGERPRINT = "bad-fingerprint"
    BAD_RESULT = "bad-result"

    def __init__(self, pass_name: str, kind: str, message: str,
                 diagnostics: Optional[list] = None,
                 op_types: Optional[list] = None):
        self.pass_name = pass_name
        self.kind = kind
        self.diagnostics = list(diagnostics or [])
        self.op_types = list(op_types or [])
        super().__init__(f"pass {pass_name!r} [{kind}]: {message}")


_REGISTRY: Dict[str, Type[Pass]] = {}


def register_pass(name: str) -> Callable:
    """Class decorator registering a pass under ``name`` (reference:
    REGISTER_PASS in framework/ir/pass.h)."""

    def deco(cls):
        enforce(issubclass(cls, Pass),
                "register_pass expects a Pass subclass")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def pass_class(name: str) -> Type[Pass]:
    """The registered class for ``name`` (un-instantiated — for CLI
    ``explain`` and callers that construct with arguments)."""
    enforce(name in _REGISTRY,
            "unknown pass %r; registered: %s" % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]


def get_pass(name: str) -> Pass:
    """Instantiate the registered pass with its defaults. Passes whose
    constructors require arguments (sharding needs a mesh, ptq_int8
    needs a calibration) cannot be built this way — construct them via
    the Python API instead."""
    cls = pass_class(name)
    try:
        return cls()
    except TypeError as e:
        raise PassError(name, PassError.BAD_RESULT,
                        "pass requires construction arguments (%s) — "
                        "instantiate it via the Python API" % e) from e


def list_passes() -> List[str]:
    return sorted(_REGISTRY)


def build_pipeline(names, keep=()) -> List[Pass]:
    """Instantiate registered passes for a name-only pipeline (the two
    CLIs): keep-aware passes (dce, fusion) receive ``keep`` as their
    fetch-name barriers — exactly what ``save_inference_model``'s
    export pipeline passes — and a pass whose constructor requires
    other arguments (ptq_int8 needs a calibration) raises a structured
    :class:`PassError` instead of a bare TypeError."""
    built = []
    for n in names:
        cls = pass_class(n)
        try:
            built.append(cls(keep=tuple(keep)))
            continue
        except TypeError:
            pass
        try:
            built.append(cls())
        except TypeError as e:
            raise PassError(
                n, PassError.BAD_RESULT,
                "pass requires construction arguments (%s) — "
                "instantiate it via the Python API" % e) from e
    return built
