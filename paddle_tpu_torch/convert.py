"""Weight and state carry-over into a paddle_tpu_torch scope.

The two packages draw initial weights from different generators, so a
comparison between them — or a run that serves weights trained with the
JAX package — loads the same arrays by name. The arrays come from
anywhere numpy does (``np.asarray`` of a JAX scope entry, a checkpoint
file, a seeded generator). ``params_from_numpy`` loads the parameters;
``state_from_numpy`` loads every persistable of a training program —
parameters, optimizer accumulators (moments, velocities, ``inf_norm``,
Ftrl's ``squared``/``linear``, ...) in their storage dtype, beta powers,
batch norm's running statistics, the learning rate and a schedule's
``@LR_DECAY_COUNTER@`` — so a state taken from the JAX package in the
middle of training resumes in the port.

A program built with ``fuse_optimizer_state`` keeps its parameters and
moments in flat buffers. Their per-name values write through the
scope's views into those buffers (which the startup program made, or
which the same call loads by their own names, as the JAX package saves
them), so either package's fused state resumes in the other.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core import dtype_utils
from .core.enforce import EnforceError
from .core.place import Place
from .core.program import Program, Variable, default_main_program
from .core.scope import Scope


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A torch copy of ``a``; numpy's bfloat16 (ml_dtypes, as JAX hands
    it out) goes through float32, which holds every bfloat16 exactly."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _load(arrays: Dict[str, np.ndarray], scope: Scope, place: Place,
          program: Program, declared: Dict[str, Variable], what: str,
          caller: str) -> None:
    """Check ``arrays`` against ``declared`` (names, shapes, dtypes),
    raising EnforceError with every problem and loading nothing; else
    load them into ``scope`` on ``place`` — names that are views of a
    flat buffer last, through the views."""
    problems = []
    missing = sorted(set(declared) - set(arrays))
    extra = sorted(set(arrays) - set(declared))
    if missing:
        problems.append("missing %s: %s" % (what, missing))
    if extra:
        problems.append("not %s of the program: %s" % (what, extra))
    for name in sorted(set(declared) & set(arrays)):
        v, a = declared[name], np.asarray(arrays[name])
        if tuple(a.shape) != tuple(v.shape):
            problems.append("%s: shape %s, the program declares %s"
                            % (name, tuple(a.shape), tuple(v.shape)))
        if dtype_utils.name(a.dtype) != dtype_utils.name(v.dtype):
            problems.append("%s: dtype %s, the program declares %s"
                            % (name, a.dtype, dtype_utils.name(v.dtype)))
    views = getattr(program, "_flat_state_views", None) or {}
    no_flat = sorted({views[n][0] for n in declared if n in views
                      and views[n][0] not in arrays
                      and scope.find_var(views[n][0]) is None})
    if no_flat:
        problems.append("flat storage %s of the fused parameters is neither "
                        "given nor in scope (run the startup program "
                        "first)" % no_flat)
    if problems:
        raise EnforceError(caller + ": " + "; ".join(problems))
    device = place.torch_device()

    def put(name):
        scope.set_var(name, _tensor(np.asarray(arrays[name])).to(
            device=device, dtype=dtype_utils.to_torch(declared[name].dtype)))

    names = sorted(declared)
    for name in names:
        if name not in views:
            put(name)
    if views:
        scope.adopt_flat_views(views)
    for name in names:
        if name in views:
            put(name)


def params_from_numpy(arrays: Dict[str, np.ndarray], scope: Scope,
                      place: Place,
                      program: Optional[Program] = None) -> None:
    """Load ``arrays`` into ``scope`` on ``place`` as the parameters of
    ``program`` (default: the default main program).

    The names must be exactly the program's parameter names, and each
    array must have its parameter's shape and dtype; any mismatch raises
    EnforceError listing every one, and nothing is loaded."""
    program = program or default_main_program()
    _load(arrays, scope, place, program,
          {p.name: p for p in program.all_parameters()}, "parameters",
          "params_from_numpy")


def state_from_numpy(arrays: Dict[str, np.ndarray], scope: Scope,
                     place: Place,
                     program: Optional[Program] = None) -> None:
    """Load ``arrays`` into ``scope`` on ``place`` as every persistable
    variable of ``program`` (default: the default main program):
    parameters and, after ``minimize``, the optimizer's accumulators,
    shared beta powers and learning rate. The same checks as
    :func:`params_from_numpy`, over all persistables."""
    program = program or default_main_program()
    _load(arrays, scope, place, program,
          {v.name: v for v in program.list_vars() if v.persistable},
          "persistables", "state_from_numpy")
