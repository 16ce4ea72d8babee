"""Weight and state carry-over into a paddle_tpu_torch scope.

The two packages draw initial weights from different generators, so a
comparison between them — or a run that serves weights trained with the
JAX package — loads the same arrays by name. The arrays come from
anywhere numpy does (``np.asarray`` of a JAX scope entry, a checkpoint
file, a seeded generator). ``params_from_numpy`` loads the parameters;
``state_from_numpy`` loads every persistable of a training program —
parameters, optimizer moments, beta powers, the learning rate — so a
state taken from the JAX package in the middle of training resumes in
the port.
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


def _load(arrays: Dict[str, np.ndarray], scope: Scope, place: Place,
          declared: Dict[str, Variable], what: str, caller: str) -> None:
    """Check ``arrays`` against ``declared`` (names, shapes, dtypes),
    raising EnforceError with every problem and loading nothing; else
    load them into ``scope`` on ``place``."""
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
    if problems:
        raise EnforceError(caller + ": " + "; ".join(problems))
    device = place.torch_device()
    for name in sorted(declared):
        t = torch.from_numpy(np.array(arrays[name]))  # a copy the scope owns
        scope.set_var(name, t.to(
            device=device, dtype=dtype_utils.to_torch(declared[name].dtype)))


def params_from_numpy(arrays: Dict[str, np.ndarray], scope: Scope,
                      place: Place,
                      program: Optional[Program] = None) -> None:
    """Load ``arrays`` into ``scope`` on ``place`` as the parameters of
    ``program`` (default: the default main program).

    The names must be exactly the program's parameter names, and each
    array must have its parameter's shape and dtype; any mismatch raises
    EnforceError listing every one, and nothing is loaded."""
    program = program or default_main_program()
    _load(arrays, scope, place,
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
    _load(arrays, scope, place,
          {v.name: v for v in program.list_vars() if v.persistable},
          "persistables", "state_from_numpy")
