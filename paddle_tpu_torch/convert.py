"""Weight carry-over into a paddle_tpu_torch scope.

The two packages draw initial weights from different generators, so a
comparison between them — or a run that serves weights trained with the
JAX package — loads the same arrays by name. The arrays come from
anywhere numpy does (``np.asarray`` of a JAX scope entry, a checkpoint
file, a seeded generator).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core import dtype_utils
from .core.enforce import EnforceError
from .core.place import Place
from .core.program import Program, default_main_program
from .core.scope import Scope


def params_from_numpy(arrays: Dict[str, np.ndarray], scope: Scope,
                      place: Place,
                      program: Optional[Program] = None) -> None:
    """Load ``arrays`` into ``scope`` on ``place`` as the parameters of
    ``program`` (default: the default main program).

    The names must be exactly the program's parameter names, and each
    array must have its parameter's shape and dtype; any mismatch raises
    EnforceError listing every one, and nothing is loaded."""
    program = program or default_main_program()
    params = {p.name: p for p in program.all_parameters()}
    problems = []
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing:
        problems.append("missing parameters: %s" % missing)
    if extra:
        problems.append("not parameters of the program: %s" % extra)
    for name in sorted(set(params) & set(arrays)):
        p, a = params[name], np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            problems.append("%s: shape %s, the program declares %s"
                            % (name, tuple(a.shape), tuple(p.shape)))
        if dtype_utils.name(a.dtype) != dtype_utils.name(p.dtype):
            problems.append("%s: dtype %s, the program declares %s"
                            % (name, a.dtype, dtype_utils.name(p.dtype)))
    if problems:
        raise EnforceError("params_from_numpy: " + "; ".join(problems))
    device = place.torch_device()
    for name in sorted(params):
        t = torch.from_numpy(np.array(arrays[name]))  # a copy the scope owns
        scope.set_var(name, t.to(device=device,
                                 dtype=dtype_utils.to_torch(params[name].dtype)))
