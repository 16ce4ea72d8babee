"""Memory optimization (counterpart of ``memory_optimize`` and
``release_memory`` in paddle_tpu/passes/transforms.py; reference:
transpiler/memory_optimization_transpiler.py:366,385).

Level 0 is ported: it marks the program so that the executor updates
its state in place whatever the ``donate_state_buffers`` flag says
(``Executor._resolve_donation``): the ops write the scope's own
parameters and moments, and ``Executor.run_steps``' captured graph
reads and writes them where they lie, with no copy in or out. Level 1
(recomputing the forward's activations in the backward) and the
liveness report of ``print_log`` raise: the port has neither remat nor
the liveness analysis (ROADMAP Queue A 8).
"""

from __future__ import annotations

from typing import Optional

from ..core.enforce import not_ported
from ..core.program import Program, default_main_program


def memory_optimize(input_program: Optional[Program] = None,
                    skip_opt_set=None, print_log: bool = False,
                    level: int = 0, assume_batch: int = 1) -> None:
    """Level 0: in-place state updates for ``input_program`` (default:
    the default main program), and a new program version. ``level >= 1``
    and ``print_log`` raise NotImplementedError."""
    del skip_opt_set, assume_batch
    if level >= 1:
        raise not_ported("memory_optimize(level=%d): remat of the "
                         "backward's forward slice" % level, "Queue A 8")
    if print_log:
        raise not_ported("memory_optimize(print_log=True): the liveness "
                         "analysis behind its peak-memory report",
                         "Queue A 8")
    program = input_program or default_main_program()
    program._memory_optimize = True
    program._bump()


def release_memory(input_program: Optional[Program] = None,
                   skip_opt_set=None) -> None:
    """The reference inserts delete ops; PyTorch's caching allocator
    frees a tensor when its last reference goes, so there is nothing to
    insert. Kept for the API, as in the JAX package."""
    del input_program, skip_opt_set
    return None
