"""Memory optimization (counterpart of ``memory_optimize`` and
``release_memory`` in paddle_tpu/passes/transforms.py; reference:
transpiler/memory_optimization_transpiler.py:366,385).

Every level marks the program so that the executor updates its state
in place whatever the ``donate_state_buffers`` flag says
(``Executor._resolve_donation``): the ops write the scope's own
parameters and moments, and ``Executor.run_steps``' captured graph
reads and writes them where they lie, with no copy in or out. Level
>= 1 also recomputes the backward's forward slice (the all-or-nothing
remat flag, set through ``passes.schedule.apply_remat_policy(
segments="all")``; the executor runs the slice under
``torch.utils.checkpoint``). ``print_log`` prints the static peak-memory
report of ``analysis.analyze_liveness``.
"""

from __future__ import annotations

from typing import Optional

from ..core.program import Program, default_main_program


def memory_optimize(input_program: Optional[Program] = None,
                    skip_opt_set=None, print_log: bool = False,
                    level: int = 0, assume_batch: int = 1) -> None:
    """Donation for ``input_program`` (default: the default main
    program) at every level; ``level >= 1`` adds remat of the backward's
    forward slice (recompute activations).

    ``print_log=True`` prints the static peak-memory report from the
    liveness engine (``analysis.analyze_liveness``, reference: the
    ControlFlowGraph liveness pass at
    memory_optimization_transpiler.py:35): peak resident bytes and the
    op where they occur, persistable-state total, and the largest
    tensors with their lifetime spans. Dynamic (-1) dims are counted as
    ``assume_batch`` extents — pass the training batch size for a
    real-traffic estimate."""
    del skip_opt_set
    program = input_program or default_main_program()
    program._memory_optimize = True
    if level >= 1:
        # the all-or-nothing remat flag, through the remat_policy
        # pass's "all" mode; stamp=False: the flag itself is what the
        # executor keys on
        from .schedule import apply_remat_policy

        apply_remat_policy(program, segments="all", stamp=False)
    else:
        program._memory_optimize_remat = False
    program._bump()
    if print_log:
        from ..analysis import analyze_liveness

        report = analyze_liveness(program, assume_batch=assume_batch)
        print("memory_optimize: buffer donation on; remat %s"
              % ("on" if level >= 1 else "off"))
        print(report.render())


def release_memory(input_program: Optional[Program] = None,
                   skip_opt_set=None) -> None:
    """The reference inserts delete ops; PyTorch's caching allocator
    frees a tensor when its last reference goes, so there is nothing to
    insert. For the static picture of what is resident when, use
    ``memory_optimize(print_log=True)`` or
    ``analysis.analyze_liveness``. Kept for the API, as in the JAX
    package."""
    del input_program, skip_opt_set
    return None
