"""High-level Inferencer — companion to Trainer (counterpart of
paddle_tpu/inferencer.py; reference: python/paddle/fluid/inferencer.py:29).

Builds the inference program from ``infer_func`` under its own scope,
loads parameters saved by the Trainer or ``io.save_params``, and serves
``infer(inputs)`` through the Executor on one device (the card unless
``place=CPUPlace()``). ``parallel=True`` (a mesh-sharded executor) is
not ported (ROADMAP Queue A 9, multi-GPU).
"""

from __future__ import annotations

import contextlib

from . import io
from .core import unique_name
from .core.enforce import not_ported
from .core.place import default_place
from .core.program import Program, program_guard
from .core.scope import Scope, scope_guard
from .executor import Executor

__all__ = ["Inferencer"]


class Inferencer:
    """reference: inferencer.py:29 (same constructor contract)."""

    def __init__(self, infer_func, param_path, place=None, parallel=False):
        if parallel:
            raise not_ported("Inferencer(parallel=True) (the SPMD "
                             "ParallelExecutor)", "Queue A 9, multi-GPU")
        self.param_path = param_path
        self.scope = Scope()
        self.parallel = False
        self.place = place if place is not None else default_place()

        self.inference_program = Program()
        # own throwaway startup program: infer_func's parameter-init ops
        # must NOT leak into the caller's default startup program
        self._startup_program = Program()
        with program_guard(self.inference_program, self._startup_program):
            with unique_name.guard():
                self.predict_var = infer_func()

        self.exe = Executor(self.place)
        with self._prog_and_scope_guard():
            io.load_params(self.exe, param_path, scope=self.scope)

        self.inference_program = self.inference_program.clone(for_test=True)

    def infer(self, inputs, return_numpy=True):
        """Run inference on a feed dict {input_name: ndarray}
        (reference: inferencer.py:80)."""
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        with scope_guard(self.scope):
            return self.exe.run(self.inference_program, feed=inputs,
                                fetch_list=[self.predict_var],
                                scope=self.scope, return_numpy=return_numpy)

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with program_guard(main_program=self.inference_program):
            with scope_guard(self.scope):
                yield
