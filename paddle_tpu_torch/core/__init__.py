"""Core IR, scope, placement and error types of paddle_tpu_torch."""

from .enforce import EOFException, EnforceError, GraphCaptureError, enforce
from .place import CPUPlace, CUDAPlace, Place, default_place
from .program import (Operator, Parameter, Program, Variable,
                      default_main_program, default_startup_program,
                      program_guard, switch_main_program,
                      switch_startup_program)
from .scope import Scope, global_scope, scope_guard
