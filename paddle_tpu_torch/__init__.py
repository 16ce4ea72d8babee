"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, beside it.

The same Fluid-style program-as-data IR with named scopes and layers;
op fns are torch callables, the Executor runs them eagerly on one
device, and every TPU kernel of paddle_tpu on a ported path is a kernel
written by hand for NVIDIA Hopper (``csrc/``). Entry points run on
``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``.

The slice ported so far serves a causal LM through paged-KV decode::

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import serve_decoding

This package imports neither jax nor paddle_tpu.
"""

from . import layers
from .convert import params_from_numpy
from .core import (CPUPlace, CUDAPlace, EnforceError, Operator, Parameter,
                   Program, Scope, Variable, default_main_program,
                   default_startup_program, global_scope, program_guard,
                   scope_guard, switch_main_program, switch_startup_program)
from .core import unique_name
from .executor import Executor
from .param_attr import ParamAttr
