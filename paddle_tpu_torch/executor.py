"""Executor: runs a Program's ops eagerly on one device (counterpart of
the inference part of paddle_tpu/executor.py).

Where the JAX package composes the op list into one jitted XLA
computation, this executor calls each op's torch fn in order over an
environment of tensors, as the reference's interpreter did
(framework/executor.cc). Semantics kept from the JAX package:

  * feed/fetch of arbitrary program variables by name;
  * persistable variables live in a :class:`Scope` across runs; those
    an op writes flow back to the scope after the run (an op that
    updates a scope tensor in place returns the same object, and
    writing it back copies nothing);
  * a fresh local environment per run for temporaries.

Not ported yet: the compile cache, ``run_steps``, sharding, AMP stamps,
passes, loaders and host offload.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import dtype_utils
from .core.enforce import EnforceError, enforce
from .core.place import Place, default_place
from .core.program import Program, Variable, default_main_program
from .core.scope import Scope, global_scope


def _as_names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f)
            for f in fetch_list or []]


def run_program_ops(ops, env: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Execute a sequence of Operators over an environment dict."""
    for op in ops:
        if op.fn is None:  # structural markers (feed/fetch) are no-ops
            continue
        try:
            args = [env[n] for n in op.input_arg_names]
        except KeyError as e:
            raise EnforceError(
                f"Op {op.type!r} needs variable {e.args[0]!r} which is "
                "neither fed, in scope, nor produced by a prior op") from e
        kwargs = {a: op.attrs[a] for a in op.attrs.get("_fn_attrs", ())}
        out = op.fn(*args, **kwargs)
        out_names = op.output_arg_names
        if len(out_names) == 1 and not isinstance(out, (tuple, list)):
            env[out_names[0]] = out
        else:
            enforce(len(out_names) == len(out),
                    "op %s produced %s outputs, declared %s"
                    % (op.type, len(out), len(out_names)))
            for n, v in zip(out_names, out):
                env[n] = v
    return env


def _written_persistables(program: Program) -> Tuple[str, ...]:
    """Names of persistable variables any op writes — everything that
    must flow back to the scope after a run (startup initializations,
    KV pools)."""
    gb = program.global_block()
    written = []
    for op in gb.ops:
        for n in op.output_arg_names:
            v = gb._find_var_recursive(n)
            if v is not None and v.persistable and n not in written:
                written.append(n)
    return tuple(written)


class Executor:
    """Runs programs on ``place`` (default ``CUDAPlace(0)``, which raises
    on a host without a card)."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()

    def _resolve_state_names(self, program: Program, feed: Dict,
                             fetch_names: Tuple[str, ...],
                             scope: Scope) -> Tuple[str, ...]:
        """External inputs that come from the scope: vars not fed that
        an op reads (or that are fetched without being produced)."""
        produced, needed = set(), set()
        for op in program.global_block().ops:
            produced.update(op.output_arg_names)
            needed.update(op.input_arg_names)
        needed |= {n for n in fetch_names if n not in produced}
        state_names = []
        for name in needed:
            if name in feed:
                continue
            if scope.has_var(name):
                state_names.append(name)
            elif name not in produced:
                if name in fetch_names:
                    raise EnforceError(
                        f"Fetch target {name!r} is not produced by the "
                        "program, not fed, and not present in scope")
                raise EnforceError(
                    f"Variable {name!r} is required by program but is "
                    "neither fed nor present in scope (did you run the "
                    "startup program?)")
        return tuple(sorted(state_names))

    def _feed_tensor(self, var: Optional[Variable], val) -> torch.Tensor:
        t = val if isinstance(val, torch.Tensor) \
            else torch.as_tensor(np.asarray(val))
        dtype = (dtype_utils.to_torch(var.dtype)
                 if var is not None and var.dtype is not None else t.dtype)
        return t.to(device=self.device, dtype=dtype)

    def run(self,
            program: Optional[Program] = None,
            feed: Optional[Dict[str, np.ndarray]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        """One run: ``feed`` maps names to arrays, ``fetch_list`` names
        (or Variables) to return. With ``return_numpy`` the fetches come
        back as host numpy arrays (bfloat16 widened to float32) after the
        device finished; otherwise as device tensors."""
        program = program or default_main_program()
        feed = dict(feed or {})
        scope = scope if scope is not None else global_scope()
        fetch_names = tuple(_as_names(fetch_list))
        gb = program.global_block()

        state_names = self._resolve_state_names(program, feed, fetch_names,
                                                scope)
        env = {n: scope.get(n) for n in state_names}
        for name, val in feed.items():
            env[name] = self._feed_tensor(gb._find_var_recursive(name), val)
        with torch.no_grad():
            run_program_ops(gb.ops, env)

        for n in _written_persistables(program):
            v = env[n]
            if isinstance(v, torch.Tensor):
                v = v.to(self.device)  # the same object when already there
            if scope.find_var(n) is not v:
                scope.set_var(n, v)

        fetches = []
        for n in fetch_names:
            enforce(n in env, "fetch target %r was not computed" % n)
            fetches.append(env[n])
        if not return_numpy:
            return fetches
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return [(f.float() if f.dtype == torch.bfloat16 else f)
                .detach().cpu().numpy() for f in fetches]
