"""Executor: runs a Program's ops eagerly on one device (counterpart of
paddle_tpu/executor.py's ``Executor.run``).

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

A training program (one with the ``backward`` op of
``append_backward``) runs one forward pass per step: the ops before
``backward`` run with autograd on, over leaf aliases of the parameters
in its ``Params`` slot; ``backward`` is executed as
``torch.autograd.grad(loss, leaves)`` and binds ``<param>@GRAD`` (and,
for a row-sparse table, ``@GRAD@ROWS`` / ``@GRAD@VALUES`` from leaf
aliases of its lookup outputs); the update ops after it run with
autograd off. Fetched tensors are detached copies.

Flat optimizer state (``fuse_optimizer_state``): the parameters of a
group are sliced out of its flat buffer by an ``unpack_flat_params`` op
at the top of the block. Those views are not read from the scope, not
fed (a feed would be overwritten, so it raises) and not written back:
the flat buffer is the state. A parameter's leaf alias is taken where
the forward reads it — at the unpack op's output — so its gradient is
the one the forward pass produced. After a run the scope adopts the
program's views (``Scope.adopt_flat_views``).

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
from .core.program import Deferred, Program, Variable, default_main_program
from .core.scope import Scope, global_scope

_UNPACK = "unpack_flat_params"


def _as_names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f)
            for f in fetch_list or []]


def _value(env, name):
    """``env[name]``, resolving a Deferred op output on first read."""
    v = env[name]
    if isinstance(v, Deferred):
        v = env[name] = v.resolve()
    return v


def run_program_ops(ops, env: Dict[str, torch.Tensor],
                    post_op=None) -> Dict[str, torch.Tensor]:
    """Execute a sequence of Operators over an environment dict.
    ``post_op(op, out) -> out`` may rewrite an op's raw result before it
    lands in the environment (backward's error clips)."""
    for op in ops:
        if op.fn is None:  # structural markers (feed/fetch) are no-ops
            continue
        try:
            args = [_value(env, n) for n in op.input_arg_names]
        except KeyError as e:
            raise EnforceError(
                f"Op {op.type!r} needs variable {e.args[0]!r} which is "
                "neither fed, in scope, nor produced by a prior op") from e
        kwargs = {a: op.attrs[a] for a in op.attrs.get("_fn_attrs", ())}
        out = op.fn(*args, **kwargs)
        if post_op is not None:
            out = post_op(op, out)
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


def _error_clip_post_op(clips):
    """post_op wrapping outputs named in ``clips`` in the error clip."""
    from .backward import clip_error

    def post(op, out):
        names = op.output_arg_names
        if not any(n in clips for n in names):
            return out
        if len(names) == 1 and not isinstance(out, (tuple, list)):
            return clip_error(out, *clips[names[0]])
        return tuple(clip_error(o, *clips[n]) if n in clips else o
                     for n, o in zip(names, out))

    return post if clips else None


def _leaf(v: torch.Tensor) -> torch.Tensor:
    return v.detach().requires_grad_(True)


def _lookup_rows(ids: torch.Tensor) -> torch.Tensor:
    """A lookup's ids as the rows of its sparse gradient: int32, a
    trailing 1 squeezed, flattened (the lookup's own normalization)."""
    idx = ids.to(torch.int32)
    if idx.dim() and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    return idx.reshape(-1)


def run_training_ops(ops, env: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Run a block holding a ``backward`` op with one forward pass: the
    ops before it under autograd over leaf aliases of its dense
    ``Params`` and of its sparse tables' lookup outputs, the op itself
    as ``torch.autograd.grad``, the ops after it with autograd off."""
    at = [i for i, op in enumerate(ops) if op.type == "backward"]
    enforce(len(at) == 1, "a program runs at most one backward op, found %d"
            % len(at))
    i = at[0]
    bw = ops[i]
    sites = bw.attrs.get("_sparse_sites", ())
    tables = list(dict.fromkeys(s[0] for s in sites))
    dense = [n for n in bw.input("Params") if n not in tables]
    leaves: Dict[str, torch.Tensor] = {}
    probes: Dict[str, Optional[torch.Tensor]] = {s[2]: None for s in sites}
    for n in dense:
        if n in env:
            env[n] = leaves[n] = _leaf(env[n])
    want = set(dense)
    clips = _error_clip_post_op(bw.attrs.get("_error_clips", {}))

    def post(op, out):
        # the leaf alias of a parameter the step itself produces (a view
        # of a flat buffer) and of each sparse lookup output
        names = op.output_arg_names
        if any(n in want or n in probes for n in names):
            one = len(names) == 1 and not isinstance(out, (tuple, list))
            vals = [out] if one else list(out)
            for k, n in enumerate(names):
                if n in want and n not in leaves:
                    vals[k] = leaves[n] = _leaf(vals[k])
                elif n in probes:
                    vals[k] = probes[n] = _leaf(vals[k])
            out = vals[0] if one else tuple(vals)
        return clips(op, out) if clips is not None else out

    with torch.enable_grad():
        run_program_ops(ops[:i], env, post_op=post)
    missing = [n for n in dense if n not in leaves]
    enforce(not missing, "backward: parameter(s) %s are neither in scope "
            "nor produced before the backward op" % missing)
    loss = _value(env, bw.attrs["loss"])
    enforce(loss.numel() == 1,
            "loss must be a scalar for append_backward; got shape %s"
            % (tuple(loss.shape),))
    inputs = [leaves[n] for n in dense] + list(probes.values())
    grads = (torch.autograd.grad(loss.reshape(()), inputs,
                                 allow_unused=True) if inputs else ())
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    out_names = bw.output("Grads")
    for name, g in zip(out_names, grads[:len(dense)]):
        env[name] = g
    cot = dict(zip(probes, grads[len(dense):]))
    k = len(dense)
    for table in tables:
        rows, vals = [], []
        for pn, ids_name, out_name, pad in sites:
            if pn != table:
                continue
            r = _lookup_rows(_value(env, ids_name))
            v = cot[out_name].reshape(-1, cot[out_name].shape[-1])
            if pad is not None:
                vocab = env[table].shape[0]
                pad = pad if pad >= 0 else vocab + pad
                # a padded id contributes no table gradient (the lookup
                # zeroes its output after the gather)
                v = torch.where((r == pad)[:, None],
                                torch.zeros((), dtype=v.dtype,
                                            device=v.device), v)
            rows.append(r)
            vals.append(v)
        env[out_names[k]] = torch.cat(rows)
        env[out_names[k + 1]] = torch.cat(vals)
        k += 2
    with torch.no_grad():
        run_program_ops(ops[i + 1:], env)
    return env


def _analyze_program_io(program: Program):
    """(produced, needed, view_produced) name sets of the global block;
    ``view_produced`` are the outputs of ``unpack_flat_params``: views
    sliced from flat buffers in the step, neither external inputs nor
    state to write back."""
    produced, needed, view_produced = set(), set(), set()
    for op in program.global_block().ops:
        produced.update(op.output_arg_names)
        needed.update(op.input_arg_names)
        if op.type == _UNPACK:
            view_produced.update(op.output_arg_names)
    return produced, needed, view_produced


def _reject_view_feeds(feed, view_produced) -> None:
    """A feed of a fused parameter would be overwritten by the unpack op
    at the top of the block: refuse it."""
    bad = sorted(n for n in (feed or ()) if n in view_produced)
    enforce(not bad,
            "Cannot feed fused parameter(s) %s: with fuse_optimizer_state "
            "their values are sliced from the flat storage each step, so "
            "a feed would be ignored. Write them through the scope "
            "(scope.set_var) or disable fuse_optimizer_state." % bad)


def _written_persistables(program: Program) -> Tuple[str, ...]:
    """Names of persistable variables any op writes — everything that
    must flow back to the scope after a run (startup initializations,
    optimizer state, KV pools). The outputs of ``unpack_flat_params``
    are not: the flat buffer carries their state."""
    gb = program.global_block()
    written = []
    for op in gb.ops:
        if op.type == _UNPACK:
            continue
        for n in op.output_arg_names:
            v = gb._find_var_recursive(n)
            if v is not None and v.persistable and n not in written:
                written.append(n)
    return tuple(written)


def fetch_var(name: str, scope: Optional[Scope] = None,
              return_numpy: bool = True):
    """The value of a (persistable) variable straight from a scope — a
    fused parameter's through its flat view: a host numpy copy (bfloat16
    widened to float32), or the tensor itself without ``return_numpy``."""
    enforce(isinstance(name, str), "name must be str")
    scope = scope if scope is not None else global_scope()
    enforce(scope.has_var(name),
            f"Cannot find variable {name!r} in the scope. Typically only "
            "persistable variables live in the scope used by Executor.run")
    val = scope.get(name)
    return _to_numpy(val) if return_numpy else val


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t`` (state tensors may
    be updated in place later)."""
    t = t.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.to("cpu", copy=True).numpy()


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
        an op reads (or that are fetched without being produced), less
        the views an unpack op slices in the step."""
        produced, needed, view_produced = _analyze_program_io(program)
        _reject_view_feeds(feed, view_produced)
        needed |= {n for n in fetch_names if n not in produced}
        state_names = []
        for name in needed:
            if name in feed or name in view_produced:
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
        if any(op.type == "backward" for op in gb.ops):
            run_training_ops(gb.ops, env)
        else:
            with torch.no_grad():
                run_program_ops(gb.ops, env)

        views = getattr(program, "_flat_state_views", None) or {}
        with torch.no_grad():
            written = _written_persistables(program)
            for n in written:
                if n in views and views[n][0] in written:
                    # a startup run: the pack op wrote the whole flat
                    # buffer, so the per-name init values are in it
                    continue
                v = _value(env, n)
                if isinstance(v, torch.Tensor):
                    if v.requires_grad:
                        v = v.detach()
                    v = v.to(self.device)  # the same object when there
                if scope.find_var(n) is not v:
                    scope.set_var(n, v)
            if views:
                scope.adopt_flat_views(views)
            fetches = []
            for n in fetch_names:
                enforce(n in env, "fetch target %r was not computed" % n)
                v = _value(env, n)
                fetches.append(v.detach() if isinstance(v, torch.Tensor)
                               else v)
        if not return_numpy:
            return fetches
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return [_to_numpy(f) for f in fetches]
