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
  * a fresh local environment per run for temporaries;
  * dead ops skipped (:func:`live_ops`, the counterpart of XLA's
    dead-code elimination): an op whose outputs nothing later reads, no
    fetch names and none is persistable does not run.

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

``run_steps`` (counterpart of the JAX package's ``run_steps`` and its
``_CompiledScan``): N steps of one program in one call, exactly N
``run`` calls' worth of state updates, with fetches stacked on a leading
``steps`` axis. On the CPU it is a loop of ``run``. On a card the
JAX package's one scanned XLA dispatch becomes a captured CUDA graph
(:class:`_CapturedSteps`): one step replayed N times, or, with
``unroll``, N steps captured as one graph and replayed once. The graph
reads and writes fixed addresses: the scope's state tensors (or, with
donation off, private copies), a stacked feed buffer, and a stacked
fetch buffer, with a step counter on the card selecting each step's
feed row and fetch row. ``run(feed=loader)`` drives a
``reader.DataLoader``, ``chunk`` batches a ``run_steps`` call.

``run_graph`` (the counterpart of the JAX package's per-shape compiled
``run``, which the decode engine's buckets rely on): one run of a
program per call, on a card as a captured CUDA graph per feed shape
(:class:`_CapturedRun`) — the feeds packed into one pinned host buffer
and copied to the card in one non-blocking copy, the fetches packed
into one buffer on the card and copied back in one copy, the scope's
tensors at fixed addresses as ``run_steps`` keeps them. On the CPU it
is ``run``.

Donation (``_resolve_donation``: ``memory_optimize`` or the
``donate_state_buffers`` flag): on, ops update state in place and the
graph works on the scope's own tensors; off, every run works on copies
of the state it writes, so a tensor obtained from the scope before a
run keeps its values.

Rematerialization (``_resolve_remat``: ``memory_optimize(level>=1)``
or the ``remat_policy`` pass's segments): the loss's forward slice, or
each chosen segment of it, runs under ``torch.utils.checkpoint``, so
the backward pass recomputes its activations instead of keeping them
(:func:`_run_forward_remat`); the policy is part of ``run_steps``'
graph key.

``export_program_ops`` traces one run of a program's ops (a training
step through ``torch.autograd.grad`` included) with ``make_fx`` on fake
tensors and exports it with ``torch.export``: the artifact behind
``io.save_inference_model`` and ``io.save_trainable_program``.
``capture_graph`` is the one capture routine of the executor's graphs
and of the artifacts' (``inference.NativePredictor``,
``io.TrainableProgram.run_steps``).

The ``check_program`` flag runs ``analysis.check_program`` over each
new program version before ``run``/``run_steps`` runs it, and raises
on an error diagnostic. The ``check_nan_inf`` flag checks, after each
``run`` (``run_steps``: after the replay, over the stacked fetches), the
fetched values and the state the run wrote for NaN/Inf with one
read-only reduction on the device and one bool read
(``amp.device_all_finite``); only when it fails does a per-tensor pass
run, to name the variable.

Compile cache (the ``compile_cache_dir`` flag): the JAX package
persists its compiled steps and scans. Here nothing the executor makes
outlives the process: ``run`` interprets the ops, and a captured CUDA
graph holds this process's device addresses, so it cannot be
serialized. With the flag set each new capture of ``run_graph`` and
``run_steps`` is fingerprinted (kinds ``"graph"`` and ``"steps"``) into
``compile_cache.recent_fingerprints()``, the program stamps a
flight-recorder bundle carries; :attr:`Executor.num_compiled` counts
captured graphs either way. What persists is ``torch.export`` of
exported programs (``io.py`` through ``compile_cache.runtime``).

Host offload (the ``host_offload`` pass, ``program._host_offload_state``,
counterpart of the JAX package's ``_stage_offload``/``_take_staged``):
after each ``run`` the offloaded state (optimizer moments; under AMP the
f32 masters) is copied to pinned host memory and the scope holds those
host tensors, so between steps the card holds none of it. The next
``run`` of the program starts the copy back on a copy stream through
``reader.prefetch.overlap_iter`` and binds each tensor as a
:class:`~paddle_tpu_torch.core.program.Deferred`: the first op that
reads it (the update, after the forward and backward ops) makes the
compute stream wait for the copy there, so the copy runs behind the
step's first ops. A write to the scope between steps (a checkpoint
restore, ``set_var``) makes the staged copy stale: the step then copies
the scope's value itself. Values round-trip with no cast, so losses are
bit-identical. ``run_steps`` on a card keeps the state on the card (its
captured graph reads and writes fixed addresses); on the CPU each of
its steps is a ``run``.

Sharding (``sharding.shard_program``, counterpart of the JAX
package's mesh-aware dispatch): a program carrying a plan whose mesh
is live (this process one rank of a ``torch.distributed`` world of the
mesh's size) runs through ``sharding/spmd.py`` — its rank's block of
the batch and of the sharded state, explicit collectives; fetches are
whole on every rank. A mesh of several ranks outside such a world
raises, nothing runs single-device in its place. ``run_steps`` on the
CPU is a loop of ``run``; on a card a sharded step is not captured
(over gloo a CUDA graph cannot hold the collectives: it raises
:class:`GraphCaptureError` before any capture).

Not ported yet: program readers.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import dtype_utils, flags
from .core.enforce import (EnforceError, EOFException, GraphCaptureError,
                           enforce)
from .core.place import Place, default_place
from .core.program import Deferred, Program, Variable, default_main_program
from .core.scope import Scope, global_scope
from .ops import _cuda
from .profiler import RecordEvent

_UNPACK = "unpack_flat_params"

# set while this thread captures a CUDA graph: an op that fails then is
# named in the error (a host sync or another call capture refuses)
_CAPTURE = threading.local()


def _capture_error(what: str, e: Exception) -> Exception:
    if getattr(_CAPTURE, "active", False):
        return EnforceError("%s failed while a CUDA graph was captured "
                            "(a host sync, or a call capture refuses, "
                            "breaks capture): %s: %s"
                            % (what, type(e).__name__, e))
    return e


def check_capturable(program: Program) -> None:
    """Raise :class:`GraphCaptureError` naming the first op of any block
    that reads a device value on the host each run (the ``_host_sync``
    attr of ``while``, ``conditional_block`` and ``print``; a sub-block's
    ops run inside its parent's composite op): a CUDA graph would replay
    the trip count or branch of its capture, so ``run_steps`` and
    ``run_graph`` refuse such a program on a card before capturing
    anything."""
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            if op.attrs.get("_host_sync"):
                raise GraphCaptureError(
                    "op %r (op %d of block %d, outputs %s) reads a device "
                    "value on the host each run and cannot be replayed as "
                    "a captured CUDA graph; run the program step by step "
                    "with Executor.run"
                    % (op.type, i, block.idx, op.output_arg_names))


def _check_shard_capturable(program: Program) -> None:
    """Raise :class:`GraphCaptureError` before any capture when
    ``program`` runs sharded on this rank (``sharding/spmd.py``): over
    gloo a CUDA graph cannot capture the step's collectives."""
    plan = _live_plan(program)
    if plan is not None:
        from .sharding import spmd

        spmd.check_capturable(plan.mesh, "Executor.run")


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
                    post_op=None, device=None) -> Dict[str, torch.Tensor]:
    """Execute a sequence of Operators over an environment dict.
    ``post_op(op, out) -> out`` may rewrite an op's raw result before it
    lands in the environment (backward's error clips). An op with no
    inputs (a constant) makes its tensors on ``device`` when given."""
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
        try:
            if device is not None and not args:
                with torch.device(device):
                    out = op.fn(**kwargs)
            else:
                out = op.fn(*args, **kwargs)
        except Exception as e:
            err = _capture_error("op %r (outputs %s)"
                                 % (op.type, op.output_arg_names), e)
            if err is e:
                raise
            raise err from e
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


def _resolve_remat(program: Program):
    """The remat policy of a training run: a frozenset of segment ids
    when the ``remat_policy`` pass solved one, else the all-or-nothing
    ``memory_optimize(level>=1)`` bool, or the policy a caller published
    (``core.trace_ctx.remat_scope``: ``BuildStrategy.use_remat``). The
    one home of the rule."""
    from .core.trace_ctx import remat_enabled

    policy = getattr(program, "_remat_policy", None)
    if policy:
        return frozenset(policy)
    return bool(getattr(program, "_memory_optimize_remat", False)) \
        or remat_enabled()


def _sharding_config(program: Program) -> Dict[str, str]:
    """Compile-cache config fragment for a sharded program
    (``sharding/plan.py`` sets the stamp: mesh shape + rule digest), as
    the JAX package's: key ABSENT for unsharded programs, so their
    fingerprints are untouched and a changed mesh or rule set never
    resolves a stale entry."""
    stamp = getattr(program, "_sharding_stamp", None)
    return {"sharding": stamp} if stamp else {}


def _live_plan(program: Program):
    """The ShardingPlan of ``program`` when this process runs as one
    rank of its mesh; None for an unsharded program. A plan over several
    ranks outside such a world raises."""
    plan = getattr(program, "_sharding_plan", None)
    if plan is None:
        return None
    from .sharding import spmd

    spmd.check_not_live(plan.mesh)
    return plan if plan.mesh.live else None


def _plan_resolver(program: Program, plan):
    """The spmd Resolver of a plan: its mesh's data-like axes and
    ``plan.spec_for`` over the program's declared shapes."""
    from .sharding import spmd

    gb = program.global_block()
    cache = program.__dict__.setdefault("_spmd_resolver", {})
    key = (id(plan), program._version)
    hit = cache.get(key)
    if hit is None:
        cache.clear()
        hit = cache[key] = spmd.Resolver(
            plan.mesh, plan.mesh.data_axes(),
            lambda n: plan.spec_for(gb._find_var_recursive(n), n))
    return hit


def _run_forward_remat(fwd, env, post, device, policy, loss_name,
                       reads_later, keep, outside) -> None:
    """The ops before ``backward`` with the forward slice of
    ``loss_name`` recomputed in the backward pass.

    ``policy`` ``True`` puts the whole slice under checkpoints;
    a frozenset puts each op whose ``_remat_segment`` is in it under its
    segment's checkpoint. Consecutive ops of one segment run as one
    ``torch.utils.checkpoint.checkpoint`` call, which takes the values
    the run reads before defining them as explicit inputs and returns
    only what a later op, the backward op, a fetch (``keep``) or the
    scope (a persistable) reads — the rest is dropped, and the backward
    pass recomputes it. Ops off the slice, and the ops in ``outside``
    (those whose outputs become autograd leaves: parameters the step
    produces, sparse lookup outputs), run as they do without remat, so
    no leaf is made inside a recomputed region. An op off the slice
    between two ops of one segment splits its checkpoint in two.

    ``use_reentrant=False`` is what lets ``torch.autograd.grad`` take
    the gradient through a checkpoint; ``preserve_rng_state=False``
    because the port's randomness is keyed on counters that the
    recomputed ops read again (the dropout counter a region read crosses
    in as an input, never advanced in place before the backward pass),
    and stashing the CUDA RNG state is not allowed in a captured
    graph. Early stop is off: torch stops a recompute by raising an
    exception through the op being recomputed, whose traceback would
    keep the region's tensors in a reference cycle until the cyclic
    collector runs; without it every op of a region runs once more, in
    the backward pass."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    from .backward import slice_ops

    in_slice = {id(op) for op in slice_ops(fwd, loss_name)}

    def region(op):
        if id(op) not in in_slice or id(op) in outside:
            return None
        if policy is True:
            return True
        sid = op.attrs.get("_remat_segment")
        return sid if sid in policy else None

    # names read at or after each position (later ops of the block too)
    after = [set() for _ in range(len(fwd) + 1)]
    after[-1] = set(reads_later) | set(keep) | {loss_name}
    for k in range(len(fwd) - 1, -1, -1):
        after[k] = after[k + 1] | set(fwd[k].input_arg_names)
    block = fwd[0].block if fwd else None

    def persistable(n):
        v = block._find_var_recursive(n)
        return v is not None and v.persistable

    k = 0
    while k < len(fwd):
        rid = region(fwd[k])
        if rid is None:
            run_program_ops(fwd[k:k + 1], env, post_op=post, device=device)
            k += 1
            continue
        end = k
        while end < len(fwd) and region(fwd[end]) == rid:
            end += 1
        group = fwd[k:end]
        defined, ins = set(), []
        for op in group:
            for n in op.input_arg_names:
                if n not in defined and n not in ins:
                    ins.append(n)
            defined.update(op.output_arg_names)
        outs = [n for n in dict.fromkeys(
            o for op in group for o in op.output_arg_names)
            if n in after[end] or persistable(n)]
        args = [n for n in ins if isinstance(env.get(n), torch.Tensor)]
        other = {n: env[n] for n in ins if n in env and n not in args}
        # names the group's environment drops after each op: those no
        # later op of the group reads and the group does not return
        last = {}
        for j, op in enumerate(group):
            for n in op.input_arg_names + op.output_arg_names:
                last[n] = j
        dead = [[] for _ in group]
        for n, j in last.items():
            if n not in outs:
                dead[j].append(n)

        def run_group(*vals, _ops=group, _args=args, _other=other,
                      _outs=outs, _dead=dead):
            # dropping values as the run goes keeps only what the
            # checkpoint saves alive, in the forward pass and in the
            # recompute alike
            e = dict(_other)
            e.update(zip(_args, vals))
            for op, names in zip(_ops, _dead):
                run_program_ops([op], e, post_op=post, device=device)
                for n in names:
                    e.pop(n, None)
            return tuple(e[n] for n in _outs)

        with set_checkpoint_early_stop(False):
            vals = checkpoint(run_group, *[env[n] for n in args],
                              use_reentrant=False, preserve_rng_state=False)
        env.update(zip(outs, vals))
        k = end


def run_training_ops(ops, env: Dict[str, torch.Tensor], device=None,
                     remat=False, keep: Sequence[str] = (), update=None,
                     forward_post=None) -> Dict[str, torch.Tensor]:
    """Run a block holding a ``backward`` op with one forward pass: the
    ops before it under autograd over leaf aliases of its dense
    ``Params`` and of its sparse tables' lookup outputs, the op itself
    as ``torch.autograd.grad``, the ops after it with autograd off.
    ``remat`` (:func:`_resolve_remat`) recomputes the loss's forward
    slice, or the chosen segments of it, in the backward pass
    (:func:`_run_forward_remat`); ``keep`` names the values the caller
    reads afterwards besides the scope's (its fetches). ``update(bw,
    ops_after, env)``, when given, runs the ops after the backward op
    in its place (a sharded run reduces the gradients first);
    ``forward_post(op, out) -> out`` rewrites each forward op's result
    (a sharded run sums a reduction over the ranks' batch blocks)."""
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
            env[n] = leaves[n] = _leaf(_value(env, n))
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
        if forward_post is not None:
            out = forward_post(op, out)
        return clips(op, out) if clips is not None else out

    with torch.enable_grad():
        if remat:
            outside = {id(op) for op in ops[:i] if any(
                n in want or n in probes for n in op.output_arg_names)}
            later = {n for op in ops[i:] for n in op.input_arg_names}
            _run_forward_remat(ops[:i], env, post, device, remat,
                               bw.attrs["loss"], later, keep, outside)
        else:
            run_program_ops(ops[:i], env, post_op=post, device=device)
    missing = [n for n in dense if n not in leaves]
    enforce(not missing, "backward: parameter(s) %s are neither in scope "
            "nor produced before the backward op" % missing)
    loss = _value(env, bw.attrs["loss"])
    enforce(loss.numel() == 1,
            "loss must be a scalar for append_backward; got shape %s"
            % (tuple(loss.shape),))
    inputs = [leaves[n] for n in dense] + list(probes.values())
    try:
        grads = (torch.autograd.grad(loss.reshape(()), inputs,
                                     allow_unused=True) if inputs else ())
    except Exception as e:
        err = _capture_error("the backward op", e)
        if err is e:
            raise
        raise err from e
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
        if update is not None:
            update(bw, ops[i + 1:], env)
        else:
            run_program_ops(ops[i + 1:], env, device=device)
    return env


def live_ops(program: Program, fetch_names: Sequence[str]) -> List:
    """The global block's ops less the dead ones, the counterpart of
    XLA's dead-code elimination in the JAX package's compiled run: an op
    is skipped when nothing after it reads its outputs, no fetch names
    them and none of them is persistable (counters, batch-norm
    statistics, optimizer state and parameters are always written). The
    ``backward`` op always runs, and reads the loss. Cached on the
    program by version and fetch names."""
    key = (program._version, tuple(fetch_names))
    cache = program.__dict__.get("_live_ops_cache", {})
    hit = cache.get(key)
    if hit is not None:
        return hit
    # keep the current version's entries only
    cache = program._live_ops_cache = {k: v for k, v in cache.items()
                                       if k[0] == program._version}
    gb = program.global_block()

    def persistable(n):
        v = gb._find_var_recursive(n)
        return v is not None and v.persistable

    live, kept = set(fetch_names), []
    for op in reversed(gb.ops):
        outs = op.output_arg_names
        if op.type == "backward" or not outs or any(
                n in live or persistable(n) for n in outs):
            kept.append(op)
            live.update(op.input_arg_names)
            if op.type == "backward":
                live.add(op.attrs["loss"])
    kept.reverse()
    cache[key] = kept
    return kept


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


def export_program_ops(ops, feed_names: Sequence[str],
                       state_names: Sequence[str],
                       example: Sequence[torch.Tensor],
                       fetch_names: Sequence[str],
                       written: Sequence[str] = ()):
    """A ``torch.export`` program of one run of ``ops``, the artifact
    behind ``io.save_inference_model`` and
    ``io.save_trainable_program``: ``(exported, written_out)``.

    The graph's inputs are the feeds, then the state, in the order of
    the names; ``example`` holds a tensor of each, on the device the
    trace runs for. A block holding a ``backward`` op runs through
    :func:`run_training_ops` (its ``torch.autograd.grad`` included),
    any other under ``no_grad`` through :func:`run_program_ops`, as
    :meth:`Executor.run` runs them. The graph returns the fetches, then
    each ``written`` name whose value an op made as a new tensor
    (``written_out`` lists them); state an op updates in place (a fused
    update's flat buffers, a table's rows) is updated in place in the
    tensor the caller passes.

    The run is traced first with ``make_fx`` on fake tensors and the
    traced graph exported: ``torch.export`` cannot take the autograd
    call itself. The kernels are custom ops, so the graph names them
    and their kernels follow the device the graph runs on; tensors an
    op makes from nothing carry the trace's device, which
    ``torch.export.passes.move_to_device_pass`` rewrites at load."""
    from torch.fx.experimental.proxy_tensor import make_fx

    names = list(feed_names) + list(state_names)
    enforce(len(example) == len(names),
            "export: %d example tensors for %d inputs"
            % (len(example), len(names)))
    device = example[0].device if example else torch.device("cpu")
    training = any(op.type == "backward" for op in ops)
    written_out: List[str] = []

    def run(*args):
        env = dict(zip(names, args))
        if training:
            run_training_ops(ops, env, device, keep=fetch_names)
        else:
            with torch.no_grad():
                run_program_ops(ops, env, device=device)
        with torch.no_grad():
            # fetches are copies: a graph output may not alias an input
            outs = [_value(env, n).detach().clone() for n in fetch_names]
            written_out.clear()
            for n in written:
                v = _value(env, n)
                if any(v is a for a in args):
                    continue  # updated in place, or passed through
                written_out.append(n)
                outs.append(v.detach())
        return tuple(outs)

    traced = make_fx(run, tracing_mode="fake")(*example)
    exported = torch.export.export(traced, tuple(example))
    # the example tensors (the parameters among them) stay out of the
    # artifact: the caller passes them at every run
    exported._example_inputs = None
    return exported, list(written_out)


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


def _assert_all_finite(named_vals) -> None:
    """The ``check_nan_inf`` sweep: one reduction over every float value
    on the device and one bool read; only on failure a per-tensor pass,
    to name the first variable (in the order given: the fetches, then
    the written state by name, as the JAX package's state dict comes
    out of its jitted step) holding NaN/Inf."""
    from .amp.scaler import device_all_finite

    floats = [(n, v) for n, v in named_vals
              if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not floats:
        return
    if bool(device_all_finite([v for _, v in floats])):
        return
    for n, v in floats:
        if not bool(torch.isfinite(v).all()):
            raise EnforceError(f"NaN/Inf detected in variable {n!r}")
    raise EnforceError("NaN/Inf detected")  # unreachable safeguard


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t`` (state tensors may
    be updated in place later)."""
    t = t.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.to("cpu", copy=True).numpy()




def classify_scan_feeds(gb, feed, feed_list, steps):
    """Normalize ``run_steps``' feeds: ``(feed, steps, stacked_names)``.

    ``feed_list`` — a list of per-step dicts — stacks per name (numpy
    arrays on the host, tensors where they lie). ``feed`` + ``steps``
    classifies PER NAME: an array whose rank is one above the variable's
    declared shape carries a leading ``steps`` axis and is sliced per
    step; rank-matching arrays are step-invariant. Undeclared or
    shapeless variables default to step-invariant — pass per-step values
    for those through ``feed_list``."""
    if feed_list is not None:
        enforce(len(feed_list) > 0, "feed_list must be non-empty")
        enforce(steps is None or steps == len(feed_list),
                "steps disagrees with len(feed_list)")
        steps = len(feed_list)
        names = sorted(feed_list[0])
        for f in feed_list:
            enforce(sorted(f) == names,
                    "every feed dict must bind the same variables")
        feed = {}
        for n in names:
            vals = [f[n] for f in feed_list]
            tensors = [v for v in vals if isinstance(v, torch.Tensor)]
            if tensors:
                feed[n] = torch.stack([
                    v if isinstance(v, torch.Tensor) else torch.as_tensor(
                        np.asarray(v), device=tensors[0].device)
                    for v in vals])
            else:
                feed[n] = np.stack([np.asarray(v) for v in vals])
        return feed, steps, tuple(names)

    feed = dict(feed or {})
    enforce(steps is not None and steps >= 1,
            "steps is required when feed_list is not given")
    stacked = []
    for n, v in feed.items():
        var = gb._find_var_recursive(n)
        shape = tuple(v.shape) if isinstance(v, torch.Tensor) \
            else np.shape(v)
        if var is not None and var.shape is not None and \
                len(shape) == len(var.shape) + 1:
            enforce(shape[0] == steps,
                    f"feed {n!r} looks stacked (rank {len(shape)} = "
                    f"declared rank {len(var.shape)} + 1) but its "
                    f"leading axis {shape[0]} != steps {steps}")
            stacked.append(n)
    return feed, steps, tuple(sorted(stacked))


def _tuning_key(program: Program) -> tuple:
    """The part of a captured graph's key that tuned kernel configs
    make (the JAX package's compile-cache ``tuning`` stamp): a graph
    bakes the launch configs it was captured with, so a sweep or a seed
    later in the process must miss the graphs captured before it.
    Empty when nothing tuned can reach the program's kernels, so the
    keys are what they were without tuning."""
    from .tuning import program_stamp

    stamp = program_stamp(program)
    return (("tuning", stamp),) if stamp else ()


def _note_capture(program: Program, kind: str, feed_avals: Dict,
                  state_names, scope: Scope, fetch_names, device,
                  config: dict) -> None:
    """With the ``compile_cache_dir`` flag set, fingerprint a new
    capture into ``compile_cache.recent_fingerprints()`` (the program
    stamps of flight-recorder bundles). A CUDA graph holds this
    process's device addresses, so nothing is persisted; with the flag
    unset this is one flag read."""
    if not flags.get_flag("compile_cache_dir"):
        return
    from .compile_cache import runtime as cc_runtime

    state_avals = {}
    for n in state_names:
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor):
            state_avals[n] = (tuple(v.shape), v.dtype)
    cc_runtime.note_capture(program, feed_avals, state_avals, fetch_names,
                            kind, device, config)


def _resolve_donation(program: Program) -> bool:
    """In-place state updates: on unless the program or the
    ``donate_state_buffers`` flag turns them off; ``memory_optimize``
    forces them on for its program. The one home of the rule."""
    explicit = getattr(program, "_memory_optimize", None)
    if explicit is not None:
        return bool(explicit)
    return bool(flags.get_flag("donate_state_buffers"))


def _same_memory(a, b) -> bool:
    """Whether two tensors are the same elements of the same memory."""
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype
            and a.device == b.device)


class FetchHandle:
    """A fetch of ``Executor.run(..., return_numpy="async")``: the
    tensor, without waiting for the card. A loop that holds handles
    queues step N+1 while step N runs, and waits only where it reads a
    value: ``numpy()``, ``np.asarray(handle)`` or ``float(handle)``
    (a ``fetch_sync`` span), which caches the host copy."""

    def __init__(self, name: str, value, event=None):
        self.name = name
        self._value = value
        self._event = event  # recorded after the run on a card
        self._np: Optional[np.ndarray] = None

    @property
    def value(self):
        """The fetched tensor; no wait."""
        return self._value

    def is_ready(self) -> bool:
        """Whether the card finished the work behind this fetch; never
        blocks."""
        return self._np is not None or self._event is None \
            or self._event.query()

    def block_until_ready(self) -> "FetchHandle":
        """Wait for the card (no host copy); returns self."""
        if self._event is not None:
            with RecordEvent("fetch_sync"):
                self._event.synchronize()
        return self

    def numpy(self) -> np.ndarray:
        """The host copy (bfloat16 widened to float32), made once."""
        if self._np is None:
            with RecordEvent("fetch_sync"):
                self._np = _to_numpy(self._value)
        return self._np

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        return float(self.numpy())

    def __repr__(self):
        state = "ready" if self.is_ready() else "pending"
        return f"FetchHandle({self.name!r}, {state})"


class _CapturedSteps:
    """``steps`` steps of one program over one scope on a card, as a
    captured CUDA graph (the counterpart of the JAX package's
    ``_CompiledScan``, whose one XLA program scans the steps in one
    dispatch).

    The graph reads and writes fixed addresses:
      * ``state``: a buffer per persistable the step reads or writes —
        the scope's own tensor with donation on (the graph updates it in
        place), a private copy with donation off. An op that writes its
        result elsewhere (the beta powers, the fused update's advanced
        scalars) has it copied into the buffer inside the graph.
      * ``feeds``: the call's feeds, stacked ones with their leading
        ``steps`` axis; each step reads its row at ``idx``, a step
        counter on the card that the graph advances.
      * ``out``: each fetch stacked on a leading ``steps`` axis, the
        step's row written at ``idx``.
    Each call copies its feeds in, and the scope's state where the scope
    holds another tensor than the buffer (after a ``run`` that wrote it
    out of place, ``scope.set_var`` or ``params_from_numpy``), so a
    replay never reads stale memory; with donation off it always copies
    the state in and hands the scope copies after the call.

    ``unroll=False`` captures one step and replays it ``steps`` times;
    ``unroll=True`` captures ``steps`` straight-line steps as one graph
    and replays it once. Capture runs nothing and wants an eager step
    before it (lazy initialisations: cuBLAS workspaces, the autograd
    engine's threads, cuDNN's choice of conv algorithms — and, with
    ``cudnn.benchmark``, its search), so the first call runs one step
    eagerly on the capture stream: with ``unroll=False`` it is the
    call's first step, and ``steps - 1`` replays follow; with
    ``unroll=True`` it runs on
    copies of the written state, which it leaves as they were. Either
    way the state advances by exactly ``steps`` steps a call.

    The kernel wrappers' launch counts rise during capture, when nothing
    runs: they are put back, and each replay adds what one replay
    launches (``_cuda.add_launches``).
    """

    def __init__(self, program: Program, scope: Scope,
                 fetch_names: Tuple[str, ...], state_names: Tuple[str, ...],
                 feed_vals: Dict, stacked_names: Tuple[str, ...],
                 steps: int, unroll: bool, donate: bool,
                 device: torch.device, remat=False):
        self.program, self.scope = program, scope
        self.ops = live_ops(program, fetch_names)
        self.training = any(op.type == "backward" for op in self.ops)
        self.remat = remat
        self.fetch_names = fetch_names
        self.steps, self.unroll, self.donate = steps, unroll, donate
        self.device = device
        self.views = getattr(program, "_flat_state_views", None) or {}
        self.caller = "run_steps"
        written = _written_persistables(program)
        # a startup program's per-name writes of a flat buffer's
        # parameters land in the packed buffer (as in Executor.run)
        written = tuple(n for n in written if not (
            n in self.views and self.views[n][0] in written))
        self.rw = tuple(n for n in state_names if n in written)
        self.ro = tuple(n for n in state_names if n not in written)
        self.wo = tuple(n for n in written if n not in state_names)
        self.stacked = frozenset(stacked_names)
        self.feeds = {n: torch.empty_like(v) for n, v in feed_vals.items()}
        self.state: Dict[str, torch.Tensor] = {}
        self.out: Optional[Dict[str, torch.Tensor]] = None
        self.idx = torch.zeros(1, dtype=torch.int64, device=device)
        self.graph = None
        # the graph's memory pool (None: a private one), and the side
        # stream the first call's eager step and the capture run on (the
        # executor's one capture stream: the caching allocator keeps a
        # stream's freed blocks for that stream, so a stream per capture
        # would hold every eager step's temporaries apart)
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.per_replay: Dict[tuple, int] = {}
        self.capture_s: Optional[float] = None

    def _alloc_out(self, fetches) -> None:
        """The fetch buffers the graph writes, each stacked on a leading
        ``steps`` axis, allocated outside the graph's pool."""
        self.out = {n: torch.empty((self.steps,) + tuple(v.shape),
                                   dtype=v.dtype, device=self.device)
                    for n, v in zip(self.fetch_names, fetches)}

    def _step(self, bufs: Dict[str, torch.Tensor], out) -> List:
        """One step over ``bufs`` (name -> state tensor): the feeds (a
        stacked feed's row at ``idx``), the program's ops, each written
        state copied into its buffer where an op wrote it elsewhere (a
        write-only state's first value becomes its entry), the fetches
        written to row ``idx`` of ``out`` (when given); then ``idx``
        advances. Returns the fetch values."""
        env = dict(bufs)
        for n, buf in self.feeds.items():
            env[n] = buf.index_select(0, self.idx)[0] \
                if n in self.stacked else buf
        if self.training:
            run_training_ops(self.ops, env, self.device, remat=self.remat,
                             keep=self.fetch_names)
        else:
            with torch.no_grad():
                run_program_ops(self.ops, env, device=self.device)
        with torch.no_grad():
            for n in self.rw + self.wo:
                v = _value(env, n).detach()
                b = bufs.get(n)
                if b is None:
                    bufs[n] = v
                elif not _same_memory(v, b):
                    b.copy_(v)
            fetches = [_value(env, n).detach() for n in self.fetch_names]
            if out is not None:
                for n, v in zip(self.fetch_names, fetches):
                    out[n].index_copy_(0, self.idx, v.unsqueeze(0))
            self.idx.add_(1)
        return fetches

    def _state_in(self, scope: Scope) -> None:
        for n in self.rw + self.ro:
            cur = scope.find_var(n)
            buf = self.state.get(n)
            if buf is None:
                enforce(isinstance(cur, torch.Tensor),
                        "%s: state %r is not a tensor" % (self.caller, n))
                buf = cur.detach()
                if buf.device != self.device:
                    buf = buf.to(self.device)
                elif n in self.rw and not self.donate:
                    buf = buf.clone()
                self.state[n] = buf
            elif not (self.donate and _same_memory(cur, buf)):
                enforce(isinstance(cur, torch.Tensor)
                        and tuple(cur.shape) == tuple(buf.shape)
                        and cur.dtype == buf.dtype,
                        "%s: state %r is %s in the scope; its "
                        "captured graph holds %s %s" % (
                            self.caller, n, (tuple(cur.shape), cur.dtype)
                            if isinstance(cur, torch.Tensor) else cur,
                            tuple(buf.shape), buf.dtype))
                buf.copy_(cur)

    def _state_out(self, scope: Scope) -> None:
        for n in self.rw + self.wo:
            buf = self.state[n]
            val = buf if self.donate else buf.clone()
            if not _same_memory(scope.find_var(n), val):
                scope.set_var(n, val)
        if self.views:
            scope.adopt_flat_views(self.views)

    def _capture(self) -> int:
        """The first call's eager step and capture; returns the replays
        the call still owes."""
        import time

        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = self.stream or torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            bufs = dict(self.state)
            if self.unroll:
                bufs.update({n: bufs[n].clone() for n in self.rw})
            fetches = self._step(bufs, None)
        main.wait_stream(side)
        # allocated on the side stream, read on the main one below
        for t in fetches + [bufs[n] for n in self.wo]:
            t.record_stream(main)
        self._alloc_out(fetches)
        for n in self.wo:
            self.state[n] = bufs[n].clone()
        if self.unroll:
            self.idx.zero_()
        else:
            for n, v in zip(self.fetch_names, fetches):
                self.out[n][0].copy_(v)
        del bufs, fetches

        def steps():
            for _ in range(self.steps if self.unroll else 1):
                self._step(self.state, self.out)

        self.graph, self.per_replay = capture_graph(
            steps, self.device, side, self.pool, "%s%s" % (
                self.caller, "" if self.unroll else " (the eager first "
                "step had already updated the state)"))
        self.capture_s = time.perf_counter() - t0
        return 1 if self.unroll else self.steps - 1

    def __call__(self, feed_vals: Dict) -> List:
        """Copy the feeds and the scope's state in, run the steps
        (capturing on the first call), write the state back; the stacked
        fetches (new tensors, queued on the current stream)."""
        self.idx.zero_()
        for n, v in feed_vals.items():
            self.feeds[n].copy_(v)
        self._state_in(self.scope)
        replays = self._capture() if self.graph is None else (
            1 if self.unroll else self.steps)
        for _ in range(replays):
            self.graph.replay()
        _cuda.add_launches(self.per_replay, replays)
        fetches = [self.out[n].clone() for n in self.fetch_names]
        self._state_out(self.scope)
        return fetches


def capture_graph(fn, device: torch.device, stream: torch.cuda.Stream,
                  pool=None, caller: str = "capture"):
    """Capture ``fn()`` as a CUDA graph on ``stream`` (into the memory
    pool ``pool``, None for a private one): ``(graph, per_replay)``.
    ``fn`` must read and write fixed addresses, and something like it
    must have run eagerly before (lazy initializations cannot be
    captured). Capture runs nothing: the kernel wrappers' launch counts
    that rose during it are put back, and ``per_replay`` is what each
    replay launches, for ``_cuda.add_launches``. A failed capture
    raises EnforceError naming ``caller``."""
    before = _cuda.launch_counts()
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(device)
    stream.wait_stream(main)
    _CAPTURE.active = True
    try:
        with torch.cuda.stream(stream):
            # thread_local: a loader's worker may pin and copy the next
            # batches while this thread captures
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was already invalidated
                raise
            graph.capture_end()
    except Exception as e:
        raise EnforceError("%s: the CUDA graph capture failed: %s"
                           % (caller, e)) from e
    finally:
        _CAPTURE.active = False
        delta = {k: v - before.get(k, 0)
                 for k, v in _cuda.launch_counts().items()}
        _cuda.add_launches(delta, -1)
    main.wait_stream(stream)
    return graph, delta


def _packed(specs, device, pin: bool):
    """One uint8 buffer holding a tensor per ``(shape, dtype)`` spec,
    each at a 16-byte aligned offset: (buffer, views)."""
    offsets, total = [], 0
    for shape, dt in specs:
        offsets.append(total)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        total += -(-nbytes // 16) * 16
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=device,
                      pin_memory=pin)
    views = [buf[off:off + int(np.prod(shape, dtype=np.int64))
                 * dt.itemsize].view(dt).view(tuple(shape))
             for off, (shape, dt) in zip(offsets, specs)]
    return buf, views


class _CapturedRun(_CapturedSteps):
    """One run of a program over one scope on a card as a captured CUDA
    graph, for one set of feed shapes (``Executor.run_graph``; the
    decode engine's buckets).

    The fixed addresses of :class:`_CapturedSteps`, with ``steps == 1``
    and transport for a call per step:
      * the feeds are views of one uint8 buffer on the card, filled from
        its twin in pinned host memory by one non-blocking copy;
      * the fetches are views of one uint8 buffer on the card, which the
        graph writes and one copy brings to pinned host memory;
      * the scope's state tensors are the graph's (donation on; with it
        off, copies), replaced scope tensors copied in before a replay.
    The first call runs the program eagerly (its result is the call's),
    then captures; later calls replay. ``pool`` is the graph memory pool
    to capture into (a handle several graphs share, or None for a
    private one). Launch counters count each replay as
    :class:`_CapturedSteps` does.
    """

    def __init__(self, program: Program, scope: Scope,
                 fetch_names: Tuple[str, ...], state_names: Tuple[str, ...],
                 feed_specs: Dict[str, tuple], donate: bool,
                 device: torch.device, pool=None):
        names = tuple(feed_specs)
        specs = [feed_specs[n] for n in names]
        self.host_in, host_views = _packed(specs, "cpu", pin=True)
        self.dev_in, dev_views = _packed(specs, device, pin=False)
        self.host_feeds = dict(zip(names, host_views))
        super().__init__(program, scope, fetch_names, state_names, {}, (),
                         1, False, donate, device)
        self.caller = "run_graph"
        self.feeds = dict(zip(names, dev_views))
        self.pool = pool
        self.host_out: Optional[torch.Tensor] = None
        self.dev_out: Optional[torch.Tensor] = None
        self.host_fetches: List[torch.Tensor] = []

    def _alloc_out(self, fetches) -> None:
        specs = [((1,) + tuple(v.shape), v.dtype) for v in fetches]
        self.dev_out, outs = _packed(specs, self.device, pin=False)
        self.host_out, self.host_fetches = _packed(specs, "cpu", pin=True)
        self.out = dict(zip(self.fetch_names, outs))

    def launch(self, feed: Dict) -> None:
        """Queue one run without waiting for the card: copy the feeds in
        (host arrays, converted to the declared dtypes), replay
        (capturing on the first call), queue the fetches' copy to host
        memory."""
        for n, v in feed.items():
            src = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(v))
            self.host_feeds[n].copy_(src)
        self.idx.zero_()
        self.dev_in.copy_(self.host_in, non_blocking=True)
        self._state_in(self.scope)
        if self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            _cuda.add_launches(self.per_replay, 1)
        self.host_out.copy_(self.dev_out, non_blocking=True)
        self._state_out(self.scope)

    def fetch(self) -> List[np.ndarray]:
        """Wait for the launched run (the call's one host sync) and
        return its fetches as host numpy arrays (bfloat16 widened to
        float32)."""
        with RecordEvent("fetch_sync"):
            torch.cuda.current_stream(self.device).synchronize()
        return [_to_numpy(t[0]) for t in self.host_fetches]

    def __call__(self, feed: Dict) -> List[np.ndarray]:
        self.launch(feed)
        return self.fetch()


class Executor:
    """Runs programs on ``place`` (default ``CUDAPlace(0)``, which raises
    on a host without a card)."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        # captured graphs: run_steps' by program, version, scope,
        # donation, remat policy, feed/fetch/state names, feed shapes,
        # steps and unroll;
        # run_graph's by program, version, scope, donation, feed names and
        # shapes, fetch names
        self._cache: Dict[tuple, _CapturedSteps] = {}
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # program -> the version check_program last passed
        self._verified = weakref.WeakKeyDictionary()
        # host_offload staging: one pending copy back per (program,
        # offloaded-name group), and the copier whose stream carries it
        self._offload_stage: Dict[tuple, dict] = {}
        self._offload_copier = None

    # -- host_offload staging (passes/schedule.py) ---------------------
    @staticmethod
    def _offload_names(program: Program,
                       state_names) -> Tuple[str, ...]:
        off = getattr(program, "_host_offload_state", None)
        if not off:
            return ()
        wanted = set(state_names)
        return tuple(n for n in off if n in wanted)

    def _take_staged(self, tok: int, names: Tuple[str, ...],
                     scope: Scope) -> Dict[str, Deferred]:
        """Start the copy back of this program's offloaded state and
        return each tensor as a Deferred that makes the reading stream
        wait for its copy, IF the host tensors the copy reads are still
        the scope's entries — any external write (checkpoint restore,
        manual set_var) between steps makes it stale, and the step then
        copies the scope's own values (an empty dict)."""
        entry = self._offload_stage.pop((tok, names), None)
        if entry is None:
            return {}
        if any(scope.find_var(n) is not entry["src"][n] for n in names):
            entry["cancel"].set()
            return {}
        entry["go"].set()
        try:
            with RecordEvent("offload_h2d"):
                staged, event = next(entry["gen"])
        finally:
            entry["cancel"].set()
        copier = self._offload_copier

        def bind(t):
            def ready():
                copier.ready([t], event)
                return t
            return Deferred(ready)

        return {n: bind(staged[n]) for n in names}

    def _stage_offload(self, tok: int, scope: Scope,
                       names: Tuple[str, ...]) -> None:
        """Epilogue for offloaded state: copy it to pinned host memory
        and keep only the host tensors in the scope between steps (the
        device tensors go back to the allocator: the liveness report's
        persistable-device-bytes drop is this), then start an
        ``overlap_iter`` worker that queues the copy back on the
        copier's stream once the next step of this program begins."""
        from .reader.prefetch import DeviceCopier, overlap_iter

        prev = self._offload_stage.pop((tok, names), None)
        if prev is not None:
            prev["cancel"].set()
        vals = {n: scope.find_var(n) for n in names}
        if any(not isinstance(v, torch.Tensor) for v in vals.values()):
            return
        src = {}
        with torch.no_grad(), RecordEvent("offload_d2h"):
            for n, v in vals.items():
                if v.device.type == "cuda":
                    host = torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                    host.copy_(v, non_blocking=True)
                else:
                    host = v.detach().clone()
                src[n] = host
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        for n, host in src.items():
            scope.set_var(n, host)
        if self._offload_copier is None:
            self._offload_copier = DeviceCopier(self.place)
        copier = self._offload_copier
        go, cancel = threading.Event(), threading.Event()

        def source():
            # the copy back waits for the next step: until then the card
            # holds none of the offloaded state. One item in a buffer of
            # one: the worker never waits for a slot, so ``cancel`` alone
            # ends it
            while not go.wait(0.25):
                if cancel.is_set():
                    return
            if not cancel.is_set():
                yield src

        def convert(host):
            if self.device.type != "cuda":
                return {n: t.clone() for n, t in host.items()}, None
            return {n: copier.put(t) for n, t in host.items()}, \
                copier.seal()

        gen, _stop = overlap_iter(source, convert, 1, "host-offload-h2d")
        self._offload_stage[(tok, names)] = {
            "gen": gen, "go": go, "cancel": cancel, "src": src}

    def _adopt_offloaded(self, program: Program, scope: Scope,
                         state_names) -> None:
        """``run_steps`` on a card: bring offloaded state an earlier
        ``run`` left on the host back into the scope on the card, where
        the captured graph reads and writes it."""
        names = self._offload_names(program, state_names)
        if not names:
            return
        staged = self._take_staged(id(program), names, scope)
        for n in names:
            if n in staged:
                scope.set_var(n, staged[n].resolve())
            else:
                v = scope.find_var(n)
                if isinstance(v, torch.Tensor) and v.device != self.device:
                    scope.set_var(n, v.to(self.device))

    def _maybe_check_program(self, program: Program, feed,
                             fetch_names: Tuple[str, ...]) -> None:
        """Opt-in verification before a run (the ``check_program``
        flag): run ``analysis.check_program`` over each NEW version of
        the program and fail with op-level context before any op runs.
        Warnings pass through silently — only error-severity diagnostics
        block execution."""
        if not flags.get_flag("check_program"):
            return
        if self._verified.get(program) == program._version:
            return
        from . import analysis

        report = analysis.check_program(program, feed=tuple(feed or ()),
                                        fetch_list=fetch_names)
        if not report.ok:
            raise EnforceError(
                "check_program found errors in the program (set the "
                "check_program flag to False to skip verification):\n"
                + str(report))
        self._verified[program] = program._version

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

    def _fetch_result(self, fetch_names, fetches, return_numpy):
        """Fetches as the caller asked: host arrays after the card
        finished (True), tensors (False), or :class:`FetchHandle`s
        ("async")."""
        if return_numpy == "async":
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            return [FetchHandle(n, f, event)
                    for n, f in zip(fetch_names, fetches)]
        if not return_numpy:
            return fetches
        with RecordEvent("fetch_sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return [_to_numpy(f) for f in fetches]

    def run(self,
            program: Optional[Program] = None,
            feed=None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy=True):
        """One run: ``feed`` maps names to arrays, ``fetch_list`` names
        (or Variables) to return. ``feed`` may also be a
        :class:`paddle_tpu_torch.reader.DataLoader`: then one batch of it
        is consumed per call (``chunk`` batches as one :meth:`run_steps`
        call when the loader was made with ``chunk > 1``), and the end of
        its pass raises :class:`EOFException`. With ``return_numpy`` the
        fetches come back as host numpy arrays (bfloat16 widened to
        float32) after the device finished; ``False`` gives the
        tensors, ``"async"`` :class:`FetchHandle`s that wait only when
        read."""
        if getattr(feed, "_pdtpu_dataloader", False):
            return self._run_from_loader(program, feed, fetch_list, scope,
                                         return_numpy)
        program = program or default_main_program()
        feed = dict(feed or {})
        scope = scope if scope is not None else global_scope()
        fetch_names = tuple(_as_names(fetch_list))
        gb = program.global_block()

        self._maybe_check_program(program, feed, fetch_names)
        plan = _live_plan(program)
        if plan is not None:
            from .sharding import spmd

            with RecordEvent("dispatch"):
                fetches = spmd.run(self, program, scope, feed, fetch_names,
                                   _plan_resolver(program, plan))
            if flags.get_flag("check_nan_inf"):
                _assert_all_finite(list(zip(fetch_names, fetches)))
            return self._fetch_result(fetch_names, fetches, return_numpy)
        state_names = self._resolve_state_names(program, feed, fetch_names,
                                                scope)
        written = _written_persistables(program)
        copy = not _resolve_donation(program)
        offload = self._offload_names(program, state_names)
        staged = (self._take_staged(id(program), offload, scope)
                  if offload else {})
        env = {}
        for n in state_names:
            if n in staged:
                env[n] = staged[n]  # a private copy on its way back
                continue
            v = scope.get(n)
            if n in offload and isinstance(v, torch.Tensor) \
                    and v.device != self.device:
                env[n] = v.to(self.device)  # a stale stage: copy it here
                continue
            # without donation the run works on copies of what it writes
            env[n] = v.clone() if copy and n in written \
                and isinstance(v, torch.Tensor) else v
        for name, val in feed.items():
            env[name] = self._feed_tensor(gb._find_var_recursive(name), val)
        ops = live_ops(program, fetch_names)
        with RecordEvent("dispatch"):
            if any(op.type == "backward" for op in ops):
                run_training_ops(ops, env, self.device,
                                 remat=_resolve_remat(program),
                                 keep=fetch_names)
            else:
                with torch.no_grad():
                    run_program_ops(ops, env, device=self.device)

            views = getattr(program, "_flat_state_views", None) or {}
            with torch.no_grad():
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
                if flags.get_flag("check_nan_inf"):
                    _assert_all_finite(
                        list(zip(fetch_names, fetches))
                        + [(n, scope.find_var(n)) for n in sorted(written)])
        if offload:
            self._stage_offload(id(program), scope, offload)
        return self._fetch_result(fetch_names, fetches, return_numpy)

    def _run_from_loader(self, program, loader, fetch_list, scope,
                         return_numpy):
        """Consume batches from a reader.DataLoader: one batch a
        :meth:`run` when ``chunk == 1``; ``chunk`` batches as one
        :meth:`run_steps` call, fetches stacked on a leading chunk axis.
        A ragged tail (fewer than ``chunk`` batches left) runs step by
        step, stacked the same way: a graph per tail length would
        capture the whole step again. The end of the loader's pass
        raises EOFException."""
        chunk = max(1, int(loader.chunk))
        batches: List[Dict] = []
        try:
            while len(batches) < chunk:
                batches.append(next(loader))
        except StopIteration:
            if batches:
                # collecting this tail swallowed the pass's end: the
                # loader re-delivers it on the next pull
                loader._defer_eof()
        if not batches:
            raise EOFException(f"data loader {loader.name!r} exhausted")
        if chunk == 1:
            return self.run(program, feed=batches[0],
                            fetch_list=fetch_list, scope=scope,
                            return_numpy=return_numpy)
        if len(batches) == chunk:
            return self.run_steps(program, feed_list=batches,
                                  fetch_list=fetch_list, scope=scope,
                                  return_numpy=return_numpy)
        outs = [self.run(program, feed=b, fetch_list=fetch_list,
                         scope=scope, return_numpy=False) for b in batches]
        stacked = [torch.stack([o[i] for o in outs])
                   for i in range(len(outs[0]))]
        return self._fetch_result(_as_names(fetch_list), stacked,
                                  return_numpy)

    def run_steps(self,
                  program: Optional[Program] = None,
                  feed: Optional[Dict] = None,
                  feed_list: Optional[Sequence[Dict]] = None,
                  steps: Optional[int] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None,
                  return_numpy=True,
                  unroll: Optional[bool] = None):
        """Run ``steps`` steps of ``program`` in one call: exactly
        ``steps`` calls of :meth:`run` (state written by step i is read
        by step i+1), with each fetch target stacked on a leading
        ``steps`` axis.

        Feeds, one of:
          * ``feed_list`` — a list of per-step feed dicts (stacked on a
            leading axis; all steps share shapes and dtypes);
          * ``feed`` + ``steps`` — classified per name: an array whose
            rank is one above the variable's declared shape carries a
            leading ``steps`` axis and is sliced per step; rank-matching
            arrays are step-invariant. The two kinds may be mixed.

        On the CPU the steps are :meth:`run` calls. On a card they are a
        captured CUDA graph (:class:`_CapturedSteps`), one per cache key
        (:attr:`num_compiled` counts them): one step replayed ``steps``
        times, or with ``unroll`` (default: the ``scan_unroll`` flag)
        ``steps`` straight-line steps replayed once. An op the capture
        cannot take raises EnforceError naming it, and a program holding
        an op that reads a device value on the host each run (``while``,
        ``conditional_block``, ``print``) raises
        :class:`GraphCaptureError` naming it before any capture
        (:func:`check_capturable`); nothing falls back to eager steps.
        Programs with readers must be driven through :meth:`run`."""
        program = program or default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = tuple(_as_names(fetch_list))
        enforce(not getattr(program, "_readers", ()),
                "run_steps does not drive program readers; feed explicitly "
                "or use Executor.run per step")
        gb = program.global_block()
        feed, steps, stacked_names = classify_scan_feeds(
            gb, feed, feed_list, steps)
        if unroll is None:
            unroll = bool(flags.get_flag("scan_unroll"))
        self._maybe_check_program(program, feed, fetch_names)

        if self.device.type != "cuda":
            # each step's fetches cloned: a fetched state tensor is the
            # scope's own, which the next step may update in place
            outs = [[v.clone() for v in self.run(program, feed={
                n: v[i] if n in stacked_names else v
                for n, v in feed.items()}, fetch_list=fetch_names,
                scope=scope, return_numpy=False)] for i in range(steps)]
            stacked = [torch.stack([o[k] for o in outs])
                       for k in range(len(fetch_names))]
            return self._fetch_result(fetch_names, stacked, return_numpy)

        state_names = self._resolve_state_names(program, feed, fetch_names,
                                                scope)
        self._adopt_offloaded(program, scope, state_names)
        feed_vals = {n: self._feed_tensor(gb._find_var_recursive(n), v)
                     for n, v in sorted(feed.items())}
        donate = _resolve_donation(program)
        remat = _resolve_remat(program)
        # one graph per scope too: with donation on a graph's buffers are
        # its scope's tensors, which another scope must not share
        key = (id(program), program._version, id(scope), donate, remat,
               tuple(feed_vals), fetch_names, state_names,
               tuple((n, tuple(v.shape), str(v.dtype))
                     for n, v in feed_vals.items()),
               steps, stacked_names, bool(unroll)) + _tuning_key(program)
        captured = self._cache.get(key)
        if captured is None:
            check_capturable(program)
            _check_shard_capturable(program)
            # a long-lived executor over a mutating program keeps only
            # the current version's graphs (the entry holds the program
            # and the scope, so their ids are not reused while it lives)
            for k in [k for k in self._cache if k[0] == id(program)
                      and k[1] != program._version]:
                del self._cache[k]
            captured = _CapturedSteps(program, scope, fetch_names,
                                      state_names, feed_vals, stacked_names,
                                      steps, bool(unroll), donate,
                                      self.device, remat=remat)
            captured.stream = self._stream()
            _note_capture(program, "steps", {
                n: (tuple(v.shape), v.dtype) for n, v in feed_vals.items()},
                state_names, scope, fetch_names, self.device,
                {"donate": donate, "remat": bool(remat), "steps": steps,
                 "stacked": list(stacked_names), "unroll": bool(unroll)})
        with RecordEvent("dispatch"):
            fetches = captured(feed_vals)
        self._cache[key] = captured
        if flags.get_flag("check_nan_inf"):
            _assert_all_finite(
                list(zip(fetch_names, fetches))
                + [(n, scope.find_var(n))
                   for n in sorted(captured.rw + captured.wo)])
        return self._fetch_result(fetch_names, fetches, return_numpy)

    def run_graph(self,
                  program: Optional[Program] = None,
                  feed: Optional[Dict] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None,
                  pool=None) -> List[np.ndarray]:
        """One run of ``program`` (the semantics of :meth:`run`), with
        the fetches as host numpy arrays. On the CPU it is :meth:`run`.
        On a card each set of feed names and shapes is a captured CUDA
        graph (:class:`_CapturedRun`): the first call runs eagerly and
        captures, later calls replay, so a call costs one feed copy, the
        replay, one fetch copy and one synchronize. ``pool`` (a
        ``torch.cuda.graph_pool_handle()``) is the memory pool the graphs
        are captured into; graphs that never run concurrently may share
        one. A capture that fails raises EnforceError naming the op;
        nothing falls back to eager runs."""
        program = program or default_main_program()
        feed = dict(feed or {})
        scope = scope if scope is not None else global_scope()
        fetch_names = tuple(_as_names(fetch_list))
        if self.device.type != "cuda":
            return self.run(program, feed=feed, fetch_list=fetch_names,
                            scope=scope)
        key, captured = self._graph_for(program, feed, fetch_names, scope,
                                        pool)
        try:
            with RecordEvent("dispatch"):
                captured.launch(feed)
            return captured.fetch()
        finally:
            # a graph is held once captured; a failed first call keeps
            # nothing
            if captured.graph is not None:
                self._cache[key] = captured

    def _graph_for(self, program: Program, feed: Dict,
                   fetch_names: Tuple[str, ...], scope: Scope, pool):
        """(cache key, the :class:`_CapturedRun` held for it or a new
        one, not yet captured) of a ``run_graph`` call."""
        donate = _resolve_donation(program)
        key = (id(program), program._version, id(scope), donate, "graph",
               tuple((n, tuple(np.shape(v)))
                     for n, v in sorted(feed.items())),
               fetch_names) + _tuning_key(program)
        captured = self._cache.get(key)
        if captured is not None:
            return key, captured
        enforce(not any(op.type == "backward"
                        for op in program.global_block().ops),
                "run_graph runs inference programs; train through run or "
                "run_steps")
        check_capturable(program)
        _check_shard_capturable(program)
        for k in [k for k in self._cache if k[0] == id(program)
                  and k[1] != program._version]:
            del self._cache[k]
        gb = program.global_block()
        state_names = self._resolve_state_names(program, feed, fetch_names,
                                                scope)
        specs = {}
        for n, v in sorted(feed.items()):
            var = gb._find_var_recursive(n)
            dt = (dtype_utils.to_torch(var.dtype)
                  if var is not None and var.dtype is not None
                  else torch.as_tensor(np.asarray(v)).dtype)
            specs[n] = (tuple(np.shape(v)), dt)
        captured = _CapturedRun(program, scope, fetch_names, state_names,
                                specs, donate, self.device, pool=pool)
        captured.stream = self._stream()
        _note_capture(program, "graph", specs, state_names, scope,
                      fetch_names, self.device, {"donate": donate})
        return key, captured

    def _stream(self) -> torch.cuda.Stream:
        """The side stream this executor's captures run on."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        return self._capture_stream

    @property
    def num_compiled(self) -> int:
        """Captured CUDA graphs held (one per ``run_steps`` cache key: the
        program and its version, the scope, donation, the remat policy,
        the feed, fetch and
        state names, the feed shapes, steps and unroll; one per
        ``run_graph`` key: the program and its version, the scope,
        donation, the feed names and shapes, the fetch names); 0 on the
        CPU, where nothing is captured."""
        return sum(c.graph is not None for c in self._cache.values())

    @property
    def capture_seconds(self) -> List[float]:
        """Host seconds each held graph's first call spent on its eager
        step and its capture."""
        return [c.capture_s for c in self._cache.values()
                if c.capture_s is not None]

    def close(self) -> None:
        """Drop the captured graphs and their memory, and stop the
        pending copies of offloaded state."""
        self._cache.clear()
        for entry in self._offload_stage.values():
            entry["cancel"].set()
        self._offload_stage.clear()
