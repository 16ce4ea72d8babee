"""Liveness analysis + peak-memory estimation over the global block
(counterpart of paddle_tpu/analysis/liveness.py, the same model,
numbers and report text).

Reference: the ControlFlowGraph liveness pass inside
transpiler/memory_optimization_transpiler.py:35-200 (live_in/live_out
per op, driving buffer reuse). On the card the *rewriting* half belongs
to PyTorch's caching allocator, which frees a tensor when its last
reference goes; what stays valuable is the *report*: a static
prediction of the device-memory footprint — peak resident bytes, the
op where the peak occurs, the largest tensors and their lifetime spans —
computed before any run. ``fluid.memory_optimize(print_log=True)``
prints this report (its text keeps the JAX package's "peak-HBM" words,
so the two packages print the same report), and the ``remat_policy``
pass sizes its checkpoints from the same numbers.

Residency model (the hand-checkable contract tests pin down):

  * a value is resident DURING the op that defines it through the op
    that last reads it (inclusive);
  * program inputs (feeds / ``is_data`` vars / scope state read before
    any write) are resident from op 0;
  * persistable variables and fetch targets stay resident through the
    last op (they live in the scope / flow back to it);
  * dynamic dims (-1) are counted as ``assume_batch`` extents; vars
    with no declared shape contribute 0 bytes and are counted in
    ``unsized_vars``.

A sharding is taken as a ``{name: shard_count}`` dict, which is all
arithmetic; a ``ShardingPlan`` object raises (the port has no sharding
yet, ROADMAP Queue A 9).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core import dtype_utils
from ..core.enforce import not_ported
from ..core.program import LOD_TENSOR, Program
from .dataflow import compute_def_use, live_intervals


def tensor_bytes(shape, dtype, assume_batch: int = 1) -> int:
    """Static byte size of one tensor; -1 dims count as assume_batch."""
    if shape is None:
        return 0
    n = 1
    for s in shape:
        n *= assume_batch if s == -1 else int(s)
    return int(n) * dtype_utils.itemsize(dtype)


class TensorLife:
    """One variable's footprint + lifetime span [first, last] op index.

    ``shard_count`` (> 1 under a sharding plan) divides the footprint:
    ``device_bytes`` is what ONE device of the mesh holds — the number
    the per-device HBM report sums. ``offloaded`` marks persistable
    state parked in host memory by the ``host_offload`` pass: it is
    device-resident only over its in-step staging span and is excluded
    from the persistable HBM totals."""

    __slots__ = ("name", "bytes", "shape", "dtype", "first", "last",
                 "persistable", "shard_count", "offloaded")

    def __init__(self, name, nbytes, shape, dtype, first, last,
                 persistable, shard_count=1, offloaded=False):
        self.name = name
        self.bytes = nbytes
        self.shape = shape
        self.dtype = dtype
        self.first = first
        self.last = last
        self.persistable = persistable
        self.shard_count = max(1, int(shard_count))
        self.offloaded = bool(offloaded)

    @property
    def device_bytes(self) -> int:
        return -(-self.bytes // self.shard_count)  # ceil: honest partial

    def __repr__(self):
        return (f"TensorLife({self.name!r}, {self.bytes}B, "
                f"span=[{self.first},{self.last}])")


def _fmt_bytes(n: int) -> str:
    if n < 1024:
        return f"{n} B"
    for unit, scale in (("KiB", 1024), ("MiB", 1024 ** 2),
                        ("GiB", 1024 ** 3)):
        if n < scale * 1024 or unit == "GiB":
            return f"{n / scale:.2f} {unit}"
    return f"{n} B"


class MemoryReport:
    """Result of :func:`analyze_liveness`: per-op resident bytes and the
    derived peak-HBM summary."""

    def __init__(self, program: Program, per_op_bytes: List[int],
                 per_op_live: List[int], lives: Dict[str, TensorLife],
                 assume_batch: int, unsized_vars: List[str],
                 per_op_device_bytes: Optional[List[int]] = None,
                 n_shards: int = 1, donation: bool = True,
                 remat=False,
                 host_offload_names: Tuple[str, ...] = (),
                 host_offload_bytes: int = 0,
                 host_offload_device_bytes: int = 0):
        self.per_op_bytes = per_op_bytes
        self.per_op_live = per_op_live
        self.lives = lives
        self.assume_batch = assume_batch
        self.unsized_vars = unsized_vars
        # scheduling-pass knobs the estimate modeled (echoed so a report
        # is self-describing when passed around, e.g. by bench JSON)
        self.donation = bool(donation)
        self.remat = remat
        self.host_offload_names = tuple(host_offload_names)
        self.host_offload_bytes = int(host_offload_bytes)
        self.host_offload_device_bytes = int(host_offload_device_bytes)
        ops = program.global_block().ops
        if per_op_bytes:
            self.peak_op_index = int(np.argmax(per_op_bytes))
            self.peak_bytes = per_op_bytes[self.peak_op_index]
            self.peak_op_type = ops[self.peak_op_index].type
        else:
            self.peak_op_index = -1
            self.peak_bytes = 0
            self.peak_op_type = None
        self.persistable_bytes = sum(
            t.bytes for t in lives.values()
            if t.persistable and not t.offloaded)
        # paged KV-cache pools (decoding rewrite: persistable vars named
        # "kv_cache@...") broken out of the persistable total — THE
        # number serving capacity planning needs: pools are sized by
        # CacheConfig, not by the model, and dominate decode-path HBM
        self.kv_cache_bytes = sum(
            t.bytes for t in lives.values()
            if t.persistable and t.name.startswith("kv_cache@"))
        self.kv_cache_pools = sum(
            1 for t in lives.values()
            if t.persistable and t.name.startswith("kv_cache@"))
        # -- per-device view (sharding plan divides through) ------------
        # n_shards > 1 means the program carries a sharding plan: the
        # global estimate above describes the whole mesh, and these
        # fields describe ONE device — what bucket/batch sizing must fit
        # in a single chip's HBM.
        self.sharded = n_shards > 1
        self.n_shards = n_shards
        self.per_op_device_bytes = (per_op_device_bytes
                                    if per_op_device_bytes is not None
                                    else list(per_op_bytes))
        if self.per_op_device_bytes:
            self.peak_device_op_index = int(
                np.argmax(self.per_op_device_bytes))
            self.peak_device_bytes = self.per_op_device_bytes[
                self.peak_device_op_index]
        else:
            self.peak_device_op_index = -1
            self.peak_device_bytes = 0
        self.persistable_device_bytes = sum(
            t.device_bytes for t in lives.values()
            if t.persistable and not t.offloaded)
        self.kv_cache_device_bytes = sum(
            t.device_bytes for t in lives.values()
            if t.persistable and t.name.startswith("kv_cache@"))

    def top_tensors(self, k: int = 10) -> List[TensorLife]:
        return sorted(self.lives.values(), key=lambda t: -t.bytes)[:k]

    def render(self, top_k: int = 10) -> str:
        live_at_peak = (self.per_op_live[self.peak_op_index]
                        if self.per_op_live else 0)
        lines = [
            "peak-HBM report (static liveness estimate, dynamic dims "
            f"counted as batch={self.assume_batch})",
            f"  peak resident: {_fmt_bytes(self.peak_bytes)} at op#"
            f"{self.peak_op_index} ({self.peak_op_type}), "
            f"{live_at_peak} live tensors",
            f"  persistable state (params/moments/stats): "
            f"{_fmt_bytes(self.persistable_bytes)}",
        ]
        if self.kv_cache_bytes:
            lines.append(
                f"  paged KV-cache pools: "
                f"{_fmt_bytes(self.kv_cache_bytes)} across "
                f"{self.kv_cache_pools} pool(s)")
        if self.host_offload_names:
            lines.append(
                f"  host-offloaded state: "
                f"{_fmt_bytes(self.host_offload_bytes)} across "
                f"{len(self.host_offload_names)} var(s) (device-resident "
                "only over the staging span)")
        if self.sharded:
            lines.append(
                f"  per-device ({self.n_shards}-way sharded): "
                f"peak {_fmt_bytes(self.peak_device_bytes)} at op#"
                f"{self.peak_device_op_index}, persistable state "
                f"{_fmt_bytes(self.persistable_device_bytes)}/device"
                + (f", KV pools "
                   f"{_fmt_bytes(self.kv_cache_device_bytes)}/device"
                   if self.kv_cache_bytes else ""))
        if self.unsized_vars:
            lines.append(
                f"  NOTE: {len(self.unsized_vars)} var(s) have no "
                "declared shape and contribute 0 bytes: "
                + ", ".join(self.unsized_vars[:5])
                + ("..." if len(self.unsized_vars) > 5 else ""))
        lines.append(f"  top {top_k} tensors by size (lifetime = "
                     "[def op, last use op]):")
        for t in self.top_tensors(top_k):
            tag = " persistable" if t.persistable else ""
            if t.shard_count > 1:
                tag = (f" sharded/{t.shard_count} "
                       f"({_fmt_bytes(t.device_bytes)}/device)") + tag
            lines.append(
                f"    {_fmt_bytes(t.bytes):>12}  {t.name}  "
                f"shape={t.shape} span=[{t.first},{t.last}]{tag}")
        return "\n".join(lines)

    def __str__(self):
        return self.render()


def analyze_liveness(program: Optional[Program] = None,
                     fetch_list: Iterable = (),
                     feed: Iterable[str] = (),
                     assume_batch: int = 1,
                     scope_state: Optional[Iterable[str]] = None,
                     sharding=None,
                     remat=None,
                     donation: Optional[bool] = None,
                     host_offload: Optional[Iterable[str]] = None,
                     model_backward: bool = True) -> MemoryReport:
    """Compute per-op live sets and the peak-HBM report for the global
    block of ``program`` (default: the default main program).

    ``sharding`` — a ``{name: shard_count}`` mapping, or None (a
    ``ShardingPlan`` raises: ROADMAP Queue A 9). When present, every
    tensor's footprint is divided by its shard count and the report
    carries a per-device view (``peak_device_bytes``,
    ``persistable_device_bytes``): ZeRO-sharded optimizer state shows
    up as ≈1/shard_count param-state bytes per device, so bucket and
    batch sizing on a mesh stay static-predictable.

    Scheduling-pass knobs (each defaults to what the program itself
    declares, so a report on a pass-rewritten program models what the
    executor will actually do):

    ``remat`` — the rematerialization policy modeled for the backward
    retention set: ``False`` keeps every forward activation live through
    the ``backward`` op, ``True`` (the legacy all-or-nothing flag) keeps
    only the slice's external inputs, and an iterable of segment ids
    (the ``remat_policy`` pass, ``program._remat_policy``) keeps each
    checkpointed segment's boundary values plus every non-checkpointed
    segment's internals — exactly the residuals a checkpoint
    saves in ``backward.remat_segment_plan`` terms (the port's executor
    runs each checkpointed segment under ``torch.utils.checkpoint``).

    ``donation`` — when buffer donation is off, every rewritten
    persistable holds TWO buffers (old + new) from its first in-step
    write to the end of the step; modeled as extra resident bytes,
    resolved through the executor's rule (``_resolve_donation``).

    ``host_offload`` — names parked in host memory (the JAX package's
    ``host_offload`` pass, not ported: ROADMAP Queue A 8): excluded
    from entry/exit residency and the persistable totals, charged on
    device only over their in-step staging span (the op that reads and
    rewrites them).

    ``model_backward=False`` restores the pre-scheduling forward-only
    residency model (the hand-checked fixtures pin that one down)."""
    from ..core.program import default_main_program
    from ..executor import _resolve_donation, _resolve_remat

    program = program or default_main_program()
    n_shards = 1
    if sharding is not None and hasattr(sharding, "shard_counts"):
        raise not_ported("analyze_liveness over a ShardingPlan (pass a "
                         "{name: shard_count} dict)", "Queue A 9")
    elif sharding is not None and not hasattr(sharding, "values"):
        raise TypeError(
            "sharding must be a {name: shard_count} dict; got "
            f"{type(sharding).__name__}")
    elif sharding:
        n_shards = max(sharding.values())
    shard_of = sharding or {}
    gb = program.global_block()
    ops = gb.ops
    du = compute_def_use(ops)

    # -- scheduling-pass knobs resolved off the program, by the
    # executor's own rules ----------------------------------------------
    if remat is None:
        remat = _resolve_remat(program)
    elif remat is not True and remat is not False:
        remat = frozenset(remat)
    if donation is None:
        donation = _resolve_donation(program)
    if host_offload is None:
        host_offload = getattr(program, "_host_offload_state", ())
    offloaded = {getattr(n, "name", n) for n in (host_offload or ())}

    feed_names = {getattr(f, "name", f) for f in (feed or ())}
    fetch_names = {getattr(f, "name", f) for f in (fetch_list or ())}

    entry_live = set(feed_names)
    exit_live = set(fetch_names)
    for n in du.names():
        v = gb._find_var_recursive(n)
        if v is None:
            continue
        if (v.persistable and n not in offloaded) or v.is_data \
                or n in feed_names:
            if n not in du.first_def or \
                    du.first_use.get(n, len(ops)) <= du.first_def[n]:
                entry_live.add(n)  # read (or never written): lives at entry
        if v.persistable and n not in offloaded:
            exit_live.add(n)  # scope-resident through the whole step
    if scope_state:
        entry_live.update(n for n in scope_state if n not in offloaded)
        exit_live.update(n for n in scope_state if n not in offloaded)

    intervals = live_intervals(ops, entry_live, exit_live)

    # -- backward retention: activations the `backward` op keeps alive --
    bw_idx = next((i for i, op in enumerate(ops)
                   if op.type == "backward"), None)
    if model_backward and bw_idx is not None:
        bw = ops[bw_idx]
        targets = bw.attrs.get("targets") or ()
        root = bw.attrs.get("loss") or (targets[0] if targets else None)
        if root is not None:
            from ..backward import _forward_slice, remat_segment_plan
            fwd_ops, ext = _forward_slice(program, root)
            if remat is True:
                retained = set(ext)  # a checkpoint saves its inputs
            elif remat:
                # every segment retains its boundary inputs (residuals
                # of its own checkpoint, or of the AD trace through it);
                # non-checkpointed segments additionally retain their
                # internal defs
                retained = set()
                for sid, seg_ops, needed, _keep in \
                        remat_segment_plan(fwd_ops, root):
                    retained.update(needed)
                    if sid not in remat:
                        retained.update(o for op in seg_ops
                                        for o in op.output_arg_names)
            else:
                retained = set(ext)
                for op in fwd_ops:
                    retained.update(op.output_arg_names)
            for n in retained:
                iv = intervals.get(n)
                if iv is not None and iv[1] < bw_idx:
                    intervals[n] = (iv[0], bw_idx)

    lives: Dict[str, TensorLife] = {}
    unsized: List[str] = []
    for n, (first, last) in intervals.items():
        v = gb._find_var_recursive(n)
        if v is None or v.type != LOD_TENSOR:
            continue
        nbytes = tensor_bytes(v.shape, v.dtype, assume_batch)
        if v.shape is None:
            unsized.append(n)
        lives[n] = TensorLife(n, nbytes, v.shape,
                              dtype_utils.name(v.dtype), first, last,
                              bool(v.persistable),
                              shard_count=shard_of.get(n, 1),
                              offloaded=n in offloaded)

    # -- host-offload totals: computed over var declarations so parked
    # state an analyzed program never touches still shows up ------------
    host_names: List[str] = []
    host_bytes = host_dev = 0
    for n in sorted(offloaded):
        v = gb._find_var_recursive(n)
        if v is None:
            continue
        b = tensor_bytes(v.shape, v.dtype, assume_batch)
        host_names.append(n)
        host_bytes += b
        host_dev += -(-b // max(1, shard_of.get(n, 1)))

    # interval diff-arrays + prefix sum: O(ops + vars), not O(ops x vars)
    # — this report runs on real models (the remat_policy pass prices
    # every candidate with it), where the nested scan would be seconds
    n_ops = len(ops)
    bytes_delta = [0] * (n_ops + 1)
    dev_delta = [0] * (n_ops + 1)
    live_delta = [0] * (n_ops + 1)
    for t in lives.values():
        bytes_delta[t.first] += t.bytes
        bytes_delta[t.last + 1] -= t.bytes
        dev_delta[t.first] += t.device_bytes
        dev_delta[t.last + 1] -= t.device_bytes
        live_delta[t.first] += 1
        live_delta[t.last + 1] -= 1
    if not donation:
        # donation off: the step's output buffer for each rewritten
        # persistable coexists with the input buffer from its first
        # in-step write to the end of the step (fused flat views are
        # slices of storage written elsewhere — skip them)
        for n, t in lives.items():
            if not t.persistable or t.offloaded:
                continue
            writes = [i for i in du.defs.get(n, ())
                      if ops[i].type != "unpack_flat_params"]
            if not writes:
                continue
            bytes_delta[writes[0]] += t.bytes
            bytes_delta[n_ops] -= t.bytes
            dev_delta[writes[0]] += t.device_bytes
            dev_delta[n_ops] -= t.device_bytes
    per_op_bytes = []
    per_op_device_bytes = []
    per_op_live = []
    acc_b = acc_d = acc_l = 0
    for i in range(n_ops):
        acc_b += bytes_delta[i]
        acc_d += dev_delta[i]
        acc_l += live_delta[i]
        per_op_bytes.append(acc_b)
        per_op_device_bytes.append(acc_d)
        per_op_live.append(acc_l)

    return MemoryReport(program, per_op_bytes, per_op_live, lives,
                        assume_batch, unsized,
                        per_op_device_bytes=per_op_device_bytes,
                        n_shards=n_shards, donation=donation, remat=remat,
                        host_offload_names=host_names,
                        host_offload_bytes=host_bytes,
                        host_offload_device_bytes=host_dev)
