"""ParallelExecutor: a Program run data-parallel over the ranks of a
``torch.distributed`` world (counterpart of
paddle_tpu/parallel/parallel_executor.py).

The reference builds a per-device SSA graph with explicit NCCL
all-reduce op-handles (reference: paddle/fluid/framework/
parallel_executor.cc:57, details/multi_devices_graph_builder.cc:189);
the JAX package jits the program once over a ``dp`` mesh and XLA
derives the collectives. The port runs one process per device: every
rank runs the program on its slice of the batch through
``sharding/spmd.py``, which issues the collectives.

Semantics preserved:
  * per-device local batches: a fed global batch is split along dim 0
    (reference: FeedAndSplitTensorIntoLocalScopes,
    parallel_executor.cc:260-277); a list of per-device feed dicts is
    concatenated first;
  * parameter broadcast at init (reference: BCastParamsToDevices,
    parallel_executor.cc:144): :meth:`bcast_params`;
  * BuildStrategy.{AllReduce,Reduce}: gradients averaged over ``dp``,
    or (Reduce, ZeRO) optimizer accumulators held as ``dp`` slices when
    dim 0 divides — the gradient reduce-scattered, each rank's update on
    its slice (a flat group's fused kernel on its slice of the group),
    the parameter slices gathered;
  * fetches: the mean of the ranks' losses, gathered batch-shaped
    values — the whole value on every rank.

A world of one process runs the program through the ordinary
Executor.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.program import Program, Variable, default_main_program
from ..core.scope import Scope, global_scope
from ..sharding.mesh import DeviceMesh, Layout, data_parallel_mesh
from .strategy import BuildStrategy, ExecutionStrategy, ReduceStrategy


def _var_sharding(mesh: DeviceMesh, v: Optional[Variable], name: str,
                  build_strategy: BuildStrategy, is_feed: bool) -> Layout:
    """Resolve the mesh layout for one variable.

    Priority: explicit ``sharding_spec`` on the Variable (set by param_attr
    or the DistributeTranspiler plan) > data vars sharded on the batch dim >
    ZeRO-sharded optimizer accumulators (Reduce strategy) > replicated."""
    spec = getattr(v, "sharding_spec", None) if v is not None else None
    if spec is not None:
        return mesh.sharding(*spec)
    if v is not None and is_feed:
        ndim = len(v.shape) if v.shape is not None else 1
        if v.is_data or (v.shape and v.shape[0] == -1):
            return mesh.data_sharding(max(ndim, 1))
        return mesh.replicated()
    if (build_strategy.reduce_strategy == ReduceStrategy.Reduce
            and v is not None and getattr(v, "is_accumulator", False)
            and v.shape and len(v.shape) >= 1 and v.shape[0] > 0
            and v.shape[0] % mesh.size("dp") == 0):
        return mesh.sharding("dp")
    return mesh.replicated()


def _place(use_cuda):
    from ..core.place import CPUPlace, CUDAPlace

    if use_cuda is False:
        return CPUPlace()
    return CUDAPlace(torch.cuda.current_device()
                     if torch.cuda.is_available() else 0)


class ParallelExecutor:
    """reference: python/paddle/fluid/parallel_executor.py:29.

    Drop-in multi-device executor: the ``run()`` contract of
    :class:`~paddle_tpu_torch.Executor`, every step run by every rank of
    ``mesh`` (default: the whole world on a ``dp`` axis). ``place``
    (default: this rank's card, ``CPUPlace()`` with ``use_cuda=False``)
    is where this rank runs."""

    def __init__(self,
                 use_tpu: bool = True,
                 loss_name: Optional[str] = None,
                 main_program: Optional[Program] = None,
                 share_vars_from: Optional["ParallelExecutor"] = None,
                 exec_strategy: Optional[ExecutionStrategy] = None,
                 build_strategy: Optional[BuildStrategy] = None,
                 num_trainers: int = 1,
                 trainer_id: int = 0,
                 scope: Optional[Scope] = None,
                 mesh: Optional[DeviceMesh] = None,
                 use_cuda: Optional[bool] = None,
                 place=None):
        from ..executor import Executor

        del use_tpu
        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._scope = scope or global_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        self.mesh = mesh or data_parallel_mesh()
        # the world (init_distributed) sizes the ranks; these are
        # informational, as in the JAX package
        self._num_trainers = num_trainers
        self._trainer_id = trainer_id
        self._exe = Executor(place if place is not None
                             else _place(use_cuda))
        self._resolvers: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    @property
    def device_count(self) -> int:
        return self.mesh.size()

    def _layout(self, name: str) -> Layout:
        gb = self._program.global_block()
        return _var_sharding(self.mesh, gb._find_var_recursive(name), name,
                             self._build_strategy, is_feed=False)

    def _resolver(self):
        from ..sharding import spmd
        from ..sharding.rules import clean_spec

        program = self._program
        key = (id(program), program._version)
        hit = self._resolvers.get(key)
        if hit is None:
            gb = program.global_block()

            def spec(name):
                v = gb._find_var_recursive(name)
                shape = v.shape if v is not None else None
                return clean_spec(self.mesh, self._layout(name).spec, shape)

            self._resolvers.clear()
            hit = self._resolvers[key] = spmd.Resolver(
                self.mesh, self.mesh.data_axes(), spec)
        return hit

    @staticmethod
    def _merge_feed(feed):
        """A list of per-device feed dicts is one global batch
        (parallel_executor.py:163)."""
        if isinstance(feed, (list, tuple)):
            merged: Dict[str, list] = {}
            for part in feed:
                for k, v in part.items():
                    merged.setdefault(k, []).append(v)
            feed = {k: (torch.cat([torch.as_tensor(np.asarray(x))
                                   if not isinstance(x, torch.Tensor)
                                   else x for x in v])
                        if len(v) > 1 else v[0])
                    for k, v in merged.items()}
        return dict(feed or {})

    def run(self,
            fetch_list: Optional[Sequence] = None,
            feed: Optional[object] = None,
            feed_dict: Optional[Dict] = None,
            return_numpy=True):
        from ..core.trace_ctx import remat_scope
        from ..executor import _as_names

        feed = self._merge_feed(feed if feed is not None else feed_dict)
        fetch_names = tuple(_as_names(fetch_list))
        use_remat = bool(self._build_strategy.use_remat)
        with remat_scope(use_remat):
            if self.mesh.size() <= 1:
                return self._exe.run(self._program, feed=feed,
                                     fetch_list=fetch_names,
                                     scope=self._scope,
                                     return_numpy=return_numpy)
            from ..sharding import spmd

            spmd.check_not_live(self.mesh)
            fetches = spmd.run(self._exe, self._program, self._scope, feed,
                               fetch_names, self._resolver(),
                               remat=True if use_remat else None)
        return self._exe._fetch_result(fetch_names, fetches, return_numpy)

    def run_steps(self,
                  feed: Optional[Dict] = None,
                  feed_list: Optional[Sequence[Dict]] = None,
                  steps: Optional[int] = None,
                  fetch_list: Optional[Sequence] = None,
                  return_numpy=True,
                  unroll: Optional[bool] = None):
        """N steps in one call, fetches stacked on a leading ``steps``
        axis (the JAX package's scanned SPMD steps). On the CPU a loop
        of :meth:`run`; on a card the steps of a world of several ranks
        are not captured as a CUDA graph (over gloo the collectives
        cannot be): it raises :class:`GraphCaptureError` before any
        step runs. A world of one runs ``Executor.run_steps``."""
        from ..executor import _as_names, classify_scan_feeds
        from ..sharding import spmd

        fetch_names = tuple(_as_names(fetch_list))
        if self.mesh.size() <= 1:
            return self._exe.run_steps(self._program, feed=feed,
                                       feed_list=feed_list, steps=steps,
                                       fetch_list=fetch_names,
                                       scope=self._scope,
                                       return_numpy=return_numpy,
                                       unroll=unroll)
        if self._exe.device.type == "cuda":
            spmd.check_capturable(self.mesh, "ParallelExecutor.run")
        gb = self._program.global_block()
        feed, steps, stacked = classify_scan_feeds(gb, feed, feed_list,
                                                   steps)
        outs = [[v.clone() for v in self.run(
            fetch_list=fetch_names, feed={
                n: v[i] if n in stacked else v for n, v in feed.items()},
            return_numpy=False)] for i in range(steps)]
        stacked_out = [torch.stack([o[k] for o in outs])
                       for k in range(len(fetch_names))]
        return self._exe._fetch_result(fetch_names, stacked_out,
                                       return_numpy)

    # ------------------------------------------------------------------
    def state_shardings(self, names: Optional[Sequence[str]] = None
                        ) -> Dict[str, Layout]:
        """The mesh layout this executor resolves for each persistable
        variable (what a restore needs to place ZeRO-sharded state)."""
        if names is None:
            names = list(self._scope.local_var_names())
        return {n: self._layout(n) for n in names}

    def bcast_params(self):
        """Make every rank's persistables rank 0's (reference:
        BCastParamsToDevices, parallel_executor.cc:144): a broadcast of
        each whole tensor the scope holds. Blocks of sharded state are
        each rank's own and are left alone."""
        if self.mesh.size() <= 1 or not self.mesh.live:
            return
        import torch.distributed as dist

        gb = self._program.global_block()
        for name in sorted(self._scope.local_var_names()):
            v = gb._find_var_recursive(name)
            val = self._scope.find_var(name)
            if v is None or not v.persistable \
                    or not isinstance(val, torch.Tensor) \
                    or v.shape is None \
                    or tuple(val.shape) != tuple(v.shape):
                continue
            buf = val.detach().contiguous().clone()
            dist.broadcast(buf, src=0)
            self._scope.set_var(name, buf)

    def close(self):
        self._resolvers.clear()
        self._exe.close()
