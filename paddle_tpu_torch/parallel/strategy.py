"""Execution/build strategies for the ParallelExecutor (counterpart of
paddle_tpu/parallel/strategy.py).

These coarse strategy enums predate the ``sharding`` pass. New code
should express placement as ordered partition rules over a named
``data``/``fsdp``/``tp`` mesh (``sharding.shard_program``):
``ReduceStrategy.AllReduce`` corresponds to params replicated over a
pure ``data`` axis, ``ReduceStrategy.Reduce`` (ZeRO) to the default
rules on a mesh with ``fsdp`` > 1. The classes remain for
ParallelExecutor API parity.

Parity with the reference's knobs (reference:
paddle/fluid/framework/details/execution_strategy.h:21,
details/build_strategy.h:23):

  * ``ReduceStrategy.AllReduce`` — every rank holds a full replica of
    params and optimizer state; gradients all-reduced (the reference's
    AllReduceOpHandle path, details/all_reduce_op_handle.cc:47).
  * ``ReduceStrategy.Reduce`` — ZeRO-style: optimizer state sharded
    across the ``dp`` axis; each rank's gradient is reduce-scattered to
    its slice, it updates that slice, and the parameter slices are
    gathered. The reference's Reduce mode placed each param's optimizer
    on one owner device and broadcast the result
    (details/multi_devices_graph_builder.cc:282-288,534).
"""

from __future__ import annotations

import enum


class ReduceStrategy(enum.Enum):
    AllReduce = 0
    Reduce = 1  # ZeRO-style sharded optimizer state


class BuildStrategy:
    """reference: details/build_strategy.h:23 (pybind'd in pybind.cc)."""

    ReduceStrategy = ReduceStrategy

    def __init__(self):
        self.reduce_strategy: ReduceStrategy = ReduceStrategy.AllReduce
        # gradient_scale in the reference (CoeffNumDevice) scaled loss@GRAD
        # by 1/num_devices (details/multi_devices_graph_builder.cc:492);
        # the ranks' gradients are averaged, which is this. Kept for API
        # parity.
        self.gradient_scale_strategy = "coeff_num_device"
        # remat: trade FLOPs for memory (no reference analog; the
        # reference's memory_optimize transpiler served the same goal)
        self.use_remat = False
        self.debug_graphviz_path = ""

    def __repr__(self):
        return (f"BuildStrategy(reduce={self.reduce_strategy.name}, "
                f"remat={self.use_remat})")


class ExecutionStrategy:
    """reference: details/execution_strategy.h:21."""

    def __init__(self):
        self.num_threads = 0          # kept for parity
        self.use_event = True
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100

    def __repr__(self):
        return "ExecutionStrategy()"
