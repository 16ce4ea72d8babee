"""DistributeTranspiler: program -> sharding-plan rewriting (counterpart
of paddle_tpu/parallel/transpiler.py).

The reference's DistributeTranspiler rewrote a single-process program into
trainer programs (split_byref + send/recv + barriers) and pserver programs
(listen_and_serv with per-param optimize blocks)
(reference: python/paddle/fluid/transpiler/distribute_transpiler.py:129,
177,320,333; operators/listen_and_serv_op.cc:101). Here, as in the JAX
package, the parameter-server tier collapses into sharded state: the
transpiler annotates variables with specs over the mesh (lookup tables
row-sharded over ``ep``/``dp``, optimizer state ZeRO-sharded through the
Reduce strategy) and the ParallelExecutor's ranks each hold their
block.

The *capability contract* preserved:
  * ``transpile()`` then ``get_trainer_program()`` /
    ``get_pserver_program()`` — every process runs the same program; both
    getters return it, since trainer and pserver roles are unified.
  * sparse distributed lookup tables — embedding params get row-sharded
    specs over the ``ep``/``dp`` axes.
  * ``sync_mode=False`` (async SGD) has no counterpart — collectives are
    synchronous by construction. Kept as an ignored knob.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.enforce import enforce
from ..core.program import Program, default_main_program
from .mesh import DeviceMesh
from .strategy import BuildStrategy, ReduceStrategy


class DistributeTranspilerConfig:
    """reference: transpiler/distribute_transpiler.py:113."""

    def __init__(self):
        self.slice_var_up = True      # → ZeRO-shard optimizer state
        self.min_block_size = 8192    # below this, keep replicated
        self.split_method = "RoundRobin"  # parity; placement is mesh-derived


class ShardingPlan:
    """The transpile result: name → PartitionSpec tuples, plus the
    BuildStrategy to execute it with. Plays the role of the reference's
    rewritten program pair (trainer/pserver)."""

    def __init__(self, mesh: Optional[DeviceMesh]):
        self.mesh = mesh
        self.var_specs: Dict[str, Tuple] = {}
        self.build_strategy = BuildStrategy()

    def spec(self, name: str) -> Optional[Tuple]:
        return self.var_specs.get(name)

    def __repr__(self):
        return f"ShardingPlan({len(self.var_specs)} sharded vars)"


def _numel(shape) -> int:
    n = 1
    for s in shape or ():
        n *= max(int(s), 1)
    return n


class DistributeTranspiler:
    """reference: transpiler/distribute_transpiler.py:129."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._program: Optional[Program] = None
        self._plan: Optional[ShardingPlan] = None

    # ------------------------------------------------------------------
    def transpile(self,
                  trainer_id: int = 0,
                  program: Optional[Program] = None,
                  pservers: str = "",
                  trainers: int = 1,
                  sync_mode: bool = True,
                  startup_program: Optional[Program] = None,
                  mesh: Optional[DeviceMesh] = None,
                  current_endpoint: str = "") -> ShardingPlan:
        """Annotate `program` with a sharding plan.

        `pservers`/`trainers`/`current_endpoint` are accepted for drop-in
        parity with reference launch scripts; placement comes from `mesh`.
        """
        del trainer_id, pservers, trainers, current_endpoint
        program = program or default_main_program()
        self._program = program
        plan = ShardingPlan(mesh)
        if not sync_mode:
            # async SGD intentionally maps to sync collectives; see module
            # docstring.
            pass
        gb = program.global_block()

        # 1. Distributed lookup tables: any param consumed by a lookup_table
        #    op is row-sharded (reference: distribute_transpiler.py:869
        #    sparse path; prefetch_op pulls rows from the owning pserver).
        embed_params = set()
        for op in gb.ops:
            if op.type in ("lookup_table", "embedding"):
                for n in op.input("W") or op.input_arg_names[:1]:
                    embed_params.add(n)
        for name in embed_params:
            v = gb._find_var_recursive(name)
            if v is None or not v.shape:
                continue
            spec = (("ep", "dp"),) + (None,) * (len(v.shape) - 1)
            v.sharding_spec = spec
            plan.var_specs[name] = spec

        # 2. Optimizer-state sharding (the pserver's storage role):
        #    accumulators above min_block_size become ZeRO-sharded via the
        #    Reduce strategy (reference: slice_variable ≥8KB blocks,
        #    distribute_transpiler.py:67-110).
        if self.config.slice_var_up:
            plan.build_strategy.reduce_strategy = ReduceStrategy.Reduce
            for v in gb.vars.values():
                if (getattr(v, "is_accumulator", False) and v.shape
                        and _numel(v.shape) * 4 < self.config.min_block_size):
                    # too small to be worth slicing: pin replicated, which
                    # overrides the Reduce-strategy default in
                    # ParallelExecutor._var_sharding (reference kept such
                    # vars unsplit too, distribute_transpiler.py:67-110)
                    spec = (None,) * len(v.shape)
                    v.sharding_spec = spec
                    plan.var_specs[v.name] = spec
        self._plan = plan
        return plan

    # -- role programs (unified under SPMD) ----------------------------
    def get_trainer_program(self) -> Program:
        """reference: distribute_transpiler.py:320."""
        enforce(self._program is not None, "call transpile() first")
        return self._program

    def get_pserver_program(self, endpoint: str = "") -> Program:
        """reference: distribute_transpiler.py:333. Under SPMD the pserver
        role is played by every device's shard of optimizer state; the
        program is identical to the trainer program."""
        enforce(self._program is not None, "call transpile() first")
        return self._program

    def get_startup_program(self, endpoint: str = "",
                            pserver_program: Optional[Program] = None
                            ) -> Program:
        """reference: distribute_transpiler.py:531."""
        from ..core.program import default_startup_program
        return default_startup_program()


# -- parity shims for the reference's pserver placement policies -------------
# (reference: transpiler/ps_dispatcher.py:16,44,68). Useful when users want a
# deterministic var→shard mapping for debugging/inspection.

class PSDispatcher:
    def __init__(self, eplist: Sequence[str]):
        self._eplist = list(eplist)
        self._step = 0

    @property
    def eplist(self) -> List[str]:
        return self._eplist

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class HashName(PSDispatcher):
    """reference: ps_dispatcher.py:44."""

    def dispatch(self, varlist):
        # crc32, not hash(): stable across processes so every trainer
        # computes the same var→shard mapping
        return [self._eplist[
            zlib.crc32(str(getattr(v, "name", v)).encode())
            % len(self._eplist)] for v in varlist]


class RoundRobin(PSDispatcher):
    """reference: ps_dispatcher.py:68."""

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eplist[self._step % len(self._eplist)])
            self._step += 1
        return out
