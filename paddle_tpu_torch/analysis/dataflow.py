"""Shared def-use / dataflow utilities over an op list (counterpart of
paddle_tpu/analysis/dataflow.py, the same functions).

The inference passes (passes/fusion.py: the fuse-pass pattern matchers
and dead-code elimination) resolve producers and consumers through
these primitives.

Reference: the graph helpers under paddle/fluid/framework/ir/
(graph_helper.h BuildOperationAdjList / HasCircle) and the
ControlFlowGraph inside transpiler/memory_optimization_transpiler.py:35
(uses/defs/live_in/live_out sets per op) — collapsed here onto the
Program IR's flat op list, where execution order IS program order.

Everything in this module is duck-typed over objects exposing
``input_arg_names`` / ``output_arg_names`` (core.program.Operator) and
deliberately imports nothing from the rest of the package.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Set


def consumer_counts(ops: Sequence) -> Dict[str, int]:
    """name -> number of ops reading it (structural fn=None ops count:
    they mark feed/fetch boundaries that must stay intact)."""
    counts: Dict[str, int] = {}
    for op in ops:
        for n in op.input_arg_names:
            counts[n] = counts.get(n, 0) + 1
    return counts


def producer_index(ops: Sequence) -> Dict[str, int]:
    """name -> index of the op producing it (last write wins, matching
    execution order)."""
    prod: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names:
            prod[n] = i
    return prod


class DefUse:
    """Per-name def/use positions over one op list (reference: the
    ControlFlowGraph's _uses/_defs in
    memory_optimization_transpiler.py:35, precomputed once instead of
    per-op set algebra).

    defs[name]  — ascending op indices that WRITE name
    uses[name]  — ascending op indices that READ name
    first_def / last_def / first_use / last_use — derived extrema
    (missing names are absent from the dicts; use .get()).
    """

    def __init__(self, ops: Sequence):
        self.defs: Dict[str, List[int]] = {}
        self.uses: Dict[str, List[int]] = {}
        for i, op in enumerate(ops):
            for n in op.input_arg_names:
                self.uses.setdefault(n, []).append(i)
            for n in op.output_arg_names:
                self.defs.setdefault(n, []).append(i)
        self.first_def = {n: idx[0] for n, idx in self.defs.items()}
        self.last_def = {n: idx[-1] for n, idx in self.defs.items()}
        self.first_use = {n: idx[0] for n, idx in self.uses.items()}
        self.last_use = {n: idx[-1] for n, idx in self.uses.items()}

    def names(self) -> Set[str]:
        return set(self.defs) | set(self.uses)


def compute_def_use(ops: Sequence) -> DefUse:
    return DefUse(ops)


def backward_live_ops(ops: Sequence, roots: Iterable[str],
                      is_effectful: Callable) -> List[bool]:
    """Mark-live sweep from the back: op i is live when it is effectful
    (``is_effectful(op)``) or writes a name demanded by a live op/root.
    Returns a keep-mask aligned with ``ops``.

    This is the single liveness kernel behind DeadCodeEliminatePass and
    Program.prune-style queries (reference: framework/ir/graph_helper +
    the analysis passes' ir_graph_clean).
    """
    live: Set[str] = set(roots)
    keep = [False] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        if is_effectful(op) or any(n in live for n in op.output_arg_names):
            keep[i] = True
            live.update(op.input_arg_names)
    return keep


def live_intervals(ops: Sequence, entry_live: Iterable[str],
                   exit_live: Iterable[str]) -> Dict[str, tuple]:
    """name -> (start, end) op-index interval during which the value is
    resident, under the convention that a value is live DURING the op
    that defines it and DURING the op that last reads it.

    ``entry_live`` names (feeds, scope state) are resident from op 0;
    ``exit_live`` names (fetch targets, written-back state) stay
    resident through the last op. Names that are never defined nor
    listed in ``entry_live`` get no interval.
    """
    du = compute_def_use(ops)
    entry = set(entry_live)
    exit_ = set(exit_live)
    n_ops = len(ops)
    out: Dict[str, tuple] = {}
    for name in du.names() | entry | exit_:
        if name in entry:
            start = 0
        elif name in du.first_def:
            start = du.first_def[name]
        else:
            continue  # read but never defined and not a program input
        if name in exit_:
            end = n_ops - 1
        else:
            end = max(du.last_use.get(name, start),
                      du.last_def.get(name, start))
        out[name] = (start, end)
    return out
