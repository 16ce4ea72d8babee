"""Ordered regex partition rules: names -> PartitionSpecs (counterpart
of paddle_tpu/sharding/rules.py, the same pure logic: its results equal
the JAX package's).

The GSPMD annotation workflow (PAPERS.md [GSPMD]): the user states
*where* a handful of tensors live as ``PartitionSpec``s and the compiler
propagates layouts to everything else. Rules here follow the
``match_partition_rules`` idiom (SNIPPETS [1]): an ordered list of
``(regex, spec)`` pairs searched first-match against a tensor's *name*
— the one addressing scheme this IR already keys everything on
(feed/fetch, checkpoints, scope state), so a rule set written for the
"fc"/"embedding" name families covers params, their ``@GRAD``s, their
optimizer moments (``<param>_moment1_0``) and their AMP bf16 copies
(``<param>@amp.bf16``) in one line.

Specs are written mesh-agnostically (axis *names*); resolution against
a concrete mesh (``clean_spec``) drops axes the mesh lacks and axes
that do not divide the dimension evenly, so one rule set serves every
mesh shape from 1 device (everything replicated — the no-op identity
the executor tests pin) to a pod.

:class:`SpecLayout` (SNIPPETS [3]) bundles the canonical transformer
placements over the ``data``/``fsdp``/``tp`` axes; ``digest()`` of a
rule set feeds the compile-cache stamp (plan.py).
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from .mesh import DATA_AXIS, DeviceMesh, FSDP_AXIS, Layout, TP_AXIS

# one rule: (regex searched against the variable name, spec entries).
# Spec entries are axis names, tuples of axis names, or None, exactly
# like PartitionSpec arguments.
Rule = Tuple[str, Tuple]


@dataclass(frozen=True)
class SpecLayout:
    """Canonical PartitionSpecs for transformer params and activations
    over a DP x FSDP x TP mesh (SNIPPETS [3] SpecLayout)."""

    data_axis: str = DATA_AXIS
    fsdp_axis: str = FSDP_AXIS
    tp_axis: str = TP_AXIS

    def batch(self) -> Tuple:
        """Activations: batch dim split over data x fsdp (the ZeRO
        convention: fsdp is a data-parallel axis for compute)."""
        return ((self.data_axis, self.fsdp_axis),)

    def embeddings(self) -> Tuple:
        """Embedding tables: vocab rows sharded over fsdp x tp."""
        return ((self.fsdp_axis, self.tp_axis), None)

    def column_parallel(self) -> Tuple:
        """[in, out] weights with out-features sharded over tp (QKV and
        FFN-up projections); in-features carry the fsdp shard."""
        return (self.fsdp_axis, self.tp_axis)

    def row_parallel(self) -> Tuple:
        """[in, out] weights with in-features sharded over tp (attention
        output and FFN-down projections)."""
        return (self.tp_axis, self.fsdp_axis)

    def bias(self) -> Tuple:
        return (None,)


def default_rules(layout: Optional[SpecLayout] = None) -> List[Rule]:
    """Ordered rules for this repo's layer name families (LayerHelper
    names params "<layer_type>.<w|b>_<i>": layers.fc -> "fc.w_0"/
    "fc.b_0", layers.embedding -> "embedding.w_0", models.transformer's
    "src_word_emb_table"/"trg_word_emb_table"). Because moments and AMP
    copies embed the param name ("fc.w_0_moment1_0", "fc.w_0@amp.bf16"),
    one rule covers the whole family. First match wins; the trailing
    catch-all replicates, so unmatched tensors are never an error with
    this set (ZeRO still fsdp-shards replicated accumulators, plan.py)."""
    lay = layout or SpecLayout()
    return [
        (r"emb_table|embedding\.w_\d+", lay.embeddings()),
        (r"fc\.w_\d+", lay.column_parallel()),
        (r"fc\.b_\d+", lay.bias()),
        (r".*", ()),  # replicate everything else
    ]


def match_partition_rules(rules: Sequence[Rule], name: str,
                          shape: Optional[Sequence[int]] = None
                          ) -> Optional[Tuple]:
    """First-match spec for ``name`` (SNIPPETS [1] match_partition_rules,
    searched in order with ``re.search``). Scalars and 1-element tensors
    are never partitioned. Returns None when no rule matches — callers
    decide whether that is an error or "replicate"."""
    if shape is not None and (len(shape) == 0
                              or int(np.prod([abs(int(s)) or 1
                                              for s in shape])) == 1):
        return ()
    for pat, spec in rules:
        if re.search(pat, name) is not None:
            return tuple(spec)
    return None


def clean_spec(mesh: DeviceMesh, spec: Sequence, shape: Optional[Sequence]
               ) -> Tuple:
    """Resolve a mesh-agnostic spec against a concrete mesh and shape:
    axes the mesh lacks are dropped; axes (or axis groups) whose product
    does not divide the dimension evenly are dropped (GSPMD supports
    uneven shards, but an indivisible annotation on optimizer state
    would break the ≈1/N per-device HBM contract silently — dropping is
    the honest degradation); entries beyond the rank are trimmed."""
    if shape is None:
        return ()
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            out.append(None)
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        axes = tuple(a for a in axes if mesh.size(a) > 1)
        prod = int(np.prod([mesh.size(a) for a in axes])) if axes else 1
        if not axes or int(dim) < 0 or int(dim) % prod != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def dropped_axes(mesh: DeviceMesh, spec: Sequence,
                 shape: Optional[Sequence]) -> Tuple:
    """``(axis, dim_idx)`` pairs ``clean_spec`` silently drops for
    *provable indivisibility* — axes the mesh simply lacks are NOT
    reported (mesh-agnostic rules are meant to degrade that way), and
    dynamic dims are NOT reported (constraint fns re-clean against the
    traced shape, which may divide fine). This is the observable half
    of the clean_spec contract: the plan warns through it once per
    (var, axis), and the comm analyzer turns the same pairs into
    ``comm-indivisible-replication`` lints."""
    if shape is None:
        return ()
    out = []
    for dim_idx, (dim, entry) in enumerate(
            zip(shape, tuple(spec) + (None,) * len(shape))):
        if entry is None or int(dim) < 0:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        axes = tuple(a for a in axes if mesh.size(a) > 1)
        if not axes:
            continue
        prod = int(np.prod([mesh.size(a) for a in axes]))
        if int(dim) % prod != 0:
            out.extend((a, dim_idx) for a in axes)
    return tuple(out)


def resolve_sharding(mesh: DeviceMesh, spec: Sequence,
                     shape: Optional[Sequence]) -> Layout:
    """Layout for a cleaned spec (replicated when nothing sticks)."""
    return Layout(mesh, clean_spec(mesh, spec, shape))


def shard_count(mesh: DeviceMesh, spec: Sequence,
                shape: Optional[Sequence]) -> int:
    """How many equal shards the cleaned spec splits a tensor into —
    the divisor the per-device HBM report (analysis.liveness) applies."""
    n = 1
    for entry in clean_spec(mesh, spec, shape):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        for a in axes:
            n *= mesh.size(a)
    return n


def rules_digest(rules: Sequence[Rule]) -> str:
    """Stable content digest of an ordered rule set — composed with the
    mesh shape into the compile-cache sharding stamp (plan.py), so a
    changed rule set can never resolve a stale executable."""
    h = hashlib.sha256()
    for pat, spec in rules:
        h.update(repr((pat, tuple(spec))).encode())
    return h.hexdigest()[:16]
