"""Recompile-hazard lint: feed shapes that force a new capture per batch
(counterpart of paddle_tpu/analysis/recompile.py, the same lint and
messages).

In the JAX package a hazardous feed is a new XLA compile. In the port
the same feed is a new CUDA-graph capture: ``Executor.run_graph`` keys
its graphs on the feed names and shapes (one bucket per key, the
decode engine's buckets) and ``Executor.run_steps`` on the feed shapes
(one graph per key), so each distinct shape runs an eager step and a
capture before it replays. The lint's semantics and messages are kept
as they are — "executable" and "compile" read as "captured graph" and
"capture" here. The serving layer's answer is bucketing (pad the batch
axis to a small pre-captured set); this lint statically flags the
hazards bucketing does NOT cover, cross-checked against a bucket
config:

  * a feed with no declared shape — every request shape is a new
    capture;
  * a dynamic (-1) extent on a NON-batch axis — engine buckets only pad
    the leading axis, so e.g. a free sequence-length axis captures per
    distinct length (pad/bucket it in the data pipeline instead);
  * with ``strict_batch=True`` (serving-oriented callers): a dynamic
    batch axis with no bucket config. A fixed-batch training loop never
    trips this, so it is opt-in — the default checks stay silent on
    clean training programs.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from ..core.program import Program
from . import diagnostics as diag
from .diagnostics import Diagnostic


def _feed_vars(program: Program, feed_names: Optional[Iterable[str]]):
    gb = program.global_block()
    if feed_names:
        out = []
        for n in feed_names:
            v = gb._find_var_recursive(getattr(n, "name", n))
            if v is not None:
                out.append(v)
        return out
    return [v for v in gb.vars.values() if v.is_data]


def find_recompile_hazards(program: Program,
                           feed_names: Optional[Iterable[str]] = None,
                           buckets: Optional[Sequence[int]] = None,
                           strict_batch: bool = False
                           ) -> List[Diagnostic]:
    """Lint the program's feed surface for shapes that defeat the compile
    cache. ``buckets`` is the serving engine's bucket config when one
    exists (engine cross-check); None means no bucketing layer.
    ``strict_batch`` additionally treats an unbucketed dynamic batch
    axis as a hazard (serving-oriented callers)."""
    out: List[Diagnostic] = []
    for v in _feed_vars(program, feed_names):
        if v.shape is None:
            out.append(Diagnostic(
                diag.WARNING, diag.RECOMPILE_HAZARD,
                "feed has no declared shape — every distinct request "
                "shape compiles a new executable; declare the shape "
                "(dynamic batch as -1) so the cache can specialize once",
                var=v.name))
            continue
        # an engine layer that pads a non-batch axis onto a precompiled
        # set declares so on the var (``bucketed_axes`` — e.g. the
        # decoding rewrite's prompt-bucketed token feed); those axes are
        # covered, not hazardous
        covered = set(getattr(v, "bucketed_axes", ()) or ())
        dyn_nonbatch = [i for i, s in enumerate(v.shape)
                        if s == -1 and i != 0 and i not in covered]
        if dyn_nonbatch:
            out.append(Diagnostic(
                diag.WARNING, diag.RECOMPILE_HAZARD,
                f"dynamic extent on non-batch axis(es) {dyn_nonbatch} of "
                f"declared shape {v.shape} — serving buckets only pad "
                "the leading batch axis, so each distinct length "
                "recompiles; pad or bucket this axis in the data "
                "pipeline",
                var=v.name))
        if strict_batch and v.shape and v.shape[0] == -1 \
                and buckets is None:
            out.append(Diagnostic(
                diag.WARNING, diag.RECOMPILE_HAZARD,
                f"dynamic batch axis with no bucket config (shape "
                f"{v.shape}) — a raw Executor loop over ragged batch "
                "sizes compiles one executable per size; serve through "
                "serving.BucketedEngine or pad batches to a fixed set",
                var=v.name))
        if buckets and v.shape and v.shape[0] not in (-1, *buckets):
            out.append(Diagnostic(
                diag.WARNING, diag.RECOMPILE_HAZARD,
                f"declared batch axis is pinned to {v.shape[0]}, which "
                f"is not one of the buckets {sorted(buckets)} — every "
                "padded bucket execution would compile a FRESH "
                "executable for this feed instead of reusing the "
                "bucket's; declare the batch axis as -1",
                var=v.name))
    return out


def check_dataloader_shapes(program: Program,
                            feed_names: Iterable[str],
                            batch_size: Optional[int] = None,
                            drop_last: bool = True) -> List[Diagnostic]:
    """Cross-check a reader.DataLoader's fixed batch shape against the
    program's declared feed surface (called from DataLoader at
    construction, the same way serving.BucketedEngine cross-checks its
    bucket config): a loader whose batch size the program cannot absorb
    compiles a FRESH executable per loader batch instead of reusing one.

    Hazards on top of the base lint (undeclared shapes, dynamic non-batch
    axes): a declared batch axis PINNED to a size different from the
    loader's, and ``drop_last=False`` batching upstream of the loader
    (the ragged tail batch is its own compiled shape)."""
    feed_names = tuple(feed_names)  # iterated twice; survive generators
    out = find_recompile_hazards(program, feed_names=feed_names)
    if batch_size:
        gb = program.global_block()
        for n in feed_names:
            v = gb._find_var_recursive(getattr(n, "name", n))
            if v is None or not v.shape:
                continue
            if v.shape[0] not in (-1, int(batch_size)):
                out.append(Diagnostic(
                    diag.WARNING, diag.RECOMPILE_HAZARD,
                    f"declared batch axis is pinned to {v.shape[0]} but "
                    f"the DataLoader delivers fixed batches of "
                    f"{batch_size} — every loader batch compiles a fresh "
                    "executable instead of hitting the cached step; "
                    "declare the batch axis as -1 or match the loader's "
                    "batch size", var=v.name))
    if not drop_last:
        out.append(Diagnostic(
            diag.WARNING, diag.RECOMPILE_HAZARD,
            "drop_last=False: the ragged tail batch of each pass has its "
            "own shape and compiles a second executable — drop the tail "
            "or pad it to the loader's batch size"))
    return out


def check_decode_feeds(program: Program,
                       feed_names: Iterable[str],
                       token_name: Optional[str] = None
                       ) -> List[Diagnostic]:
    """Cross-check a derived prefill/decode program's feed surface
    (called from decoding.DecodeEngine at construction). The engine
    buckets BOTH axes of the token feed (batch buckets x prompt
    buckets), so a dynamic token shape is fine; what remains hazardous:

      * an undeclared feed shape (every request shape compiles fresh);
      * a dynamic NON-batch axis on an auxiliary feed — the block-table
        width is the static gather/scatter window and MUST be pinned by
        the CacheConfig, or every admission mix recompiles;
      * a pinned batch axis (defeats the batch buckets).
    """
    out: List[Diagnostic] = []
    gb = program.global_block()
    for n in feed_names:
        name = getattr(n, "name", n)
        v = gb._find_var_recursive(name)
        if v is None or v.shape is None:
            out.append(Diagnostic(
                diag.WARNING, diag.RECOMPILE_HAZARD,
                "decode-pair feed has no declared shape — every "
                "distinct request shape compiles a new executable",
                var=name))
            continue
        if v.shape[0] != -1:
            out.append(Diagnostic(
                diag.WARNING, diag.RECOMPILE_HAZARD,
                f"decode-pair feed batch axis is pinned to {v.shape[0]}"
                " — the engine's batch buckets cannot absorb it",
                var=name))
        if name == token_name:
            continue  # both token axes are bucketed by the engine
        dyn_nonbatch = [i for i, s in enumerate(v.shape)
                        if s == -1 and i != 0]
        if dyn_nonbatch:
            out.append(Diagnostic(
                diag.WARNING, diag.RECOMPILE_HAZARD,
                f"dynamic extent on non-batch axis(es) {dyn_nonbatch} "
                f"of decode-pair feed (declared {v.shape}) — the "
                "block-table window must be static (CacheConfig."
                "max_blocks_per_seq) or each admission mix recompiles",
                var=name))
    return out


def check_serving_buckets(program: Program,
                          feed_names: Iterable[str],
                          buckets: Sequence[int]) -> List[Diagnostic]:
    """Cross-check a Program's feed surface against a serving bucket
    config (called from serving.engine at construction): the buckets
    absorb DYNAMIC batch-axis variation, so what remains hazardous is a
    feed the config cannot cover — an undeclared shape, a dynamic
    non-batch axis, or a batch axis pinned to a concrete size outside
    the bucket set."""
    return find_recompile_hazards(program, feed_names=feed_names,
                                  buckets=list(buckets),
                                  strict_batch=True)
