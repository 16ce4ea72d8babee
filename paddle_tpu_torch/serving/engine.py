"""Bucketed inference engine (counterpart of
paddle_tpu/serving/engine.py): pad any feed batch to a small set of
bucket shapes, so arbitrary traffic runs on a handful of prepared
executables instead of one per batch size.

Two backends. The program backend: an in-memory Program run through a
dedicated :class:`~paddle_tpu_torch.executor.Executor`. The artifact
backend (``from_artifact``): a ``save_inference_model`` directory run
through ``inference.NativePredictor``, its exported program per bucket.
On a card each bucket is one captured CUDA graph (``Executor.run_graph``
or the predictor's) — the counterpart of the JAX package's one compiled
executable per bucket — so ``compile_count`` counts captures,
``warm_up()`` captures every bucket, and traffic replays them. On the
CPU both run eagerly (``compile_count`` stays 0), since the CPU was
asked for.

The engine is the single-threaded execution layer — the server's
worker thread is its only caller after ``warm_up``.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.enforce import enforce
from ..resilience import faults
from .metrics import ServingMetrics

ENGINE_SPAN = "serving/engine"
COMPILE_SPAN = "serving/engine.compile"


def default_buckets(max_batch_size: int) -> List[int]:
    """Powers of two up to ``max_batch_size``, always including it."""
    enforce(max_batch_size >= 1, "max_batch_size must be >= 1")
    buckets = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


class ServingConfig:
    """Knobs for the serving stack (engine + batcher + server).

    buckets: batch sizes to prepare; feed batches are padded up to the
        next bucket. Default: powers of two up to ``max_batch_size``.
    max_batch_size: cap on coalesced rows per executed batch (the
        largest bucket when ``buckets`` is given).
    batch_timeout_ms: how long the batcher waits for more requests
        before flushing a partial batch.
    queue_capacity: bound on the request queue; submits beyond it are
        rejected with QueueFullError (backpressure).
    default_deadline_ms: per-request deadline applied when a request
        doesn't carry its own; None = no deadline.
    warm_up: prepare (on a card: capture) every bucket when the server
        starts, so the first real request never pays a capture.
    breaker: a ``resilience.CircuitBreaker`` (closed→open on error rate
        or queue saturation, half-open probes; open sheds load with the
        retriable CircuitOpenError). None = no breaker.
    degrade: a ``resilience.DegradationConfig`` (or a built
        ``DegradationManager``): on the plain serving tier the active
        rung is stage-4 shedding of low-priority submits. None =
        disabled.
    """

    def __init__(self, max_batch_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 batch_timeout_ms: float = 2.0,
                 queue_capacity: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 warm_up: bool = True,
                 breaker=None,
                 degrade=None):
        if buckets:
            self.buckets = sorted(set(int(b) for b in buckets))
            enforce(self.buckets[0] >= 1, "buckets must be >= 1")
            self.max_batch_size = self.buckets[-1]
        else:
            self.max_batch_size = int(max_batch_size)
            self.buckets = default_buckets(self.max_batch_size)
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self.warm_up = bool(warm_up)
        self.breaker = breaker
        self.degrade = degrade


class BucketedEngine:
    """Pads feed batches to bucket shapes, runs them on one of the two
    backends, and slices the fetches back to the true batch size."""

    def __init__(self, config: Optional[ServingConfig] = None, *,
                 predictor=None, program=None,
                 feed_names: Optional[Sequence[str]] = None,
                 fetch_list: Optional[Sequence] = None,
                 scope=None, place=None,
                 metrics: Optional[ServingMetrics] = None):
        self.config = config or ServingConfig()
        self.metrics = metrics or ServingMetrics()
        self.buckets = list(self.config.buckets)
        # bucket size -> tuple of fetch leading dims (calibration data
        # for batched_fetch_mask)
        self._fetch_lead: Dict[int, tuple] = {}
        enforce((predictor is None) != (program is None),
                "BucketedEngine needs exactly one backend: predictor= "
                "(artifact) or program= (in-memory)")
        self._predictor = predictor
        self._program = None
        if predictor is not None:
            self.device = predictor.device
            self.feed_names = list(predictor.feed_names)
            self.fetch_names = list(predictor.fetch_names)
            self._feed_meta = {
                n: (tuple(predictor._feed_meta[n]["shape"] or ()),
                    predictor._feed_meta[n]["dtype"])
                for n in self.feed_names}
            return
        from ..analysis import check_serving_buckets
        from ..core.program import Program
        from ..core.scope import global_scope
        from ..executor import Executor

        enforce(isinstance(program, Program), "program= must be a Program")
        enforce(feed_names, "the program backend needs feed_names=")
        enforce(fetch_list, "the program backend needs fetch_list=")
        self._program = program
        self._scope = scope if scope is not None else global_scope()
        self._executor = Executor(place)
        self.device = self._executor.device
        self.feed_names = [str(n) for n in feed_names]
        self.fetch_names = [v.name if hasattr(v, "name") else str(v)
                            for v in fetch_list]
        gb = program.global_block()
        self._feed_meta = {}
        for n in self.feed_names:
            v = gb._find_var_recursive(n)
            enforce(v is not None and v.shape is not None,
                    "feed %r has no declared shape in the program — the "
                    "engine needs shapes to pad to buckets" % n)
            enforce(len(v.shape) >= 1 and v.shape[0] == -1,
                    "feed %r must have a leading batch axis (declared "
                    "shape %s)" % (n, (v.shape,)))
            self._feed_meta[n] = (tuple(v.shape), v.dtype)
        # static recompile-hazard cross-check against this bucket
        # config: a hazard left after the buckets absorb the batch axis
        # (a dynamic non-batch axis) would defeat warm_up's "one
        # capture per bucket"
        for d in check_serving_buckets(program, self.feed_names,
                                       self.buckets):
            warnings.warn(f"serving engine: {d}")

    # ------------------------------------------------------------------
    @classmethod
    def from_artifact(cls, model_dir: str,
                      config: Optional[ServingConfig] = None,
                      device: int = 0,
                      metrics: Optional[ServingMetrics] = None,
                      place=None) -> "BucketedEngine":
        """Engine over a ``save_inference_model`` directory, through
        ``inference.NativePredictor`` on ``cuda:<device>`` (``place``,
        when given, picks the device instead: ``CPUPlace()`` runs on the
        CPU). With ``config`` None the buckets are the artifact's own
        (``available_batch_sizes()``), so warm-up captures exactly the
        exported set."""
        from ..inference import NativeConfig, create_paddle_predictor

        if place is not None:
            dev = place.torch_device()
            use_gpu, device = dev.type == "cuda", dev.index or 0
        else:
            use_gpu = True
        pred = create_paddle_predictor(
            NativeConfig(model_dir=model_dir, use_gpu=use_gpu, device=device))
        if config is None:
            config = ServingConfig(buckets=pred.available_batch_sizes())
        return cls(config, predictor=pred, metrics=metrics)

    @classmethod
    def from_program(cls, program, feed_names: Sequence[str],
                     fetch_list: Sequence,
                     scope=None, config: Optional[ServingConfig] = None,
                     place=None,
                     metrics: Optional[ServingMetrics] = None
                     ) -> "BucketedEngine":
        return cls(config, program=program, feed_names=feed_names,
                   fetch_list=fetch_list, scope=scope, place=place,
                   metrics=metrics)

    # ------------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """CUDA graphs captured, one per bucket run (0 on the CPU)."""
        if self._predictor is not None:
            return self._predictor.compile_count
        return self._executor.num_compiled

    @property
    def max_batch_size(self) -> int:
        return self.config.max_batch_size

    @property
    def batched_fetch_mask(self):
        """Per fetch: does the leading dim track the batch? Calibrated
        from runs at two different bucket sizes (a fetch whose leading
        dim is the same at bucket 4 and bucket 8 is NOT batch-major,
        even if it equals one bucket). None until two distinct buckets
        have run — callers fall back to the leading-dim heuristic."""
        sizes = [b for b in self._fetch_lead if self._fetch_lead[b]]
        for b1 in sizes:
            for b2 in sizes:
                if b1 < b2:
                    l1, l2 = self._fetch_lead[b1], self._fetch_lead[b2]
                    return [a != c for a, c in zip(l1, l2)]
        return None

    def bucket_for(self, batch: int) -> Optional[int]:
        """Smallest bucket >= batch, or None when batch exceeds all."""
        for b in self.buckets:
            if b >= batch:
                return b
        return None

    # ------------------------------------------------------------------
    def warm_up(self) -> int:
        """Run every bucket once with zero feeds (on a card: capture its
        graph), so startup — not the first user — pays. Returns
        ``compile_count``.

        Consults the persistent tuning store FIRST: tuned kernel configs
        prefetch into the in-process memo, so the bucket runs about to
        capture resolve their launch configs from memory and the first
        capture already uses them. (An artifact backend's predictor
        seeded them from its manifest when it loaded.)"""
        if self._program is not None:
            from .. import tuning as _tuning

            _tuning.prefetch(self._program)
        with self.metrics.span(COMPILE_SPAN):
            for b in self.buckets:
                self.run(self._dummy_feed(b), _warm=True)
        return self.compile_count

    def _dummy_feed(self, batch: int) -> Dict[str, np.ndarray]:
        from ..core import dtype_utils

        feed = {}
        for n, (shape, dtype) in self._feed_meta.items():
            full = tuple(batch if i == 0 else (1 if s == -1 else s)
                         for i, s in enumerate(shape))
            # numpy has no bfloat16: a bf16 feed is fed as f32 and cast
            name = dtype_utils.name(dtype)
            feed[n] = np.zeros(full, dtype="float32" if name == "bfloat16"
                               else name)
        return feed

    # ------------------------------------------------------------------
    def run(self, feed: Dict[str, np.ndarray],
            _warm: bool = False) -> List[np.ndarray]:
        """Run one feed batch: pad rows up to the next bucket (by
        repeating the last row, so padded rows stay in-domain), run that
        bucket, slice the fetches back. Batches beyond the largest
        bucket run in largest-bucket chunks."""
        missing = [n for n in self.feed_names if n not in feed]
        enforce(not missing, "missing feeds: %s" % missing)
        arrays = {n: np.asarray(feed[n]) for n in self.feed_names}
        batch = next(iter(arrays.values())).shape[0]
        for n, a in arrays.items():
            enforce(a.ndim >= 1 and a.shape[0] == batch,
                    "feed %r batch %s disagrees with %s"
                    % (n, a.shape[0] if a.ndim else None, batch))

        bucket = self.bucket_for(batch)
        if bucket is None:
            # oversize request: largest-bucket chunks + a bucketed tail;
            # only batch-major fetches concatenate — a non-batched fetch
            # (per the calibrated mask) is the same in every chunk and
            # comes back once
            step = self.buckets[-1]
            chunks: List[List[np.ndarray]] = []
            for s in range(0, batch, step):
                chunks.append(self.run(
                    {n: a[s:s + step] for n, a in arrays.items()}))
            mask = self.batched_fetch_mask
            outs = []
            for i in range(len(chunks[0])):
                batched = (mask[i] if mask is not None and i < len(mask)
                           else getattr(chunks[0][i], "ndim", 0) >= 1)
                outs.append(np.concatenate([c[i] for c in chunks], axis=0)
                            if batched else chunks[0][i])
            return outs

        pad = bucket - batch
        if pad:
            arrays = {n: np.concatenate(
                [a, np.repeat(a[-1:], pad, axis=0)], axis=0)
                for n, a in arrays.items()}
        if not _warm:
            self.metrics.inc("padded_rows_total", pad)
            self.metrics.inc("batched_rows_total", bucket)
            # chaos hook: a "raise" travels the batcher's poison
            # isolation and feeds the server's circuit breaker
            faults.fire("serving.step")

        with self.metrics.span(ENGINE_SPAN,
                               None if _warm
                               else self.metrics.batch_execute):
            outs = self._execute(arrays)
        if bucket not in self._fetch_lead:
            self._fetch_lead[bucket] = tuple(
                o.shape[0] if getattr(o, "ndim", 0) else None
                for o in outs)
        if pad:
            mask = self.batched_fetch_mask
            outs = [
                o[:batch]
                if (hasattr(o, "ndim") and o.ndim >= 1
                    and o.shape[0] == bucket
                    and (mask is None or (i < len(mask) and mask[i])))
                else o
                for i, o in enumerate(outs)]
        return outs

    def _execute(self, arrays: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """One bucket: its captured graph on a card, eagerly on the
        CPU."""
        if self._predictor is not None:
            return self._predictor.run_batch(arrays)
        return self._executor.run_graph(self._program, feed=arrays,
                                        fetch_list=list(self.fetch_names),
                                        scope=self._scope)
