"""DataLoader: the overlapped training input pipeline (counterpart of
paddle_tpu/reader/dataloader.py; reference: the py_reader +
double_buffer chain, operators/reader/buffered_reader.cc,
lod_tensor_blocking_queue.h:31).

A background thread runs reader iteration, ``DataFeeder`` conversion
and the copy to the card (``prefetch.DeviceCopier``: pinned host memory,
a CUDA stream of the loader's own) while the card runs the current
step, keeping ``buffer_size`` batches in flight. The loader plugs into
the executor: ``Executor.run(feed=loader)`` consumes one batch a call,
or ``chunk`` of them as one ``run_steps`` call (a captured CUDA graph
replayed over the chunk on the card), so host input latency hides
behind the card's work.

In-flight accounting is EXACT: the worker acquires a slot from a
``buffer_size``-token semaphore *before* pulling the next reader item,
so at most ``buffer_size`` undelivered batches ever exist. Consumer
waits are measured (``feed_wait`` profiler spans, the stall fraction of
:class:`PipelineMetrics`); the worker's conversion and queued copy is
the ``h2d`` span.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dtype_utils
from ..core.enforce import enforce
from ..core.place import default_place
from ..core.program import Program, Variable
from ..profiler import RecordEvent
from .prefetch import DeviceCopier, overlap_iter

__all__ = ["DataLoader", "PipelineMetrics"]


class _Histogram:
    """Millisecond samples with a count/mean/p50/p99/max snapshot."""

    def __init__(self):
        self._ms: List[float] = []

    def observe(self, ms: float) -> None:
        self._ms.append(float(ms))

    def snapshot(self) -> Dict[str, float]:
        if not self._ms:
            return {"count": 0}
        a = np.asarray(self._ms)
        return {"count": int(a.size), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)), "max": float(a.max())}


class PipelineMetrics:
    """Input-pipeline counters of one DataLoader: how often and how long
    the consumer stalled waiting on data, and how long the worker spent
    converting and queueing copies. The JAX package homes these in its
    process-wide ``obs`` registry; the port has none, so they live here
    (``report()`` has the same keys)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.batches_total = 0       # batches delivered to the consumer
        self.stall_waits = 0         # gets that actually blocked (>1 ms)
        self.feed_wait = _Histogram()
        self.h2d = _Histogram()
        self._wait_s = 0.0
        self._first_get: Optional[float] = None
        self._last_get: Optional[float] = None

    def record_wait(self, t0: float, t1: float) -> None:
        with self._lock:
            dt = t1 - t0
            self._wait_s += dt
            self.feed_wait.observe(dt * 1e3)
            if dt > 1e-3:
                self.stall_waits += 1
            if self._first_get is None:
                self._first_get = t0
            self._last_get = t1
            self.batches_total += 1

    def record_h2d(self, dt_s: float) -> None:
        with self._lock:
            self.h2d.observe(dt_s * 1e3)

    def stall_fraction(self) -> float:
        """Fraction of the consumer's wall time (first to last batch pull)
        spent blocked waiting for data. ~0: the pipeline hides host input
        latency behind the card's work; ~1: the consumer is input-bound
        (grow buffer_size, cheapen the reader, or raise ``chunk``)."""
        with self._lock:
            if self._first_get is None or self._last_get is None:
                return 0.0
            wall = self._last_get - self._first_get
            if wall <= 0.0:
                return 0.0
            return min(1.0, self._wait_s / wall)

    def report(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                "batches_total": self.batches_total,
                "stall_waits": self.stall_waits,
                "feed_wait": self.feed_wait.snapshot(),
                "h2d": self.h2d.snapshot(),
            }
        out["stall_fraction"] = round(self.stall_fraction(), 4)
        return out


class DataLoader:
    """Overlapped reader -> DataFeeder -> device pipeline.

    Args:
        reader: a reader creator (zero-arg callable returning an iterable)
            or a plain iterable. Items are either minibatches in the
            ``paddle.batch`` convention (a list of per-sample slot tuples,
            converted through the ``DataFeeder``) or ready feed dicts
            (name -> array; used as-is after the copy).
        feed_list: program Variables (or names) the batches bind, in slot
            order — required for tuple-style batches, optional for
            dict-style ones.
        place: target place (default ``CUDAPlace(0)``).
        program: the Program the feeds belong to (defaults to the current
            main program when ``feed_list`` holds names).
        buffer_size: batches kept in flight by the background worker
            (default: the ``dataloader_buffer_size`` flag).
        chunk: when > 1, ``Executor.run(feed=loader)`` runs this many
            batches as one ``run_steps`` call; fetches come back with a
            leading ``chunk`` axis.
        drop_last: drop a ragged tail batch so every delivered batch has
            one shape (tuple-style batches; dict-style readers batch for
            themselves).
        check_recompile: warn, once the first batch's size is known, of
            feed shapes that make run_steps capture a graph per batch
            (``analysis.check_dataloader_shapes``).
    """

    _pdtpu_dataloader = True  # duck-type marker (executor dispatch)

    def __init__(self, reader, feed_list: Optional[Sequence] = None,
                 place=None, program: Optional[Program] = None,
                 buffer_size: Optional[int] = None, chunk: int = 1,
                 drop_last: bool = True, name: str = "dataloader",
                 check_recompile: bool = True):
        from ..core import flags

        enforce(reader is not None, "DataLoader needs a reader")
        if buffer_size is None:
            buffer_size = int(flags.get_flag("dataloader_buffer_size") or 2)
        enforce(buffer_size >= 1, "buffer_size must be >= 1")
        enforce(chunk >= 1, "chunk must be >= 1")
        self._reader = reader
        self.buffer_size = int(buffer_size)
        self.chunk = int(chunk)
        self.drop_last = bool(drop_last)
        self.name = name
        self.place = place if place is not None else default_place()
        self._copier = DeviceCopier(self.place)
        self.metrics = PipelineMetrics()
        self._feeder = None
        self.feed_names: Optional[tuple] = None
        self._feeder_program = program
        if feed_list is not None:
            from ..data_feeder import DataFeeder

            self._feeder = DataFeeder(feed_list=feed_list, place=place,
                                      program=program)
            self.feed_names = self._feeder.feed_names
            if program is None and self._feeder.feed_vars:
                self._feeder_program = self._feeder.feed_vars[0].block.program
        self.batch_size: Optional[int] = None  # discovered from batch 0
        self._checked_recompile = not check_recompile
        self._it = None       # implicit current pass (for __next__)
        self._stop: Optional[threading.Event] = None
        # a plain ITERATOR (iter(x) is x) can only ever supply one pass:
        # silently yielding zero batches for every later epoch would make
        # multi-epoch training a no-op
        self._oneshot = (not callable(reader)
                         and iter(reader) is reader)
        self._passes = 0
        # set via _defer_eof when a consumer (the executor's chunked pull)
        # swallowed this pass's StopIteration while collecting a ragged
        # tail: the NEXT __next__ must deliver the owed end of pass
        # instead of silently starting a fresh pass
        self._pending_eof = False

    # -- the shape lint -----------------------------------------------------
    def _maybe_check_recompile(self, batch_size: Optional[int],
                               batch) -> None:
        """Once the batch size is known: warn of the shape hazards of the
        feed surface (``feed_list``, or the first batch's keys)."""
        if self._checked_recompile:
            return
        self._checked_recompile = True
        names = self.feed_names or tuple(batch)
        prog = self._feeder_program
        if prog is None or not names:
            return
        from ..analysis import check_dataloader_shapes

        for d in check_dataloader_shapes(prog, names, batch_size,
                                         self.drop_last):
            warnings.warn(f"data loader {self.name!r}: {d}")

    # -- worker-side conversion --------------------------------------------
    def _to_device_feed(self, item):
        """reader item -> (feed dict on the place, its copy event); runs
        on the worker thread, overlapped with the consumer's step."""
        t0 = time.perf_counter()
        with RecordEvent("h2d"):
            if isinstance(item, dict):
                feed = item
            else:
                enforce(self._feeder is not None,
                        "DataLoader got a tuple-style minibatch but has no "
                        "feed_list — pass feed_list=[...] (slot order) or "
                        "yield feed dicts from the reader")
                feed = self._feeder.feed(item)
            out = {}
            for n, v in feed.items():
                var = self._find_var(n)
                dtype = (dtype_utils.to_torch(var.dtype)
                         if var is not None and var.dtype is not None
                         else None)
                out[n] = self._copier.put(v, dtype)
            event = self._copier.seal()
        self.metrics.record_h2d(time.perf_counter() - t0)
        return out, event

    def _find_var(self, name: str) -> Optional[Variable]:
        prog = self._feeder_program
        if prog is None:
            return None
        return prog.global_block()._find_var_recursive(name)

    # -- pass lifecycle -----------------------------------------------------
    def _start_pass(self):
        """One producer pass over ``overlap_iter``, with the loader's
        extras: first-batch lint and batch-size discovery in ``convert``,
        ragged-tail dropping in ``keep``, the stream wait in ``deliver``
        and stall metrics in ``on_deliver``."""
        enforce(not (self._oneshot and self._passes),
                f"DataLoader {self.name!r} wraps a one-shot iterator that "
                "was already consumed — pass a reader CREATOR (a zero-arg "
                "callable returning a fresh iterable) for multi-pass use")
        self._passes += 1
        first = [True]

        def convert(item):
            pair = self._to_device_feed(item)
            if first[0]:
                first[0] = False
                bs = self._infer_batch_size(pair[0])
                self._maybe_check_recompile(bs, pair[0])
                self.batch_size = bs
            return pair

        def keep(pair) -> bool:
            # ragged tail under drop_last: one shape per pass
            return not (self.drop_last and self.batch_size is not None
                        and self._infer_batch_size(pair[0])
                        != self.batch_size)

        def deliver(pair):
            feed, event = pair
            self._copier.ready(feed.values(), event)
            return feed

        it, stop = overlap_iter(
            self._reader, convert, self.buffer_size,
            f"pdtpu-dataloader-{self.name}", keep=keep,
            on_deliver=self.metrics.record_wait, deliver=deliver)
        self._stop = stop
        return it

    def __iter__(self):
        """Start a fresh pass (one epoch). Each item is a feed dict of
        tensors on the place; abandoning iteration stops the worker."""
        self.close()
        self._pending_eof = False
        it = self._start_pass()
        self._it = it
        return it

    def __next__(self):
        """Pull from the current pass, starting one lazily — this is what
        ``Executor.run(feed=loader)`` consumes. Raises StopIteration at
        end of pass (the executor surfaces it as EOFException)."""
        if self._pending_eof:
            self._pending_eof = False
            raise StopIteration
        if self._it is None:
            self._it = self._start_pass()
        try:
            return next(self._it)
        except StopIteration:
            self._it = None
            raise

    def _defer_eof(self) -> None:
        """Called by a consumer that swallowed this pass's StopIteration
        mid-collection (the executor's ragged chunk tail): deliver it on
        the next pull so the epoch boundary is not lost."""
        self._pending_eof = True

    def close(self) -> None:
        """Stop the current pass's worker and drop buffered batches."""
        it, self._it = self._it, None
        if it is not None:
            it.close()
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @staticmethod
    def _infer_batch_size(feed: Dict[str, torch.Tensor]) -> Optional[int]:
        for v in feed.values():
            shape = getattr(v, "shape", None)
            if shape:
                return int(shape[0])
        return None

    def __repr__(self):
        return (f"DataLoader({self.name!r}, buffer_size={self.buffer_size}, "
                f"chunk={self.chunk}, batch_size={self.batch_size})")
