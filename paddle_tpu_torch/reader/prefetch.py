"""Host-to-device prefetch (counterpart of paddle_tpu/reader/prefetch.py;
reference: paddle/fluid/operators/reader/buffered_reader.cc double
buffer, py_reader + LoDTensorBlockingQueue,
operators/reader/lod_tensor_blocking_queue.h:31).

:func:`overlap_iter` is the one bounded-overlap engine behind
:func:`prefetch_to_device` and ``reader.DataLoader``: a worker thread
pulls reader items and converts them while the consumer's step runs on
the card. :class:`DeviceCopier` is the conversion's last leg, the
double-buffer reader's job with CUDA streams: on a CUDA place each
tensor is staged in pinned host memory and copied on the copier's own
stream, so the copy overlaps the step running on the consumer's stream;
an event recorded after a batch's copies is waited for on the
consumer's stream when the batch is delivered (the host never blocks),
and each tensor is marked as used there (``record_stream``), so the
allocator does not hand its memory to the next batch while the step
still reads it. On the CPU a batch is only converted.

Consumer waits are recorded as ``feed_wait`` spans, worker conversions
as ``h2d`` spans.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.place import Place, default_place
from ..profiler import RecordEvent


def batch(reader, batch_size: int, drop_last: bool = True):
    """Group samples into lists of `batch_size` (reference:
    python/paddle/batch.py)."""

    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


class DeviceCopier:
    """Copies host arrays to one place. On a CUDA place: from pinned
    host memory on a stream of its own (made on first use, in the
    worker); :meth:`copy` returns the copied structure and an event to
    wait for, :meth:`ready` makes the current stream wait for it."""

    def __init__(self, place: Place):
        self.device = place.torch_device()
        self._stream = None

    def put(self, value, dtype: Optional[torch.dtype] = None):
        """One array (or tensor) on the device, cast to ``dtype`` first
        (on the host, so the copy moves the smaller type)."""
        if isinstance(value, torch.Tensor) and value.device == self.device:
            return value if dtype is None else value.to(dtype)
        t = value if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.asarray(value))
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        t = t.contiguous().pin_memory()
        with torch.cuda.stream(self._stream):
            return t.to(self.device, non_blocking=True)

    def seal(self):
        """An event after every copy queued so far (None off the card)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def ready(self, tensors, event) -> None:
        """In the consumer: the current stream waits for ``event``, and
        ``tensors`` are marked as used on it."""
        if event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)

    def copy(self, item):
        """(item with every array on the device, its event)."""
        if isinstance(item, dict):
            out = {k: self.put(v) for k, v in item.items()}
        elif isinstance(item, (tuple, list)):
            out = type(item)(self.put(v) for v in item)
        else:
            out = self.put(item)
        return out, self.seal()


def _tensors(item):
    if isinstance(item, dict):
        return list(item.values())
    if isinstance(item, (tuple, list)):
        return list(item)
    return [item]


def prefetch_to_device(reader, buffer_size: int = 2,
                       place: Optional[Place] = None,
                       transform: Optional[Callable] = None):
    """Iterate batches on ``place`` (default ``CUDAPlace(0)``) with
    ``buffer_size`` in flight.

    reader: yields numpy-convertible batches (dict, tuple, or array).
    transform: host-side fn applied before the copy (e.g. stacking).
    """
    copier = DeviceCopier(place if place is not None else default_place())

    def to_device(item):
        with RecordEvent("h2d"):
            if transform is not None:
                item = transform(item)
            return copier.copy(item)

    def deliver(pair):
        item, event = pair
        copier.ready(_tensors(item), event)
        return item

    gen, _stop = overlap_iter(reader, to_device, buffer_size,
                              "pdtpu-prefetch", deliver=deliver)
    return gen


_END = object()


def overlap_iter(source, convert, buffer_size: int, thread_name: str,
                 keep: Optional[Callable] = None,
                 on_deliver: Optional[Callable] = None,
                 deliver: Optional[Callable] = None):
    """The bounded-overlap engine: a daemon worker pulls ``source``
    items and ``convert``s them (host prep and the queued copy to the
    card, overlapped with the consumer's step), and hands them over a
    queue. Returns ``(generator, stop_event)``.

    Contract:
      * EXACT in-flight bound — a ``buffer_size``-token semaphore slot is
        taken BEFORE the next source item is pulled, so no more than
        buffer_size undelivered converted batches ever exist;
      * abandonment-safe — the slot-acquire polls the stop event, which
        fires from the consumer generator's ``finally`` (break/GC) or via
        the returned event, so no worker outlives its consumer pinning
        device buffers;
      * exceptions surface in the consumer carrying the worker traceback
        (the exception object crosses the queue and is re-raised);
      * consumer waits are profiled as ``feed_wait`` spans; ``on_deliver
        (t0, t1)`` additionally observes each wait (loader metrics);
      * ``keep(converted) -> bool`` filters post-conversion (the slot is
        released for a dropped item — DataLoader's drop_last tail);
      * ``deliver(converted) -> item`` runs in the consumer before an
        item is yielded (the copier's stream wait).
    """
    q: _queue.Queue = _queue.Queue()
    slots = threading.Semaphore(buffer_size)
    stop = threading.Event()
    # the worker's spans join the creator's trace (obs.trace; None
    # when tracing is off)
    from ..obs import trace as obs_trace
    from ..resilience import faults

    creator_ctx = obs_trace.current()

    def worker():
        with obs_trace.attach(creator_ctx):
            _worker_body()

    def _worker_body():
        try:
            for item in (source() if callable(source) else source):
                while not stop.is_set():
                    if slots.acquire(timeout=0.25):
                        break
                if stop.is_set():
                    return
                # chaos hook: a "raise" surfaces in the consumer like
                # any worker failure; "delay" simulates stalled input
                faults.fire("reader.worker")
                out = convert(item)
                if keep is not None and not keep(out):
                    slots.release()
                    continue
                q.put(out)
        except BaseException as e:  # surface in the consumer, not stderr
            q.put(_END if isinstance(e, StopIteration) else e)
            return
        q.put(_END)

    t = threading.Thread(target=worker, daemon=True, name=thread_name)
    t.start()

    def gen():
        try:
            while True:
                t0 = time.perf_counter()
                with RecordEvent("feed_wait"):
                    out = q.get()
                if out is _END:
                    return
                if isinstance(out, BaseException):
                    raise out
                slots.release()
                if deliver is not None:
                    out = deliver(out)
                if on_deliver is not None:
                    on_deliver(t0, time.perf_counter())
                yield out
        finally:
            # consumer broke out / generator GC'd: release the worker and
            # drop queued device batches so their buffers free promptly
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass

    return gen(), stop
