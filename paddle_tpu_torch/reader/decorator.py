"""Reader combinators (counterpart of paddle_tpu/reader/decorator.py;
reference: python/paddle/reader/decorator.py:29-337).

Pure Python, no tensors: each combinator takes reader(s) and returns a
new reader. This is the host side of the data path.
"""

from __future__ import annotations

import itertools
import queue as _queue
import random
import threading
from typing import Callable, Iterable, List

from ..core.enforce import EnforceError

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "cache", "multiprocess_reader", "PipeReader",
    "bucket_by_length",
    "ComposeNotAligned",
]


class ComposeNotAligned(ValueError):
    """reference: decorator.py:112."""


def map_readers(func: Callable, *readers):
    """Apply `func` to the items of each reader, zipped
    (reference: decorator.py:29)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size: int):
    """Shuffle within a sliding buffer (reference: decorator.py:45)."""

    def new_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return new_reader


def chain(*readers):
    """Concatenate readers end to end (reference: decorator.py:78)."""

    def reader():
        for r in readers:
            for e in r():
                yield e

    return reader


def compose(*readers, **kwargs):
    """Zip readers into tuple samples (reference: decorator.py:116).
    check_alignment=True raises ComposeNotAligned on ragged ends."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def _stoppable_put(q: "_queue.Queue", item, stop: "threading.Event") -> bool:
    """Bounded put that notices consumer abandonment: a worker blocked
    forever in ``q.put`` on a full queue outlives the consumer and leaks
    (one thread + ``size`` buffered items per abandoned iteration).
    Returns False when the stop event fired instead."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.25)
            return True
        except _queue.Full:
            continue
    return False


_STOP = object()  # _stoppable_get's give-up sentinel (None is a valid sample)


def _stoppable_get(q: "_queue.Queue", stop: "threading.Event"):
    """Blocking get that gives up when the stop event fires (returns the
    ``_STOP`` sentinel); workers draining a queue nobody fills any more
    must not block forever."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.25)
        except _queue.Empty:
            continue
    return _STOP


def buffered(reader, size: int):
    """Prefetch up to `size` items on a background thread
    (reference: decorator.py:165). The worker is a daemon with a
    sentinel-based shutdown path: abandoning iteration (consumer breaks
    early) stops it instead of leaving it blocked on the full queue."""

    class _End:
        pass

    class _Raise:
        def __init__(self, exc):
            self.exc = exc

    def read_worker(r, q, stop):
        try:
            for d in r:
                if not _stoppable_put(q, d, stop):
                    return
            _stoppable_put(q, _End(), stop)
        except BaseException as exc:  # propagate instead of deadlocking
            _stoppable_put(q, _Raise(exc), stop)

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)
        stop = threading.Event()
        t = threading.Thread(target=read_worker, args=(r, q, stop),
                             daemon=True, name="pdtpu-buffered")
        t.start()
        try:
            e = q.get()
            while not isinstance(e, _End):
                if isinstance(e, _Raise):
                    raise e.exc
                yield e
                e = q.get()
        finally:
            # consumer done or gone: retire the worker and drop the buffer
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass

    return data_reader


def firstn(reader, n: int):
    """First n samples (reference: decorator.py:236)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                return
            yield item

    return firstn_reader


def cache(reader):
    """Materialize once, replay from memory (host-RAM cache for small
    datasets; matches later-reference `paddle.reader.cache`)."""
    all_data: List = []
    filled = [False]

    def cache_reader():
        if not filled[0]:
            for item in reader():
                all_data.append(item)
                yield item
            filled[0] = True
        else:
            for item in all_data:
                yield item

    return cache_reader


def xmap_readers(mapper: Callable, reader, process_num: int,
                 buffer_size: int, order: bool = False):
    """Parallel map over samples with worker threads
    (reference: decorator.py:236 XmapEndSignal machinery). All workers are
    daemons with a shared stop event: abandoning iteration retires the
    whole read/map crew instead of leaving them blocked on full queues."""
    end = object()

    class _WorkerError:
        def __init__(self, exc):
            self.exc = exc

    def read_worker(r, in_q, stop):
        try:
            for i, d in enumerate(r()):
                if not _stoppable_put(in_q, (i, d) if order else d, stop):
                    return
            _stoppable_put(in_q, end, stop)
        except BaseException as exc:
            _stoppable_put(in_q, _WorkerError(exc), stop)

    def handle_worker(in_q, out_q, stop):
        try:
            sample = _stoppable_get(in_q, stop)
            while sample is not _STOP and sample is not end \
                    and not isinstance(sample, _WorkerError):
                if order:
                    i, d = sample
                    if not _stoppable_put(out_q, (i, mapper(d)), stop):
                        return
                else:
                    if not _stoppable_put(out_q, mapper(sample), stop):
                        return
                sample = _stoppable_get(in_q, stop)
            if sample is _STOP:  # stop fired while waiting
                return
            _stoppable_put(in_q, sample, stop)  # siblings see end/error
            _stoppable_put(
                out_q, sample if isinstance(sample, _WorkerError) else end,
                stop)
        except BaseException as exc:
            _stoppable_put(in_q, end, stop)
            _stoppable_put(out_q, _WorkerError(exc), stop)

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)
        stop = threading.Event()
        t = threading.Thread(target=read_worker, args=(reader, in_q, stop),
                             daemon=True, name="pdtpu-xmap-read")
        t.start()
        workers = []
        for _ in range(process_num):
            w = threading.Thread(target=handle_worker,
                                 args=(in_q, out_q, stop),
                                 daemon=True, name="pdtpu-xmap-map")
            w.start()
            workers.append(w)
        finished = 0
        next_idx = 0
        held = {}
        try:
            while finished < process_num:
                sample = out_q.get()
                if isinstance(sample, _WorkerError):
                    raise sample.exc
                if sample is end:
                    finished += 1
                    continue
                if order:
                    i, d = sample
                    held[i] = d
                    while next_idx in held:
                        yield held.pop(next_idx)
                        next_idx += 1
                else:
                    yield sample
            if order:
                for i in sorted(held):
                    yield held[i]
        finally:
            # consumer done or gone: retire the read+map crew and drop
            # whatever is still queued
            stop.set()
            for q in (in_q, out_q):
                try:
                    while True:
                        q.get_nowait()
                except _queue.Empty:
                    pass

    return xreader


def multiprocess_reader(readers, use_pipe: bool = True,
                        queue_size: int = 1000):
    """Run several readers concurrently, merging their streams.
    Thread-based (a process that has started CUDA must not fork); the
    contract matches the later reference's multiprocess_reader."""
    merged = [buffered(r, queue_size // max(len(readers), 1) or 1)
              for r in readers]

    def reader():
        its = [iter(r()) for r in merged]
        alive = list(its)
        while alive:
            for it in list(alive):
                try:
                    yield next(it)
                except StopIteration:
                    alive.remove(it)

    return reader


class PipeReader:
    """Stream samples out of a shell pipeline (reference:
    decorator.py:294)."""

    def __init__(self, command: str, bufsize: int = 8192,
                 file_type: str = "plain"):
        import subprocess

        if not isinstance(command, str):
            raise TypeError("pipe command must be a string")
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type
        self.process = subprocess.Popen(
            self.command.split(" "), bufsize=bufsize,
            stdout=subprocess.PIPE)

    def get_line(self, cut_lines: bool = True, line_break: bytes = b"\n"):
        remained = b""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if buff:
                if self.file_type == "gzip":
                    import zlib

                    decomp = getattr(self, "_dec", None)
                    if decomp is None:
                        decomp = self._dec = zlib.decompressobj(
                            32 + zlib.MAX_WBITS)
                    buff = decomp.decompress(buff)
                if cut_lines:
                    lines = (remained + buff).split(line_break)
                    remained = lines.pop()
                    for line in lines:
                        yield line.decode()
                else:
                    yield buff
            else:
                if remained:
                    yield remained.decode()
                break


def bucket_by_length(reader, boundaries, batch_size, len_fn=None,
                     drop_last: bool = False):
    """Group variable-length samples into length buckets and emit batches
    drawn from ONE bucket at a time (parity-plus; the reference pads each
    LoD batch to its own max length, which under ``Executor.run_steps``
    means one captured CUDA graph per distinct shape — bucketing bounds
    the number of padded shapes to len(boundaries)+1).

    ``boundaries`` are ascending max-lengths; a sample with
    ``len_fn(sample) <= boundaries[i]`` lands in bucket i, longer ones in
    the overflow bucket. ``len_fn`` defaults to the length of the
    sample's first field (or of the sample itself for flat samples).
    Leftover partial batches flush at end of data unless ``drop_last``
    (note: the sibling ``reader.batch`` defaults to dropping partials;
    here flushing is the default because bucket tails are common and the
    caller pads to the bucket boundary anyway — pass drop_last=True for
    strictly uniform batch counts).

    Pad each emitted batch to its bucket boundary (feeders round up, so
    all batches of a bucket share one compiled shape)."""
    bounds = sorted(int(b) for b in boundaries)

    if len_fn is None:
        def len_fn(sample):  # noqa: ANN001
            if isinstance(sample, tuple):
                first = sample[0]
            elif isinstance(sample, list):
                if sample and hasattr(sample[0], "__len__"):
                    # a list of sized things is ambiguous: multi-field
                    # sample or a flat list of strings? force the caller
                    # to say
                    raise EnforceError(
                        "bucket_by_length: list sample with sized "
                        "fields is ambiguous — pass len_fn=... to say "
                        "which field holds the sequence")
                first = sample  # flat list IS the sequence
            else:
                first = sample
            try:
                return len(first)
            except TypeError:
                raise EnforceError(
                    "bucket_by_length: the sample's first field has no "
                    "length — pass len_fn=... to say which field holds "
                    "the sequence (silently bucketing everything "
                    "together would defeat shape bounding)")

    def bucket_reader():
        buckets: List[List] = [[] for _ in range(len(bounds) + 1)]
        for sample in reader():
            n = len_fn(sample)
            idx = len(bounds)
            for i, b in enumerate(bounds):
                if n <= b:
                    idx = i
                    break
            buckets[idx].append(sample)
            if len(buckets[idx]) == batch_size:
                yield buckets[idx]
                buckets[idx] = []
        if not drop_last:
            for bucket in buckets:
                if bucket:
                    yield bucket

    return bucket_reader
