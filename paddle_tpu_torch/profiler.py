"""Profiler + tracing (counterpart of paddle_tpu/profiler.py).

``RecordEvent`` marks a host span (reference: platform/profiler.h:72,
``RecordEvent``; python/paddle/fluid/profiler.py). While the profiler is
on, each closed span is folded into a per-name table (count and total
seconds) and kept in a bounded ring of ``(name, t0, t1)`` records; while
a ``torch.profiler`` session records, each span also opens a
``torch.profiler.record_function`` of the same name, so it shows in the
torch trace beside the card's kernels. Off, a span costs two global
reads.

Spans the port records: ``dispatch`` (the executor queueing a step's or
a chunk's work), ``fetch_sync`` (waiting for the card and copying
fetches to the host), ``feed_wait`` (the consumer blocked on a
``reader.DataLoader``), ``h2d`` (the loader's worker converting a
batch and queueing its copy to the card) and the compile cache's
``compile_cache/hit|miss|deserialize``. Spans are recorded from the
loader's worker threads too, so the table is updated under a lock.

The ring holds the newest ``profiler_max_spans`` spans (the flag, read
at :func:`reset_profiler`); evictions are counted by
:func:`spans_dropped` and mirrored into the metrics registry as
``pdtpu_profiler_spans_dropped_total``.

With ``obs.trace`` enabled (it installs :func:`set_trace_hook`), every
span also carries a ``(trace_id, span_id, parent_id)`` triple and is
recorded even while the profiler is off, so one request's spans form
one causally linked trace across threads.

Device tracing: where the JAX package starts ``jax.profiler``'s
Perfetto dump, ``start_profiler(trace_dir=...)`` runs a
``torch.profiler`` session (CPU and, on a card, CUDA activities) and
:func:`stop_profiler` writes its chrome trace to
``<trace_dir>/device_trace.json`` — the card's kernels on rows of their
own beside the host spans. ``timeline.export_chrome_trace`` writes the
host spans alone. ``annotate`` marks a region in the host table, the
torch trace and, on a card, an NVTX range.

UX kept: ``with profiler.profiler('All', 'total', path):`` around N
steps prints a sorted host-event table and writes the device trace.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

__all__ = ["RecordEvent", "annotate", "cuda_profiler", "event_counts",
           "event_totals", "get_spans", "is_profiler_enabled", "profiler",
           "reset_profiler", "set_trace_hook", "spans_dropped",
           "start_profiler", "stop_profiler"]

_DEFAULT_MAX_SPANS = 1_000_000
DEVICE_TRACE_FILE = "device_trace.json"

_STATE = {"enabled": False, "spans_dropped": 0,
          "max_spans": _DEFAULT_MAX_SPANS, "torch_prof": None,
          "trace_dir": None, "trace_path": None}
# name -> [count, total_s, min_s, max_s], in first-seen order
_EVENTS: Dict[str, List[float]] = {}
# (name, t0, t1, thread id, thread name, trace) records
_SPANS: deque = deque()
# REENTRANT: the flight recorder's signal-handler dump reads the ring on
# whatever frame the signal interrupted — possibly one inside
# _record_span on the same thread
_LOCK = threading.RLock()

# the structured-trace hook (obs.trace installs it): ``begin(name) ->
# token`` at span open, ``end(token) -> (trace_id, span_id, parent_id)
# | None`` at close. None (the default) costs one global read a span.
_TRACE_HOOK = None


def set_trace_hook(hook) -> None:
    """Install (or, with None, remove) the structured-trace hook. Owned
    by ``obs.trace`` — call ``trace.enable()``/``disable()`` instead."""
    global _TRACE_HOOK
    _TRACE_HOOK = hook


def _ring_capacity() -> int:
    from .core import flags

    try:
        cap = int(flags.get_flag("profiler_max_spans") or 0)
    except (TypeError, ValueError):
        cap = 0
    return cap if cap > 0 else _DEFAULT_MAX_SPANS


def _record_span(name: str, t0: float, t1: float, trace=None) -> None:
    """Fold one closed span into the table and the ring (shared by
    RecordEvent and ``obs.trace.root_span``)."""
    dt = t1 - t0
    th = threading.current_thread()
    dropped = None
    with _LOCK:
        ev = _EVENTS.get(name)
        if ev is None:
            ev = _EVENTS[name] = [0, 0.0, float("inf"), 0.0]
        ev[0] += 1
        ev[1] += dt
        ev[2] = min(ev[2], dt)
        ev[3] = max(ev[3], dt)
        if len(_SPANS) >= _STATE["max_spans"]:
            _SPANS.popleft()
            _STATE["spans_dropped"] += 1
            dropped = _STATE["spans_dropped"]
        _SPANS.append((name, t0, t1, th.ident, th.name, trace))
    if dropped is not None and (dropped == 1
                                or dropped % _DROP_PUBLISH_EVERY == 0):
        # outside _LOCK, and throttled: once the ring is full every span
        # drops one, and a gauge write per span would tax the hot path;
        # spans_dropped() re-syncs the gauge exactly on every read
        _publish_spans_dropped(dropped)


# the drop count is also a registry gauge, so a scraper sees the span
# record going lossy; created at the first drop
_DROP_GAUGE = None
_DROP_PUBLISH_EVERY = 4096


def _publish_spans_dropped(count: int) -> None:
    global _DROP_GAUGE
    if _DROP_GAUGE is None:
        try:
            from .obs import metrics as _obs_metrics

            _DROP_GAUGE = _obs_metrics.REGISTRY.gauge(
                "pdtpu_profiler_spans_dropped_total",
                "spans evicted from the bounded profiler span ring "
                "since the last reset_profiler()")
        except Exception:
            _DROP_GAUGE = False  # registry unavailable: stay silent
    if _DROP_GAUGE:
        _DROP_GAUGE.set(count)


class RecordEvent:
    """A host span: a context manager or a decorator. Records nothing
    while the profiler is off, tracing is off and no torch profiler
    runs."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._torch = None
        self._tok = None
        self._hook = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._torch = torch.profiler.record_function(self.name)
            self._torch.__enter__()
        # end() runs on the hook that issued the token, even if tracing
        # is turned off in between (else its context would stay on this
        # thread's stack and misparent every later span)
        hook = self._hook = _TRACE_HOOK
        if hook is not None:
            self._tok = hook.begin(self.name)
        if _STATE["enabled"] or self._tok is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tok, self._tok = self._tok, None
        hook, self._hook = self._hook, None
        trace = (hook.end(tok) if hook is not None and tok is not None
                 else None)
        if self._t0 is not None:
            _record_span(self.name, self._t0, time.perf_counter(), trace)
            self._t0 = None
        if self._torch is not None:
            span, self._torch = self._torch, None
            span.__exit__(*exc)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)

        return wrapped


def is_profiler_enabled() -> bool:
    return _STATE["enabled"]


def reset_profiler() -> None:
    """Clear the event table and the span ring; the ring's capacity is
    (re)read from the ``profiler_max_spans`` flag here, so a flag change
    applies to the next session, not mid-recording."""
    with _LOCK:
        _EVENTS.clear()
        _SPANS.clear()
        _STATE["max_spans"] = _ring_capacity()
        _STATE["spans_dropped"] = 0
    if _DROP_GAUGE:
        _DROP_GAUGE.set(0)


def spans_dropped() -> int:
    """Spans evicted from the bounded ring since the last reset (0:
    nothing was lost). Every read re-syncs the registry gauge."""
    with _LOCK:
        dropped = _STATE["spans_dropped"]
    if dropped:
        _publish_spans_dropped(dropped)
    return dropped


def start_profiler(state: str = "All",
                   trace_dir: Optional[str] = None) -> None:
    """Start recording host spans (reference: EnableProfiler,
    profiler.h:111). With ``trace_dir`` and ``state`` other than
    ``'CPU'`` a ``torch.profiler`` session records too (CUDA activities
    when a card is visible), written by :func:`stop_profiler` as a
    chrome trace in ``trace_dir``."""
    if _STATE["enabled"]:
        return
    _STATE["enabled"] = True
    if trace_dir and state in ("GPU", "All"):
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(trace_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _STATE["torch_prof"] = prof
        _STATE["trace_dir"] = trace_dir
        _STATE["trace_path"] = None


def _name_rows(path: str) -> None:
    """Give every row of a ``torch.profiler`` chrome trace a
    ``thread_name`` (kineto leaves its own session row unnamed), so the
    file passes ``tools.trace validate``."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents") or []
    named = {e.get("tid") for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    rows = {}
    for e in events:
        if e.get("ph") == "X" and e.get("tid") not in named:
            rows.setdefault(e.get("tid"), e.get("pid"))
    if not rows:
        return
    events.extend({"name": "thread_name", "ph": "M", "pid": pid,
                   "tid": tid, "args": {"name": str(tid)}}
                  for tid, pid in rows.items())
    with open(path, "w") as f:
        json.dump(doc, f)


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None,
                  print_report: bool = True) -> None:
    """Stop recording (reference: DisableProfiler): finish the device
    trace, write the event table to ``profile_path`` and print it
    (``print_report``), sorted by ``sorted_key`` ('calls', 'total',
    'min', 'max', 'ave'; None: first-seen order). The tables stay
    readable until :func:`reset_profiler`."""
    if not _STATE["enabled"]:
        return
    _STATE["enabled"] = False
    prof = _STATE["torch_prof"]
    if prof is not None:
        _STATE["torch_prof"] = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        path = os.path.join(_STATE["trace_dir"], DEVICE_TRACE_FILE)
        prof.export_chrome_trace(path)
        _name_rows(path)
        _STATE["trace_path"] = path
    report = _render_report(sorted_key)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(report)
    if print_report:
        print(report)


def device_trace_path() -> Optional[str]:
    """The chrome trace the last device-traced session wrote, or None."""
    return _STATE["trace_path"]


def _render_report(sorted_key: Optional[str] = None) -> str:
    with _LOCK:
        rows = [(name, int(cnt), total, mn, mx, total / cnt)
                for name, (cnt, total, mn, mx) in _EVENTS.items() if cnt]
    key = {None: None, "default": None,
           "calls": lambda r: -r[1], "total": lambda r: -r[2],
           "min": lambda r: r[3], "max": lambda r: -r[4],
           "ave": lambda r: -r[5]}.get(sorted_key)
    if key:
        rows.sort(key=key)
    lines = ["------------------------->  Profiling Report  "
             "<-------------------------", "",
             f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
             f"{'Max(ms)':>10}{'Ave(ms)':>10}"]
    for name, cnt, total, mn, mx, ave in rows:
        lines.append(f"{name:<40}{cnt:>8}{total * 1e3:>12.3f}"
                     f"{mn * 1e3:>10.3f}{mx * 1e3:>10.3f}{ave * 1e3:>10.3f}")
    if _STATE["trace_path"]:
        lines += ["", f"Device trace (chrome trace): {_STATE['trace_path']}"]
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = "total",
             profile_path: Optional[str] = None,
             trace_dir: Optional[str] = None):
    """``with profiler.profiler('All', 'total', '/tmp/profile'):``
    (reference: python/paddle/fluid/profiler.py:218)."""
    reset_profiler()
    start_profiler(state, trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key=sorted_key, profile_path=profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file: Optional[str] = None,
                  output_mode: Optional[str] = None, config=None):
    """API-parity alias (reference: profiler.py:36 ``cuda_profiler``):
    a profiling scope whose report goes to ``output_file``; the nvprof
    knobs are accepted for the signature."""
    del output_mode, config
    with profiler(state="All", sorted_key="total",
                  profile_path=output_file):
        yield


class annotate:
    """A named region in the host table, the torch trace and, on a
    card, an NVTX range (the JAX package's ``TraceAnnotation``)."""

    def __init__(self, name: str):
        self.name = name
        self._host = None
        self._nvtx = False

    def __enter__(self):
        self._host = RecordEvent(self.name)
        self._host.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        self._host.__exit__(*exc)
        return False


def get_spans(with_threads: bool = False, with_trace: bool = False,
              tail: Optional[int] = None):
    """A copy of the recorded spans, oldest first (``perf_counter``
    seconds): ``(name, t0, t1)`` triples by default, with
    ``with_threads`` ``(name, t0, t1, thread_id, thread_name)``, and with
    ``with_trace`` the six-field records whose last element is None or
    the ``(trace_id, span_id, parent_id)`` triple of ``obs.trace``.
    ``tail`` copies only the newest N under the lock (the flight
    recorder's per-dump read)."""
    with _LOCK:
        if tail is not None and tail < len(_SPANS):
            spans = list(itertools.islice(reversed(_SPANS), int(tail)))
            spans.reverse()
        else:
            spans = list(_SPANS)
    if with_trace:
        return spans
    if with_threads:
        return [s[:5] for s in spans]
    return [s[:3] for s in spans]


def event_counts() -> Dict[str, int]:
    """{span name: count} of the table."""
    with _LOCK:
        return {n: int(ev[0]) for n, ev in _EVENTS.items() if ev[0]}


def event_totals() -> Dict[str, float]:
    """{span name: total seconds} of the table (e.g. ``feed_wait`` over
    the wall time is the input pipeline's stall share); with a
    ``spans_dropped`` count when the ring evicted spans (the counts and
    totals never drop)."""
    with _LOCK:
        out = {n: ev[1] for n, ev in _EVENTS.items() if ev[0]}
        if _STATE["spans_dropped"]:
            out["spans_dropped"] = _STATE["spans_dropped"]
    return out
