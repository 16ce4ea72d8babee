"""Host-span profiler (counterpart of the host-span core of
paddle_tpu/profiler.py).

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
``reader.DataLoader``) and ``h2d`` (the loader's worker converting a
batch and queueing its copy to the card). Spans are recorded from the
loader's worker threads too, so the table is updated under a lock.

With ``obs.trace`` enabled (it installs :func:`set_trace_hook`), every
span also carries a ``(trace_id, span_id, parent_id)`` triple and is
recorded even while the profiler is off, so one request's spans form
one causally linked trace across threads.

Not ported: the device trace directory (``jax.profiler``'s role is
``torch.profiler``'s, which the caller runs) and the registry gauge of
dropped spans.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Dict, List

import torch

__all__ = ["RecordEvent", "event_counts", "event_totals", "get_spans",
           "reset_profiler", "set_trace_hook", "start_profiler",
           "stop_profiler"]

MAX_SPANS = 1_000_000

_STATE = {"enabled": False, "spans_dropped": 0}
# name -> [count, total_s, min_s, max_s], in first-seen order
_EVENTS: Dict[str, List[float]] = {}
# (name, t0, t1, thread id, thread name, trace) records
_SPANS: deque = deque()
_LOCK = threading.Lock()

# the structured-trace hook (obs.trace installs it): ``begin(name) ->
# token`` at span open, ``end(token) -> (trace_id, span_id, parent_id)
# | None`` at close. None (the default) costs one global read a span.
_TRACE_HOOK = None


def set_trace_hook(hook) -> None:
    """Install (or, with None, remove) the structured-trace hook. Owned
    by ``obs.trace`` — call ``trace.enable()``/``disable()`` instead."""
    global _TRACE_HOOK
    _TRACE_HOOK = hook


def _record_span(name: str, t0: float, t1: float, trace=None) -> None:
    """Fold one closed span into the table and the ring (shared by
    RecordEvent and ``obs.trace.root_span``)."""
    dt = t1 - t0
    th = threading.current_thread()
    with _LOCK:
        ev = _EVENTS.get(name)
        if ev is None:
            ev = _EVENTS[name] = [0, 0.0, float("inf"), 0.0]
        ev[0] += 1
        ev[1] += dt
        ev[2] = min(ev[2], dt)
        ev[3] = max(ev[3], dt)
        if len(_SPANS) >= MAX_SPANS:
            _SPANS.popleft()
            _STATE["spans_dropped"] += 1
        _SPANS.append((name, t0, t1, th.ident, th.name, trace))


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


def reset_profiler() -> None:
    """Clear the event table and the span ring."""
    with _LOCK:
        _EVENTS.clear()
        _SPANS.clear()
        _STATE["spans_dropped"] = 0


def start_profiler(state: str = "All") -> None:
    """Start recording host spans (reference: EnableProfiler,
    profiler.h:111). ``state`` ('CPU' | 'GPU' | 'All') is kept for the
    API; card activity is traced by ``torch.profiler``."""
    del state
    _STATE["enabled"] = True


def stop_profiler(print_report: bool = True) -> None:
    """Stop recording and print the event table (reference:
    DisableProfiler). The tables stay readable until
    :func:`reset_profiler`."""
    if not _STATE["enabled"]:
        return
    _STATE["enabled"] = False
    if print_report:
        print(_render_report())


def _render_report() -> str:
    with _LOCK:
        rows = [(name, int(cnt), total, mn, mx, total / cnt)
                for name, (cnt, total, mn, mx) in _EVENTS.items() if cnt]
    lines = ["------------------------->  Profiling Report  "
             "<-------------------------", "",
             f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
             f"{'Max(ms)':>10}{'Ave(ms)':>10}"]
    for name, cnt, total, mn, mx, ave in rows:
        lines.append(f"{name:<40}{cnt:>8}{total * 1e3:>12.3f}"
                     f"{mn * 1e3:>10.3f}{mx * 1e3:>10.3f}{ave * 1e3:>10.3f}")
    return "\n".join(lines)


def get_spans(with_threads: bool = False, with_trace: bool = False):
    """A copy of the recorded spans, oldest first (``perf_counter``
    seconds): ``(name, t0, t1)`` triples by default, with
    ``with_threads`` ``(name, t0, t1, thread_id, thread_name)``, and with
    ``with_trace`` the six-field records whose last element is None or
    the ``(trace_id, span_id, parent_id)`` triple of ``obs.trace``."""
    with _LOCK:
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
    ``spans_dropped`` count when the ring, which keeps the newest
    ``MAX_SPANS``, evicted spans (the counts and totals never drop)."""
    with _LOCK:
        out = {n: ev[1] for n, ev in _EVENTS.items() if ev[0]}
    if _STATE["spans_dropped"]:
        out["spans_dropped"] = _STATE["spans_dropped"]
    return out
