"""Structured tracing: Dapper-style trace context over profiler spans
(counterpart of paddle_tpu/obs/trace.py).

The profiler's ``RecordEvent`` markers are flat: a name, a time range, a
thread. With tracing enabled every span also carries a ``(trace_id,
span_id, parent_id)`` triple, so one serving request yields ONE
causally linked tree instead of an unordered pile of events (reference
lineage: the host-side RecordEvent table of platform/profiler.h plus
the correlation ids its device tracer threads through CUPTI records).

Propagation:

* **within a thread** — enabling installs a hook into
  ``profiler.RecordEvent``; nested events chain parent ids;
* **across threads** — capture :func:`current` in the producer, adopt
  it in the consumer with :func:`attach` (the serving and decoding
  batchers attach each request's context, stamped on it at submit);
* **across processes** — :func:`env_value` serializes the current
  context for the ``PDTPU_TRACE_CTX`` env var; :func:`enable` in a
  child with that var set roots the child's spans in the parent's
  trace.

Default OFF: the hook is absent and a RecordEvent pays one global read.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

from .. import profiler

ENV_VAR = "PDTPU_TRACE_CTX"

_STATE = {"on": False, "proc_root": None}
_tls = threading.local()


def _new_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """One point in a trace: the trace it belongs to and the span that
    children should name as their parent."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def env_value(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def from_env_value(cls, value: str) -> Optional["SpanContext"]:
        parts = (value or "").split(":")
        if len(parts) != 2 or not all(parts):
            return None
        return cls(parts[0], parts[1])

    def __repr__(self):
        return f"SpanContext({self.trace_id}:{self.span_id})"


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def enabled() -> bool:
    return _STATE["on"]


def enable() -> None:
    """Turn structured tracing on (idempotent). The process root context
    comes from ``PDTPU_TRACE_CTX`` when a parent process exported one
    (so this process's spans join the parent's trace), else a fresh
    trace is opened for the process."""
    if _STATE["on"]:
        return
    if _STATE["proc_root"] is None:
        env_ctx = SpanContext.from_env_value(os.environ.get(ENV_VAR, ""))
        _STATE["proc_root"] = env_ctx or SpanContext(_new_id(), _new_id())
    _STATE["on"] = True
    profiler.set_trace_hook(_Hook)


def disable() -> None:
    """Turn tracing off; RecordEvent reverts to the flat profiler path."""
    _STATE["on"] = False
    profiler.set_trace_hook(None)


def process_root() -> Optional[SpanContext]:
    """The process-level root context (None until enable())."""
    return _STATE["proc_root"]


def current() -> Optional[SpanContext]:
    """The context new spans in this thread would parent to: the
    innermost attached/open span, falling back to the process root.
    None while tracing is off."""
    if not _STATE["on"]:
        return None
    s = _stack()
    return s[-1] if s else _STATE["proc_root"]


def env_value(ctx: Optional[SpanContext] = None) -> str:
    """Serialized context for child-process inheritance: put it in the
    child env under :data:`ENV_VAR`."""
    ctx = ctx or current()
    return ctx.env_value() if ctx is not None else ""


@contextlib.contextmanager
def attach(ctx: Optional[SpanContext]):
    """Adopt ``ctx`` as this thread's current context for the block —
    the cross-thread propagation primitive. No-op (and free of trace
    state) when ``ctx`` is None or tracing is off."""
    if ctx is None or not _STATE["on"]:
        yield None
        return
    s = _stack()
    s.append(ctx)
    try:
        yield ctx
    finally:
        s.pop()


@contextlib.contextmanager
def root_span(name: str):
    """Open a NEW trace whose root span is recorded around the block and
    yield its :class:`SpanContext` — hand that to other threads
    (:func:`attach`) or processes (:func:`env_value`) and their spans
    become children of this one. The per-request entry point the
    serving/decoding submit paths use. Yields None when tracing is off
    (zero recording, zero allocation beyond the generator)."""
    if not _STATE["on"]:
        yield None
        return
    ctx = SpanContext(_new_id(), _new_id())
    s = _stack()
    s.append(ctx)
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        t1 = time.perf_counter()
        if s and s[-1] is ctx:
            s.pop()
        profiler._record_span(name, t0, t1,
                              (ctx.trace_id, ctx.span_id, ""))


class _Hook:
    """The profiler.RecordEvent hook: allocates child span ids and keeps
    the per-thread parent chain."""

    @staticmethod
    def begin(name):
        if not _STATE["on"]:
            return None
        s = _stack()
        parent = s[-1] if s else _STATE["proc_root"]
        ctx = SpanContext(parent.trace_id, _new_id())
        s.append(ctx)
        return (ctx, parent.span_id)

    @staticmethod
    def end(tok):
        if tok is None:
            return None
        ctx, parent_id = tok
        s = _stack()
        if s and s[-1] is ctx:
            s.pop()
        return (ctx.trace_id, ctx.span_id, parent_id)
