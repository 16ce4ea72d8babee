"""Chrome-trace timeline export (counterpart of paddle_tpu/timeline.py;
reference: tools/timeline.py — converts the profiler's event timestamps
into a chrome://tracing JSON file).

Host events come from profiler.RecordEvent spans — the executor's
``dispatch``/``fetch_sync``, the data pipeline's ``feed_wait``/``h2d``,
the serving and decoding spans and the compile cache's
``compile_cache/hit|miss|deserialize`` markers all land in one
timeline, one row per recording thread, with the structured-trace ids
of ``obs.trace`` kept in each span's args. The card's side is
``torch.profiler``'s chrome trace (profiler.start_profiler's
``trace_dir``) — this module covers the host-event half of the
reference's timeline UX.

    with profiler.profiler("All"):
        ... train / serve ...
    timeline.export_chrome_trace("/tmp/trace.json")   # chrome://tracing
"""

from __future__ import annotations

import json
import os

from . import profiler


def make_chrome_trace() -> dict:
    """The recorded host spans as a chrome-trace event dict: one
    complete-event ("ph": "X") per span, one ``tid`` row per recording
    thread (main loop vs DataLoader/prefetch workers), plus metadata
    events naming the process and each thread."""
    events = []
    spans = profiler.get_spans(with_trace=True)
    t_base = min((s[1] for s in spans), default=0.0)
    pid = os.getpid()
    # stable small tids in order of first appearance, so traces from
    # repeat runs line up row-for-row. Rows key on (ident, name):
    # CPython reuses a dead thread's ident, so ident alone would merge
    # a later worker's spans onto an exited worker's row under its
    # stale name
    tids = {}
    for name, t0, t1, thread_id, thread_name, trace in spans:
        tid = tids.setdefault((thread_id, thread_name),
                              (len(tids), thread_name))[0]
        ev = {
            "name": name, "cat": "host", "ph": "X", "pid": pid,
            "tid": tid,
            "ts": (t0 - t_base) * 1e6,           # microseconds
            "dur": (t1 - t0) * 1e6,
        }
        if trace is not None:
            # structured trace context (obs.trace): Perfetto
            # shows args; tools.trace validates the causal links
            ev["args"] = {"trace_id": trace[0], "span_id": trace[1],
                          "parent_id": trace[2]}
        events.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "paddle_tpu_torch host"}}]
    for tid, tname in sorted(tids.values()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str) -> str:
    """Write the recorded profiler spans as a chrome://tracing /
    Perfetto JSON file; returns ``path`` (reference: tools/timeline.py
    output contract). Record spans by running under
    ``with profiler.profiler(...):`` first."""
    with open(path, "w") as f:
        json.dump(make_chrome_trace(), f)
    return path


def save_chrome_trace(path: str) -> str:
    """Back-compat alias of :func:`export_chrome_trace`."""
    return export_chrome_trace(path)
