"""Inspect/validate Chrome-trace exports (counterpart of
paddle_tpu/tools/trace.py, the same checks and exit codes).

    python -m paddle_tpu_torch.tools.trace validate TRACE.json
    python -m paddle_tpu_torch.tools.trace summary  TRACE.json
    python -m paddle_tpu_torch.tools.trace tree     TRACE.json [--trace ID]

The input is a ``timeline.export_chrome_trace`` JSON file, or the
device trace ``profiler.start_profiler(trace_dir=...)`` writes. ``validate``
checks the file structurally — loadable JSON, well-formed complete
events, named thread rows, and (for spans carrying obs.trace context)
that every parent_id resolves inside its trace — the causal-link check
the decoding acceptance test keys on. ``summary`` prints per-trace and
per-thread rollups; ``tree`` renders one trace's span tree.

Exit codes (the tools.cache mold): 0 ok, 1 validation found problems,
2 usage error (missing/unreadable file, unknown command).

Reference lineage: tools/timeline.py, which converted the profiler
proto into this same chrome://tracing format.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional


def _load(path: str):
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except OSError as e:
        print("cannot read %s: %s" % (path, e), file=sys.stderr)
        raise SystemExit(2)
    except ValueError as e:
        # a half-written or corrupt file is a VALIDATION failure, not a
        # usage error: the caller handed us a real file that is broken
        print("invalid JSON in %s: %s" % (path, e), file=sys.stderr)
        raise SystemExit(1)


def _events(doc) -> List[dict]:
    evs = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(evs, list):
        print("not a chrome trace: no traceEvents list", file=sys.stderr)
        raise SystemExit(1)
    return evs


def _spans(events) -> List[dict]:
    return [e for e in events if e.get("ph") == "X"]


def _traced(events) -> Dict[str, List[dict]]:
    """Spans grouped by trace_id (only those carrying obs.trace args)."""
    by_trace: Dict[str, List[dict]] = defaultdict(list)
    for e in _spans(events):
        args = e.get("args") or {}
        tid = args.get("trace_id")
        if tid:
            by_trace[tid].append(e)
    return by_trace


def validate_events(events) -> List[str]:
    """Structural problems in a chrome-trace event list (empty = ok)."""
    problems: List[str] = []
    spans = _spans(events)
    for e in spans:
        if not isinstance(e.get("name"), str) or "ts" not in e:
            problems.append("malformed complete event: %r" % (e,))
        elif e.get("dur", 0) < 0:
            problems.append("negative duration on %r" % e["name"])
    named_tids = {e.get("tid") for e in events
                  if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for tid in {e.get("tid") for e in spans}:
        if tid not in named_tids:
            problems.append("thread row %r has no thread_name metadata"
                            % (tid,))
    by_trace = _traced(events)
    ids_by_trace = {t: {e["args"]["span_id"] for e in g}
                    for t, g in by_trace.items()}
    for trace_id, group in by_trace.items():
        ids = ids_by_trace[trace_id]
        roots = 0
        anchors = set()   # parents outside the export: the ambient
        for e in group:   # process/cross-process root is never recorded
            parent = e["args"].get("parent_id", "")
            if not parent:
                roots += 1
            elif parent not in ids:
                owner = next((t for t, other in ids_by_trace.items()
                              if t != trace_id and parent in other), None)
                if owner is not None:
                    problems.append(
                        "trace %s: span %r parent %s belongs to trace %s"
                        % (trace_id[:8], e["name"], parent[:8],
                           owner[:8]))
                else:
                    anchors.add(parent)
        if not roots and not anchors:
            problems.append("trace %s has no root span" % trace_id[:8])
    return problems


def cmd_validate(args) -> int:
    events = _events(_load(args.file))
    problems = validate_events(events)
    by_trace = _traced(events)
    if args.trace and args.trace not in by_trace:
        problems.append("requested trace %s not present" % args.trace)
    for p in problems:
        print("BAD  " + p)
    print("%d events, %d spans, %d traces, %d problems"
          % (len(events), len(_spans(events)), len(by_trace),
             len(problems)))
    return 1 if problems else 0


def cmd_summary(args) -> int:
    events = _events(_load(args.file))
    spans = _spans(events)
    names: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in spans:
        names[e["name"]][0] += 1
        names[e["name"]][1] += e.get("dur", 0.0)
    print(f"{'span':<40}{'count':>7}{'total_ms':>12}")
    for n in sorted(names, key=lambda n: -names[n][1]):
        c, d = names[n]
        print(f"{n:<40}{c:>7}{d / 1e3:>12.3f}")
    by_trace = _traced(events)
    tids = {e.get("tid") for e in spans}
    print("%d spans over %d thread rows; %d structured traces"
          % (len(spans), len(tids), len(by_trace)))
    for trace_id, group in sorted(by_trace.items(),
                                  key=lambda kv: -len(kv[1])):
        threads = {e.get("tid") for e in group}
        print("  trace %s: %d spans across %d threads"
              % (trace_id[:16], len(group), len(threads)))
    return 0


def cmd_tree(args) -> int:
    events = _events(_load(args.file))
    by_trace = _traced(events)
    if not by_trace:
        print("no structured traces in this export (enable "
              "paddle_tpu_torch.obs.trace before recording)", file=sys.stderr)
        return 1
    trace_id = args.trace
    if trace_id is None:
        trace_id = max(by_trace, key=lambda t: len(by_trace[t]))
    group = [e for t, g in by_trace.items() if t.startswith(trace_id)
             for e in g]
    if not group:
        print("trace %s not found" % trace_id, file=sys.stderr)
        return 1
    children: Dict[str, List[dict]] = defaultdict(list)
    roots: List[dict] = []
    for e in sorted(group, key=lambda e: e["ts"]):
        parent = e["args"].get("parent_id", "")
        (children[parent] if parent else roots).append(e)
    # orphans (parent outside the export window) render as extra roots
    ids = {e["args"]["span_id"] for e in group}
    roots += [e for p, es in children.items() if p and p not in ids
              for e in es]

    def render(e, depth):
        print("%s%s  [%.3f ms, tid %s]"
              % ("  " * depth, e["name"], e.get("dur", 0.0) / 1e3,
                 e.get("tid")))
        for c in children.get(e["args"]["span_id"], ()):
            render(c, depth + 1)

    print("trace %s (%d spans)" % (group[0]["args"]["trace_id"],
                                   len(group)))
    for r in roots:
        render(r, 1)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.trace",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd")
    for name, fn in (("validate", cmd_validate), ("summary", cmd_summary),
                     ("tree", cmd_tree)):
        p = sub.add_parser(name)
        p.add_argument("file")
        p.add_argument("--trace", default=None,
                       help="trace id (prefix ok) to focus on")
        p.set_defaults(fn=fn)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
