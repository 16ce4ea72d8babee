"""Inspect, validate and diff flight-recorder bundles (counterpart of
paddle_tpu/tools/postmortem.py, the same commands and exit codes; either
package's bundles).

    python -m paddle_tpu_torch.tools.postmortem validate BUNDLE_OR_DIR
    python -m paddle_tpu_torch.tools.postmortem summary  BUNDLE_OR_DIR
    python -m paddle_tpu_torch.tools.postmortem tree     BUNDLE_OR_DIR [--trace ID]
    python -m paddle_tpu_torch.tools.postmortem diff     BUNDLE_A BUNDLE_B

A BUNDLE is one ``bundle-*`` directory written by
``obs.record``; passing a record DIR picks its newest
bundle. ``validate`` re-checks the manifest digests and JSON structure
(the atomic-publish contract: a listed bundle is complete or it does
not exist). ``summary`` reconstructs the last seconds of the dead
process — reason, env pins, alerts, errors, step tail. ``tree``
renders the trace tail's span tree per trace id. ``diff`` compares two
bundles (e.g. a clean run vs a storm run): env-pin drift, counter
deltas, alerts present in one but not the other.

Exit codes (the tools.cache mold): 0 ok, 1 validation found problems,
2 usage error (missing path, no bundle, unknown command).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from ..obs import record as obs_record


def _resolve_bundle(path: str) -> str:
    import os

    if not os.path.exists(path):
        print("no such path: %s" % path, file=sys.stderr)
        raise SystemExit(2)
    if os.path.isfile(os.path.join(path, "MANIFEST.json")):
        return path
    newest = obs_record.latest_bundle(path, valid_only=False)
    if newest is None:
        print("no bundles under %s" % path, file=sys.stderr)
        raise SystemExit(2)
    return newest


def _read(path: str) -> dict:
    try:
        return obs_record.read_bundle(path)
    except (OSError, ValueError) as e:
        print("cannot read bundle %s: %s" % (path, e), file=sys.stderr)
        raise SystemExit(1)


# ---------------------------------------------------------------------------


def cmd_validate(args) -> int:
    bundle = _resolve_bundle(args.path)
    problems = obs_record.validate_bundle(bundle)
    for p in problems:
        print("BAD  " + p)
    print("%s: %d problems" % (bundle, len(problems)))
    return 1 if problems else 0


def cmd_summary(args) -> int:
    bundle = _resolve_bundle(args.path)
    b = _read(bundle)
    man = b["manifest"]
    print("bundle   %s" % bundle)
    print("reason   %s  (seq %s, pid %s)"
          % (man.get("reason"), man.get("seq"), man.get("pid")))
    print("time     %s" % man.get("t"))
    env = man.get("env") or {}
    print("env      torch=%s cuda=%s platform=%s device=%s x%s"
          % (env.get("torch"), env.get("cuda") or "-", env.get("platform"),
             env.get("device_kind") or "-", env.get("num_devices")))
    stamps = (man.get("stamps") or {}).get("fingerprints") or []
    if stamps:
        print("stamps   %d recent program fingerprints (newest %s...)"
              % (len(stamps), str(stamps[-1].get("fingerprint"))[:16]))
    counts = man.get("counts") or {}
    print("rings    %s spans dropped=%s"
          % (" ".join("%s=%s" % (k, v) for k, v in sorted(
              counts.items()) if k != "active_alerts"),
             counts.get("spans_dropped")))
    active = counts.get("active_alerts") or []
    if active:
        print("FIRING   %s" % ", ".join(active))
    for alert in (b.get("alerts") or [])[-args.tail:]:
        print("alert    [%s] %s %s: %s"
              % (alert.get("severity"), alert.get("rule"),
                 alert.get("state"), alert.get("reason")))
    for err in (b.get("errors") or [])[-args.tail:]:
        print("error    %s (%s): %s"
              % (err.get("type"), err.get("context"),
                 (err.get("error") or "")[:120]))
    for tr in (b.get("degrade") or [])[-args.tail:]:
        print("degrade  stage %s -> %s (%s)"
              % (tr.get("from"), tr.get("to"), tr.get("reason")))
    steps = b.get("steplog") or []
    for rec in steps[-min(args.tail, 5):]:
        print("step     epoch=%s step=%s dt_s=%s loss=%s"
              % (rec.get("epoch"), rec.get("step"), rec.get("dt_s"),
                 rec.get("loss")))
    spans = b.get("trace") or []
    print("%d spans, %d steps, %d alerts, %d errors"
          % (len(spans), len(steps), len(b.get("alerts") or []),
             len(b.get("errors") or [])))
    return 0


def cmd_tree(args) -> int:
    bundle = _resolve_bundle(args.path)
    b = _read(bundle)
    spans = [s for s in (b.get("trace") or []) if s.get("trace_id")]
    if not spans:
        print("no structured-trace spans in this bundle (enable "
              "paddle_tpu_torch.obs.trace before recording)", file=sys.stderr)
        return 1
    by_trace: Dict[str, List[dict]] = defaultdict(list)
    for s in spans:
        by_trace[s["trace_id"]].append(s)
    trace_id = args.trace
    if trace_id is None:
        trace_id = max(by_trace, key=lambda t: len(by_trace[t]))
    group = [s for t, g in by_trace.items() if t.startswith(trace_id)
             for s in g]
    if not group:
        print("trace %s not in this bundle" % trace_id, file=sys.stderr)
        return 1
    children: Dict[str, List[dict]] = defaultdict(list)
    roots: List[dict] = []
    ids = {s["span_id"] for s in group}
    for s in sorted(group, key=lambda s: s["t0"]):
        parent = s.get("parent_id", "")
        if parent and parent in ids:
            children[parent].append(s)
        else:
            # tail truncation: a parent evicted from the ring (or the
            # ambient cross-process anchor) renders as a root
            roots.append(s)

    def render(s, depth):
        print("%s%s  [%.3f ms, thread %s]"
              % ("  " * depth, s["name"], (s["t1"] - s["t0"]) * 1e3,
                 s.get("thread")))
        for c in children.get(s["span_id"], ()):
            render(c, depth + 1)

    print("trace %s (%d spans in tail)" % (group[0]["trace_id"],
                                           len(group)))
    for r in roots:
        render(r, 1)
    return 0


# ---------------------------------------------------------------------------


def _counter_map(metrics: dict) -> Dict[str, float]:
    """{family{labels}: value} for counters/gauges in a bundle's
    metrics.json snapshot."""
    out: Dict[str, float] = {}
    for fam, body in (metrics or {}).items():
        if body.get("type") == "histogram":
            continue
        for v in body.get("values", ()):
            labels = ",".join("%s=%s" % kv
                              for kv in sorted(v["labels"].items()))
            out["%s{%s}" % (fam, labels)] = v.get("value")
    return out


def cmd_diff(args) -> int:
    a = _read(_resolve_bundle(args.path))
    bd = _read(_resolve_bundle(args.b))
    man_a, man_b = a["manifest"], bd["manifest"]
    print("A: %s (reason %s, t %s)"
          % (args.path, man_a.get("reason"), man_a.get("t")))
    print("B: %s (reason %s, t %s)"
          % (args.b, man_b.get("reason"), man_b.get("t")))
    env_a, env_b = man_a.get("env") or {}, man_b.get("env") or {}
    for k in sorted(set(env_a) | set(env_b)):
        if env_a.get(k) != env_b.get(k):
            print("env      %-18s %r -> %r"
                  % (k, env_a.get(k), env_b.get(k)))
    ca, cb = _counter_map(a.get("metrics")), _counter_map(
        bd.get("metrics"))
    rows = []
    for k in sorted(set(ca) | set(cb)):
        va, vb = ca.get(k), cb.get(k)
        if va != vb:
            rows.append((k, va, vb))
    for k, va, vb in rows[:args.tail]:
        print("metric   %-60s %s -> %s" % (k, va, vb))
    if len(rows) > args.tail:
        print("metric   ... %d more changed families elided "
              "(--tail raises the cap)" % (len(rows) - args.tail))

    def alert_keys(bundle):
        return {(al.get("rule"), al.get("state"))
                for al in bundle.get("alerts") or []}

    only_a = alert_keys(a) - alert_keys(bd)
    only_b = alert_keys(bd) - alert_keys(a)
    for rule, state in sorted(only_a):
        print("alert    only in A: %s %s" % (rule, state))
    for rule, state in sorted(only_b):
        print("alert    only in B: %s %s" % (rule, state))
    print("%d env diffs, %d metric diffs, %d alert diffs"
          % (sum(1 for k in set(env_a) | set(env_b)
                 if env_a.get(k) != env_b.get(k)),
             len(rows), len(only_a) + len(only_b)))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.postmortem",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd")
    for name, fn in (("validate", cmd_validate),
                     ("summary", cmd_summary), ("tree", cmd_tree),
                     ("diff", cmd_diff)):
        p = sub.add_parser(name)
        p.add_argument("path")
        if name == "diff":
            p.add_argument("b")
        if name == "tree":
            p.add_argument("--trace", default=None,
                           help="trace id (prefix ok) to render")
        p.add_argument("--tail", type=int, default=10,
                       help="how many ring entries / diff rows to show")
        p.set_defaults(fn=fn)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
