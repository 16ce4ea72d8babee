"""Live-tail a training steplog (obs.steplog JSONL; counterpart of
paddle_tpu/tools/top.py, the same output and exit codes).

    python -m paddle_tpu_torch.tools.top RUN.jsonl [--tail N] [--follow]
                                             [--interval S] [--once]

Renders the most recent StepStats records as a table — step time, loss,
input-stall fraction, fresh compiles — plus rolling rates; ``--follow``
re-reads on an interval (the ``top`` for a training run). Every refresh
re-opens the file BY PATH and, when the live file holds fewer than
``--tail`` records, backfills from the atomic ``<path>.1`` rotation —
so a rotation (``os.replace``) between refreshes is followed instead of
tailing a stale fd, and the tail never shrinks right after one.
``--once`` prints ONE machine-readable JSON line (the tail records plus
rolling rates) and exits — the scripting-friendly snapshot. Exit codes
(the tools.cache mold): 0 ok, 1 the file holds no parseable records,
2 usage error (missing file).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

COLUMNS = (("epoch", 5), ("step", 7), ("dt_s", 9), ("loss", 12),
           ("stall_frac", 11), ("fresh_compiles", 15))


def _fmt(rec, name, width):
    v = rec.get(name)
    if v is None:
        return " " * (width - 1) + "-"
    if isinstance(v, float):
        return f"{v:>{width}.4g}"
    return f"{v:>{width}}"


def read_records(path: str, tail: Optional[int]) -> List[dict]:
    """The steplog tail, rotation-aware: always re-opened by path (an
    os.replace rotation between calls is picked up, never a stale fd),
    backfilled from ``<path>.1`` when the freshly-rotated live file is
    shorter than the requested tail."""
    from ..obs.steplog import read_steplog

    records = list(read_steplog(path))
    if (tail is None or len(records) < tail) \
            and os.path.exists(path + ".1"):
        records = list(read_steplog(path + ".1")) + records
    return records[-tail:] if tail is not None else records


def _rates(records: List[dict]) -> dict:
    dts = [r["dt_s"] for r in records
           if isinstance(r.get("dt_s"), (int, float))]
    if not dts:
        return {"steps_shown": len(records)}
    return {"steps_shown": len(records),
            "steps_per_sec": round(len(dts) / sum(dts), 4)
            if sum(dts) else 0.0,
            "mean_ms_per_step": round(sum(dts) / len(dts) * 1e3, 3)}


def render(records: List[dict]) -> str:
    lines = ["".join(f"{n:>{w}}" for n, w in COLUMNS) + "  spans"]
    for rec in records:
        spans = rec.get("spans") or {}
        span_txt = " ".join(f"{k}={v * 1e3:.1f}ms"
                            for k, v in sorted(spans.items()))
        lines.append("".join(_fmt(rec, n, w) for n, w in COLUMNS)
                     + ("  " + span_txt if span_txt else ""))
    rates = _rates(records)
    if "steps_per_sec" in rates:
        lines.append(
            "%d steps shown | %.2f steps/s | mean %.1f ms/step"
            % (rates["steps_shown"], rates["steps_per_sec"],
               rates["mean_ms_per_step"]))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.top",
        description=__doc__.splitlines()[0])
    parser.add_argument("file")
    parser.add_argument("--tail", type=int, default=20)
    parser.add_argument("--follow", action="store_true")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument("--once", action="store_true",
                        help="print ONE JSON line (tail records + "
                             "rates) and exit — no table, no loop")
    parser.add_argument("--max-rounds", type=int, default=0,
                        help="with --follow: stop after N refreshes "
                             "(0 = until interrupted; tests use 1)")
    args = parser.parse_args(argv)
    if not os.path.exists(args.file):
        print("no such steplog: %s" % args.file, file=sys.stderr)
        return 2
    if args.once:
        records = read_records(args.file, args.tail)
        if not records:
            print("no parseable StepStats records in %s" % args.file,
                  file=sys.stderr)
            return 1
        print(json.dumps({"file": args.file, "records": records,
                          **_rates(records)}))
        return 0
    rounds = 0
    while True:
        records = read_records(args.file, args.tail)
        if not records and not args.follow:
            print("no parseable StepStats records in %s" % args.file,
                  file=sys.stderr)
            return 1
        print(render(records))
        rounds += 1
        if not args.follow or (args.max_rounds and
                               rounds >= args.max_rounds):
            return 0 if records else 1
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
