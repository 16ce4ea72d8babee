"""Maintenance + sweep CLI for the kernel-autotuning store (counterpart
of paddle_tpu/tools/tuning.py).

    python -m paddle_tpu_torch.tools.tuning ls     [--dir DIR]
    python -m paddle_tpu_torch.tools.tuning verify [--dir DIR]
    python -m paddle_tpu_torch.tools.tuning sweep  --kernel NAME|all
        [--problem k=v,...] [--dtype DT] [--iters N] [--samples N]
        [--subset k=v1|v2,...] [--force] [--device cuda|cpu] [--dir DIR]
    python -m paddle_tpu_torch.tools.tuning gc --max-bytes N [--dir DIR]
    python -m paddle_tpu_torch.tools.tuning clear  [--dir DIR]

``--dir`` defaults to the active store: the ``tuning_cache_dir`` flag
(``PDTPU_TUNING_CACHE_DIR``), else ``<compile_cache_dir>/tuning``.
``sweep`` measures on the card (``--device cuda``, the default: device
time from CUDA events) or, asked for, times the plain versions on the
host (``--device cpu``: their host time, keyed to device kind ``cpu``).
Exit codes: 0 ok, 1 verify found corrupt entries, 2 usage error (no
store dir / unknown command / unparseable problem).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional


def _store(args):
    from ..tuning import TuningStore, active_store

    if args.dir:
        return TuningStore(str(args.dir))
    store = active_store()
    if store is None:
        print("no tuning store: pass --dir or set the tuning_cache_dir "
              "or compile_cache_dir flag", file=sys.stderr)
        raise SystemExit(2)
    return store


def _age(ts: float) -> str:
    if not ts:
        return "-"
    dt = max(0.0, time.time() - ts)
    for unit, span in (("d", 86400), ("h", 3600), ("m", 60)):
        if dt >= span:
            return f"{dt / span:.1f}{unit}"
    return f"{dt:.0f}s"


def _parse_kv(text: str, what: str) -> dict:
    """'k=v,k2=v2' -> dict with ints/floats/bools parsed."""
    out = {}
    if not text:
        return out
    for part in text.split(","):
        if "=" not in part:
            print(f"unparseable {what} fragment {part!r} (want k=v)",
                  file=sys.stderr)
            raise SystemExit(2)
        k, v = part.split("=", 1)
        try:
            out[k.strip()] = json.loads(v)
        except ValueError:
            out[k.strip()] = v
    return out


def cmd_ls(args) -> int:
    es = _store(args).entries()
    es.sort(key=lambda e: (e.get("kernel", "?"), str(e.get("bucket"))))
    print(f"{'kernel':<24} {'device':<24} {'dtype':<9} "
          f"{'bucket':<38} {'hits':>5} {'last_hit':>9}")
    for e in es:
        bucket = json.dumps(e.get("bucket", {}), sort_keys=True)
        if len(bucket) > 38:
            bucket = bucket[:35] + "..."
        print(f"{e.get('kernel', '?'):<24} "
              f"{e.get('device_kind', '?'):<24} "
              f"{e.get('dtype', '?'):<9} {bucket:<38} "
              f"{e.get('hits', 0):>5} "
              f"{_age(e.get('last_hit', 0.0)):>9}")
    print(f"{len(es)} entries, {sum(e['bytes'] for e in es)} bytes")
    return 0


def cmd_verify(args) -> int:
    result = _store(args).verify()
    bad = sorted(fp for fp, ok in result.items() if not ok)
    for fp in sorted(result):
        print(f"{'OK ' if result[fp] else 'BAD'} {fp}")
    print(f"{len(result)} entries, {len(bad)} bad")
    return 1 if bad else 0


def cmd_sweep(args) -> int:
    from ..tuning import get_tunable, list_tunables, sweep

    store = _store(args)
    names = list_tunables() if args.kernel == "all" else [args.kernel]
    if args.kernel == "all" and (args.problem or args.subset):
        # a problem/subset spec cannot apply to every kernel's distinct
        # parameter space — silently measuring the defaults instead
        # would hand back configs for sizes the user never asked for
        print("--problem/--subset require a single --kernel "
              "(each kernel has its own problem shape and space)",
              file=sys.stderr)
        raise SystemExit(2)
    for name in names:
        get_tunable(name)  # unknown-kernel usage errors before any work
    problem = _parse_kv(args.problem, "--problem") or None
    subset = None
    if args.subset:
        subset = {k: (v if isinstance(v, list)
                      else [json.loads(x) if x else x
                            for x in str(v).split("|")])
                  for k, v in _parse_kv(args.subset, "--subset").items()}
    for name in names:
        print(f"sweeping {name}...")
        rec = sweep(name, problem,
                    dtype=args.dtype, iters=args.iters,
                    samples=args.samples, store=store,
                    force=args.force, device=args.device,
                    subset=subset, progress=print)
        best = ("" if rec.best_ms is None
                else f"  ({rec.best_ms:.4f} ms/call)")
        print(f"  -> {name}[{json.dumps(rec.bucket, sort_keys=True)}] "
              f"= {rec.config}{best}")
    return 0


def cmd_gc(args) -> int:
    store = _store(args)
    before = store.total_bytes()
    evicted = store.gc(args.max_bytes)
    print(f"evicted {len(evicted)} entries "
          f"({before - store.total_bytes()} bytes); "
          f"{store.total_bytes()} bytes remain")
    for fp in evicted:
        print(f"  {fp}")
    return 0


def cmd_clear(args) -> int:
    n = _store(args).clear()
    print(f"cleared {n} entries")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.tuning",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd")
    for name, fn in (("ls", cmd_ls), ("verify", cmd_verify),
                     ("clear", cmd_clear)):
        p = sub.add_parser(name)
        p.add_argument("--dir", default=None)
        p.set_defaults(fn=fn)
    p = sub.add_parser("sweep")
    p.add_argument("--dir", default=None)
    p.add_argument("--kernel", required=True,
                   help="tunable kernel name, or 'all'")
    p.add_argument("--problem", default="",
                   help="k=v,... problem spec (default: the kernel's "
                        "representative problem for this device)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--subset", default="",
                   help="narrow the space: param=v1|v2,...")
    p.add_argument("--force", action="store_true",
                   help="re-measure even when an entry exists")
    p.add_argument("--device", default="cuda",
                   help="where to measure: cuda (the card, default) or "
                        "cpu (the plain versions' host time)")
    p.set_defaults(fn=cmd_sweep)
    p = sub.add_parser("gc")
    p.add_argument("--dir", default=None)
    p.add_argument("--max-bytes", type=int, required=True)
    p.set_defaults(fn=cmd_gc)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
