"""Maintenance CLI for the persistent compile cache (counterpart of
paddle_tpu/tools/cache.py, the same commands, output and exit codes).

    python -m paddle_tpu_torch.tools.cache stats  [--dir DIR]
    python -m paddle_tpu_torch.tools.cache ls     [--dir DIR]
    python -m paddle_tpu_torch.tools.cache verify [--dir DIR]
    python -m paddle_tpu_torch.tools.cache gc --max-bytes N [--dir DIR]
    python -m paddle_tpu_torch.tools.cache clear  [--dir DIR]

``--dir`` defaults to the ``compile_cache_dir`` flag (settable through
the ``PDTPU_COMPILE_CACHE_DIR`` env var). Exit codes: 0 ok, 1 verify
found corrupt entries, 2 usage error (no cache dir / unknown command).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def _store(args):
    from ..compile_cache.store import CacheStore
    from ..core import flags

    d = args.dir or flags.get_flag("compile_cache_dir")
    if not d:
        print("no cache dir: pass --dir or set the compile_cache_dir "
              "flag (PDTPU_COMPILE_CACHE_DIR)", file=sys.stderr)
        raise SystemExit(2)
    return CacheStore(str(d))


def _age(ts: float) -> str:
    if not ts:
        return "-"
    dt = max(0.0, time.time() - ts)
    for unit, span in (("d", 86400), ("h", 3600), ("m", 60)):
        if dt >= span:
            return f"{dt / span:.1f}{unit}"
    return f"{dt:.0f}s"


def cmd_stats(args) -> int:
    st = _store(args).stats()
    for k in ("root", "entries", "bytes", "hits", "with_executable",
              "corrupt"):
        print(f"{k:>16}: {st[k]}")
    return 0


def cmd_ls(args) -> int:
    es = _store(args).entries()
    es.sort(key=lambda e: -e.get("last_hit", 0.0))
    print(f"{'fingerprint':<16} {'kind':<12} {'bytes':>10} {'hits':>5} "
          f"{'exe':>4} {'last_hit':>9}")
    for e in es:
        print(f"{e['fingerprint'][:16]:<16} {e['kind']:<12} "
              f"{e['bytes']:>10} {e.get('hits', 0):>5} "
              f"{'y' if e.get('has_executable') else '-':>4} "
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
        prog="python -m paddle_tpu_torch.tools.cache",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd")
    for name, fn in (("stats", cmd_stats), ("ls", cmd_ls),
                     ("verify", cmd_verify), ("clear", cmd_clear)):
        p = sub.add_parser(name)
        p.add_argument("--dir", default=None)
        p.set_defaults(fn=fn)
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
