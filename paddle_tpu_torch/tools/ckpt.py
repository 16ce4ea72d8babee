"""Maintenance CLI for checkpoint roots (counterpart of
paddle_tpu/tools/ckpt.py, the same commands, output and exit status).

    python -m paddle_tpu_torch.tools.ckpt ls     --root DIR
    python -m paddle_tpu_torch.tools.ckpt verify --root DIR [--serial N]
    python -m paddle_tpu_torch.tools.ckpt gc     --root DIR --keep N
    python -m paddle_tpu_torch.tools.ckpt clean  --root DIR

Understands every checkpoint format (dense, sharded, elastic — the
readers auto-detect via meta.json). ``verify`` re-hashes every recorded
payload; ``gc`` applies the scroll-delete rule (a serial is only pruned
when a NEWER VALID serial exists, so gc can never drop the last
recoverable state). Exit codes: 0 ok, 1 verify found invalid serials,
2 usage error (missing/unknown root or command).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional


def _root(args) -> str:
    if not args.root or not os.path.isdir(args.root):
        print("no checkpoint root: pass --root DIR (an existing "
              "directory)", file=sys.stderr)
        raise SystemExit(2)
    return args.root


def _fmt(meta) -> str:
    if meta is None:
        return "corrupt"
    fmt = meta.get("format")
    if fmt in ("elastic", "sharded"):
        return fmt
    return "dense" if "md5" in meta else "?"


def _age(ts: float) -> str:
    if not ts:
        return "-"
    dt = max(0.0, time.time() - ts)
    for unit, span in (("d", 86400), ("h", 3600), ("m", 60)):
        if dt >= span:
            return f"{dt / span:.1f}{unit}"
    return f"{dt:.0f}s"


def _dir_bytes(d: str) -> int:
    total = 0
    try:
        for name in os.listdir(d):
            try:
                total += os.path.getsize(os.path.join(d, name))
            except OSError:
                pass
    except OSError:
        pass
    return total


def cmd_ls(args) -> int:
    from ..ckpt import (is_valid, list_checkpoints, manifest_entries,
                        read_meta, serial_dir)

    root = _root(args)
    serials = list_checkpoints(root)
    print(f"{'serial':>6} {'format':<8} {'valid':<5} {'procs':>5} "
          f"{'vars':>5} {'bytes':>12} {'age':>8}")
    total = 0
    for s in serials:
        meta = read_meta(root, s)
        d = serial_dir(root, s)
        nbytes = _dir_bytes(d)
        total += nbytes
        try:
            nvars = len(manifest_entries(root, s))
        except Exception:
            nvars = 0
        try:
            # a live trainer's scroll-delete can reclaim the serial
            # between the listing and this stat — show it as ageless
            # rather than aborting the whole listing
            age = _age(os.path.getmtime(d))
        except OSError:
            age = "-"
        print(f"{s:>6} {_fmt(meta):<8} {'y' if is_valid(root, s) else '-':<5} "
              f"{(meta or {}).get('process_count', 1):>5} {nvars:>5} "
              f"{nbytes:>12} {age:>8}")
    print(f"{len(serials)} serial(s), {total} bytes")
    return 0


def cmd_verify(args) -> int:
    from ..ckpt import is_valid, latest_valid_serial, list_checkpoints

    root = _root(args)
    serials = list_checkpoints(root)
    if args.serial is not None:
        if args.serial not in serials:
            print(f"serial {args.serial} not found in {root}",
                  file=sys.stderr)
            return 1
        serials = [args.serial]
    bad = []
    for s in serials:
        ok = is_valid(root, s)
        if not ok:
            bad.append(s)
        print(f"{'OK ' if ok else 'BAD'} checkpoint_{s}")
    newest = latest_valid_serial(root)
    print(f"{len(serials)} serial(s), {len(bad)} bad; "
          f"newest valid: {newest if newest is not None else '-'}")
    return 1 if bad else 0


def cmd_gc(args) -> int:
    from ..ckpt import _scroll_delete, list_checkpoints, sweep_orphans

    root = _root(args)
    before = list_checkpoints(root)
    # explicit maintenance: no writer can be live, sweep every orphan
    orphans = sweep_orphans(root, max_age_s=0.0)
    _scroll_delete(root, max(1, args.keep))
    after = set(list_checkpoints(root))
    dropped = [s for s in before if s not in after]
    print(f"pruned {len(dropped)} serial(s), "
          f"{len(orphans)} crash-orphaned temp artifact(s); "
          f"{len(after)} remain")
    for s in dropped:
        print(f"  checkpoint_{s}")
    return 0


def cmd_clean(args) -> int:
    from ..ckpt import clean_checkpoint, list_checkpoints

    root = _root(args)
    n = len(list_checkpoints(root))
    clean_checkpoint(root)
    print(f"removed {n} serial(s)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.ckpt",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd")
    for name, fn in (("ls", cmd_ls), ("clean", cmd_clean)):
        p = sub.add_parser(name)
        p.add_argument("--root", default=None)
        p.set_defaults(fn=fn)
    p = sub.add_parser("verify")
    p.add_argument("--root", default=None)
    p.add_argument("--serial", type=int, default=None)
    p.set_defaults(fn=cmd_verify)
    p = sub.add_parser("gc")
    p.add_argument("--root", default=None)
    p.add_argument("--keep", type=int, required=True)
    p.set_defaults(fn=cmd_gc)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
