"""CLI for the unified pass manager: ``python -m
paddle_tpu_torch.tools.passes`` (counterpart of paddle_tpu/tools/passes.py,
the same subcommands, text and exit status).

Reference: the offline tooling the reference ships around its IR
(tools/print_signatures.py, the analyzer's pass-list dumps); this is
the pass-manager companion to ``tools.check_program``.

Subcommands:

  list                     one line per registered pass (name, kind,
                           declared writes, summary)
  explain <pass>           full contract of one pass: docstring,
                           reads/writes declarations, stamping mode,
                           constructor signature
  run <pipeline> <target>  apply a comma-separated pipeline to a demo
                           model (--model mlp|mnist|resnet) or a
                           ``save_inference_model`` artifact directory,
                           with the manager's central invariants on;
                           prints per-pass op deltas, the composed
                           stamp, and the post-pipeline diagnostic
                           summary

Exit status: 0 clean, 1 invariant violation or error diagnostics,
2 bad usage.

Examples:
    python -m paddle_tpu_torch.tools.passes list
    python -m paddle_tpu_torch.tools.passes explain ptq_int8
    python -m paddle_tpu_torch.tools.passes run dce,transpose_eliminate --model mlp
    python -m paddle_tpu_torch.tools.passes run memory_optimize /path/to/artifact
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

_PROG = "python -m paddle_tpu_torch.tools.passes"


def _summary(cls) -> str:
    doc = inspect.getdoc(cls) or ""
    first = doc.split("\n\n", 1)[0].replace("\n", " ").strip()
    return first if len(first) <= 100 else first[:97] + "..."


def _fmt_family(fam) -> str:
    if fam is None:
        return "(undeclared)"
    if not fam:
        return "(none)"
    return ", ".join(sorted(fam))


def cmd_list(args) -> int:
    from .. import passes

    rows = []
    for name in passes.list_passes():
        cls = passes.pass_class(name)
        kind = ("self-stamping" if cls.stamp_attr
                else "composed-stamp")
        rows.append((name, kind, _fmt_family(cls.writes), _summary(cls)))
    wid = max(len(r[0]) for r in rows)
    kid = max(len(r[1]) for r in rows)
    print(f"{len(rows)} registered passes ({_PROG} explain <name>):")
    for name, kind, writes, summary in rows:
        print(f"  {name:<{wid}}  {kind:<{kid}}  writes: {writes}")
        print(f"  {'':<{wid}}  {summary}")
    return 0


def cmd_explain(args) -> int:
    from .. import passes

    try:
        cls = passes.pass_class(args.name)
    except Exception:
        print(f"error: unknown pass {args.name!r}; registered: "
              f"{', '.join(passes.list_passes())}", file=sys.stderr)
        return 2
    print(f"pass {args.name!r} ({cls.__module__}.{cls.__qualname__})")
    print(f"  reads:  {_fmt_family(cls.reads)}")
    print(f"  writes: {_fmt_family(cls.writes)}")
    if cls.stamp_attr:
        print(f"  stamp:  self-stamping via program.{cls.stamp_attr}")
    else:
        print("  stamp:  name=fingerprint() composed into "
              "program._passes_stamp")
    try:
        print(f"  fingerprint: {cls().fingerprint()}")
    except TypeError:
        print("  fingerprint: (constructor requires arguments — "
              "instantiate via the Python API)")
    except NotImplementedError as e:
        print(f"  fingerprint: ({e})")
    if cls.mutates_scope:
        print("  scope:  rewrites parameter VALUES (needs a scope)")
    if getattr(cls, "requires_backward", False):
        print("  target: TRAINING programs only (reads the backward "
              "op / optimizer state; refused on inference artifacts)")
    try:
        sig = str(inspect.signature(cls.__init__)).replace("'", "")
    except (TypeError, ValueError):
        sig = "(...)"
    print(f"  init:   {cls.__name__}{sig}")
    doc = inspect.getdoc(cls)
    if doc:
        print()
        for line in doc.splitlines():
            print(f"  {line}")
    return 0


def _load_target(args, ap):
    """(label, program, feeds, fetches) for the run target."""
    from .check_program import _build_demo, _program_from_manifest

    if bool(args.model) == bool(args.model_dir):
        ap.print_usage(sys.stderr)
        print("error: give exactly one of MODEL_DIR or --model",
              file=sys.stderr)
        return None
    if args.model:
        main_prog, _startup, feeds, fetches = _build_demo(args.model)
        return "demo:" + args.model, main_prog, feeds, fetches
    path = os.path.join(args.model_dir, "__model__.json")
    if not os.path.exists(path):
        print(f"error: no __model__.json under {args.model_dir!r}",
              file=sys.stderr)
        return None
    with open(path) as f:
        manifest = json.load(f)
    return (args.model_dir, _program_from_manifest(manifest),
            manifest.get("feed_names", []),
            manifest.get("fetch_names", []))


def cmd_run(args, ap) -> int:
    from .. import analysis, passes

    target = _load_target(args, ap)
    if target is None:
        return 2
    label, program, feeds, fetches = target
    names = [n.strip() for n in args.pipeline.split(",") if n.strip()]
    if not names:
        print("error: empty pipeline", file=sys.stderr)
        return 2

    try:
        pipeline = passes.build_pipeline(names, keep=fetches)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # post-backward-only passes (remat_policy, host_offload) read the
    # backward op / optimizer state; a loaded inference artifact has
    # neither — refuse up front with a usage error, same precedent as
    # ptq_int8 without a calibration (structured error, not a
    # PassError traceback out of the manager)
    has_backward = any(op.type == "backward"
                       for b in program.blocks for op in b.ops)
    if not has_backward:
        offenders = [p.name for p in pipeline
                     if getattr(p, "requires_backward", False)]
        if offenders:
            print("error: pass(es) %s require a TRAINING program "
                  "(backward op / optimizer state); %r is an inference "
                  "program — run them through the Python API on the "
                  "training program instead"
                  % (", ".join(repr(n) for n in offenders), label),
                  file=sys.stderr)
            return 2

    def op_count(p):
        return sum(len(b.ops) for b in p.blocks)

    print(f"== {label}: {op_count(program)} ops, "
          f"{len(program.blocks)} block(s) ==")
    rc = 0
    for p in pipeline:
        before = op_count(program)
        try:
            program = passes.PassManager(
                [p], check=not args.no_check,
                stamp=not args.no_check).apply(program)
        except passes.PassError as e:
            print(f"  {p.name}: INVARIANT VIOLATION — {e}")
            return 1
        print(f"  {p.name}: {before} -> {op_count(program)} ops "
              f"(fingerprint {p.fingerprint()})")
    stamp = getattr(program, "_passes_stamp", None)
    print("composed stamp: %s"
          % (stamp or "(absent — no pass changed the program)"))
    report = analysis.check_program(program, feed=feeds,
                                    fetch_list=fetches)
    print(report)
    if not report.ok:
        rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=_PROG,
        description="Unified pass-manager tooling: list/explain "
                    "registered passes, run pipelines under the central "
                    "invariants.")
    sub = ap.add_subparsers(dest="cmd")
    sub.add_parser("list", help="list registered passes")
    ex = sub.add_parser("explain", help="show one pass's contract")
    ex.add_argument("name")
    run = sub.add_parser("run", help="apply a pipeline to a model")
    run.add_argument("pipeline",
                     help="comma-separated registered pass names")
    run.add_argument("model_dir", nargs="?",
                     help="save_inference_model artifact directory")
    run.add_argument("--model", choices=["mlp", "mnist", "resnet"],
                     help="run against a built-in demo model")
    run.add_argument("--no-check", action="store_true",
                     help="skip the central invariants AND stamp "
                          "composition (legacy core.passes shim "
                          "semantics: check=False, stamp=False)")
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return cmd_list(args)
    if args.cmd == "explain":
        return cmd_explain(args)
    if args.cmd == "run":
        return cmd_run(args, ap)
    ap.print_usage(sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
