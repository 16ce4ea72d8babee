"""CLI for the static program verifier: ``python -m
paddle_tpu_torch.tools.check_program`` (counterpart of
paddle_tpu/tools/check_program.py, the same arguments and exit status).

Reference: the offline ProgramDesc tooling the reference ships around
its protobuf IR (tools/print_signatures.py for the API surface,
debugger.py for dumps); this is the analysis companion — point it at a
``save_inference_model`` artifact directory (the ``__model__.json``
manifest carries the full structural op/var graph) or at a named demo
model, and it prints the diagnostic listing and, with ``--hbm``, the
static peak device-memory report. It analyzes programs only and runs
nothing, so it needs no card.

Exit status: 0 clean, 1 error-severity diagnostics found, 2 bad usage.
``--comm`` and ``--shard`` (the SPMD communication analysis) exit 2:
they are not ported (ROADMAP Queue A 9).

Examples:
    python -m paddle_tpu_torch.tools.check_program --model mlp --hbm
    python -m paddle_tpu_torch.tools.check_program /path/to/artifact_dir
    python -m paddle_tpu_torch.tools.check_program --model resnet --batch 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_NOT_PORTED = ("error: %s: the SPMD communication analysis is not "
               "ported yet (ROADMAP Queue A 9)")


def _program_from_manifest(manifest: dict):
    """Rebuild a STRUCTURAL Program (symbol table + fn=None ops) from a
    save_inference_model manifest — enough for the validator, liveness
    and recompile lint; shape inference degrades to the declared types
    (op fns cannot be rebuilt from JSON)."""
    from ..core.program import Program

    program = Program()
    gb = program.global_block()
    for name, meta in manifest.get("vars", {}).items():
        gb.create_var(name=name, shape=meta.get("shape"),
                      dtype=meta.get("dtype") or "float32",
                      persistable=bool(meta.get("persistable")),
                      is_data=bool(meta.get("is_data")))
    for desc in manifest.get("ops", []):
        gb.append_op(type=desc["type"], inputs=desc.get("inputs") or {},
                     outputs=desc.get("outputs") or {},
                     attrs=desc.get("attrs") or {}, fn=None)
    return program


def _build_demo(model: str):
    """Build (main, startup, feed_names, fetch_names) for a named demo
    model — the corpus the CLI smoke test drives (the JAX package's)."""
    import paddle_tpu_torch as fluid
    from ..core import unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        if model == "mlp":
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            h = fluid.layers.fc(input=x, size=16, act="relu")
            pred = fluid.layers.fc(input=h, size=1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(pred, y))
            fluid.SGD(learning_rate=0.1).minimize(loss)
            return main, startup, ["x", "y"], [loss.name]
        if model == "mnist":
            from ..models.mnist import mnist_cnn

            img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                    dtype="float32")
            lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
            pred = mnist_cnn(img)
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, lbl))
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
            return main, startup, ["img", "lbl"], [loss.name]
        if model == "resnet":
            from ..models import resnet

            image, label, avg_cost, predict = resnet.build_train(
                class_dim=10, depth=20, image_shape=(3, 32, 32),
                cifar=True)
            fluid.optimizer.Momentum(learning_rate=0.1,
                                     momentum=0.9).minimize(avg_cost)
            return main, startup, [image.name, label.name], [avg_cost.name]
    raise AssertionError(f"unhandled model {model!r}")  # argparse guards


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.check_program",
        description="Static program verifier: graph validation, shape/"
                    "dtype inference, recompile lint, peak-memory report.")
    ap.add_argument("model_dir", nargs="?",
                    help="save_inference_model artifact directory "
                         "(__model__.json manifest)")
    ap.add_argument("--model", choices=["mlp", "mnist", "resnet"],
                    help="check a built-in demo model instead of an "
                         "artifact")
    ap.add_argument("--hbm", action="store_true",
                    help="also print the static peak device-memory report")
    ap.add_argument("--batch", type=int, default=1,
                    help="extent assumed for dynamic (-1) dims in the "
                         "memory report (default 1)")
    ap.add_argument("--buckets", type=str, default=None,
                    help="comma-separated serving bucket sizes for the "
                         "recompile cross-check, e.g. 1,2,4,8")
    ap.add_argument("--strict-batch", action="store_true",
                    help="serving-oriented lint: also flag a dynamic "
                         "batch axis not covered by --buckets")
    ap.add_argument("--comm", action="store_true",
                    help="the SPMD communication analysis (not ported: "
                         "exits 2, ROADMAP Queue A 9)")
    ap.add_argument("--shard", type=str, default=None, metavar="AXES",
                    help="shard the demo model over a training mesh "
                         "(not ported: exits 2, ROADMAP Queue A 9)")
    ap.add_argument("--after-pass", type=str, default=None,
                    metavar="PIPELINE",
                    help="apply a comma-separated pass pipeline "
                         "(python -m paddle_tpu_torch.tools.passes list) "
                         "through the PassManager BEFORE analyzing — "
                         "verifies the program a pipeline would ship, "
                         "not the one that was built")
    args = ap.parse_args(argv)

    if bool(args.model_dir) == bool(args.model):
        ap.print_usage(sys.stderr)
        print("error: give exactly one of MODEL_DIR or --model",
              file=sys.stderr)
        return 2
    if args.comm or args.shard:
        print(_NOT_PORTED % ("--comm" if args.comm else "--shard"),
              file=sys.stderr)
        return 2

    from .. import analysis

    buckets = ([int(b) for b in args.buckets.split(",")]
               if args.buckets else None)

    if args.model:
        main_prog, startup, feeds, fetches = _build_demo(args.model)
        programs = [("startup", startup, [], []),
                    ("main", main_prog, feeds, fetches)]
    else:
        path = os.path.join(args.model_dir, "__model__.json")
        if not os.path.exists(path):
            print(f"error: no __model__.json under {args.model_dir!r}",
                  file=sys.stderr)
            return 2
        with open(path) as f:
            manifest = json.load(f)
        prog = _program_from_manifest(manifest)
        programs = [("main", prog, manifest.get("feed_names", []),
                     manifest.get("fetch_names", []))]

    if args.after_pass:
        from .. import passes as _passes

        names = [n.strip() for n in args.after_pass.split(",")
                 if n.strip()]
        rewritten = []
        for label, prog, feeds, fetches in programs:
            if label == "startup":
                rewritten.append((label, prog, feeds, fetches))
                continue  # pipelines target the main/inference program
            try:
                # keep-aware passes (dce, fusion) get the program's
                # fetch names as barriers, exactly like tools.passes
                # run and the save_inference_model pipeline — without
                # them dce would delete the whole forward and report a
                # false violation
                pipeline = _passes.build_pipeline(names, keep=fetches)
            except Exception as e:
                print(f"error: --after-pass: {e}", file=sys.stderr)
                return 2
            try:
                prog = _passes.PassManager(pipeline).apply(prog)
            except _passes.PassError as e:
                print(f"== {label} program ==")
                print(f"after-pass INVARIANT VIOLATION: {e}")
                return 1
            rewritten.append((label + f" (after {args.after_pass})",
                              prog, feeds, fetches))
        programs = rewritten

    rc = 0
    for label, prog, feeds, fetches in programs:
        report = analysis.check_program(
            prog, feed=feeds, fetch_list=fetches, buckets=buckets,
            strict_batch=args.strict_batch,
            with_memory=args.hbm,
            assume_batch=args.batch)
        print(f"== {label} program "
              f"({sum(len(b.ops) for b in prog.blocks)} ops, "
              f"{len(prog.blocks)} block(s)) ==")
        print(report)
        if not report.ok:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
