"""Chaos CLI: execute a deterministic fault plan against a named
workload (counterpart of paddle_tpu/tools/chaos.py: the same workloads,
output keys and exit codes).

    python -m paddle_tpu_torch.tools.chaos list
    python -m paddle_tpu_torch.tools.chaos run
        --workload {train,serve,decode,fleet}
        [--plan PLAN.json | --plan '{"seed":7,"faults":[...]}']
        [--steps N] [--seed S] [--record DIR] [--device cuda|cpu]

``list`` prints the registered fault-point registry (site name + the
failure semantics the injection exercises). ``run`` installs the plan
in THIS process (so ``crash`` rules genuinely SIGKILL the CLI — run
those under the supervisor instead) and drives a small workload through
the wired code paths, on the card (``--device cuda``, the default) or
the host (``--device cpu``):

  * train  — a Trainer epoch loop (sites: trainer.step, ckpt.publish/
             payload via a per-epoch checkpoint);
  * serve  — an InferenceServer with a circuit breaker under a burst of
             requests (sites: serving.step);
  * decode — a DecodeSession generating under continuous batching
             (sites: decoding.prefill, decoding.step);
  * fleet  — one prefix-affinity Router over 1 prefill + 2 decode
             LocalReplicas serving a seeded mixed greedy/sampled/
             priority burst, every accepted stream checked against a
             sequential single-replica unfaulted oracle (sites:
             fleet.route, fleet.migrate, fleet.replica_death, plus the
             decode sites above).

``--record DIR`` additionally enables the flight recorder
(paddle_tpu_torch.obs.record) for the run: the workload's crash/exception
paths dump post-mortem bundles under DIR, and the output JSON gains
``bundles`` plus ``bundle_valid`` (every published bundle re-validated
through the tools.postmortem machinery).

Output: ONE JSON line — workload results, the injections that fired,
the full injection log, and (serve/decode) the health snapshot. Exit
codes: 0 workload completed (injections surfacing as typed errors are
EXPECTED chaos outcomes, not CLI failures), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def cmd_list(args) -> int:
    from ..resilience import FAULT_POINTS

    width = max(len(n) for n in FAULT_POINTS)
    for name in sorted(FAULT_POINTS):
        print(f"{name:<{width}}  {FAULT_POINTS[name]}")
    print(f"{len(FAULT_POINTS)} registered fault points")
    return 0


# ---------------------------------------------------------------------------
# workloads — all small, all through the real wired paths
# ---------------------------------------------------------------------------


def _place(device: str):
    import paddle_tpu_torch as fluid

    return fluid.CUDAPlace(0) if device == "cuda" else fluid.CPUPlace()


def _wl_train(steps: int, seed: int, device: str) -> dict:
    import tempfile

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ckpt import CheckpointConfig, latest_valid_serial
    from paddle_tpu_torch.resilience import InjectedFault

    rng = np.random.RandomState(seed)
    w = rng.randn(8, 1).astype("float32")

    def train_func():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(steps):
            xb = r.randn(4, 8).astype("float32")
            yield [(xb[i], xb[i] @ w) for i in range(4)]

    ckpt_dir = tempfile.mkdtemp(prefix="pdtpu_chaos_ckpt_")
    losses: List[float] = []
    errors: List[str] = []

    def handler(e):
        if type(e).__name__ == "EndStepEvent" and e.metrics:
            losses.append(float(np.asarray(e.metrics[0])))

    t = fluid.Trainer(
        train_func=train_func,
        optimizer_func=lambda: fluid.SGD(learning_rate=0.05),
        place=_place(device),
        checkpoint_config=CheckpointConfig(checkpoint_dir=ckpt_dir,
                                           step_interval=None))
    try:
        t.train(num_epochs=1, event_handler=handler, reader=reader,
                feed_order=["x", "y"])
    except InjectedFault as e:
        errors.append(repr(e))
    return {"steps_run": len(losses), "losses": losses[-3:],
            "errors": errors,
            "checkpoint_serial": latest_valid_serial(ckpt_dir)}


def _serve_program(place):
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        pred = fluid.layers.fc(input=x, size=4, act="softmax")
    fluid.Executor(place).run(startup, scope=scope)
    return main, scope, pred


def _wl_serve(steps: int, seed: int, device: str) -> dict:
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.resilience import CircuitBreaker
    from paddle_tpu_torch.serving import (ServingConfig, is_retriable,
                                          serve_program)

    place = _place(device)
    main, scope, pred = _serve_program(place)
    config = ServingConfig(max_batch_size=8, queue_capacity=32,
                           batch_timeout_ms=0.5,
                           breaker=CircuitBreaker(min_samples=4,
                                                  reset_timeout_s=0.2))
    rng = np.random.RandomState(seed)
    ok = retriable = fatal = 0
    with fluid.scope_guard(scope):
        server = serve_program(main, feed_names=["x"], fetch_list=[pred],
                               scope=scope, config=config, place=place)
        results = []
        for _ in range(steps):
            try:
                results.append(server.submit(
                    {"x": rng.randn(2, 8).astype("float32")}))
            except Exception as e:
                (retriable, fatal) = (
                    (retriable + 1, fatal) if is_retriable(e)
                    else (retriable, fatal + 1))
        for f in results:
            try:
                f.result(timeout=60)
                ok += 1
            except Exception as e:
                (retriable, fatal) = (
                    (retriable + 1, fatal) if is_retriable(e)
                    else (retriable, fatal + 1))
        health = server.health()
        server.shutdown(drain=True, timeout=60)
    return {"requests": steps, "ok": ok, "retriable_errors": retriable,
            "fatal_errors": fatal, "health": health}


def _wl_decode(steps: int, seed: int, device: str) -> dict:
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import (CacheConfig, DecodingConfig,
                                           serve_decoding)
    from paddle_tpu_torch.models.causal_lm import causal_lm
    from paddle_tpu_torch.resilience import CircuitBreaker
    from paddle_tpu_torch.serving import is_retriable

    place = _place(device)
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens, logits = causal_lm(vocab_size=23, n_layer=1, n_head=2,
                                   d_model=16, d_inner_hid=32)
    fluid.Executor(place).run(startup, scope=scope)
    config = DecodingConfig(
        cache=CacheConfig(num_blocks=16, block_size=4,
                          max_blocks_per_seq=4),
        decode_buckets=(1, 2, 4), max_new_tokens=4,
        breaker=CircuitBreaker(min_samples=4, reset_timeout_s=0.2))
    rng = np.random.RandomState(seed)
    ok = retriable = fatal = 0
    with fluid.scope_guard(scope):
        session = serve_decoding(main, "tokens", logits.name,
                                 scope=scope, config=config, place=place)
        futs = []
        for _ in range(steps):
            try:
                futs.append(session.submit(
                    rng.randint(1, 23, size=rng.randint(2, 6))))
            except Exception as e:
                (retriable, fatal) = (
                    (retriable + 1, fatal) if is_retriable(e)
                    else (retriable, fatal + 1))
        for f in futs:
            try:
                f.result(timeout=120)
                ok += 1
            except Exception as e:
                (retriable, fatal) = (
                    (retriable + 1, fatal) if is_retriable(e)
                    else (retriable, fatal + 1))
        health = session.health()
        session.shutdown(drain=True, timeout=120)
    return {"requests": steps, "ok": ok, "retriable_errors": retriable,
            "fatal_errors": fatal, "health": health}


def _wl_fleet(steps: int, seed: int, device: str) -> dict:
    """The MULTI-REPLICA chaos storm. One prefix-affinity
    Router fronts 1 prefill + 2 decode LocalReplicas (bit-identical
    weights, one shared MigrationStore) and serves a seeded mixed
    greedy/sampled/priority burst while the installed plan injects
    into the fleet fault points (fleet.route, fleet.migrate,
    fleet.replica_death in raise mode = an in-process replica death)
    and any decode-tier sites. Every ACCEPTED stream is checked
    bit-identical against a sequential SINGLE-replica unfaulted
    oracle; every rejection must be a typed retriable error; corrupt
    migration payloads degrade to local re-prefill, never a crash;
    surviving decode pools end fully reclaimable."""
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.convert import seeded_state
    from paddle_tpu_torch.decoding import (CacheConfig, DecodingConfig,
                                           SamplingParams, serve_decoding)
    from paddle_tpu_torch.decoding.engine import DecodeEngine
    from paddle_tpu_torch.models.causal_lm import causal_lm
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import is_retriable

    place = _place(device)
    cache = dict(num_blocks=24, block_size=4, max_blocks_per_seq=6)

    def build():
        # every replica must hold IDENTICAL weights for cross-replica
        # resume to be bit-identical: float params are pure seeded
        # noise, deterministic regardless of initializer state
        main, startup = fluid.Program(), fluid.Program()
        scope = fluid.Scope()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, startup):
            tokens, logits = causal_lm(vocab_size=23, n_layer=1,
                                       n_head=2, d_model=16,
                                       d_inner_hid=32)
        fluid.Executor(place).run(startup, scope=scope)
        # the JAX CLI's weights: one seed, one model in either package
        seeded_state(main, scope, place, seed + 100, 0.1)
        return main, scope, logits

    def config():
        return DecodingConfig(
            cache=CacheConfig(prefix_cache=True, **cache),
            decode_buckets=(1, 2, 4), max_new_tokens=6,
            sampling=True)

    rng = np.random.RandomState(seed)
    shared = [list(rng.randint(1, 23, size=8)) for _ in range(2)]
    n = max(8, 2 * steps)
    reqs = []
    for i in range(n):
        prompt = shared[i % 2] + list(rng.randint(1, 23, size=2))
        sp = None
        if i % 3 == 1:
            sp = SamplingParams(temperature=0.8, top_k=5,
                                seed=int(rng.randint(1 << 16)))
        elif i % 3 == 2:
            sp = SamplingParams(temperature=0.7, top_p=0.9,
                                seed=int(rng.randint(1 << 16)))
        reqs.append((prompt, sp, i % 3))

    # sequential single-replica unfaulted oracle (the plan pauses)
    plan = faults.active_plan()
    faults.clear_plan()
    main, scope, logits = build()
    s0 = serve_decoding(main, "tokens", logits.name, scope=scope,
                        config=config(), place=place)
    oracle = [s0.generate(p, max_new_tokens=6, sampling=sp,
                          priority=pr, timeout=300)
              for p, sp, pr in reqs]
    s0.shutdown(drain=True, timeout=120)
    if plan is not None:
        faults.install_plan(plan)

    store_dir = tempfile.mkdtemp(prefix="pdtpu-fleet-chaos-")
    store = fleet.MigrationStore(store_dir)
    reps = []
    for i in range(2):
        m2, sc2, lg2 = build()
        sess = serve_decoding(m2, "tokens", lg2.name, scope=sc2,
                              config=config(), place=place)
        reps.append(fleet.LocalReplica(
            "decode-%d" % i, sess,
            migrator=fleet.BlockMigrator(store, sess.engine)))
    m3, sc3, lg3 = build()
    eng = DecodeEngine(m3, "tokens", lg3.name, scope=sc3,
                       config=config(), place=place)
    eng.warm_up()
    mig_p = fleet.BlockMigrator(store, eng, export=True)
    reps.append(fleet.LocalReplica(
        "prefill-0", fleet.PrefillWorker(eng, mig_p), role="prefill",
        migrator=mig_p))
    router = fleet.Router(reps, fleet.FleetConfig(
        cache=CacheConfig(prefix_cache=True, **cache),
        health_interval_s=0.1))

    ok = bit_identical = retriable = fatal = 0
    try:
        futs = [(i, router.submit(p, max_new_tokens=6, sampling=sp,
                                  priority=pr))
                for i, (p, sp, pr) in enumerate(reqs)]
        for i, f in futs:
            try:
                got = f.result(timeout=300)
                ok += 1
                if got == oracle[i]:
                    bit_identical += 1
            except Exception as e:
                if is_retriable(e):
                    retriable += 1
                else:
                    fatal += 1
        health = router.health()
        counts = router.metrics.report()
        mig = {"published": 0, "restored": 0, "corrupt": 0}
        for r in reps:
            if r.migrator is not None:
                st = r.migrator.stats()
                for k in mig:
                    mig[k] += st[k]
        store_entries = len(store.keys())
        # surviving decode pools fully reclaimable (checked BEFORE the
        # drain marks every replica dead)
        survivors = [r for r in reps
                     if r.role == "decode" and not r.dead]
        pool_clean = bool(survivors) and all(
            r.target.kv.live_sequences == 0
            and r.target.kv.reclaimable_blocks
            == r.target.kv.config.num_blocks for r in survivors)
    finally:
        router.drain(timeout=120)
        shutil.rmtree(store_dir, ignore_errors=True)
    return {"requests": n, "ok": ok, "bit_identical": bit_identical,
            "retriable_errors": retriable, "fatal_errors": fatal,
            "replica_deaths": counts["replica_deaths"],
            "resumes": counts["resumes"],
            "retries": counts["retries"],
            "affinity_hits": counts["affinity_hits"],
            "spillovers": counts["spillovers"],
            "prefills_delegated": counts["prefills_delegated"],
            "route_overloaded": counts["route_overloaded"],
            "migration": mig, "store_entries": store_entries,
            "pool_clean": pool_clean, "live": health["live"],
            "status": health["status"],
            "max_pressure": health["pressure"]}


WORKLOADS = {"train": _wl_train, "serve": _wl_serve,
             "decode": _wl_decode, "fleet": _wl_fleet}


def cmd_run(args) -> int:
    from ..resilience import faults

    if args.record:
        # flight-recorder mode: the workload's crash/exception paths
        # dump post-mortem bundles here (fast cadence — a chaos run is
        # short), and the output JSON reports whether every published
        # bundle validates. An explicit --record wins over any
        # already-enabled recorder (enable() is idempotent — without
        # the disable, an env-auto-enabled recorder would keep its own
        # dir and --record DIR would never be created)
        from ..obs import record as obs_record

        obs_record.disable()
        obs_record.enable(dir=args.record, interval_s=0.2)
    plan = (faults.load_plan(args.plan) if args.plan
            else faults.FaultPlan(seed=args.seed))
    faults.install_plan(plan)
    result = WORKLOADS[args.workload](args.steps, args.seed, args.device)
    result = {
        "workload": args.workload,
        "plan_seed": plan.seed,
        "rules": len(plan.faults),
        **result,
        "injections": faults.injections(),
        "injection_log": faults.injection_log(),
        "hit_counts": faults.hit_counts(),
    }
    if args.record:
        # stop the recorder FIRST: a rolling tick racing collection
        # could prune a just-listed bundle mid-validation and flakily
        # report a healthy run as invalid
        obs_record.disable()
        bundles = obs_record.find_bundles(args.record)
        result["bundles"] = bundles
        result["bundle_valid"] = bool(bundles) and all(
            not obs_record.validate_bundle(b) for b in bundles)
    print(json.dumps(result))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.chaos",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd")
    p = sub.add_parser("list")
    p.set_defaults(fn=cmd_list)
    p = sub.add_parser("run")
    p.add_argument("--workload", required=True,
                   choices=sorted(WORKLOADS))
    p.add_argument("--plan", default=None,
                   help="plan file path or inline JSON (default: an "
                        "empty plan — a dry run of the workload)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--record", default=None, metavar="DIR",
                   help="enable the flight recorder for this run: "
                        "post-mortem bundles land here and the output "
                        "JSON gains bundles/bundle_valid (validate "
                        "with `python -m paddle_tpu_torch.tools.postmortem`)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run the workload on the card (default) or the "
                        "host")
    p.set_defaults(fn=cmd_run)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
