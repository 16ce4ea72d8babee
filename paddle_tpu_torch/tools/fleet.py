"""Fleet CLI: run, inspect and drain paddle_tpu_torch.fleet replica
workers (counterpart of paddle_tpu/tools/fleet.py, with its flags and
exit codes).

    python -m paddle_tpu_torch.tools.fleet serve --name R --fleet-dir DIR \\
        --store DIR [--role decode|prefill] [--seed N] [--vocab V] \\
        [--layers L] [--d-model D] [--num-blocks N] [--block-size B] \\
        [--max-blocks-per-seq M] [--max-new-tokens T] [--device cuda|cpu]
    python -m paddle_tpu_torch.tools.fleet status --fleet-dir DIR
    python -m paddle_tpu_torch.tools.fleet drain  --fleet-dir DIR [--name R]

``serve`` builds a tiny seeded causal LM (``n_head=2``, ``d_inner =
2·d_model``; every float param drawn with numpy from ``--seed`` in the
JAX CLI's order, so same-seed replicas of either package hold
bit-identical weights), wraps it in the requested role over the shared
migration ``--store`` on the card (``--device cuda``, the default) or
the host, publishes its handshake into ``--fleet-dir`` (ephemeral TCP
port + ephemeral /metrics port, so replicas on one host never collide)
and blocks until drained. ``status`` probes every published
handshake's health over the wire and prints one row per replica plus
the aggregate. ``drain`` asks replicas to drain gracefully and exit.

Exit codes: 0 ok (status: at least one live replica), 1 degraded
(status/drain found no live replica or an unreachable one), 2 usage
error.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def _place(args):
    import paddle_tpu_torch as fluid

    return fluid.CUDAPlace(0) if args.device == "cuda" \
        else fluid.CPUPlace()


def _build(args):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import seeded_state
    from paddle_tpu_torch.models.causal_lm import causal_lm

    place = _place(args)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens, logits = causal_lm(vocab_size=args.vocab,
                                   n_layer=args.layers, n_head=2,
                                   d_model=args.d_model,
                                   d_inner_hid=2 * args.d_model)
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    seeded_state(main, scope, place, args.seed, 0.1)
    return main, scope, logits


def _config(args):
    from ..decoding import CacheConfig, DecodingConfig

    return DecodingConfig(
        cache=CacheConfig(prefix_cache=True,
                          num_blocks=args.num_blocks,
                          block_size=args.block_size,
                          max_blocks_per_seq=args.max_blocks_per_seq),
        decode_buckets=(1, 2, 4), sampling=True,
        max_new_tokens=args.max_new_tokens)


def cmd_serve(args) -> int:
    from .. import fleet

    store = fleet.MigrationStore(args.store)
    if args.role == "prefill":
        from ..decoding.engine import DecodeEngine

        main, scope, logits = _build(args)
        eng = DecodeEngine(main, "tokens", logits.name, scope=scope,
                           config=_config(args), place=_place(args))
        eng.warm_up()
        mig = fleet.BlockMigrator(store, eng, export=True)
        target = fleet.PrefillWorker(eng, mig)
    else:
        from ..decoding import serve_decoding

        main, scope, logits = _build(args)
        sess = serve_decoding(main, "tokens", logits.name,
                              scope=scope, config=_config(args),
                              place=_place(args))
        mig = fleet.BlockMigrator(store, sess.engine)
        target = sess
    srv = fleet.serve_replica(target, args.name, role=args.role,
                              fleet_dir=args.fleet_dir, migrator=mig)
    print("serving %s role=%s port=%d fleet_dir=%s"
          % (args.name, args.role, srv.port, args.fleet_dir),
          flush=True)
    srv.serve_forever()
    print("drained", flush=True)
    return 0


def cmd_status(args) -> int:
    from .. import fleet

    handshakes = fleet.discover(args.fleet_dir)
    if not handshakes:
        print("no handshakes in %s" % args.fleet_dir, file=sys.stderr)
        return 1
    live = 0
    print(f"{'name':<12} {'role':<8} {'port':>6} {'metrics':>8} "
          f"{'status':<9} {'pressure':>8} {'stage':>5}")
    for hs in handshakes:
        h = fleet.RemoteReplica(hs).health(timeout=args.timeout)
        if h is None:
            print(f"{hs['name']:<12} {hs.get('role', '?'):<8} "
                  f"{hs.get('port', 0):>6} "
                  f"{str(hs.get('metrics_port') or '-'):>8} "
                  f"{'DEAD':<9} {'-':>8} {'-':>5}")
            continue
        live += 1
        print(f"{hs['name']:<12} {h.get('role', '?'):<8} "
              f"{hs.get('port', 0):>6} "
              f"{str(hs.get('metrics_port') or '-'):>8} "
              f"{h.get('status', '?'):<9} "
              f"{h.get('pressure', 0.0):>8} "
              f"{h.get('degradation_stage') or 0:>5}")
    print("%d replica(s), %d live" % (len(handshakes), live))
    return 0 if live else 1


def cmd_drain(args) -> int:
    from .. import fleet

    handshakes = [hs for hs in fleet.discover(args.fleet_dir)
                  if args.name in (None, hs["name"])]
    if not handshakes:
        print("no matching handshakes in %s" % args.fleet_dir,
              file=sys.stderr)
        return 1
    failed = 0
    for hs in handshakes:
        r = fleet.RemoteReplica(hs)
        alive = r.health(timeout=args.timeout) is not None
        r.drain(timeout=args.timeout)
        # the server tears down asynchronously after acking the drain;
        # poll until its health endpoint actually goes away
        deadline = time.monotonic() + args.timeout
        still = fleet.RemoteReplica(hs).health(timeout=args.timeout)
        while still is not None and time.monotonic() < deadline:
            time.sleep(0.2)
            still = fleet.RemoteReplica(hs).health(timeout=args.timeout)
        if still is None:
            print("drained %s" % hs["name"])
            if not alive:
                failed += 1  # it was already unreachable
        else:
            print("FAILED to drain %s" % hs["name"], file=sys.stderr)
            failed += 1
    return 1 if failed else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.fleet",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd")
    p = sub.add_parser("serve")
    p.add_argument("--name", required=True)
    p.add_argument("--fleet-dir", required=True)
    p.add_argument("--store", required=True,
                   help="shared migration-store root")
    p.add_argument("--role", choices=["decode", "prefill"],
                   default="decode")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--vocab", type=int, default=23)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--d-model", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=24)
    p.add_argument("--block-size", type=int, default=4)
    p.add_argument("--max-blocks-per-seq", type=int, default=6)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="serve on the card (default) or the host")
    p.set_defaults(fn=cmd_serve)
    for name, fn in (("status", cmd_status), ("drain", cmd_drain)):
        p = sub.add_parser(name)
        p.add_argument("--fleet-dir", required=True)
        p.add_argument("--timeout", type=float, default=5.0)
        if name == "drain":
            p.add_argument("--name", default=None,
                           help="drain one replica (default: all)")
        p.set_defaults(fn=fn)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
