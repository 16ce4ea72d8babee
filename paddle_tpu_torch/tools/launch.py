"""Multi-process training launcher (counterpart of
paddle_tpu/tools/launch.py).

Reference: paddle/scripts/cluster_train_v2/{fabric,openmpi} launchers and
the NCCL2-mode env contract (benchmark/fluid/README.md:25-49) — the
reference starts trainer/pserver processes with PADDLE_TRAINER_ID /
PADDLE_TRAINERS_NUM style env vars. Here one command spawns N local
worker processes wired for ``torch.distributed``:

    python -m paddle_tpu_torch.tools.launch --nproc 2
        [--coordinator host:port] [--backend gloo] train.py [args...]

Each worker gets PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
PADDLE_COORDINATOR (+ PADDLE_DIST_BACKEND when ``--backend`` is given),
which ``paddle_tpu_torch.parallel.init_distributed`` picks up. One
process per device: under NCCL worker ``r`` drives card
``r % device_count``; gloo runs on the CPU, or several ranks on one
card. On several hosts run this once per host with
--node-rank/--nnodes. First worker failure tears the job down (the
fail-fast behavior of the reference's fabric launcher)."""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.tools.launch",
        description="spawn N distributed training worker processes")
    ap.add_argument("--nproc", type=int, default=1,
                    help="worker processes to launch on this node")
    ap.add_argument("--nnodes", type=int, default=1,
                    help="total nodes in the job")
    ap.add_argument("--node-rank", type=int, default=0,
                    help="rank of this node [0, nnodes)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator host:port (default: localhost on a "
                         "free port; required for nnodes > 1)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="collective backend (default: nccl with a card, "
                         "gloo without)")
    ap.add_argument("script", help="training script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    if args.nnodes > 1 and not args.coordinator:
        ap.error("--coordinator is required when nnodes > 1")
    coordinator = args.coordinator or f"localhost:{_free_port()}"
    world = args.nproc * args.nnodes

    procs = []
    try:
        for local_rank in range(args.nproc):
            rank = args.node_rank * args.nproc + local_rank
            env = dict(os.environ)
            env.update({
                "PADDLE_COORDINATOR": coordinator,
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_TRAINER_ID": str(rank),
                # PDTPU_* aliases for the Trainer's env bootstrap
                "PDTPU_COORDINATOR_ADDRESS": coordinator,
                "PDTPU_NUM_PROCESSES": str(world),
                "PDTPU_PROCESS_ID": str(rank),
            })
            if args.backend is not None:
                env["PADDLE_DIST_BACKEND"] = args.backend
            procs.append(subprocess.Popen(
                [sys.executable, args.script] + args.script_args, env=env))

        rc = 0
        # fail fast: first non-zero exit kills the remaining workers
        remaining = {p.pid: p for p in procs}
        while remaining and rc == 0:
            for pid, p in list(remaining.items()):
                code = p.poll()
                if code is None:
                    continue
                del remaining[pid]
                if code != 0:
                    rc = code
            if remaining and rc == 0:
                # poll() both reaps and records exit codes; a raw
                # waitpid(-1) here would race it and steal a worker's
                # status (Popen would then report rc 0 for a dead worker)
                import time

                time.sleep(0.2)
        for p in remaining.values():
            p.send_signal(signal.SIGTERM)
        for p in remaining.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        return rc
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        return 130


if __name__ == "__main__":
    sys.exit(main())
