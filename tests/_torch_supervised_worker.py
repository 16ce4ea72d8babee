"""Worker for tests/test_torch_supervisor.py's supervised elastic runs
(the port's counterpart of tests/_supervised_worker.py).

Usage, one rank per process under the launcher:

    python -m paddle_tpu_torch.tools.launch --nproc N --backend gloo \
        _torch_supervised_worker.py <ckpt_root> <total_steps> <out_json> \
        <start_state.npz>

(or directly, a world of one). One resumable trainer: the JAX worker's
MLP (``build``, ``feed``), sharded over the DP x FSDP mesh of the world's
ranks (4: data 2 x fsdp 2, 2: data 2, 1: none), started from the
``.npz`` start state the test writes (the JAX package's startup values),
restoring the newest VALID checkpoint through ``ckpt.restore`` (N->M:
the same run may hold four ranks' blocks in one attempt and two in the
next), every rank writing the blocks it owns into an elastic serial
every step (serial = step), and heartbeating once a step (rank 0 only:
``resilience.note_progress``).

Faults arrive through the PDTPU_FAULT_PLAN environment the supervisor's
launch spec sets; each rank installs the plan and counts its own hits.
This file calls the ``trainer.step`` site once per step. Rank 0
rewrites ``out_json`` atomically every step (per-step losses keyed by
GLOBAL step, the resume point, the injection log and hit counts), so a
killed attempt still leaves its partial record. Imports only the port.
"""

import json
import os
import sys
import tempfile

import numpy as np


def mesh_for(fluid, world):
    """The DP x FSDP factorization of a world of ``world`` ranks (None
    for one)."""
    factor = {4: (2, 2), 2: (2, 1)}.get(world)
    if factor is None:
        return None
    return fluid.sharding.training_mesh(data=factor[0], fsdp=factor[1],
                                        tp=1)


def build(fluid, mesh):
    """tests/_supervised_worker.py's MLP (Adam 0.05), sharded over
    ``mesh`` before ``minimize``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="relu")
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if mesh is not None:
            fluid.sharding.shard_program(main, mesh)
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def feed(step):
    rng = np.random.RandomState(100 + step)
    x = rng.rand(64, 16).astype("float32")
    return {"x": x, "y": (x.sum(1, keepdims=True) * 0.5).astype("float32")}


def _publish(out_json, record):
    d = os.path.dirname(out_json) or "."
    fd, tmp = tempfile.mkstemp(prefix=".out_", dir=d)
    with os.fdopen(fd, "w") as f:
        json.dump(record, f)
    os.replace(tmp, out_json)


def main():
    ckpt_root, total_steps, out_json, state_path = (
        sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])

    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import ckpt, parallel
    from paddle_tpu_torch.resilience import (faults, hit_counts,
                                             injection_log, note_progress)
    from paddle_tpu_torch.sharding.spmd import held_state

    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if world > 1:
        parallel.init_distributed(backend="gloo")
    rank = torch.distributed.get_rank() if world > 1 else 0
    mesh = mesh_for(fluid, world)
    main_p, startup, loss = build(fluid, mesh)
    place = fluid.CPUPlace()
    scope, exe = fluid.Scope(), fluid.Executor(place)
    exe.run(startup, scope=scope)
    with np.load(state_path) as z:
        fluid.state_from_numpy({k: z[k] for k in z.files}, scope, place,
                               program=main_p)
    state, targs = ckpt.restore(ckpt_root, program=main_p, scope=scope,
                                place=place)
    start_step = int(targs["step"]) if state is not None else 0
    gb = main_p.global_block()
    plan = getattr(main_p, "_sharding_plan", None)
    losses = {}
    record = {"world_size": world, "start_step": start_step,
              "losses": losses, "done": False, "pid": os.getpid()}
    note_progress(start_step, resumed_from=start_step)
    for s in range(start_step, total_steps):
        faults.fire("trainer.step")
        out, = exe.run(main_p, feed=feed(s), fetch_list=[loss],
                       scope=scope)
        losses[str(s)] = float(np.asarray(out))
        if mesh is not None:
            held = held_state(main_p, scope, mesh, lambda n: plan.spec_for(
                gb._find_var_recursive(n), n))
        else:
            held = {n: scope.find_var(n) for n in scope.local_var_names()}
        ckpt.save_checkpoint_elastic(
            ckpt_root, held, serial=s, trainer_args={"step": s + 1},
            max_num_checkpoints=100)
        record["injection_log"] = injection_log()
        record["hit_counts"] = hit_counts()
        if rank == 0:
            _publish(out_json, record)
        # heartbeat AFTER the save: the step the supervisor sees is a
        # step the next attempt can resume past
        note_progress(s + 1, resumed_from=start_step)
        if world > 1:
            # no rank reaches the next step's fault site before rank 0
            # has beaten this step (a kill there then loses no beat)
            torch.distributed.barrier()
    record["done"] = True
    record["injection_log"] = injection_log()
    record["hit_counts"] = hit_counts()
    if rank == 0:
        _publish(out_json, record)
    if world > 1:
        parallel.env.shutdown()
    print("WORKER_DONE", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
