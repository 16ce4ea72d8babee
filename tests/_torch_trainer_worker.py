"""Worker for tests/test_torch_supervisor.py's supervised Trainer world:
the ``Trainer(parallel=True)`` path of a supervised run.

Usage, one rank per process under the launcher:

    python -m paddle_tpu_torch.tools.launch --nproc N --backend gloo \
        _torch_trainer_worker.py <ckpt_root> <total_steps> <out_json>

(or directly, a world of one). A ``Trainer(parallel=True)`` over a small
MLP with a ``CheckpointConfig`` of one serial a step: the Trainer
restores the newest VALID serial itself (N->M), fires ``trainer.step``
and beats the heartbeat once a step (rank 0, then a barrier of every
rank). This worker adds the resume point to the heartbeat (once before
training, once after it), so the supervisor can count the steps a
restart lost. Rank 0 rewrites ``out_json`` after every step (losses by
step, the resume point, the injection log and hit counts). Imports only
the port.
"""

import json
import os
import sys
import tempfile

import numpy as np


def train_func(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(x, size=32, act="relu")
    pred = fluid.layers.fc(h, size=1)
    return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))


def reader(total_steps):
    def read():
        for s in range(total_steps):
            rng = np.random.RandomState(100 + s)
            x = rng.rand(8, 16).astype("float32")
            y = (x.sum(1, keepdims=True) * 0.5).astype("float32")
            yield [(x[i], y[i]) for i in range(8)]
    return read


def _publish(out_json, record):
    d = os.path.dirname(out_json) or "."
    fd, tmp = tempfile.mkstemp(prefix=".out_", dir=d)
    with os.fdopen(fd, "w") as f:
        json.dump(record, f)
    os.replace(tmp, out_json)


def main():
    ckpt_root, total_steps, out_json = (sys.argv[1], int(sys.argv[2]),
                                        sys.argv[3])
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.resilience import (hit_counts, injection_log,
                                             note_progress)

    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if world > 1:
        parallel.init_distributed(backend="gloo")
    rank = torch.distributed.get_rank() if world > 1 else 0
    cfg = fluid.CheckpointConfig(checkpoint_dir=ckpt_root,
                                 step_interval=1, max_num_checkpoints=100)
    trainer = fluid.Trainer(
        lambda: train_func(fluid),
        lambda: fluid.optimizer.Adam(learning_rate=0.05),
        place=fluid.CPUPlace(), parallel=True, checkpoint_config=cfg)
    start_step = int(cfg.step_id)
    note_progress(start_step, resumed_from=start_step)
    losses = {}
    record = {"world_size": world, "start_step": start_step,
              "losses": losses, "done": False}

    def handler(event):
        if isinstance(event, fluid.EndStepEvent):
            losses[str(event.step)] = float(np.asarray(
                event.metrics[0]))
            record["injection_log"] = injection_log()
            record["hit_counts"] = hit_counts()
            if rank == 0:
                _publish(out_json, record)

    trainer.train(num_epochs=1, event_handler=handler,
                  reader=reader(total_steps), feed_order=["x", "y"])
    note_progress(total_steps, resumed_from=start_step)
    record["done"] = True
    if rank == 0:
        _publish(out_json, record)
    if world > 1:
        parallel.env.shutdown()
    print("WORKER_DONE", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
