"""Multi-process bootstrap and role environment (counterpart of
paddle_tpu/parallel/env.py).

Replaces the reference's bootstrap (the ``gen_nccl_id`` op RPC-ing an
ncclUniqueId to peers, reference: paddle/fluid/operators/
gen_nccl_id_op.cc:31, and the PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM
env-var role protocol, python/paddle/fluid/trainer.py:321) with
``torch.distributed.init_process_group`` over a TCP store at one
coordinator address.

The port runs one device per process: rank ``r`` drives card
``r % device_count`` (NCCL), or every rank shares the card or the CPU
(gloo). ``local_device_count`` > 1 — the JAX package's several virtual
devices per process — has no counterpart and raises.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

_initialized = False


class DistributedInitError(RuntimeError):
    """Multi-process bootstrap failed: joining the coordinator exhausted
    its bounded timeout/retry budget (or raised a non-transient error).
    Carries ``attempts`` and chains the underlying failure."""

    def __init__(self, message: str, attempts: int = 1):
        super().__init__(message)
        self.attempts = attempts


def _default_backend() -> str:
    import torch

    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_count: Optional[int] = None,
                     timeout_s: Optional[float] = None,
                     max_attempts: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group. Reads PADDLE_* env vars for drop-in
    parity with reference launch scripts: PADDLE_TRAINER_ID ->
    process_id, PADDLE_TRAINERS_NUM -> num_processes,
    PADDLE_COORDINATOR -> coordinator_address: ``host:port`` (rank 0
    serves a TCP store there) or ``file://<path>`` (a store in a file
    every rank can reach: no port to race for on a shared host).

    ``backend``: ``"nccl"`` or ``"gloo"`` (default: nccl when a card is
    present, gloo on the CPU; PADDLE_DIST_BACKEND overrides). Under
    NCCL each rank selects card ``rank % device_count``. Gloo also takes
    CUDA tensors: two ranks on one card (which NCCL refuses) run over
    it.

    ``local_device_count`` (or PADDLE_LOCAL_DEVICES) must be 1 or
    unset: the port has one device per process.

    The join is BOUNDED: ``timeout_s`` (default 60, or
    PDTPU_INIT_TIMEOUT_S) caps each attempt and ``max_attempts``
    (default 3, or PDTPU_INIT_RETRIES) retries under the shared
    resilience backoff policy; exhaustion raises the typed
    :class:`DistributedInitError` instead of hanging on a dead
    coordinator."""
    global _initialized
    import torch
    import torch.distributed as dist

    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return
    if local_device_count is None and "PADDLE_LOCAL_DEVICES" in os.environ:
        local_device_count = int(os.environ["PADDLE_LOCAL_DEVICES"])
    if local_device_count is not None and int(local_device_count) != 1:
        raise ValueError(
            "init_distributed: local_device_count=%s — the port runs one "
            "device per process; start one process per device instead "
            "(ROADMAP Queue C 2)" % local_device_count)
    coordinator_address = (coordinator_address
                           or os.environ.get("PADDLE_COORDINATOR"))
    if num_processes is None and "PADDLE_TRAINERS_NUM" in os.environ:
        num_processes = int(os.environ["PADDLE_TRAINERS_NUM"])
    if process_id is None and "PADDLE_TRAINER_ID" in os.environ:
        process_id = int(os.environ["PADDLE_TRAINER_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        _initialized = True  # single-process: nothing to do
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed: coordinator_address, num_processes and "
            "process_id are all needed (or PADDLE_COORDINATOR, "
            "PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ID)")
    backend = (backend or os.environ.get("PADDLE_DIST_BACKEND")
               or _default_backend())
    if backend == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    from ..resilience import faults, retry

    if timeout_s is None:
        timeout_s = float(os.environ.get("PDTPU_INIT_TIMEOUT_S", "60"))
    if max_attempts is None:
        max_attempts = int(os.environ.get("PDTPU_INIT_RETRIES", "3"))
    policy = retry.RetryPolicy(max_attempts=max_attempts,
                               base_delay_s=0.5, max_delay_s=5.0)
    def _connect():
        faults.fire("parallel.init_distributed")
        # a store of our own: its connect is bounded by timeout_s (the
        # group's default store would retry for its own 30 minutes)
        if coordinator_address.startswith("file://"):
            store = dist.FileStore(coordinator_address[len("file://"):],
                                   int(num_processes))
            store.set_timeout(timedelta(seconds=timeout_s))
        else:
            host, _, port = coordinator_address.rpartition(":")
            store = dist.TCPStore(host or "localhost", int(port),
                                  int(num_processes), int(process_id) == 0,
                                  timeout=timedelta(seconds=timeout_s))
        dist.init_process_group(backend, store=store,
                                world_size=int(num_processes),
                                rank=int(process_id),
                                timeout=timedelta(seconds=max(
                                    timeout_s, 300.0)))

    try:
        policy.call(_connect, retriable=Exception,
                    span="resilience/init_distributed")
    except retry.RetryError as e:
        raise DistributedInitError(
            "could not join the distributed world at %r after %d "
            "attempts (timeout %.0fs each): %r"
            % (coordinator_address, e.attempts, timeout_s, e.last),
            attempts=e.attempts) from e.last
    _initialized = True


def shutdown() -> None:
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def trainer_id() -> int:
    """This process's rank (reference: PADDLE_TRAINER_ID)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def num_trainers() -> int:
    """World size in processes (reference: PADDLE_TRAINERS_NUM)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1
