"""Fault-tolerant data dispatch — the Go master/etcd equivalent
(counterpart of paddle_tpu/reader/dispatch.py).

The reference's legacy fault-tolerance tier (SURVEY §5): a Go master
partitions recordio chunks into tasks, leases them to trainers with
timeouts, retries failed tasks ≤ failureMax, and snapshots its dispatch
state into etcd so a restarted master resumes where it left off
(go/master/service.go:89-472, etcd_client.go:46). Trainers pull tasks via
a client (python/paddle/v2/master/client.py).

Design (per SURVEY §2.4): SPMD jobs are gang-scheduled, so
task *leasing* collapses into deterministic sharding — every process
derives its own shard from (process_index, num_processes) with no
coordinator — and fault tolerance becomes *preemption-safe resume*: the
iterator's position is part of the checkpoint, and a restarted job fast-
forwards deterministically. This module provides both pieces:

  * ``shard_reader``      — deterministic per-host shard of a reader
  * ``CheckpointableReader`` — epoch/offset-tracking iterator whose
    ``state_dict``/``load_state_dict`` plug into checkpoint.save/load
    (the etcd snapshot equivalent, stored with the model state)
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional


def shard_reader(reader: Callable, num_shards: Optional[int] = None,
                 shard_id: Optional[int] = None) -> Callable:
    """Every process reads sample i with i % num_shards == shard_id —
    the deterministic replacement for master task leasing (reference:
    go/master/service.go:368 GetTask)."""
    def sharded(epoch: int = 0):
        # resolve defaults at iteration time so the process group may
        # be initialized after the reader was wrapped; without one, this
        # process is the only shard
        n, s = num_shards, shard_id
        if n is None or s is None:
            import torch.distributed as dist

            grouped = dist.is_available() and dist.is_initialized()
            if n is None:
                n = dist.get_world_size() if grouped else 1
            if s is None:
                s = dist.get_rank() if grouped else 0
        it = reader(epoch) if getattr(reader, "_pdtpu_epoch_aware",
                                      False) else reader()
        for i, sample in enumerate(it):
            if i % n == s:
                yield sample

    # epoch-awareness propagates through the wrapper so a sharded
    # shuffled_reader still replays deterministically per epoch
    sharded._pdtpu_epoch_aware = getattr(reader, "_pdtpu_epoch_aware",
                                         False)
    return sharded


class CheckpointableReader:
    """Resumable reader: tracks (epoch, offset) and fast-forwards on
    resume (reference capability: master state snapshot/recover,
    go/master/service.go:166-229; pserver checkpoint meta
    go/pserver/service.go:120).

    Usage:
        ckr = CheckpointableReader(reader)
        for batch in ckr:          # one epoch from the current offset
            ...
        state = ckr.state_dict()   # store alongside model checkpoint
        ckr2 = CheckpointableReader(reader); ckr2.load_state_dict(state)
    """

    def __init__(self, reader: Callable):
        self._reader = reader
        # epoch-aware readers (shuffled_reader and wrappers that
        # propagate its marker) take the epoch as an argument so the
        # order replays deterministically on resume; ordinary zero-arg
        # readers (the package contract) are never called with one
        self._epoch_aware = bool(getattr(reader, "_pdtpu_epoch_aware",
                                         False))
        self.epoch = 0
        self.offset = 0         # samples already consumed this epoch

    # -- iteration -----------------------------------------------------
    def __iter__(self) -> Iterator:
        it = (self._reader(self.epoch) if self._epoch_aware
              else self._reader())
        for i, sample in enumerate(it):
            if i < self.offset:
                continue
            self.offset = i + 1
            yield sample
        # epoch exhausted
        self.epoch += 1
        self.offset = 0

    def __call__(self):
        return iter(self)

    # -- checkpoint plumbing -------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "offset": self.offset}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state.get("epoch", 0))
        self.offset = int(state.get("offset", 0))


def shuffled_reader(reader: Callable, seed: int = 0,
                    buffer_size: Optional[int] = None) -> Callable:
    """Deterministic, epoch-keyed shuffle for resumable training.

    The order is a pure function of (seed, epoch): call with an explicit
    epoch, or hand the wrapped reader to ``CheckpointableReader``, which
    recognizes it (via the ``_pdtpu_epoch_aware`` marker set here) and
    passes its own epoch counter — so a job resumed mid-epoch replays
    exactly the order the interrupted run saw (reference capability: the
    master snapshots its dispatch order so a restart continues the same
    epoch plan, go/master/service.go:166-229). ``buffer_size`` switches
    to windowed shuffling for unbounded streams (matching
    reader/decorator.py shuffle's memory bound, still (seed, epoch)-
    deterministic)."""
    import numpy as np

    def shuffled(epoch: int = 0):
        rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2**31))
        if buffer_size is None:
            samples = list(reader())
            for i in rng.permutation(len(samples)):
                yield samples[i]
            return
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buffer_size:
                rng.shuffle(buf)
                for s in buf:
                    yield s
                buf = []
        rng.shuffle(buf)
        for s in buf:
            yield s

    shuffled._pdtpu_epoch_aware = True
    return shuffled


# ---------------------------------------------------------------------------
# Task-queue dispatch with straggler re-lease and failure caps — the Go
# master's queue semantics (go/master/service.go:89-472: todo/pending/
# done/failed queues, lease timeouts re-queueing stragglers at :91-92,
# 455, and failureMax capping retries at :200,341) for host-side data
# workers that are NOT gang-scheduled (reader processes, prefetch
# pools). Gang-scheduled SPMD keeps deterministic sharding above.
# ---------------------------------------------------------------------------


class TaskDispatcher:
    """Lease tasks to workers; re-lease stragglers; cap retries.

    ``chunks`` is any list of payloads (file paths, index ranges...).
    Thread-safe: one dispatcher may serve a pool of worker threads.
    ``state_dict``/``load_state_dict`` snapshot the queue state (the
    etcd-snapshot equivalent) so a restarted coordinator resumes
    mid-epoch instead of re-dispatching finished work."""

    def __init__(self, chunks, failure_max: int = 3,
                 lease_timeout_s: Optional[float] = None, clock=None):
        import threading
        import time

        self._chunks = list(chunks)
        self.failure_max = int(failure_max)
        self.lease_timeout_s = lease_timeout_s
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._todo = list(range(len(self._chunks)))
        self._pending: Dict[int, float] = {}   # task_id -> lease time
        self._done: set = set()
        self._failed: set = set()              # dropped past failure_max
        self._failures: Dict[int, int] = {}

    # -- worker API ----------------------------------------------------
    def get_task(self):
        """Lease the next task: (task_id, payload), or None when nothing
        is leasable. Stragglers: when todo is empty, the oldest TIMED-OUT
        pending task is re-leased (go/master/service.go:455
        checkTimeoutFunc)."""
        with self._lock:
            if self._todo:
                tid = self._todo.pop(0)
                self._pending[tid] = self._clock()
                return tid, self._chunks[tid]
            if self.lease_timeout_s is not None and self._pending:
                now = self._clock()
                expired = [t for t, at in self._pending.items()
                           if now - at >= self.lease_timeout_s]
                if expired:
                    tid = min(expired, key=lambda t: self._pending[t])
                    self._pending[tid] = now
                    return tid, self._chunks[tid]
            return None

    def report_done(self, task_id: int) -> None:
        with self._lock:
            self._pending.pop(task_id, None)
            # a straggler's late success rescues a task that concurrent
            # failures already dropped — it must not be counted twice
            self._failed.discard(task_id)
            self._done.add(task_id)

    def report_failure(self, task_id: int) -> None:
        """Failed tasks re-queue until ``failure_max`` failures, then
        drop into ``failed`` (go/master/service.go:341 processFailedTask)
        — the epoch completes without the poisoned chunk instead of the
        whole job dying."""
        with self._lock:
            if task_id in self._done:
                return
            self._pending.pop(task_id, None)
            n = self._failures.get(task_id, 0) + 1
            self._failures[task_id] = n
            if n >= self.failure_max:
                self._failed.add(task_id)
            elif task_id not in self._todo:
                self._todo.append(task_id)

    # -- introspection -------------------------------------------------
    @property
    def all_done(self) -> bool:
        with self._lock:
            return len(self._done | self._failed) == len(self._chunks)

    @property
    def failed_tasks(self):
        with self._lock:
            return sorted(self._failed)

    # -- snapshot (etcd equivalent) ------------------------------------
    def state_dict(self) -> Dict:
        with self._lock:
            # pending leases re-queue on restore: the restarted
            # coordinator cannot know whether their workers survived
            todo = list(self._todo) + sorted(self._pending)
            return {"todo": todo, "done": sorted(self._done),
                    "failed": sorted(self._failed),
                    "failures": dict(self._failures),
                    "num_chunks": len(self._chunks)}

    def load_state_dict(self, state: Dict) -> None:
        from ..core.enforce import enforce

        with self._lock:
            enforce(int(state["num_chunks"]) == len(self._chunks),
                    "TaskDispatcher restore: %d chunks saved, %d now"
                    % (int(state["num_chunks"]), len(self._chunks)))
            self._todo = [int(t) for t in state["todo"]]
            self._pending = {}
            self._done = {int(t) for t in state["done"]}
            self._failed = {int(t) for t in state["failed"]}
            self._failures = {int(k): int(v)
                              for k, v in state["failures"].items()}

    def as_reader(self, load_chunk: Callable) -> Callable:
        """One epoch as a reader: lease -> load_chunk(payload) yields
        samples -> report_done; a raising chunk reports failure and the
        loop moves on (retried elsewhere/later until the cap drops it).
        The trainer-side pull loop of the reference's master client
        (python/paddle/v2/master/client.py)."""
        def reader():
            while not self.all_done:
                leased = self.get_task()
                if leased is None:
                    break  # everything outstanding is leased elsewhere
                tid, payload = leased
                try:
                    # buffer the whole chunk BEFORE yielding: a chunk
                    # that raises midway must contribute nothing, or its
                    # retry would re-deliver the samples already yielded
                    samples = list(load_chunk(payload))
                except Exception:
                    self.report_failure(tid)
                    continue
                self.report_done(tid)
                yield from samples

        return reader
