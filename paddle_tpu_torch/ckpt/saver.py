"""Checkpoint writers: atomic dense and elastic saves, and the async
background saver (counterpart of paddle_tpu/ckpt/saver.py).

``save_checkpoint`` writes the dense format (``state.npz`` + md5) and
``save_checkpoint_elastic`` / :class:`AsyncCheckpointSaver` the elastic
manifest format (manifest.py), byte-compatible with the JAX package's:
bfloat16 members are raw two-byte bits (``'<V2'``), and the elastic
manifest records their dtype name.

The state of a run on the card is updated in place: the fused update,
``memory_optimize`` and ``run_steps``' captured graphs write the scope's
own tensors. So every save snapshots its values to the host on the
caller's thread before it returns (``manifest.snapshot_state``: a copy
queued behind the steps that wrote them); the async saver's background
worker only serializes, hashes and publishes host copies, and the next
step may overwrite the tensors at once.

The writers fire the JAX package's fault points: ``ckpt.publish`` once
the temp dir exists (an injected crash orphans it for
``sweep_orphans``) and ``ckpt.payload`` once the payload's digest is
recorded (an injected corruption makes that serial invalid, so
restore's newest-valid fallback skips it).

Not ported: the legacy sharded format and multi-process elastic saves
(``save_checkpoint_sharded``, ``pcount > 1``; ROADMAP Queue A 9).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

from ..core import npz
from ..core.enforce import not_ported
from ..profiler import RecordEvent
from ..resilience import faults
from .base import (_META_FILE, _TRAINER_PREFIX, _md5, _scroll_delete,
                   _serial_dir, list_checkpoints)
from .manifest import publish_serial, snapshot_state


def save_checkpoint(root: str,
                    state: Dict[str, Any],
                    trainer_id: int = 0,
                    trainer_args: Optional[Dict[str, Any]] = None,
                    max_num_checkpoints: int = 3,
                    extra_meta: Optional[Dict[str, Any]] = None) -> int:
    """Write a new DENSE checkpoint of ``state`` (name -> torch tensor
    or host value); returns its serial.

    ``trainer_args`` (epoch/step/iterator position) are stored per trainer
    id (reference: trainer.py:637 save_checkpoint + trainer args files)."""
    os.makedirs(root, exist_ok=True)
    serials = list_checkpoints(root)
    serial = (serials[-1] + 1) if serials else 0
    final_dir = _serial_dir(root, serial)
    with RecordEvent("ckpt/snapshot"):
        arrays = {k: npz.host_array(v) for k, v in state.items()
                  if v is not None}

    tmp_dir = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=root)
    try:
        # AFTER mkdtemp: an injected crash here orphans the temp dir
        # (the kill signature sweep_orphans reclaims); a delay widens
        # the real crash window
        faults.fire("ckpt.publish")
        state_p = npz.savez(os.path.join(tmp_dir, "state.npz"), arrays)
        meta = {"md5": _md5(state_p), "serial": serial,
                "names": sorted(arrays)}
        meta.update(extra_meta or {})
        # the digest is recorded: a corruption landing on the payload
        # NOW makes this serial invalid, as a torn write would
        faults.fire("ckpt.payload", state_p)
        with open(os.path.join(tmp_dir, _META_FILE), "w") as f:
            json.dump(meta, f)
        if trainer_args is not None:
            with open(os.path.join(
                    tmp_dir, f"{_TRAINER_PREFIX}_{trainer_id}.json"),
                    "w") as f:
                json.dump(trainer_args, f)
        os.rename(tmp_dir, final_dir)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise

    _scroll_delete(root, max_num_checkpoints)
    return serial


def save_checkpoint_sharded(root: str, state: Dict[str, Any], *args,
                            **kwargs) -> int:
    """The legacy per-process sharded format: not ported."""
    raise not_ported("ckpt.save_checkpoint_sharded (per-process shards "
                     "of a device mesh)", "Queue A 9, multi-GPU")


def _write_elastic(root: str, serial: int, entries: Dict[str, Any],
                   pid: int, pcount: int,
                   trainer_id: Optional[int] = None,
                   trainer_args: Optional[Dict[str, Any]] = None,
                   max_num_checkpoints: int = 3,
                   extra_meta: Optional[Dict[str, Any]] = None) -> int:
    """IO phase of an elastic save (host copies only; background-safe):
    one process publishes the whole serial with one rename."""
    if pcount > 1:
        raise not_ported("a multi-process elastic save (process_count=%d)"
                         % pcount, "Queue A 9, multi-GPU")
    with RecordEvent("ckpt/serialize"):
        with RecordEvent("ckpt/publish"):
            publish_serial(root, serial, entries, trainer_id=trainer_id,
                           trainer_args=trainer_args, extra_meta=extra_meta)
            _scroll_delete(root, max_num_checkpoints)
    return serial


def _process_count() -> int:
    """Processes of this run: the ``torch.distributed`` world, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def save_checkpoint_elastic(root: str, state: Dict[str, Any],
                            serial: Optional[int] = None,
                            trainer_id: Optional[int] = None,
                            trainer_args: Optional[Dict[str, Any]] = None,
                            max_num_checkpoints: int = 3,
                            extra_meta: Optional[Dict[str, Any]] = None
                            ) -> int:
    """Blocking elastic save: snapshot + write + publish on the caller's
    thread. In a ``torch.distributed`` world of more than one process it
    raises (multi-process saves are not ported)."""
    pcount = _process_count()
    if pcount > 1:
        raise not_ported("a multi-process elastic save (process_count=%d)"
                         % pcount, "Queue A 9, multi-GPU")
    if serial is None:
        serials = list_checkpoints(root)
        serial = (serials[-1] + 1) if serials else 0
    os.makedirs(root, exist_ok=True)
    with RecordEvent("ckpt/snapshot"):
        entries = snapshot_state(state)
    return _write_elastic(root, serial, entries, 0, 1,
                          trainer_id=trainer_id, trainer_args=trainer_args,
                          max_num_checkpoints=max_num_checkpoints,
                          extra_meta=extra_meta)


class AsyncCheckpointSaver:
    """Overlap checkpoint IO with training (the reference's Go pserver
    snapshots on a timer thread, go/pserver/service.go:120).

    ``save()`` snapshots the state to the host on the caller's thread
    (span ``ckpt/snapshot``; the only wait on the card) and hands the
    serialize+hash+atomic-publish work to ONE background worker, so the
    train loop never blocks on disk. A single worker keeps writes
    ordered; serials are allocated by the worker at write time, exactly
    as the blocking path would. Publishes the ELASTIC manifest format."""

    def __init__(self, root: str, max_num_checkpoints: int = 3,
                 max_pending: int = 2):
        from concurrent.futures import ThreadPoolExecutor

        self.root = root
        self.max_num_checkpoints = max_num_checkpoints
        self.max_pending = max(1, int(max_pending))
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="pdtpu-ckpt")
        self._pending: List = []
        # serials of writes that PUBLISHED but whose futures were consumed
        # by an error-path drain in save(); wait() still reports them
        self._drained_serials: List[int] = []

    def _alloc_and_write(self, entries, trainer_id, trainer_args,
                         extra_meta) -> int:
        """Worker-side write: the serial is derived from the directory
        listing AT WRITE TIME (one worker ⇒ ordered), so partial serials
        left by a crashed run are skipped, never reused."""
        serials = list_checkpoints(self.root)
        serial = (serials[-1] + 1) if serials else 0
        return _write_elastic(self.root, serial, entries, 0, 1,
                              trainer_id=trainer_id,
                              trainer_args=trainer_args,
                              max_num_checkpoints=self.max_num_checkpoints,
                              extra_meta=extra_meta)

    def save(self, state: Dict[str, Any], trainer_id: Optional[int] = None,
             trainer_args: Optional[Dict[str, Any]] = None,
             extra_meta: Optional[Dict[str, Any]] = None):
        """Returns a Future resolving to the checkpoint serial.

        The snapshot (a host copy of every value) is taken HERE, at the
        caller's step boundary — the background writer never sees a
        tensor a later step updates in place.

        Backpressure: at most ``max_pending`` saves may be in flight —
        each holds a full host copy of the state, so when the disk falls
        behind, save() blocks on the oldest write instead of growing
        memory without bound."""
        with RecordEvent("ckpt/backpressure"):
            while len(self._pending) >= self.max_pending:
                try:
                    self._pending.pop(0).result()
                except Exception:
                    # a background write failed (e.g. ENOSPC): drain every
                    # remaining pending write first, then surface the
                    # ORIGINAL failure here
                    drain, self._pending = self._pending, []
                    for f in drain:
                        try:
                            self._drained_serials.append(f.result())
                        except Exception:
                            pass
                    raise
        pcount = _process_count()
        if pcount > 1:
            raise not_ported("a multi-process elastic save (process_count="
                             "%d)" % pcount, "Queue A 9, multi-GPU")
        with RecordEvent("ckpt/snapshot"):
            entries = snapshot_state(state)  # the only wait on the card
        fut = self._pool.submit(
            self._alloc_and_write, entries,
            0 if trainer_id is None else trainer_id, trainer_args,
            extra_meta)
        self._pending.append(fut)
        return fut

    def wait(self) -> List[int]:
        """Block until every pending save has published; returns their
        serials. All writes are drained before the first error (if any)
        is re-raised."""
        with RecordEvent("ckpt/wait"):
            done, self._pending = self._pending, []
            serials, first_err = self._drained_serials, None
            self._drained_serials = []
            for f in done:
                try:
                    serials.append(f.result())
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    if first_err is None:
                        first_err = e
        if first_err is not None:
            raise first_err
        return serials

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class CheckpointConfig:
    """reference: python/paddle/fluid/trainer.py:98. ``async_save``
    routes Trainer checkpoints through AsyncCheckpointSaver.
    ``checkpoint_dir`` defaults to ``paddle_tpu_checkpoints`` under the
    system's temporary directory, as in the JAX package."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3,
                 epoch_interval: int = 1,
                 step_interval: Optional[int] = 10,
                 async_save: bool = False):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            tempfile.gettempdir(), "paddle_tpu_checkpoints")
        self.max_num_checkpoints = max(1, int(max_num_checkpoints))
        self.epoch_interval = max(1, int(epoch_interval))
        # step_interval=None -> epoch-boundary saves only; the Trainer
        # then leaves steps_per_loop groups at full length instead of
        # capping them to the save granularity
        self.step_interval = (None if step_interval is None
                              else max(1, int(step_interval)))
        self.async_save = bool(async_save)
        # filled on resume
        self.epoch_id = 0
        self.step_id = 0
