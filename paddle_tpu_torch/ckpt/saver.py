"""Checkpoint writers: atomic dense, sharded and elastic saves, and the
async background saver (counterpart of paddle_tpu/ckpt/saver.py).

``save_checkpoint`` writes the dense format (``state.npz`` + md5),
``save_checkpoint_sharded`` the legacy per-process format (md5 shard
files), and ``save_checkpoint_elastic`` / :class:`AsyncCheckpointSaver`
the elastic manifest format (manifest.py), byte-compatible with the JAX
package's: bfloat16 members are raw two-byte bits (``'<V2'``), and the
elastic manifest records their dtype name.

Across the ranks of a ``torch.distributed`` world each process writes
the blocks it owns (``manifest.Shard``; whole values are process 0's)
into the same serial, which becomes valid when the last process's files
land: there is no barrier, and restore takes the newest valid serial. A
multi-process save needs an explicit serial, or the async saver's,
whose first serial process 0 derives from the directory and broadcasts
(:func:`_synchronized_serial_seed`).

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
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

from ..core import npz
from ..profiler import RecordEvent
from ..resilience import faults
from .base import (_META_FILE, _TRAINER_PREFIX, _md5, _scroll_delete,
                   _serial_dir, list_checkpoints)
from .manifest import (_process_index, publish_serial,
                       snapshot_state, write_meta, write_process_files)


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


# ---------------------------------------------------------------------------
# sharded / multi-process checkpoints (legacy md5 format)
# ---------------------------------------------------------------------------
# Each process writes exactly the blocks it owns to its own
# ``shards_<pid>.npz`` plus a ``manifest_<pid>.json`` with the global
# index of every block (the reference's pserver-side per-shard snapshots,
# go/pserver/service.go:120-203). There is NO cross-process barrier: a
# checkpoint becomes valid when the last process's shard file lands, and
# restore takes the newest VALID serial.


def _snapshot_local_shards(state: Dict[str, Any]) -> Dict[str, Any]:
    """Device→host snapshot of the blocks THIS process owns (the only
    wait on the card of a sharded save; on the caller's thread)."""
    return snapshot_state(state)


def _write_sharded(root: str, serial: int, entries: Dict[str, Any],
                   pid: int, pcount: int,
                   trainer_id: Optional[int] = None,
                   trainer_args: Optional[Dict[str, Any]] = None,
                   max_num_checkpoints: int = 3,
                   extra_meta: Optional[Dict[str, Any]] = None) -> int:
    """IO phase of a legacy sharded save (host copies only;
    background-safe)."""
    d = _serial_dir(root, serial)
    os.makedirs(d, exist_ok=True)
    # after makedirs: a crash fired here leaves .tmp* files in a live
    # serial dir — exactly what sweep_orphans exists to reclaim
    faults.fire("ckpt.publish")
    payload, man_vars = {}, {}
    for name, e in entries.items():
        recs = []
        for i, srec in enumerate(e["shards"]):
            key = f"{name}::{i}"
            payload[key] = srec["data"]
            recs.append({"key": key, "index": srec["index"]})
        man_vars[name] = {"shape": e["shape"], "dtype": e["dtype"],
                          "shards": recs}
    shard_name = f"shards_{pid}.npz"
    tmp = npz.savez(os.path.join(d, f".tmp_{shard_name}"), payload)
    digest = _md5(tmp)
    faults.fire("ckpt.payload", tmp)
    os.replace(tmp, os.path.join(d, shard_name))
    man = {"process_index": pid, "md5": digest, "vars": man_vars}
    tmp = os.path.join(d, f".tmp_manifest_{pid}.json")
    with open(tmp, "w") as f:
        json.dump(man, f)
    os.replace(tmp, os.path.join(d, f"manifest_{pid}.json"))
    if trainer_args is not None:
        tid = pid if trainer_id is None else trainer_id
        tmp = os.path.join(d, f".tmp{pid}_{_TRAINER_PREFIX}_{tid}.json")
        with open(tmp, "w") as f:
            json.dump(trainer_args, f)
        os.replace(tmp, os.path.join(d, f"{_TRAINER_PREFIX}_{tid}.json"))
    if pid == 0:
        meta = {"format": "sharded", "serial": serial,
                "process_count": pcount, "names": sorted(entries)}
        meta.update(extra_meta or {})
        tmp = os.path.join(d, f".tmp_{_META_FILE}")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(d, _META_FILE))
        _scroll_delete(root, max_num_checkpoints)
    return serial


def _process_count() -> int:
    """Processes of this run: the ``torch.distributed`` world, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _synchronized_serial_seed(root: str) -> int:
    """First serial for a fresh multi-process saver: derived from the
    directory listing by process 0 ONLY and broadcast to the others
    (``torch.distributed``), so every process starts the same run of
    serials. Seeding independently from per-process listings races: a
    rank could list rank 0's freshly-created checkpoint_<s>/ and seed at
    s+1, splitting one logical checkpoint across two serials. Seeding
    past EVERY existing directory, valid or not, stays: a partial serial
    of a crashed run is never reused (reference contract:
    go/pserver/service.go:120-203, one snapshot epoch shared by all
    shard owners)."""
    seed = 0
    if _process_index() == 0:
        serials = list_checkpoints(root)
        seed = (serials[-1] + 1) if serials else 0
    if _process_count() > 1:
        import torch
        import torch.distributed as dist

        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([seed], dtype=torch.int64, device=dev)
        dist.broadcast(t, src=0)
        seed = int(t.item())
    return seed


def _explicit_serial(root: str, serial: Optional[int], pcount: int,
                     kind: str) -> int:
    if serial is not None:
        return serial
    if pcount > 1:
        raise ValueError(
            "multi-process %s save needs an explicit serial (use the "
            "global step, or AsyncCheckpointSaver which allocates serials "
            "deterministically)" % kind)
    serials = list_checkpoints(root)
    return (serials[-1] + 1) if serials else 0


def save_checkpoint_sharded(root: str, state: Dict[str, Any],
                            serial: Optional[int] = None,
                            trainer_id: Optional[int] = None,
                            trainer_args: Optional[Dict[str, Any]] = None,
                            max_num_checkpoints: int = 3,
                            extra_meta: Optional[Dict[str, Any]] = None
                            ) -> int:
    """Sharded save (legacy md5 format): every process calls this with
    the SAME state names (its blocks as ``manifest.Shard``); each writes
    only the blocks it owns. Multi-process callers must pass an explicit
    ``serial`` (e.g. the global step)."""
    pid, pcount = _process_index(), _process_count()
    serial = _explicit_serial(root, serial, pcount, "sharded")
    os.makedirs(root, exist_ok=True)
    entries = _snapshot_local_shards(state)
    return _write_sharded(root, serial, entries, pid, pcount,
                          trainer_id=trainer_id, trainer_args=trainer_args,
                          max_num_checkpoints=max_num_checkpoints,
                          extra_meta=extra_meta)


# ---------------------------------------------------------------------------
# elastic manifest saves (manifest.py; the AsyncCheckpointSaver format)
# ---------------------------------------------------------------------------


def _write_elastic(root: str, serial: int, entries: Dict[str, Any],
                   pid: int, pcount: int,
                   trainer_id: Optional[int] = None,
                   trainer_args: Optional[Dict[str, Any]] = None,
                   max_num_checkpoints: int = 3,
                   extra_meta: Optional[Dict[str, Any]] = None) -> int:
    """IO phase of an elastic save (host copies only; background-safe):
    one process publishes the whole serial with one rename; several
    write their files into a shared serial dir and process 0 lands the
    meta. The ckpt.publish fault point fires once the temp/serial dir
    exists."""
    with RecordEvent("ckpt/serialize"):
        if pcount <= 1:
            with RecordEvent("ckpt/publish"):
                publish_serial(root, serial, entries,
                               trainer_id=trainer_id,
                               trainer_args=trainer_args,
                               extra_meta=extra_meta)
                _scroll_delete(root, max_num_checkpoints)
            return serial
        d = _serial_dir(root, serial)
        os.makedirs(d, exist_ok=True)
        faults.fire("ckpt.publish")
        write_process_files(d, pid, entries, trainer_id=trainer_id,
                            trainer_args=trainer_args)
    if pid == 0:
        with RecordEvent("ckpt/publish"):
            write_meta(d, serial, pcount, entries, extra_meta)
            _scroll_delete(root, max_num_checkpoints)
    return serial


def save_checkpoint_elastic(root: str, state: Dict[str, Any],
                            serial: Optional[int] = None,
                            trainer_id: Optional[int] = None,
                            trainer_args: Optional[Dict[str, Any]] = None,
                            max_num_checkpoints: int = 3,
                            extra_meta: Optional[Dict[str, Any]] = None
                            ) -> int:
    """Blocking elastic save: snapshot + write + publish on the caller's
    thread. Same calling convention as :func:`save_checkpoint_sharded`
    (explicit ``serial`` required multi-process)."""
    pid, pcount = _process_index(), _process_count()
    serial = _explicit_serial(root, serial, pcount, "elastic")
    os.makedirs(root, exist_ok=True)
    with RecordEvent("ckpt/snapshot"):
        entries = snapshot_state(state)
    return _write_elastic(root, serial, entries, pid, pcount,
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
    ordered; single-process serials are allocated by the worker at write
    time, exactly as the blocking path would. Across the ranks of a
    world every process writes its blocks into the same serial: the
    first is agreed through the process group
    (:func:`_synchronized_serial_seed`) and then counted locally — the
    ranks save in lockstep. Publishes the ELASTIC manifest format."""

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
        # the next serial of a multi-process saver (agreed on first use)
        self._next_serial: Optional[int] = None

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
        pid, pcount = _process_index(), _process_count()
        with RecordEvent("ckpt/snapshot"):
            entries = snapshot_state(state)  # the only wait on the card
        if pcount > 1:
            if self._next_serial is None:
                self._next_serial = _synchronized_serial_seed(self.root)
            serial, self._next_serial = (self._next_serial,
                                         self._next_serial + 1)
            fut = self._pool.submit(
                _write_elastic, self.root, serial, entries, pid, pcount,
                trainer_id=trainer_id, trainer_args=trainer_args,
                max_num_checkpoints=self.max_num_checkpoints,
                extra_meta=extra_meta)
        else:
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
