"""paddle_tpu_torch.ckpt — atomic checkpoints with async saves and
program-aware restore (counterpart of paddle_tpu/ckpt).

The reference's fault-tolerance heritage (SURVEY §5): Fluid's save/load
ops (operators/save_op.cc:66), the Trainer-level CheckpointConfig with
scroll-delete (python/paddle/fluid/trainer.py:98,637,737,1164), and the
Go pserver's checkpoint-recover protocol with per-shard digests and
recovery from the newest valid serial (go/pserver/service.go:120-203).
The files are the JAX package's, in both directions:

  * base     — serial dirs, md5/sha256 digests, validity, orphan sweep,
    scroll-delete and ``clean_checkpoint``;
  * manifest — the elastic format (single-process writes): per-tensor
    global shape/dtype, sha256+size per payload, atomic-rename publish;
  * saver    — the dense ``save_checkpoint``, the elastic blocking save,
    and ``AsyncCheckpointSaver`` (host snapshot on the caller's thread,
    serialize/hash/publish on one background worker);
  * restore  — ``load_checkpoint`` of any format, the restore-lint
    (``check_restore``), ``apply_state`` (one write per flat buffer) and
    ``restore``.

The writers fire the ``ckpt.publish`` and ``ckpt.payload`` fault
points (``resilience``). Across ranks each process writes the blocks it
owns (the legacy sharded and the multi-process elastic formats) and a
restore reads them on any number of ranks. ``python -m
paddle_tpu_torch.tools.ckpt {ls,verify,gc,clean} --root DIR`` maintains
a root of any format.
"""

from __future__ import annotations

from .base import (CHECKPOINT_PREFIX, _is_valid, _md5, _md5_cached,
                   _scroll_delete, _serial_dir, clean_checkpoint,
                   is_valid, latest_valid_serial, list_checkpoints,
                   read_meta, serial_dir, sweep_orphans)
from .manifest import manifest_entries, snapshot_state
from .restore import (apply_state, check_restore, load_checkpoint,
                      load_checkpoint_sharded, program_state_shardings,
                      restore)
from .saver import (AsyncCheckpointSaver, CheckpointConfig,
                    _write_elastic, save_checkpoint,
                    save_checkpoint_elastic, save_checkpoint_sharded)

__all__ = [
    "AsyncCheckpointSaver", "CheckpointConfig", "CHECKPOINT_PREFIX",
    "apply_state", "check_restore", "clean_checkpoint", "is_valid",
    "latest_valid_serial", "list_checkpoints", "load_checkpoint",
    "load_checkpoint_sharded", "manifest_entries",
    "program_state_shardings", "read_meta", "restore", "save_checkpoint",
    "save_checkpoint_elastic", "save_checkpoint_sharded", "serial_dir",
    "snapshot_state", "sweep_orphans",
]
