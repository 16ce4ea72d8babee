"""DEPRECATED shim (counterpart of paddle_tpu/checkpoint.py): the
checkpoint subsystem lives in :mod:`paddle_tpu_torch.ckpt`. Every name
here re-exports the ckpt implementation (identity, not copies), so
imports written against the old module keep working.
"""

from __future__ import annotations

from .ckpt import (  # noqa: F401
    CHECKPOINT_PREFIX, AsyncCheckpointSaver, CheckpointConfig,
    apply_state, check_restore, clean_checkpoint, is_valid,
    latest_valid_serial, list_checkpoints, load_checkpoint,
    load_checkpoint_sharded, manifest_entries, program_state_shardings,
    read_meta, restore, save_checkpoint, save_checkpoint_elastic,
    save_checkpoint_sharded, serial_dir, snapshot_state,
)
from .ckpt import (  # noqa: F401  (private names the tests rely on)
    _is_valid, _md5, _md5_cached, _scroll_delete, _serial_dir,
    _write_elastic,
)

__all__ = [
    "AsyncCheckpointSaver", "CheckpointConfig", "CHECKPOINT_PREFIX",
    "apply_state", "check_restore", "clean_checkpoint", "is_valid",
    "latest_valid_serial", "list_checkpoints", "load_checkpoint",
    "load_checkpoint_sharded", "manifest_entries",
    "program_state_shardings", "read_meta", "restore", "save_checkpoint",
    "save_checkpoint_elastic", "save_checkpoint_sharded", "serial_dir",
    "snapshot_state",
]
