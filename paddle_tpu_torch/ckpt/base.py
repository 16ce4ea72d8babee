"""Serial-directory layout, payload digests, and the validity/recovery
rules shared by every checkpoint format (counterpart of
paddle_tpu/ckpt/base.py, the same layout and rules).

One checkpoint = one directory ``checkpoint_<serial>`` under a root.
Three on-disk formats coexist (readers auto-detect via ``meta.json``):

  * dense   — ``state.npz`` + md5 meta (the original single-host format);
  * sharded — per-process ``shards_<pid>.npz`` + md5 manifests (the
    legacy multi-host format; the port reads it, and writes none);
  * elastic — the manifest format (manifest.py): per-tensor global
    shape/dtype + per-shard payload records with sha256+size integrity.

The recovery contract is format-independent and mirrors the reference
Go pserver (go/pserver/service.go:120-203): a serial is VALID only when
every recorded payload verifies; restore walks serials newest-first and
takes the newest valid one, so corrupt, truncated, or partially-written
serials cost a fallback, never a crash.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

CHECKPOINT_PREFIX = "checkpoint"
_STATE_FILE = "state.npz"
_META_FILE = "meta.json"
_TRAINER_PREFIX = "trainer_args"


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# digest cache keyed by (algo, path, inode, mtime_ns, size): checkpoint
# payloads are immutable once atomically renamed into place (a rename
# always delivers a fresh inode, so a reused PATH with new content can
# never alias an old entry even on coarse-mtime filesystems), and
# re-probing validity (latest_valid_serial walks newest-first on every
# restore) must not re-hash every byte of every shard each call.
# The lock: AsyncCheckpointSaver's worker thread probes validity
# (via _scroll_delete) concurrently with main-thread restores.
_DIGEST_CACHE: Dict[tuple, str] = {}
_DIGEST_CACHE_LOCK = threading.Lock()


def _digest_cached(path: str, algo: str = "md5") -> str:
    st = os.stat(path)
    key = (algo, os.path.abspath(path), st.st_ino, st.st_mtime_ns,
           st.st_size)
    with _DIGEST_CACHE_LOCK:
        digest = _DIGEST_CACHE.get(key)
    if digest is None:
        # hash outside the lock: IO-bound
        digest = (_sha256 if algo == "sha256" else _md5)(path)
        with _DIGEST_CACHE_LOCK:
            if len(_DIGEST_CACHE) >= 512:
                # long runs churn serials via scroll-delete: drop entries
                # for files that no longer exist so the cache stays
                # bounded at roughly the live checkpoint set
                for k in [k for k in _DIGEST_CACHE
                          if not os.path.exists(k[1])]:
                    del _DIGEST_CACHE[k]
                if len(_DIGEST_CACHE) >= 512:
                    # every cached file is still live (many roots / large
                    # live sets): evict oldest insertions so the cache —
                    # and the O(n) existence sweep each insert would
                    # otherwise repeat under the lock — stays bounded
                    for k in list(_DIGEST_CACHE)[:256]:
                        del _DIGEST_CACHE[k]
            _DIGEST_CACHE[key] = digest
    return digest


def _md5_cached(path: str) -> str:
    return _digest_cached(path, "md5")


def _serial_dir(root: str, serial: int) -> str:
    return os.path.join(root, f"{CHECKPOINT_PREFIX}_{serial}")


def serial_dir(root: str, serial: int) -> str:
    """Directory of one checkpoint serial (``<root>/checkpoint_<N>``)."""
    return _serial_dir(root, serial)


def list_checkpoints(root: str) -> List[int]:
    """Serial numbers of complete (renamed) checkpoints, ascending."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith(CHECKPOINT_PREFIX + "_"):
            tail = name[len(CHECKPOINT_PREFIX) + 1:]
            if tail.isdigit():
                out.append(int(tail))
    return sorted(out)


def read_meta(root: str, serial: int) -> Optional[dict]:
    """Parsed ``meta.json`` of one serial, or None when missing/corrupt
    (callers treat that as an invalid serial, never an error)."""
    try:
        with open(os.path.join(_serial_dir(root, serial), _META_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _is_valid(root: str, serial: int) -> bool:
    meta = read_meta(root, serial)
    if meta is None:
        return False
    d = _serial_dir(root, serial)
    if meta.get("format") == "elastic":
        from .manifest import verify_serial

        return verify_serial(d, meta)
    if meta.get("format") == "sharded":
        # valid only once EVERY process's shard file landed and verifies —
        # per-shard validity + recovery-from-newest-valid is the same
        # contract as the Go pserver's per-shard snapshots
        # (reference: go/pserver/service.go:120-203)
        for p in range(int(meta.get("process_count", 1))):
            man_p = os.path.join(d, f"manifest_{p}.json")
            sh_p = os.path.join(d, f"shards_{p}.npz")
            if not (os.path.isfile(man_p) and os.path.isfile(sh_p)):
                return False
            try:
                with open(man_p) as f:
                    man = json.load(f)
            except (OSError, ValueError):
                return False
            if man.get("md5") != _md5_cached(sh_p):
                return False
        return True
    state_p = os.path.join(d, _STATE_FILE)
    if not os.path.isfile(state_p):
        return False
    return meta.get("md5") == _md5_cached(state_p)


def is_valid(root: str, serial: int) -> bool:
    """Whether ``serial``'s recorded payloads all verify (any format)."""
    return _is_valid(root, serial)


def latest_valid_serial(root: str) -> Optional[int]:
    """Newest checkpoint whose integrity digests verify (reference:
    go/pserver/service.go:156-203 LoadCheckpoint recovery)."""
    for serial in reversed(list_checkpoints(root)):
        if _is_valid(root, serial):
            return serial
    return None


def sweep_orphans(root: str, max_age_s: float = 3600.0) -> List[str]:
    """Reclaim temp artifacts orphaned by crashed/killed writers — the
    ``tuning/compile_cache`` store ``_sweep_tmp`` idiom, checkpoint
    flavor: ``.ckpt_tmp_*`` publish dirs at the root (a writer SIGKILLed
    between ``mkdtemp`` and the atomic rename) and ``.tmp*`` payload/
    manifest files inside serial dirs (a sharded/elastic writer killed
    between its temp write and the ``os.replace``). The age guard keeps
    live writers safe — an async saver mid-publish is younger than an
    hour; pass ``max_age_s=0`` only when no writer can be live (the
    explicit ``clean``/``gc`` tools). Returns the reclaimed paths."""
    removed: List[str] = []
    if not os.path.isdir(root):
        return removed
    now = time.time()

    def stale(p):
        try:
            return now - os.path.getmtime(p) >= max_age_s
        except OSError:
            return False

    for name in os.listdir(root):
        p = os.path.join(root, name)
        if name.startswith(".ckpt_tmp_") and os.path.isdir(p):
            if stale(p):
                shutil.rmtree(p, ignore_errors=True)
                removed.append(p)
        elif name.startswith(CHECKPOINT_PREFIX + "_") and os.path.isdir(p):
            try:
                leftovers = [f for f in os.listdir(p)
                             if f.startswith(".tmp")]
            except OSError:
                continue
            for f in leftovers:
                fp = os.path.join(p, f)
                if not stale(fp):
                    continue
                try:
                    os.unlink(fp)
                    removed.append(fp)
                except OSError:
                    pass
    return removed


def _scroll_delete(root: str, max_num_checkpoints: int) -> None:
    """Keep only the newest N checkpoints (reference:
    trainer.py:1164 _scroll_delete).

    A serial outside the window is deleted only when a NEWER VALID
    checkpoint exists: sharded serials become valid once the slowest
    process's shards land, so pruning by number alone could delete the
    last recoverable state while the newest serial is still incomplete."""
    serials = list_checkpoints(root)
    old = serials[:max(0, len(serials) - max_num_checkpoints)]
    if not old:
        return
    newest_valid = latest_valid_serial(root)
    for serial in old:
        if newest_valid is not None and serial < newest_valid:
            shutil.rmtree(_serial_dir(root, serial), ignore_errors=True)
    # every save already walks the directory here — piggyback the
    # age-guarded orphan sweep so a crash-looping trainer cannot
    # accumulate dead .ckpt_tmp_* dirs without bound
    sweep_orphans(root)


def clean_checkpoint(root: str, delete_dir: bool = False) -> None:
    """Remove all checkpoints (reference: trainer.py clean_checkpoint)."""
    sweep_orphans(root, max_age_s=0.0)  # explicit clean: everything goes
    for serial in list_checkpoints(root):
        shutil.rmtree(_serial_dir(root, serial), ignore_errors=True)
    if delete_dir and os.path.isdir(root) and not os.listdir(root):
        os.rmdir(root)
