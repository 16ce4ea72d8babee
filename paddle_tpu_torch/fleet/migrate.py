"""Content-addressed KV-block migration (counterpart of
paddle_tpu/fleet/migrate.py).

Disaggregated prefill/decode needs finished KV blocks to MOVE between
replica processes. A migrated span is a set of **store entries** keyed
by the prefix cache's chain hash (``KVCacheManager.prefix_keys``: the
key digests the cache config and every prompt token through the block,
so an entry identifies itself across processes and never matches
another geometry or dtype). Each entry is one directory

    <root>/<key[:2]>/<key>/{blocks.npz, meta.json}

written to a temp dir and published with one ``os.rename``
(first publisher wins; a crash mid-publish leaves only a temp dir),
with the sha256 and size of the payload in ``meta.json``, so every read
verifies before use. A corrupt or torn entry is EVICTED on read and the
consumer re-prefills locally: migration can lose its benefit, never
correctness. The layout, the manifest and the keys are the JAX
package's, so either package restores the other's f32 and int8 entries.

A bfloat16 pool has no numpy dtype: its rows travel as their 16-bit
patterns (``uint16`` members) and the manifest's ``geometry`` names
``bfloat16``; a read returns such a member as a ``torch.bfloat16``
tensor, whatever numpy type stored it.

:class:`BlockMigrator` is the engine-side adapter. It EXPORTS committed
pool rows (one ``[block_size, heads, head_dim]`` slab per pool, the
int8 scale pools included) and RESTORES missing ones by adopting a pool
block (``KVCacheManager.import_span``) and writing the verified payload
into the device pools IN PLACE (``pool[b].copy_(rows)``): the pools are
the fixed addresses the engine's captured CUDA graphs read, so a restore
never replaces a pool tensor. Exports read device rows only after the
prefill or extend that wrote them returned (the engine's call ends with
a synchronize of its stream); restores queue their copies on the
calling thread's current stream, the stream the engine's replays run
on. The batcher calls it at three sites (``batcher.migrator``, None by
default): restore before admission, export after a prefill-role commit,
export after a preemption publish.

The ``fleet.migrate`` fault point fires on every fetch with the raw
payload bytes: a corrupt rule flips a byte so the sha256 check fails as
real disk corruption would.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dtype_utils
from ..profiler import RecordEvent
from ..resilience import faults
from ..resilience.faults import InjectedFault

FORMAT_VERSION = 1
_TMP_PREFIX = ".tmp-migrate-"


def _to_wire(a):
    """(numpy member, manifest dtype name) of one pool row slab."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    a = np.asarray(a)
    return a, str(a.dtype)


def _from_wire(a: np.ndarray, dtype: Optional[str]):
    """A stored member in the dtype its manifest names: numpy, or a
    ``torch.bfloat16`` tensor for ``bfloat16``."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.asarray(a)


class MigrationStore:
    """Content-addressed KV-block store on a shared directory.

    One entry per chain key; publish is temp dir + atomic rename with
    first publisher wins, reads verify the recorded sha256 and evict on
    any mismatch or parse failure (returning None: the caller falls back
    to a local re-prefill). Safe for concurrent publishers and readers
    across processes by construction.
    """

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _entry_dir(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key)

    def contains(self, key: str) -> bool:
        return os.path.isfile(
            os.path.join(self._entry_dir(key), "meta.json"))

    def keys(self) -> List[str]:
        """Every published chain key, sorted."""
        out = []
        try:
            shards = os.listdir(self.root)
        except OSError:
            return out
        for shard in shards:
            if shard.startswith(_TMP_PREFIX) or shard.startswith("."):
                continue
            d = os.path.join(self.root, shard)
            if not os.path.isdir(d):
                continue
            for key in os.listdir(d):
                if os.path.isfile(os.path.join(d, key, "meta.json")):
                    out.append(key)
        return sorted(out)

    def nbytes(self) -> int:
        """Payload bytes of every published entry (from the manifests)."""
        return sum(int((self.meta(k) or {}).get("bytes") or 0)
                   for k in self.keys())

    def publish(self, key: str, arrays: Dict[str, object]) -> bool:
        """Publish one block's pool rows (numpy arrays or tensors) under
        its chain key. Returns False when the entry already exists (the
        first publisher won; content addressing makes the payloads
        identical)."""
        if self.contains(key):
            return False
        with RecordEvent("fleet/migrate.publish"):
            wire = {n: _to_wire(a) for n, a in arrays.items()}
            buf = io.BytesIO()
            np.savez(buf, **{n: a for n, (a, _) in wire.items()})
            raw = buf.getvalue()
            meta = {"format_version": FORMAT_VERSION, "key": key,
                    "sha256": hashlib.sha256(raw).hexdigest(),
                    "bytes": len(raw),
                    "pools": sorted(arrays),
                    # per-pool geometry: a reader refuses a stale-
                    # geometry payload from the manifest alone
                    "geometry": {n: {"shape": [int(d) for d in a.shape],
                                     "dtype": dt}
                                 for n, (a, dt) in wire.items()}}
            tmp = tempfile.mkdtemp(dir=self.root, prefix=_TMP_PREFIX)
            try:
                with open(os.path.join(tmp, "blocks.npz"), "wb") as f:
                    f.write(raw)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f, sort_keys=True)
                final = self._entry_dir(key)
                os.makedirs(os.path.dirname(final), exist_ok=True)
                os.rename(tmp, final)
            except OSError:
                # lost the publish race (or a dead filesystem): the
                # surviving entry holds the same content
                shutil.rmtree(tmp, ignore_errors=True)
                return False
            return True

    def evict(self, key: str) -> None:
        shutil.rmtree(self._entry_dir(key), ignore_errors=True)

    def meta(self, key: str) -> Optional[dict]:
        """One entry's parsed manifest, or None for a missing or torn
        entry. Never raises."""
        try:
            with open(os.path.join(self._entry_dir(key),
                                   "meta.json")) as f:
                return json.load(f)
        except Exception:
            return None

    def fetch(self, key: str) -> Optional[Dict[str, object]]:
        """Verified read of one entry's pool rows, or None (missing,
        torn, corrupt: a corrupt entry is evicted for every later
        reader). Never raises."""
        d = self._entry_dir(key)
        meta_p = os.path.join(d, "meta.json")
        blob_p = os.path.join(d, "blocks.npz")
        if not (os.path.isfile(meta_p) and os.path.isfile(blob_p)):
            return None
        with RecordEvent("fleet/migrate.fetch"):
            try:
                with open(meta_p) as f:
                    meta = json.load(f)
                with open(blob_p, "rb") as f:
                    raw = f.read()
                try:
                    raw = faults.fire("fleet.migrate", raw)
                except InjectedFault:
                    raw = None
                if raw is None or len(raw) != meta.get("bytes") \
                        or hashlib.sha256(raw).hexdigest() \
                        != meta.get("sha256"):
                    self.evict(key)
                    return None
                geo = meta.get("geometry") or {}
                with np.load(io.BytesIO(raw)) as z:
                    return {n: _from_wire(z[n], (geo.get(n) or {})
                                          .get("dtype"))
                            for n in z.files}
            except Exception:
                self.evict(key)  # torn or unparseable: evict, never crash
                return None


class BlockMigrator:
    """Engine adapter over a :class:`MigrationStore`: export committed
    prefix blocks, restore missing ones into adopted pool blocks.

    ``export`` marks the prefill ROLE: the batcher (and
    :class:`~paddle_tpu_torch.fleet.PrefillWorker`) export every
    committed prefix at once. Decode-role replicas leave it False and
    export only at preemption, when a peer may need the span to resume
    the stream. ``stats()`` holds plain integer counters, which replicas
    report through ``health()``.
    """

    def __init__(self, store: MigrationStore, engine,
                 export: bool = False):
        self.store = store
        self.engine = engine
        self.export_on_commit = bool(export)
        self._exported = set()  # keys known published (skip rework)
        self.published_total = 0
        self.restored_total = 0
        self.corrupt_total = 0

    def stats(self) -> dict:
        return {"published": self.published_total,
                "restored": self.restored_total,
                "corrupt": self.corrupt_total}

    def _pool_rows(self, block: int) -> Dict[str, torch.Tensor]:
        """Host copies of one block's rows of every pool (the prefill or
        extend that wrote them has returned, so its stream is done)."""
        scope = self.engine.scope
        return {name: scope.find_var(name)[block].cpu()
                for name, _, _ in self.engine.pair.pool_specs}

    def _stale_geometry(self, meta: Optional[dict]) -> bool:
        """True when an entry's manifest records pool shapes that do not
        match this engine's pool specs (a payload of another cache
        geometry), refused before a payload byte is read. An entry
        without a recorded geometry falls through to the array checks
        of :meth:`preload`."""
        geo = (meta or {}).get("geometry")
        if not isinstance(geo, dict):
            return False
        for name, shape, _ in self.engine.pair.pool_specs:
            g = geo.get(name)
            if g is None:
                return True  # a pool this engine needs is absent
            if list(g.get("shape") or []) != [int(d) for d in shape[1:]]:
                return True
        return False

    def export_prefix(self, kv, tokens: Sequence[int]) -> int:
        """Publish every committed chain-key block of ``tokens``'
        cacheable span that the store does not hold yet. Returns the
        entries newly published."""
        if not kv.config.prefix_cache:
            return 0
        n = 0
        for key, b in kv.export_span(tokens):
            if key in self._exported or self.store.contains(key):
                self._exported.add(key)
                continue
            if self.store.publish(key, self._pool_rows(b)):
                n += 1
                self.published_total += 1
            self._exported.add(key)
        return n

    def preload(self, kv, tokens: Sequence[int],
                keys: Optional[Sequence[str]] = None) -> int:
        """Restore migrated blocks of ``tokens``' chain so the next
        admission matches them as committed prefix. Walks the chain in
        order, verifying each entry (manifest geometry, then sha256 and
        size, then array shapes) BEFORE adopting any block, so a bad
        payload never leaves a committed key over garbage rows. A
        missing or refused entry, or a full pool, stops the walk (the
        admission matches a shorter span and re-prefills the rest).
        Returns the blocks restored. Never raises."""
        if not kv.config.prefix_cache:
            return 0
        if keys is None:
            keys = kv.prefix_keys(list(tokens))
        specs = self.engine.pair.pool_specs
        scope = self.engine.scope
        verified = []  # [(key, {pool name: row tensor, pool dtype})]
        for key in keys:
            if kv.cached_block(key) is not None:
                continue  # already local; keep walking the chain
            if not self.store.contains(key):
                break
            if self._stale_geometry(self.store.meta(key)):
                self.corrupt_total += 1
                self.store.evict(key)
                break
            arrays = self.store.fetch(key)
            if arrays is None:
                self.corrupt_total += 1
                break
            rows = {}
            for name, shape, dt in specs:
                a = arrays.get(name)
                if a is None or tuple(a.shape) != tuple(shape[1:]):
                    rows = None
                    break
                t = a if isinstance(a, torch.Tensor) \
                    else torch.from_numpy(np.ascontiguousarray(a))
                rows[name] = t.to(dtype_utils.to_torch(dt))
            if rows is None:
                self.corrupt_total += 1
                self.store.evict(key)
                break
            verified.append((key, rows))
        if not verified:
            return 0
        adopted = kv.import_span([k for k, _ in verified])
        by_key = dict(verified)
        for key, b in adopted:
            for name, _, _ in specs:
                # in place: the pool's address is what the captured
                # graphs read
                scope.find_var(name)[b].copy_(by_key[key][name])
            self._exported.add(key)  # exporting it again is rework
            self.restored_total += 1
        return len(adopted)
