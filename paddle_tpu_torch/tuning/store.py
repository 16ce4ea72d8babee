"""Persistent content-addressed store for tuned kernel configs
(counterpart of paddle_tpu/tuning/store.py: the same layout, keys and
sidecar, byte for byte, so either package lists, verifies and reads the
other's entries).

The on-disk sibling of ``compile_cache.store``, holding one *measured
launch-config selection* per tuning key instead of a compiled artifact.
Keys are content hashes of

    (device_kind, kernel, kernel version fingerprint, shape bucket,
     dtype)

so a config tuned on one card or kernel revision can never be replayed
against another — version skew is a *miss by construction*, not a
runtime check. ``device_kind`` is ``torch.cuda.get_device_name()`` on
the card (e.g. ``NVIDIA H100 80GB HBM3``), ``cpu`` on the host. Layout::

    <root>/<fp[:2]>/<fp>/
        config.json   # TunedRecord payload: key fields + winning
                      # config + per-candidate measurements
        meta.json     # store format, sha256+size of config.json,
                      # created/last_hit/hits, display key fields

Write protocol: the checkpoint idiom shared with compile_cache —
payloads land in a hidden temp dir, ONE ``os.rename`` publishes, first
publisher wins, a preempted writer never leaves a half entry.

Read protocol: meta must parse, the store format must match, and
``config.json`` must match its recorded sha256 + size and itself parse
as a record for the SAME key fields. Any violation evicts the entry and
reports a miss — a corrupt or truncated entry costs one re-sweep (or a
fall back to defaults), never a crash. Hits touch ``last_hit``/``hits``
via atomic replace, which feeds ``gc(max_bytes)``'s least-recently-hit
eviction order.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Tuple

META_FILE = "meta.json"
CONFIG_FILE = "config.json"
STORE_FORMAT = 1


def canonical_json(obj) -> str:
    """Deterministic JSON for hashing: sorted keys, no whitespace."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def tuning_key(kernel: str, version: str, device_kind: str,
               dtype: str, bucket: dict) -> str:
    """The content address of one tuned selection."""
    return hashlib.sha256(canonical_json(
        {"kernel": kernel, "version": version,
         "device_kind": device_kind, "dtype": dtype,
         "bucket": bucket}).encode()).hexdigest()


class TunedRecord:
    """One persisted tuning result: the key fields, the winning config,
    and the per-candidate measurements that elected it."""

    def __init__(self, kernel: str, version: str, device_kind: str,
                 dtype: str, bucket: dict, config: dict,
                 best_ms: Optional[float] = None,
                 measurements: Optional[List[dict]] = None,
                 source: str = "sweep"):
        self.kernel = kernel
        self.version = version
        self.device_kind = device_kind
        self.dtype = dtype
        self.bucket = dict(bucket)
        self.config = dict(config)
        self.best_ms = best_ms
        self.measurements = list(measurements or [])
        self.source = source  # "sweep" | "manifest" | "default"

    @property
    def key(self) -> str:
        return tuning_key(self.kernel, self.version, self.device_kind,
                          self.dtype, self.bucket)

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "version": self.version,
                "device_kind": self.device_kind, "dtype": self.dtype,
                "bucket": self.bucket, "config": self.config,
                "best_ms": self.best_ms,
                "measurements": self.measurements,
                "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "TunedRecord":
        return cls(str(d["kernel"]), str(d["version"]),
                   str(d["device_kind"]), str(d["dtype"]),
                   dict(d["bucket"]), dict(d["config"]),
                   d.get("best_ms"), d.get("measurements"),
                   str(d.get("source", "sweep")))


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class TuningStore:
    """Content-addressed tuned-config store rooted at ``root``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    # -- paths ---------------------------------------------------------
    def entry_dir(self, fp: str) -> str:
        return os.path.join(self.root, fp[:2], fp)

    def _iter_entry_dirs(self) -> Iterator[Tuple[str, str]]:
        if not os.path.isdir(self.root):
            return
        for shard in sorted(os.listdir(self.root)):
            sd = os.path.join(self.root, shard)
            if len(shard) != 2 or not os.path.isdir(sd):
                continue
            for fp in sorted(os.listdir(sd)):
                d = os.path.join(sd, fp)
                if not fp.startswith(".") and os.path.isdir(d):
                    yield fp, d

    # -- read ----------------------------------------------------------
    def get(self, fp: str, touch: bool = True) -> Optional[TunedRecord]:
        """Verified lookup: returns the record, or None on miss /
        corruption / format skew (corrupt entries are evicted)."""
        from ..compile_cache.store import (_MetaAbsent, _MetaUnreadable,
                                           _meta_read_policy)
        from ..resilience import faults
        from ..resilience.retry import RetryError

        d = self.entry_dir(fp)
        # chaos hook: "corrupt" exercises evict-and-resweep/fall-back
        faults.fire("tuning.get", d)
        meta_p = os.path.join(d, META_FILE)

        def _read_meta():
            # two looks through the shared retry policy: the first
            # ENOENT can race a concurrent publisher's atomic rename
            # (same protocol as compile_cache.store.get)
            try:
                with open(meta_p) as f:
                    return json.load(f)
            except (OSError, ValueError):
                if not os.path.isdir(d):
                    raise _MetaAbsent from None
                raise _MetaUnreadable from None

        try:
            meta = _meta_read_policy().call(
                _read_meta, retriable=(_MetaUnreadable,),
                span="resilience/store_read")
        except _MetaAbsent:
            return None  # genuinely absent: plain miss
        except RetryError:
            meta = None
        if meta is None or meta.get("store_format") != STORE_FORMAT:
            self.evict(fp)
            return None
        try:
            with open(os.path.join(d, CONFIG_FILE), "rb") as f:
                payload = f.read()
            if (len(payload) != int(meta.get("size", -1))
                    or _sha256_bytes(payload) != meta.get("sha256")):
                self.evict(fp)
                return None
            rec = TunedRecord.from_dict(json.loads(payload.decode()))
        except (OSError, ValueError, KeyError, TypeError):
            self.evict(fp)
            return None
        if rec.key != fp:
            # payload claims different key fields than its address —
            # a tampered or mis-filed entry can never be valid here
            self.evict(fp)
            return None
        if touch:
            self._touch(d, meta)
        return rec

    def _touch(self, d: str, meta: dict) -> None:
        try:
            meta = dict(meta)
            meta["last_hit"] = time.time()
            meta["hits"] = int(meta.get("hits", 0)) + 1
            fd, tmp = tempfile.mkstemp(prefix=".meta_", dir=d)
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(d, META_FILE))
        except OSError:
            pass  # read-only store still serves hits

    # -- write ---------------------------------------------------------
    def put(self, record: TunedRecord) -> bool:
        """Atomically publish one record at its content address;
        returns False when an entry already exists (first publisher
        wins) or publishing failed (a full/read-only disk must not fail
        the sweep that produced the result)."""
        fp = record.key
        d = self.entry_dir(fp)
        if os.path.isdir(d):
            return False
        try:
            os.makedirs(os.path.dirname(d), exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=".put_",
                                   dir=os.path.dirname(d))
        except OSError:
            return False
        try:
            payload = json.dumps(record.to_dict(), indent=1,
                                 sort_keys=True).encode()
            with open(os.path.join(tmp, CONFIG_FILE), "wb") as f:
                f.write(payload)
            now = time.time()
            meta = {"store_format": STORE_FORMAT, "fingerprint": fp,
                    "sha256": _sha256_bytes(payload),
                    "size": len(payload),
                    "created": now, "last_hit": now, "hits": 0,
                    # display fields for ls — never trusted on read
                    "kernel": record.kernel, "version": record.version,
                    "device_kind": record.device_kind,
                    "dtype": record.dtype, "bucket": record.bucket}
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f, indent=1)
            os.rename(tmp, d)  # atomic publish
            return True
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            return False

    def evict(self, fp: str) -> None:
        shutil.rmtree(self.entry_dir(fp), ignore_errors=True)

    # -- maintenance ---------------------------------------------------
    def entries(self) -> List[dict]:
        """Unverified tooling view: one dict per parseable entry."""
        out = []
        for fp, d in self._iter_entry_dirs():
            rec = {"fingerprint": fp, "bytes": 0, "hits": 0,
                   "last_hit": 0.0, "created": 0.0, "kernel": "?",
                   "device_kind": "?", "dtype": "?", "bucket": {}}
            try:
                for name in os.listdir(d):
                    rec["bytes"] += os.path.getsize(
                        os.path.join(d, name))
                with open(os.path.join(d, META_FILE)) as f:
                    meta = json.load(f)
                rec.update({k: meta[k] for k in
                            ("hits", "last_hit", "created", "kernel",
                             "version", "device_kind", "dtype",
                             "bucket") if k in meta})
            except (OSError, ValueError):
                rec["kernel"] = "corrupt"
            out.append(rec)
        return out

    def records(self) -> List[TunedRecord]:
        """Every VERIFIED record (no touch) — the program-stamp and
        export walks; corrupt entries are skipped, not evicted (the
        next addressed get() reclaims them)."""
        out = []
        for fp, d in self._iter_entry_dirs():
            try:
                with open(os.path.join(d, META_FILE)) as f:
                    meta = json.load(f)
                if meta.get("store_format") != STORE_FORMAT:
                    continue
                with open(os.path.join(d, CONFIG_FILE), "rb") as f:
                    payload = f.read()
                if (len(payload) != int(meta.get("size", -1))
                        or _sha256_bytes(payload) != meta.get("sha256")):
                    continue
                rec = TunedRecord.from_dict(json.loads(payload.decode()))
                if rec.key == fp:
                    out.append(rec)
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    def total_bytes(self) -> int:
        return sum(e["bytes"] for e in self.entries())

    def stats(self) -> dict:
        es = self.entries()
        return {"root": self.root, "entries": len(es),
                "bytes": sum(e["bytes"] for e in es),
                "hits": sum(e.get("hits", 0) for e in es),
                "corrupt": sum(1 for e in es
                               if e["kernel"] == "corrupt")}

    def verify(self) -> Dict[str, bool]:
        """{fingerprint: verifies} — read-only (no touch, no eviction;
        the CLI reports, callers decide)."""
        out: Dict[str, bool] = {}
        for fp, d in self._iter_entry_dirs():
            ok = True
            try:
                with open(os.path.join(d, META_FILE)) as f:
                    meta = json.load(f)
                with open(os.path.join(d, CONFIG_FILE), "rb") as f:
                    payload = f.read()
                if (meta.get("store_format") != STORE_FORMAT
                        or len(payload) != int(meta.get("size", -1))
                        or _sha256_bytes(payload) != meta.get("sha256")
                        or TunedRecord.from_dict(
                            json.loads(payload.decode())).key != fp):
                    ok = False
            except (OSError, ValueError, KeyError, TypeError):
                ok = False
            out[fp] = ok
        return out

    def _sweep_tmp(self, max_age_s: float = 3600.0) -> None:
        """Reclaim orphaned ``.put_*`` temp dirs and ``.meta_*`` touch
        files left by killed writers (compile_cache.store idiom)."""
        if not os.path.isdir(self.root):
            return
        now = time.time()

        def stale(p):
            try:
                return now - os.path.getmtime(p) > max_age_s
            except OSError:
                return False

        for shard in os.listdir(self.root):
            sd = os.path.join(self.root, shard)
            if not os.path.isdir(sd):
                continue
            for name in os.listdir(sd):
                p = os.path.join(sd, name)
                if name.startswith(".put_"):
                    if stale(p):
                        shutil.rmtree(p, ignore_errors=True)
                elif os.path.isdir(p):
                    try:
                        leftovers = [f for f in os.listdir(p)
                                     if f.startswith(".meta_")]
                    except OSError:
                        continue
                    for f in leftovers:
                        fp_ = os.path.join(p, f)
                        if stale(fp_):
                            try:
                                os.unlink(fp_)
                            except OSError:
                                pass

    def gc(self, max_bytes: int) -> List[str]:
        """Evict least-recently-hit entries until the store fits
        ``max_bytes`` (corrupt entries first regardless of age)."""
        self._sweep_tmp()
        es = self.entries()
        total = sum(e["bytes"] for e in es)
        es.sort(key=lambda e: (e["kernel"] != "corrupt",
                               e.get("last_hit", 0.0),
                               e.get("created", 0.0)))
        evicted = []
        for e in es:
            if total <= max_bytes and e["kernel"] != "corrupt":
                break
            self.evict(e["fingerprint"])
            total -= e["bytes"]
            evicted.append(e["fingerprint"])
        return evicted

    def clear(self) -> int:
        self._sweep_tmp(max_age_s=0.0)
        n = 0
        for fp, _ in list(self._iter_entry_dirs()):
            self.evict(fp)
            n += 1
        return n
