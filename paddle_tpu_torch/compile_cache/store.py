"""Content-addressed on-disk store for compiled artifacts (counterpart
of paddle_tpu/compile_cache/store.py, the same layout, protocols and
metadata, so either package can read the other's entries).

Layout — one directory per fingerprint, sharded by prefix::

    <cache_dir>/<fp[:2]>/<fp>/
        module.stablehlo   # the module text the caller stores (always
                           # present; the name is the JAX package's)
        executable.bin     # a serialized executable (optional)
        meta.json          # env pin, checksums, calling convention,
                           # sizes, created/last-hit timestamps, hits

Write protocol (the ``checkpoint.py`` idiom): payloads land in a hidden
temp dir next to the final location, then ONE ``os.rename`` publishes
the entry — a preempted writer never leaves a half entry, and readers
either see nothing or a complete directory. First publisher wins;
concurrent publishers of the same fingerprint lose the rename and
discard their temp dir.

Read protocol: ``meta.json`` must parse, its recorded environment must
match the caller's, and every payload file must match its recorded
sha256 + size. Any violation evicts the entry and reports a miss — a
corrupt, truncated, or version-skewed entry costs one fresh build,
never a crash. Hits touch ``last_hit``/``hits`` in meta via an atomic
replace (best-effort: a read-only cache dir still serves hits).

``gc(max_bytes)`` evicts least-recently-hit entries until the store
fits the budget. Eviction is plain ``rmtree`` — safe against concurrent
readers because every reader verifies checksums and treats a vanishing
entry as a miss.

The tuning store (``tuning/store.py``) reuses the meta-read policy, its
two exceptions and the fault and retry sites. What the port compiles
into this store (the executor's steps, serving buckets, the decode
pair) comes with ROADMAP Queue A step (f2), with
``compile_cache/{fingerprint,runtime}.py``.
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
MODULE_FILE = "module.stablehlo"
EXECUTABLE_FILE = "executable.bin"
STORE_FORMAT = 1


class _MetaAbsent(Exception):
    """Entry dir genuinely absent: a plain miss."""


class _MetaUnreadable(Exception):
    """Meta present but unreadable — retriable once (a first ENOENT can
    race a concurrent publisher's atomic rename); persistent failure
    means corruption."""


def _meta_read_policy():
    """The stores' second-look read, expressed on the ONE shared
    resilience policy (two attempts, no delay — the rename race
    resolves immediately or not at all)."""
    from ..resilience.retry import RetryPolicy

    return RetryPolicy(max_attempts=2, base_delay_s=0.0, jitter=0.0)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CacheEntry:
    """A verified, read-side view of one store entry. The payload bytes
    the verifying read already pulled through memory are retained, so a
    hit costs ONE disk read per payload, not a hash pass plus a
    re-read."""

    def __init__(self, fp: str, path: str, meta: dict,
                 payloads: Optional[Dict[str, bytes]] = None):
        self.fingerprint = fp
        self.path = path
        self.meta = meta
        self._payloads = payloads or {}

    @property
    def has_executable(self) -> bool:
        return EXECUTABLE_FILE in self.meta.get("sha256", {})

    def _read(self, name: str) -> bytes:
        data = self._payloads.pop(name, None)  # one-shot: don't pin RAM
        if data is None:
            with open(os.path.join(self.path, name), "rb") as f:
                data = f.read()
        return data

    def read_module(self) -> str:
        return self._read(MODULE_FILE).decode("utf-8")

    def read_executable(self) -> bytes:
        return self._read(EXECUTABLE_FILE)


class CacheStore:
    """Content-addressed artifact store rooted at ``root``."""

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
    def get(self, fp: str,
            env: Optional[dict] = None,
            touch: bool = True) -> Optional[CacheEntry]:
        """Verified lookup. ``env`` (an environment signature dict) is
        compared against the entry's recorded environment — any skew (a
        cache written by another framework version or backend) evicts.
        Returns None on miss/corruption/skew."""
        from ..resilience import faults
        from ..resilience.retry import RetryError

        d = self.entry_dir(fp)
        # chaos hook: "corrupt" flips a byte of some payload in the
        # entry dir, exercising the evict-and-rebuild fallback below
        faults.fire("compile_cache.get", d)
        meta_p = os.path.join(d, META_FILE)

        def _read_meta():
            # a first ENOENT can race a concurrent publisher's atomic
            # rename (dir appears between the failed open and the isdir
            # probe) — evicting on the stale first look would discard
            # the just-published valid entry, so unreadable-but-present
            # is retried once through the shared policy
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
        except RetryError:  # present on both looks but unreadable
            self.evict(fp)
            return None
        if meta.get("store_format") != STORE_FORMAT:
            self.evict(fp)
            return None
        if env is not None and meta.get("env") != dict(env):
            # version/backend skew: this entry can never be valid for
            # this process again under content addressing — reclaim it
            self.evict(fp)
            return None
        sums = meta.get("sha256", {})
        sizes = meta.get("sizes", {})
        if MODULE_FILE not in sums:
            self.evict(fp)
            return None
        payloads: Dict[str, bytes] = {}
        for name, want in sums.items():
            p = os.path.join(d, name)
            try:
                data = None
                if os.path.getsize(p) != int(sizes.get(name, -1)):
                    self.evict(fp)
                    return None
                with open(p, "rb") as f:
                    data = f.read()
                if hashlib.sha256(data).hexdigest() != want:
                    self.evict(fp)
                    return None
                payloads[name] = data
            except OSError:
                self.evict(fp)
                return None
        if touch:
            self._touch(d, meta)
        return CacheEntry(fp, d, meta, payloads)

    def _touch(self, d: str, meta: dict) -> None:
        """Record the hit for LRU GC — atomic replace so concurrent
        readers always see a complete meta; best-effort (a read-only
        cache still serves)."""
        try:
            meta = dict(meta)
            meta["last_hit"] = time.time()
            meta["hits"] = int(meta.get("hits", 0)) + 1
            fd, tmp = tempfile.mkstemp(prefix=".meta_", dir=d)
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(d, META_FILE))
        except OSError:
            pass

    # -- write ---------------------------------------------------------
    def put(self, fp: str, module_text: str,
            executable: Optional[bytes] = None,
            meta: Optional[dict] = None) -> bool:
        """Atomically publish one entry; returns False when an entry for
        ``fp`` already exists (first publisher wins) or publishing
        failed (a full/read-only disk must not fail the build that
        produced the artifact)."""
        d = self.entry_dir(fp)
        if os.path.isdir(d):
            return False
        try:
            os.makedirs(os.path.dirname(d), exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=".put_", dir=os.path.dirname(d))
        except OSError:
            return False
        try:
            record = dict(meta or {})
            record["store_format"] = STORE_FORMAT
            record["fingerprint"] = fp
            now = time.time()
            record.setdefault("created", now)
            record.setdefault("last_hit", now)
            record.setdefault("hits", 0)
            sums: Dict[str, str] = {}
            sizes: Dict[str, int] = {}
            mp = os.path.join(tmp, MODULE_FILE)
            with open(mp, "w") as f:
                f.write(module_text)
            sums[MODULE_FILE] = _sha256(mp)
            sizes[MODULE_FILE] = os.path.getsize(mp)
            if executable is not None:
                ep = os.path.join(tmp, EXECUTABLE_FILE)
                with open(ep, "wb") as f:
                    f.write(executable)
                sums[EXECUTABLE_FILE] = _sha256(ep)
                sizes[EXECUTABLE_FILE] = os.path.getsize(ep)
            record["sha256"] = sums
            record["sizes"] = sizes
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(record, f, indent=1)
            os.rename(tmp, d)  # atomic publish
            return True
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            return False

    def evict(self, fp: str) -> None:
        shutil.rmtree(self.entry_dir(fp), ignore_errors=True)

    # -- maintenance ---------------------------------------------------
    def entries(self) -> List[dict]:
        """[{fingerprint, bytes, hits, last_hit, created, kind}] for
        every (parseable) entry, unverified — tooling view."""
        out = []
        for fp, d in self._iter_entry_dirs():
            rec = {"fingerprint": fp, "bytes": 0, "hits": 0,
                   "last_hit": 0.0, "created": 0.0, "kind": "?"}
            try:
                for name in os.listdir(d):
                    rec["bytes"] += os.path.getsize(os.path.join(d, name))
                with open(os.path.join(d, META_FILE)) as f:
                    meta = json.load(f)
                rec.update({k: meta[k] for k in
                            ("hits", "last_hit", "created")
                            if k in meta})
                rec["kind"] = meta.get("kind", "?")
                rec["has_executable"] = EXECUTABLE_FILE in meta.get(
                    "sha256", {})
            except (OSError, ValueError):
                rec["kind"] = "corrupt"
            out.append(rec)
        return out

    def total_bytes(self) -> int:
        return sum(e["bytes"] for e in self.entries())

    def stats(self) -> dict:
        es = self.entries()
        return {
            "root": self.root,
            "entries": len(es),
            "bytes": sum(e["bytes"] for e in es),
            "hits": sum(e.get("hits", 0) for e in es),
            "with_executable": sum(1 for e in es
                                   if e.get("has_executable")),
            "corrupt": sum(1 for e in es if e["kind"] == "corrupt"),
        }

    def verify(self) -> Dict[str, bool]:
        """{fingerprint: payloads verify} — read-only (no touch, no
        eviction; the CLI reports, callers decide)."""
        out: Dict[str, bool] = {}
        for fp, d in self._iter_entry_dirs():
            ok = True
            try:
                with open(os.path.join(d, META_FILE)) as f:
                    meta = json.load(f)
                sums = meta.get("sha256", {})
                sizes = meta.get("sizes", {})
                if meta.get("store_format") != STORE_FORMAT or not sums:
                    ok = False
                for name, want in sums.items():
                    p = os.path.join(d, name)
                    if os.path.getsize(p) != int(sizes.get(name, -1)) \
                            or _sha256(p) != want:
                        ok = False
            except (OSError, ValueError):
                ok = False
            out[fp] = ok
        return out

    def _sweep_tmp(self, max_age_s: float = 3600.0) -> None:
        """Reclaim orphaned temp artifacts left by killed writers — e.g.
        the preempted trainer this cache exists for: ``.put_*`` publish
        dirs (killed between mkdtemp and the rename) at the shard level,
        and ``.meta_*`` files inside entry dirs (killed between a hit's
        touch-mkstemp and its os.replace). The age guard keeps live
        writers safe."""
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
        """Evict least-recently-hit entries until total size fits
        ``max_bytes``; returns evicted fingerprints (corrupt entries go
        first regardless of age). Also reclaims orphaned publish temp
        dirs older than an hour."""
        self._sweep_tmp()
        es = self.entries()
        total = sum(e["bytes"] for e in es)
        # corrupt first, then coldest last_hit, then oldest created
        es.sort(key=lambda e: (e["kind"] != "corrupt",
                               e.get("last_hit", 0.0),
                               e.get("created", 0.0)))
        evicted = []
        for e in es:
            if total <= max_bytes and e["kind"] != "corrupt":
                break
            self.evict(e["fingerprint"])
            total -= e["bytes"]
            evicted.append(e["fingerprint"])
        return evicted

    def clear(self) -> int:
        self._sweep_tmp(max_age_s=0.0)  # explicit clear: everything goes
        n = 0
        for fp, _ in list(self._iter_entry_dirs()):
            self.evict(fp)
            n += 1
        return n
