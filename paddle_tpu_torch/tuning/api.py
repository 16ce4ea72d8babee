"""Process-level tuning API: lookup, stamps, manifest export/seed
(counterpart of paddle_tpu/tuning/api.py).

``lookup`` is what the kernels' launchers call at each launch (or once,
at capture, for a CUDA graph): in-process memo first, then the
persistent store, then the kernel's declared defaults. Defaults make
the subsystem free when unconfigured: with no store (or no entry) a
lookup returns the launch shape the kernels had before they were
tunable, and the executor's graph-key stamp stays ABSENT, so every
captured-graph key is the one it was without tuning.

Every call after the first for the same (kernel, problem, dtype,
device) is a memo hit: it builds the ``_RESOLVED`` key (the problem's
items as a tuple), reads that dict, draws from an atomic counter and
copies the one- or two-entry config; no key hashing, no lock, no store
read, no JSON (1.6-3.0 µs of the host on an H100 machine in
``chip_smoke.py``'s ``tuning`` phase). The paged kernel is looked up at every eager decode launch,
whose binding already costs the host about 145 µs. Memo hits reach
``tuning_metrics()`` and the ``obs.metrics`` registry when either is
read.

``program_stamp`` is the graph-key bridge: the digest of every tuned
config that could influence a program's kernels (selected by op type).
A captured graph bakes the launch shape it was captured with, so the
executor keys its graphs by the stamp: a sweep later in the process
changes the stamp and the next run captures anew.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import warnings
import weakref
from typing import Dict, List, Optional

import torch

from ..core import flags
from ..obs import metrics as obs_metrics
from .registry import TunableKernel, get_tunable, tunables_for_ops
from .store import TunedRecord, TuningStore, canonical_json, tuning_key

# reentrant: lookup's slow path holds it across the store read and the
# seed it may make, so no concurrent seed or clear can leave a stale
# entry in _RESOLVED
_LOCK = threading.RLock()
# key -> TunedRecord (store/manifest/sweep resolved) | None (defaults
# elected and memoized so repeated lookups never re-walk the store)
_MEMO: Dict[str, Optional[TunedRecord]] = {}
# (kernel, dtype, device kind, problem items) -> the config a lookup
# returned: the one-dict-lookup path; cleared whenever _MEMO gains or
# loses a record
_RESOLVED: Dict[tuple, dict] = {}
# bumped with every change of _MEMO's records: program_stamp's cache key
_GENERATION = [0]
# program -> ((its version, generation, store root), stamp); weak, so a
# collected program's entry goes with it
_STAMPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# torch device index -> torch.cuda.get_device_name(index)
_DEVICE_NAMES: Dict[int, str] = {}


def _zero_metrics() -> Dict[str, int]:
    return {"lookups": 0, "memo_hits": 0, "store_hits": 0,
            "defaults": 0, "sweeps": 0, "sweep_reused": 0,
            "candidates_measured": 0, "rejected": 0, "seeded": 0,
            "prefetched": 0}


_METRICS: Dict[str, int] = _zero_metrics()
# lookup's hit path counts its memo hits (each also a lookup) with
# next(_HITS): atomic, and no lock. _flush_hits moves them into _METRICS
# under the lock; _HITS_TAKEN is the count's value up to which they were
# moved (each flush itself draws one value past it)
_HITS = itertools.count()
_HITS_TAKEN = [0]
# the process-wide registry's family the counts are mirrored into, and
# its child per event, resolved once (and again if the family is
# unregistered)
_FAMILY = "pdtpu_tuning_total"
_CHILDREN: Dict[str, tuple] = {}


def _mirror(key: str, n: int) -> None:
    """Add ``n`` to the ``pdtpu_tuning_total{event=key}`` counter of
    ``obs.metrics``; tuning_metrics() stays the source of truth."""
    try:
        fam = obs_metrics.REGISTRY.family(_FAMILY)
        hit = _CHILDREN.get(key)
        if fam is None or hit is None or hit[0] is not fam:
            fam = obs_metrics.counter(
                _FAMILY,
                "kernel-autotuning events (lookups, store hits, sweeps)",
                labels=("event",))
            hit = _CHILDREN[key] = (fam, fam.labels(event=key))
        hit[1].inc(n)
    except Exception:  # noqa: BLE001 - telemetry never breaks tuning
        pass


def _count(key: str, n: int = 1) -> None:
    with _LOCK:
        _METRICS[key] = _METRICS.get(key, 0) + n
    _mirror(key, n)


def _flush_hits() -> None:
    """Add the memo hits counted since the last flush to ``_METRICS``
    and the registry (run when either is read)."""
    with _LOCK:
        drawn = next(_HITS)
        n = drawn - _HITS_TAKEN[0]
        _HITS_TAKEN[0] = drawn + 1
        if not n:
            return
        _METRICS["lookups"] += n
        _METRICS["memo_hits"] += n
    _mirror("lookups", n)
    _mirror("memo_hits", n)


obs_metrics.REGISTRY.add_collector(_flush_hits)


def tuning_metrics() -> Dict[str, int]:
    """Process-wide counters: lookups/store_hits/defaults/sweeps... —
    the zero-re-sweep warm-start proof reads ``sweeps`` here."""
    _flush_hits()
    with _LOCK:
        return dict(_METRICS)


def reset_tuning_metrics() -> None:
    with _LOCK:
        _HITS_TAKEN[0] = next(_HITS) + 1
        _METRICS.clear()
        _METRICS.update(_zero_metrics())


def _changed() -> None:
    """_MEMO's records changed (caller holds _LOCK)."""
    _RESOLVED.clear()
    _GENERATION[0] += 1


def clear_memo() -> None:
    """Drop the in-process cache (tests; a cleared memo re-resolves
    from the store on the next lookup)."""
    with _LOCK:
        _MEMO.clear()
        _changed()


def seed_memo(record: TunedRecord) -> None:
    with _LOCK:
        _MEMO[record.key] = record
        _changed()


def current_device_kind(device=None) -> str:
    """The device kind tuned configs are keyed by: the card's name
    (``torch.cuda.get_device_name``, e.g. ``NVIDIA H100 80GB HBM3``)
    for a CUDA device, ``cpu`` for the host. With no device: the
    current card when one is visible, else ``cpu``."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        index = torch.cuda.current_device()
    else:
        if not isinstance(device, torch.device):
            device = torch.device(device)
        if device.type != "cuda":
            return device.type
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
    name = _DEVICE_NAMES.get(index)
    if name is None:
        name = _DEVICE_NAMES[index] = torch.cuda.get_device_name(index)
    return name


def active_store() -> Optional[TuningStore]:
    """The store named by the ``tuning_cache_dir`` flag; None = no
    persistence (lookups serve memo/defaults only)."""
    d = flags.get_flag("tuning_cache_dir")
    if not d:
        return None
    return TuningStore(str(d))


def lookup(kernel: str, problem: Optional[dict] = None, *,
           dtype: str = "float32", device_kind: Optional[str] = None,
           device=None) -> dict:
    """The tuned config for ``(kernel, problem-bucket, dtype)`` on
    ``device`` (or ``device_kind``) — or the kernel's declared defaults
    when nothing resolves.

    Called at launch from the kernels' wrappers, so it must be cheap
    (after the first call, a memo hit: see the module docstring) and
    must never raise: a stored config that fails the kernel's
    machine-checked constraints is EVICTED and defaults are returned."""
    try:
        device_kind = device_kind or current_device_kind(device)
        fast = (kernel, str(dtype), device_kind,
                tuple(problem.items()) if problem else ())
        cfg = _RESOLVED.get(fast)
        if cfg is not None:
            next(_HITS)
            return dict(cfg)
        k: TunableKernel = get_tunable(kernel)
    except Exception:  # noqa: BLE001 - a lookup never raises
        return {}
    with _LOCK:
        cfg = _RESOLVED[fast] = _resolve(k, problem, str(dtype),
                                         device_kind)
    return dict(cfg)


def _resolve(k: TunableKernel, problem, dtype: str,
             device_kind: str) -> dict:
    """lookup's slow path (under _LOCK): memo, then store, then
    defaults."""
    key = tuning_key(k.name, k.version, device_kind, dtype,
                     k.bucket_key(problem))
    _count("lookups")
    hit = key in _MEMO
    rec = _MEMO.get(key)
    if hit:
        _count("memo_hits")
        if rec is not None and k.is_valid(rec.config, problem):
            return dict(rec.config)
        return dict(k.defaults)
    store = active_store()
    if store is not None:
        try:
            rec = store.get(key)
        except Exception as e:  # noqa: BLE001 - never breaks a launch
            warnings.warn(f"tuning store lookup failed ({e!r})")
            rec = None
        if rec is not None:
            if not k.is_valid(rec.config, problem):
                # the entry can never be valid for this kernel revision
                # again — reclaim it
                _count("rejected")
                store.evict(key)
            else:
                _count("store_hits")
                seed_memo(rec)
                return dict(rec.config)
    _count("defaults")
    _MEMO[key] = None
    return dict(k.defaults)


# ---------------------------------------------------------------------------
# graph-key stamp + manifest export/seed
# ---------------------------------------------------------------------------


def _op_types(programs) -> set:
    op_types = set()
    for p in programs:
        try:
            op_types.update(op.type for op in p.global_block().ops)
        except Exception:  # noqa: BLE001 - a foreign object adds no ops
            continue
    return op_types


def _relevant_records(op_types, device_kind: Optional[str] = None
                      ) -> List[TunedRecord]:
    """Every resolvable record for kernels any of the given op types
    reach: verified store records plus memo-seeded entries a loaded
    manifest or a sweep installed."""
    kernels = tunables_for_ops(op_types)
    if not kernels:
        return []
    device_kind = device_kind or current_device_kind()
    by_name = {k.name: k for k in kernels}
    out: Dict[str, TunedRecord] = {}
    store = active_store()
    if store is not None:
        try:
            for rec in store.records():
                k = by_name.get(rec.kernel)
                if (k is not None and rec.version == k.version
                        and rec.device_kind == device_kind):
                    out[rec.key] = rec
        except Exception as e:  # noqa: BLE001 - best effort
            warnings.warn(f"tuning store walk failed ({e!r})")
    with _LOCK:
        memo = [r for r in _MEMO.values() if r is not None]
    for rec in memo:
        k = by_name.get(rec.kernel)
        if (k is not None and rec.version == k.version
                and rec.device_kind == device_kind):
            out.setdefault(rec.key, rec)
    return [out[key] for key in sorted(out)]


def program_stamp(program) -> str:
    """Digest of the tuned configs that could influence this program's
    kernels — '' (stamp ABSENT) when every lookup would return
    defaults, so graph keys stay what they are without tuning.
    Computed once per program version and memo generation (a sweep, a
    seed, a store hit or ``clear_memo`` starts a new one). Best-effort:
    any failure degrades to the empty stamp with a warning."""
    store = active_store()
    key = (getattr(program, "_version", None), _GENERATION[0],
           store.root if store is not None else None)
    cached = _STAMPS.get(program)
    if cached is not None and cached[0] == key:
        return cached[1]
    try:
        recs = _relevant_records(_op_types([program]))
        stamp = "" if not recs else hashlib.sha256(canonical_json(
            [[r.key, r.config] for r in recs]).encode()).hexdigest()[:16]
    except Exception as e:  # noqa: BLE001 - best effort
        warnings.warn(f"tuning stamp failed ({e!r})")
        return ""
    _STAMPS[program] = (key, stamp)
    return stamp


def export_configs(*programs) -> List[dict]:
    """The tuned records relevant to the given programs' kernels, as
    manifest-embeddable dicts — what ``io.save_inference_model`` records
    under ``tuned_configs`` so an exported artifact ships its launch
    configs with it."""
    return [r.to_dict() for r in _relevant_records(_op_types(programs))]


def seed_configs(records, publish: bool = True) -> int:
    """Install manifest-carried tuned records into this process: memo
    always (so lookups resolve without a store), the persistent store
    too when one is active (first-publisher-wins — a local sweep's entry
    is never overwritten). Records for other device kinds or kernel
    versions are skipped, constraint-violating ones rejected. Returns
    the number installed."""
    n = 0
    device_kind = current_device_kind()
    store = active_store() if publish else None
    for d in records or []:
        try:
            rec = TunedRecord.from_dict(d)
            k = get_tunable(rec.kernel)
        except Exception:  # noqa: BLE001 - a bad record is skipped
            _count("rejected")
            continue
        if (rec.version != k.version
                or rec.device_kind != device_kind
                or not k.is_valid(rec.config)):
            _count("rejected")
            continue
        rec.source = "manifest"
        seed_memo(rec)
        if store is not None:
            store.put(rec)
        _count("seeded")
        n += 1
    return n


def prefetch(*programs) -> int:
    """Warm the in-process memo with every store record relevant to the
    given programs — serving and decoding ``warm_up`` call this BEFORE
    capturing buckets, so launches resolve from memory and the first
    capture already uses the tuned configs. Returns the number of
    records prefetched."""
    recs = _relevant_records(_op_types(programs))
    for rec in recs:
        seed_memo(rec)
    _count("prefetched", len(recs))
    return len(recs)
