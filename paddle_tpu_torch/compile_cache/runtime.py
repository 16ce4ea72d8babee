"""Runtime glue: resolve a compilation site against the persistent store
(counterpart of paddle_tpu/compile_cache/runtime.py).

The JAX package resolves three sites here; each maps to the port
differently:

* the executor's steps and scans (its ``resolve``): the port's executor
  compiles nothing a later process can read. ``Executor.run``
  interprets the ops, and ``run_graph``/``run_steps`` capture CUDA
  graphs, which hold this process's device addresses and cannot be
  serialized. With the flag set each capture is only fingerprinted
  (:func:`note_capture`) into :func:`recent_fingerprints`, the program
  stamps the flight recorder writes into its bundles;
* the native predictor's per-bucket compiles (``load_or_compile_hlo``):
  the port's ``NativePredictor`` loads ``.pt2`` files that are already
  exported and compiles nothing, so there is nothing to cache;
* ``save_inference_model``'s bucket lowering (``cached_lowering``): the
  port's counterpart is the ``torch.export`` of each bucket, and of
  ``save_trainable_program``'s step — :func:`cached_export`. The
  parameters are graph inputs, so an exported graph does not depend on
  the weights: a re-export after retraining, or a second process
  exporting the same program, reuses it.

Every failure of the cache's own plumbing — an unreadable store, a
payload that does not load — degrades to a fresh export with a warning,
never an error: a broken cache costs export time, not correctness. An
error of the export itself propagates.
"""

from __future__ import annotations

import io
import os
import threading
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import flags
from ..profiler import RecordEvent
from .fingerprint import CompilationUnit, environment_signature
from .store import CacheStore

SPAN_HIT = "compile_cache/hit"
SPAN_MISS = "compile_cache/miss"
SPAN_DESERIALIZE = "compile_cache/deserialize"

_LOCK = threading.Lock()


def _zero_metrics() -> Dict[str, float]:
    return {"hit": 0, "miss": 0, "deserialize": 0, "hlo_compile": 0,
            "publish": 0, "publish_skipped": 0, "bad_entry": 0,
            "bytes_read": 0, "bytes_written": 0, "deserialize_s": 0.0}


_METRICS: Dict[str, float] = _zero_metrics()


def _count(key: str, n=1) -> None:
    with _LOCK:
        _METRICS[key] = _METRICS.get(key, 0) + n
    # mirror into the process-wide registry (obs.metrics) so /metrics
    # exposes hits, misses and bytes beside everything else;
    # cache_metrics() stays the source of truth here
    try:
        from ..obs import metrics as obs_metrics

        obs_metrics.counter(
            "pdtpu_compile_cache_total",
            "persistent compile-cache events (hits, misses, bytes, "
            "deserialize seconds)", labels=("event",)
        ).labels(event=key).inc(n)
    except Exception:
        pass  # telemetry must never break the cache path


def cache_metrics() -> Dict[str, float]:
    """Process-wide compile-cache counters: hits, misses, publishes,
    bad entries, bytes read and written, and the ``torch.export.load``
    checks of hits (``deserialize``, ``deserialize_s``). The JAX
    package's keys; ``hlo_compile`` and ``publish_skipped`` stay 0 (the
    port has no StableHLO recompile and no calling convention to
    refuse)."""
    with _LOCK:
        return dict(_METRICS)


def reset_cache_metrics() -> None:
    with _LOCK:
        _METRICS.clear()
        _METRICS.update(_zero_metrics())


# the newest program fingerprints this process resolved or captured —
# the "program stamps" a flight-recorder bundle carries so a post-mortem
# can name the graphs a dead worker was running (bounded ring)
_RECENT_FP: deque = deque(maxlen=32)


def _note_fingerprint(fp: str, kind: str) -> None:
    with _LOCK:
        _RECENT_FP.append({"fingerprint": fp, "kind": kind,
                           "t": round(time.time(), 6)})


def recent_fingerprints() -> List[dict]:
    """Newest-last ring of the fingerprints this process resolved
    against the store or captured (empty while the cache is off)."""
    with _LOCK:
        return list(_RECENT_FP)


def active_store() -> Optional[CacheStore]:
    """The store named by the ``compile_cache_dir`` flag, or None (the
    default: caching off, zero behavior change)."""
    d = flags.get_flag("compile_cache_dir")
    return CacheStore(str(d)) if d else None


def _device_tag(device) -> str:
    """Stable identity of one device: platform:kind:index (the JAX
    package's ``_device_tag``)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return "cuda:%s:%d" % (torch.cuda.get_device_name(index), index)
    return "%s:%s:0" % (device.type, device.type)


def _program_stamps(program) -> dict:
    """The stamps that change what a program runs without changing its
    desc's ops: the AMP policy (``amp/rewrite.py``), the pass pipeline
    (``passes/manager.py``), the schedule passes (``passes/schedule.py``)
    and the tuned configs its kernels would read (``tuning``). A key is
    left out when its stamp is unset, so untouched programs keep their
    fingerprints."""
    out = {}
    for key, attr in (("amp", "_amp_stamp"), ("passes", "_passes_stamp"),
                      ("schedule", "_schedule_stamp")):
        stamp = getattr(program, attr, None)
        if stamp:
            out[key] = stamp
    from ..tuning import program_stamp

    tuned = program_stamp(program)
    if tuned:
        out["tuning"] = tuned
    return out


def note_capture(program, feed_avals: Dict[str, tuple],
                 state_avals: Dict[str, tuple],
                 fetch_names: Sequence[str], kind: str, device,
                 config: Optional[dict] = None) -> Optional[str]:
    """Fingerprint one executor capture (``kind`` "graph" or "steps")
    at its feed and state ``(shape, dtype)`` avals on ``device`` into
    :func:`recent_fingerprints` when the ``compile_cache_dir`` flag is
    set; nothing is persisted (a CUDA graph holds this process's
    addresses). Returns the fingerprint; None with the flag unset, or
    when fingerprinting failed (it warns)."""
    if not flags.get_flag("compile_cache_dir"):
        return None
    try:
        unit = CompilationUnit(program, sorted(feed_avals), fetch_names)
        cfg = {"kind": kind, **dict(config or {}),
               "device": _device_tag(device), **_program_stamps(program)}
        fp = unit.fingerprint(feed_avals, state_avals, cfg)
    except Exception as e:
        warnings.warn(f"compile_cache: capture fingerprint failed ({e!r})")
        return None
    _note_fingerprint(fp, kind)
    return fp


def _check_payload(data: bytes) -> None:
    """Raise unless ``data`` loads as a ``torch.export`` program (the
    modules that register the graphs' custom ops imported first)."""
    import torch

    from ..layers import nn  # noqa: F401
    from ..ops import (dropout, flash_attention,  # noqa: F401
                       fused_optimizer, paged_attention)

    torch.export.load(io.BytesIO(data))


def cached_export(program, feed_names: Sequence[str],
                  fetch_names: Sequence[str],
                  feed_avals: Dict[str, tuple],
                  state_avals: Dict[str, tuple],
                  config: dict,
                  produce: Callable[[], Tuple[object, dict]]
                  ) -> Tuple[bytes, dict]:
    """The ``.pt2`` bytes of one export of ``program`` (the port's
    ``cached_lowering``): ``(payload, extra)``.

    The key is the program's :class:`CompilationUnit` fingerprint at the
    feed and state shapes, with ``config`` (the site's kind, the feed
    order, the trace's device, anything else the export bakes in) and
    the program's stamps. ``produce()`` exports: it returns the
    ``ExportedProgram`` and ``extra``, a JSON dict the caller needs back
    on a hit (stored in the entry's meta). A hit returns the stored
    bytes verbatim, so a warm file is byte-equal to the cold one (two
    exports of one program are not: ``torch.export.save`` writes a
    random serialization id and the trace's node ids); it counts
    ``hit`` and ``bytes_read``. A miss exports, publishes
    (first publisher wins) and counts ``miss``, ``publish`` and
    ``bytes_written``. An entry whose payload fails its checksum or does
    not load counts ``bad_entry``, is evicted and exported again. With
    the flag unset it is ``produce`` and a save to a buffer, the
    caller writing the bytes as ``torch.export.save`` would."""
    import torch

    def export() -> Tuple[bytes, str, dict]:
        exported, extra = produce()
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        return buf.getvalue(), exported.graph_module.code, dict(extra or {})

    store = active_store()
    if store is None:
        data, _, extra = export()
        return data, extra
    env = environment_signature()
    fp = None
    try:
        unit = CompilationUnit(program, feed_names, fetch_names)
        # the graph binds feeds and state POSITIONALLY while the desc
        # keys them by name: both orders are part of the key, the state's
        # as canonical ids (so param naming cannot split the cache)
        cfg = {**dict(config), "feed_order": list(feed_names),
               "state_order": [unit.cid(n) if unit.cid(n) is not None
                               else "?" + n for n in state_avals],
               **_program_stamps(program)}
        fp = unit.fingerprint(feed_avals, state_avals, cfg, env=env)
        _note_fingerprint(fp, "export")
        present = os.path.isdir(store.entry_dir(fp))
        entry = store.get(fp, env=env)
        if entry is None and present:
            _count("bad_entry")  # failed its checksums or its env pin
        elif entry is not None and not entry.has_executable:
            _count("bad_entry")
            store.evict(fp)
            entry = None
        if entry is not None:
            data = entry.read_executable()
            t0 = time.perf_counter()
            try:
                with RecordEvent(SPAN_DESERIALIZE):
                    _check_payload(data)
            except Exception as e:
                warnings.warn(f"compile_cache: a stored export does not "
                              f"load ({e!r}); entry evicted, exporting")
                _count("bad_entry")
                store.evict(fp)
            else:
                _count("deserialize")
                _count("deserialize_s", time.perf_counter() - t0)
                _count("hit")
                _count("bytes_read", len(data))
                with RecordEvent(SPAN_HIT):
                    pass  # zero-length marker span
                return data, dict(entry.meta.get("extra") or {})
    except Exception as e:
        warnings.warn(f"compile_cache lookup failed ({e!r})")
        fp = None
    _count("miss")
    with RecordEvent(SPAN_MISS):
        data, text, extra = export()
    if fp is not None:
        try:
            if store.put(fp, text, data, {"kind": "export", "env": env,
                                          "cc": None, "extra": extra}):
                _count("publish")
                _count("bytes_written", len(text.encode("utf-8"))
                       + len(data))
        except Exception as e:
            warnings.warn(f"compile_cache publish failed ({e!r})")
    return data, extra
