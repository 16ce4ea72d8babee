"""Per-step training telemetry: StepStats records to an append-only
JSONL run log with atomic rotation (counterpart of
paddle_tpu/obs/steplog.py: the same record keys).

The Trainer's event loop already sees everything worth logging — loss
from the step's fetches, the step-time breakdown from the profiler's
``feed_wait``/``h2d``/``dispatch``/``fetch_sync`` spans, fresh captures
(the port's compiles: captured CUDA graphs) and compile-cache deltas
from ``Executor.num_compiled`` and ``compile_cache.cache_metrics()``,
the AMP loss scale from the scope. :class:`StepLogger` wraps the
Trainer's event handler (pass ``steplog=`` to
:class:`~paddle_tpu_torch.trainer.Trainer`) and appends one JSON line
per step; ``python -m paddle_tpu_torch.tools.top`` live-tails the
file.

Honesty rules: a value the step did not materialize is absent or null,
never fabricated — lazy FetchHandle metrics are NOT synced just to log
them (that would change the overlap the pipeline exists for), and span
deltas appear only while the profiler (or obs.trace) is recording.
Rotation is atomic: the live file is os.replace()d to ``<path>.1`` and
a fresh file continues, so a tail never sees a half-truncated line.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from .. import profiler

# the step-time breakdown spans: input-pipeline wait, host->device
# staging, device dispatch, fetch synchronization
BREAKDOWN_SPANS = ("feed_wait", "h2d", "dispatch", "fetch_sync")


class StepLogger:
    """Append-only JSONL step log with size-based atomic rotation."""

    def __init__(self, path: str, rotate_bytes: int = 64 << 20,
                 max_rotations: int = 2):
        self.path = path
        self.rotate_bytes = int(rotate_bytes)
        self.max_rotations = max(1, int(max_rotations))
        self._lock = threading.Lock()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    # ------------------------------------------------------------------
    def log(self, record: Dict[str, object]) -> None:
        """Append one record (adds a wall-clock ``t`` stamp)."""
        record = dict(record)
        record.setdefault("t", round(time.time(), 6))
        line = json.dumps(record, default=_json_default)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            if self._f.tell() >= self.rotate_bytes:
                self._rotate_locked()
        # feed the flight recorder's steplog ring + step-rule watchdogs
        # (one None check while the recorder is off); outside the file
        # lock so an alert-triggered bundle dump never blocks rotation
        from . import record as obs_record

        obs_record.note_step(record)

    def _rotate_locked(self) -> None:
        """Shift <path>.(k) -> <path>.(k+1), os.replace the live file to
        <path>.1, reopen fresh — each step is a single atomic rename, so
        a concurrent tail reads either the old or the new file, never a
        torn one."""
        self._f.close()
        for k in range(self.max_rotations - 1, 0, -1):
            src = "%s.%d" % (self.path, k)
            if os.path.exists(src):
                os.replace(src, "%s.%d" % (self.path, k + 1))
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    # ------------------------------------------------------------------
    def wrap_events(self, handler, executor=None, scope=None):
        """Wrap a Trainer event handler: BeginStepEvent snapshots the
        span totals / compile counters, EndStepEvent emits the StepStats
        record. The wrapped handler still sees every event unchanged."""
        from ..compile_cache.runtime import cache_metrics

        state: Dict[str, object] = {}

        def snap_compiles():
            return (executor.num_compiled if executor is not None
                    else None)

        def wrapped(event):
            name = type(event).__name__
            if name == "BeginStepEvent":
                state["t0"] = time.perf_counter()
                state["spans"] = dict(profiler.event_totals())
                state["compiled"] = snap_compiles()
                state["cache"] = cache_metrics()
            ret = handler(event)
            if name == "EndStepEvent":
                t1 = time.perf_counter()
                t0 = state.pop("t0", None)
                dt = (t1 - t0) if t0 is not None else None
                rec: Dict[str, object] = {
                    "epoch": event.epoch, "step": event.step,
                    "dt_s": None if dt is None else round(dt, 6),
                    "loss": _materialized_scalar(event.metrics),
                }
                spans0 = state.pop("spans", {})
                spans1 = profiler.event_totals()
                breakdown = {}
                for k in BREAKDOWN_SPANS:
                    d = spans1.get(k, 0.0) - spans0.get(k, 0.0)
                    if d > 0.0:
                        breakdown[k] = round(d, 6)
                if breakdown:
                    rec["spans"] = breakdown
                if dt and breakdown.get("feed_wait"):
                    rec["stall_frac"] = round(
                        min(1.0, breakdown["feed_wait"] / dt), 4)
                c0 = state.pop("compiled", None)
                c1 = snap_compiles()
                if c0 is not None and c1 is not None:
                    rec["fresh_compiles"] = c1 - c0
                cache0 = state.pop("cache", None)
                if cache0 is not None:
                    cache1 = cache_metrics()
                    hits = cache1.get("hit", 0) - cache0.get("hit", 0)
                    if hits:
                        rec["cache_hits"] = hits
                ls = _loss_scale(scope)
                if ls is not None:
                    rec["loss_scale"] = ls
                self.log(rec)
            return ret

        return wrapped


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return repr(o)


def _materialized_scalar(metrics: List) -> Optional[float]:
    """loss from the step metrics IF it is already host-materialized —
    a lazy FetchHandle (or a tensor still on the card) is never synced
    just for logging (honesty over completeness: the overlapped
    pipeline's numbers stay valid)."""
    if not metrics:
        return None
    m = metrics[0]
    if type(m).__name__ == "FetchHandle" or (
            hasattr(m, "device") and getattr(m.device, "type", "cpu")
            != "cpu"):
        return None
    try:
        import numpy as np

        arr = np.asarray(m)
        if arr.size >= 1:
            return round(float(arr.reshape(-1)[0]), 6)
    except Exception:
        pass
    return None


def _loss_scale(scope) -> Optional[float]:
    """The AMP dynamic loss scale, when the train program carries one
    (amp/scaler.py names the state var ``loss_scaling``): one read of a
    scalar, as the JAX package's."""
    if scope is None:
        return None
    try:
        for name in scope.local_var_names():
            if "loss_scaling" in name and "good" not in name \
                    and "bad" not in name:
                import numpy as np

                v = scope.get(name)
                if hasattr(v, "detach"):
                    v = v.detach().float().cpu().numpy()
                return float(np.asarray(v).reshape(-1)[0])
    except Exception:
        pass
    return None


def read_steplog(path: str, tail: Optional[int] = None
                 ) -> Iterator[Dict[str, object]]:
    """Parse a steplog JSONL file (skipping any torn/garbage lines);
    ``tail`` keeps only the last N records."""
    records: List[Dict[str, object]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    if tail is not None:
        records = records[-tail:]
    return iter(records)
