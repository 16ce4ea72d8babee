"""Flight recorder: a crash-surviving black box over the telemetry
plane, dumping atomic post-mortem bundles (counterpart of
paddle_tpu/obs/record.py: the same rings, bundle layout, manifest and
validation, so either package's ``validate_bundle`` accepts the other's
bundles).

The rest of ``obs`` is live: everything it knows evaporates when a
worker dies, which is exactly when a post-mortem needs it. This module
keeps bounded in-memory rings of the recent past and persists them as
**bundles**:

* **rings** — the newest profiler spans (with obs.trace ids), metric
  registry snapshots at a configurable cadence, the steplog tail, the
  last typed errors, watchdog alerts (:mod:`~paddle_tpu_torch.obs.watch`),
  and degradation-stage transitions;
* **bundles** — one directory per dump, written to a temp dir and
  published with a single ``os.rename`` (the ckpt/store publish idiom:
  a SIGKILL mid-dump leaves either no bundle or a fully valid one,
  never a torn one). Each bundle carries the trace tail as JSONL,
  Prometheus + JSON metric snapshots, the composed ``health()`` view,
  program stamps (recent compile-cache and capture fingerprints) and
  environment pins (torch, CUDA, the card: ``compile_cache.
  environment_signature()``), and the active fault plan's hit counts —
  everything ``tools.postmortem`` needs to reconstruct the last seconds
  of a dead process;
* **triggers** — unhandled exceptions (``sys.excepthook`` + the
  Trainer's and the request server's worker hooks, the decode session's
  among them), SIGTERM/SIGQUIT handlers, a watchdog alert firing,
  degradation reaching a configured stage, explicit :func:`dump`, and —
  the black-box property — a **rolling flush** every snapshot interval,
  so even an uncatchable SIGKILL leaves the last flushed bundle behind.

A supervising parent injects ``PDTPU_RECORD_DIR`` into each worker's
env; importing paddle_tpu_torch with that var (or the ``obs_record``
flag) set enables the recorder there.

Default OFF changes nothing: with no recorder enabled every hook in the
codebase is one ``None``-check, and programs are never rewritten —
fingerprints, ``num_compiled`` and existing counters are untouched.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal as _signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import profiler
from . import metrics as obs_metrics
from . import trace as obs_trace
from . import watch as obs_watch

ENV_VAR = "PDTPU_RECORD_DIR"
FORMAT_VERSION = 1
BUNDLE_PREFIX = "bundle-"
_TMP_PREFIX = ".tmp-bundle-"

# every bundle carries exactly this file set (plus MANIFEST.json);
# validate_bundle checks presence, digests, and JSON well-formedness
BUNDLE_FILES = ("trace.jsonl", "steplog.jsonl", "errors.jsonl",
                "alerts.jsonl", "degrade.jsonl", "metrics_history.jsonl",
                "metrics.json", "metrics.prom", "health.json",
                "faults.json")

_HANDLED_SIGNALS = ("SIGTERM", "SIGQUIT")


class RecorderConfig:
    """Knobs of one :class:`FlightRecorder`.

    dir: where bundles land (created if missing).
    interval_s: snapshot cadence — metric-registry snapshots, tick-rule
        watchdog evaluation, and (with ``rolling``) the black-box flush
        all run on this period.
    rolling: keep a rolling bundle current every interval so an
        uncatchable SIGKILL still leaves a valid post-mortem (the
        flight-recorder property). ``keep_rolling`` bounds how many
        rolling bundles survive pruning.
    spans_tail/steps_tail/errors_tail/alerts_tail/snapshots_tail/
    degrade_tail: ring capacities (bounded memory, newest kept).
    keep_bundles: total bundles kept in ``dir`` (oldest pruned).
    dump_on_alert: dump a bundle the moment a watchdog alert FIRES, so
        the anomaly is on disk even if the process dies before the next
        tick.
    dump_at_stage: dump when the degradation ladder reaches this stage
        (default 4 = load_shed; None disables the trigger).
    rules / watchdogs / on_alert: the anomaly-watchdog wiring — a rule
        list (default :func:`~paddle_tpu_torch.obs.watch.default_rules`), or
        a pre-built :class:`~paddle_tpu_torch.obs.watch.Watchdogs`, plus an
        optional alert callback (e.g. a Supervisor annotating
        restarts).
    install_handlers: chain SIGTERM/SIGQUIT handlers and
        ``sys.excepthook`` so orderly kills and unhandled exceptions
        dump before the process exits (main thread only).
    """

    def __init__(self, dir: str, interval_s: float = 1.0,
                 rolling: bool = True, keep_rolling: int = 2,
                 spans_tail: int = 512, steps_tail: int = 256,
                 errors_tail: int = 64, alerts_tail: int = 256,
                 snapshots_tail: int = 32, degrade_tail: int = 64,
                 keep_bundles: int = 16, dump_on_alert: bool = True,
                 dump_at_stage: Optional[int] = 4,
                 rules=None, watchdogs=None, on_alert=None,
                 install_handlers: bool = True):
        if not dir:
            raise ValueError("RecorderConfig needs a bundle dir")
        self.dir = str(dir)
        self.interval_s = max(0.01, float(interval_s))
        self.rolling = bool(rolling)
        self.keep_rolling = max(1, int(keep_rolling))
        self.spans_tail = max(1, int(spans_tail))
        self.steps_tail = max(1, int(steps_tail))
        self.errors_tail = max(1, int(errors_tail))
        self.alerts_tail = max(1, int(alerts_tail))
        self.snapshots_tail = max(1, int(snapshots_tail))
        self.degrade_tail = max(1, int(degrade_tail))
        self.keep_bundles = max(1, int(keep_bundles))
        self.dump_on_alert = bool(dump_on_alert)
        self.dump_at_stage = (None if dump_at_stage is None
                              else int(dump_at_stage))
        self.rules = rules
        self.watchdogs = watchdogs
        self.on_alert = on_alert
        self.install_handlers = bool(install_handlers)


class FlightRecorder:
    """The black box: bounded rings + atomic bundle dumps.

    One recorder per process (module-level :func:`enable`); all ring
    appends are lock-guarded and every dump is serialized behind one
    dump lock, so a signal-handler dump racing the rolling flush writes
    two complete bundles, never a torn one."""

    def __init__(self, config: RecorderConfig):
        self.config = config
        os.makedirs(config.dir, exist_ok=True)
        # REENTRANT, both of them: a SIGTERM handler runs its dump on
        # whatever main-thread frame it interrupted — including one
        # already holding the ring lock (note_step) or mid-dump — and a
        # plain Lock would deadlock the dying process against itself
        self._lock = threading.RLock()
        self._dump_lock = threading.RLock()
        self._steps: deque = deque(maxlen=config.steps_tail)
        self._errors: deque = deque(maxlen=config.errors_tail)
        self._degrade: deque = deque(maxlen=config.degrade_tail)
        self._snapshots: deque = deque(maxlen=config.snapshots_tail)
        self._seq = self._initial_seq()
        self.dumps = 0
        # the watchdog engine: a supplied instance gets its on_alert
        # chained (every user callback fires — the config's AND the
        # instance's own — then the recorder's dump-on-firing hook);
        # otherwise one is built from the rules
        wd = config.watchdogs
        if wd is None:
            wd = obs_watch.Watchdogs(rules=config.rules,
                                     alerts_tail=config.alerts_tail)
        self._user_on_alert = [cb for cb in (config.on_alert,
                                             wd.on_alert)
                               if cb is not None]
        wd.on_alert = self._alert_hook
        self.watch = wd
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_signal: Dict[int, object] = {}
        self._prev_excepthook = None
        # the identity of the last exception already noted+dumped by
        # record_exception: when it propagates on up to sys.excepthook,
        # the hook must not note and dump the SAME death a second time.
        # (id, type), not the exception: its traceback holds the dying
        # worker's frames, and with them its engine and CUDA graphs,
        # which a live recorder must not keep on the card
        self._last_exception: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _initial_seq(self) -> int:
        """Continue the bundle sequence past whatever already exists in
        the dir (a restarted worker must not collide with — and can
        never overwrite — its predecessor's bundles)."""
        seq = 0
        try:
            for name in os.listdir(self.config.dir):
                if name.startswith(BUNDLE_PREFIX):
                    try:
                        seq = max(seq, int(name.split("-")[1]) + 1)
                    except (IndexError, ValueError):
                        pass
        except OSError:
            pass
        return seq

    def _alert_hook(self, alert) -> None:
        for cb in self._user_on_alert:
            try:
                cb(alert)
            except Exception:
                pass
        if self.config.dump_on_alert and alert.state == "firing":
            try:
                self.dump("alert")
            except Exception:
                pass  # the black box must never break the workload

    # ------------------------------------------------------- ring feeds
    def note_step(self, record: dict) -> None:
        """One StepStats record (the steplog feeds this): ring append +
        step-rule watchdog evaluation."""
        with self._lock:
            self._steps.append(dict(record))
        self.watch.observe_step(record)

    def note_error(self, exc: BaseException,
                   context: Optional[str] = None) -> None:
        """Append one typed error to the ring (no dump — pair with
        :meth:`dump` or use :func:`record_exception`)."""
        ctx = obs_trace.current()
        rec = {"t": round(time.time(), 6),
               "type": type(exc).__name__,
               "error": str(exc)[:2000],
               "context": context,
               "trace": ctx.env_value() if ctx is not None else None}
        with self._lock:
            self._errors.append(rec)

    def note_degradation(self, frm: int, to: int, reason: str) -> None:
        """One degradation-ladder transition; reaching the configured
        stage triggers a dump."""
        with self._lock:
            self._degrade.append({"t": round(time.time(), 6),
                                  "from": int(frm), "to": int(to),
                                  "reason": str(reason)})
        if self.config.dump_at_stage is not None \
                and int(to) >= self.config.dump_at_stage:
            try:
                self.dump("degrade")
            except Exception:
                pass

    # ------------------------------------------------------------ cadence
    def tick(self) -> None:
        """One snapshot-cadence beat: condensed registry snapshot into
        the history ring, tick-rule watchdog evaluation (fed the SAME
        registry walk — one traversal per tick, not two), rolling
        flush."""
        condensed, counters = _walk_registry()
        snap = {"t": round(time.time(), 6), "values": condensed}
        with self._lock:
            self._snapshots.append(snap)
        try:
            health = obs_metrics.health_snapshot()
        except Exception:
            health = {}
        self.watch.observe_tick(health=health,
                                dt_s=self.config.interval_s,
                                counter_values=counters)
        if self.config.rolling:
            try:
                self.dump("rolling")
            except Exception:
                pass

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:
                pass  # the recorder thread must never die loudly

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="pdtpu-obs-record",
                                        daemon=True)
        self._thread.start()
        if self.config.install_handlers:
            self._install_handlers()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._restore_handlers()

    # ------------------------------------------------------------ handlers
    def _install_handlers(self) -> None:
        # signal handlers only bind on the main thread; elsewhere the
        # rolling flush remains the crash-survival path
        for name in _HANDLED_SIGNALS:
            signum = getattr(_signal, name, None)
            if signum is None:
                continue
            try:
                self._prev_signal[signum] = _signal.signal(
                    signum, self._on_signal)
            except (ValueError, OSError):
                pass
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook

    def _restore_handlers(self) -> None:
        for signum, prev in self._prev_signal.items():
            try:
                _signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_signal.clear()
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None

    def _on_signal(self, signum, frame) -> None:
        try:
            # BOUNDED lock wait: the rolling-flush thread may hold the
            # dump lock while blocked on a profiler/registry lock this
            # very handler's interrupted frame owns — an unbounded
            # acquire would deadlock the dying process. On timeout the
            # dump is skipped (the last rolling bundle stands) and the
            # signal still runs its course.
            self.dump("signal_%d" % signum, lock_timeout_s=2.0)
        except Exception:
            pass
        prev = self._prev_signal.get(signum)
        if prev is _signal.SIG_IGN:
            return  # the process chose to survive this signal — honor it
        if callable(prev):
            prev(signum, frame)
        else:
            # previously-default disposition: restore it and re-deliver
            # so the exit status stays what the sender expects
            _signal.signal(signum, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def _excepthook(self, tp, val, tb) -> None:
        if _identity(val) != self._last_exception:  # not dumped below
            try:
                self.note_error(val, context="sys.excepthook")
                self.dump("exception")
            except Exception:
                pass
        (self._prev_excepthook or sys.__excepthook__)(tp, val, tb)

    # --------------------------------------------------------------- dump
    def child_dir(self, tag: str) -> str:
        """A per-worker collection dir under this recorder's dir — what
        a Supervisor injects as the worker's ``PDTPU_RECORD_DIR``."""
        d = os.path.join(self.config.dir, "workers", str(tag))
        os.makedirs(d, exist_ok=True)
        return d

    def dump(self, reason: str = "manual",
             lock_timeout_s: Optional[float] = None) -> Optional[str]:
        """Write one atomic bundle; returns its path (None if the write
        failed, or if ``lock_timeout_s`` was given and another thread's
        dump did not finish in time — the signal-handler path, where
        blocking forever would deadlock the dying process). Safe from
        any thread: content gathering is best-effort per section, the
        bundle publishes with a single ``os.rename``."""
        reason = "".join(c if c.isalnum() or c == "_" else "_"
                         for c in str(reason)) or "manual"
        if lock_timeout_s is None:
            self._dump_lock.acquire()
        elif not self._dump_lock.acquire(timeout=lock_timeout_s):
            return None
        try:
            with self._lock:
                seq = self._seq
                self._seq += 1
                steps = list(self._steps)
                errors = list(self._errors)
                degrade = list(self._degrade)
                snapshots = list(self._snapshots)
            files = self._gather(steps, errors, degrade, snapshots)
            try:
                tmp = tempfile.mkdtemp(prefix=_TMP_PREFIX,
                                       dir=self.config.dir)
            except OSError:
                return None
            try:
                digests = {}
                for name, text in files.items():
                    data = text.encode("utf-8")
                    with open(os.path.join(tmp, name), "wb") as f:
                        f.write(data)
                    digests[name] = {
                        "sha256": hashlib.sha256(data).hexdigest(),
                        "bytes": len(data)}
                manifest = self._manifest(reason, seq, digests,
                                          len(steps), len(errors))
                with open(os.path.join(tmp, "MANIFEST.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(manifest, f, indent=1, sort_keys=True)
                final = os.path.join(
                    self.config.dir,
                    "%s%06d-%s" % (BUNDLE_PREFIX, seq, reason))
                os.rename(tmp, final)  # atomic publish
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
                return None
            self.dumps += 1
            self._prune()
            return final
        finally:
            self._dump_lock.release()

    def _gather(self, steps, errors, degrade, snapshots
                ) -> Dict[str, str]:
        """Every bundle file's text content, each section best-effort —
        a dying process gets whatever sections still work."""
        files: Dict[str, str] = {}

        def put(name, fn):
            try:
                files[name] = fn()
            except Exception as e:
                files[name] = json.dumps(
                    {"_section_error": repr(e)}) + (
                    "\n" if name.endswith("jsonl") else "")

        put("trace.jsonl", lambda: _spans_jsonl(self.config.spans_tail))
        put("steplog.jsonl", lambda: _jsonl(steps))
        put("errors.jsonl", lambda: _jsonl(errors))
        put("alerts.jsonl", lambda: _jsonl(
            [a.to_dict() for a in list(self.watch.alerts)]))
        put("degrade.jsonl", lambda: _jsonl(degrade))
        put("metrics_history.jsonl", lambda: _jsonl(snapshots))
        put("metrics.json", lambda: json.dumps(
            obs_metrics.snapshot(), sort_keys=True, default=repr))
        put("metrics.prom", obs_metrics.render_prometheus)
        put("health.json", lambda: json.dumps(
            obs_metrics.health_snapshot(), sort_keys=True, default=repr))
        put("faults.json", _faults_json)
        return files

    def _manifest(self, reason, seq, digests, n_steps, n_errors) -> dict:
        man = {
            "format": FORMAT_VERSION,
            "reason": reason,
            "seq": seq,
            "t": round(time.time(), 6),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "interval_s": self.config.interval_s,
            "counts": {"steps": n_steps, "errors": n_errors,
                       "alerts": len(self.watch.alerts),
                       "active_alerts": self.watch.active(),
                       "spans_dropped": profiler.spans_dropped()},
            "files": digests,
        }
        try:
            ctx = obs_trace.process_root()
            man["trace_root"] = ctx.env_value() if ctx else None
        except Exception:
            man["trace_root"] = None
        try:
            from ..compile_cache.fingerprint import environment_signature

            man["env"] = environment_signature()
        except Exception as e:
            man["env"] = {"error": repr(e)}
        try:
            from ..compile_cache.runtime import (cache_metrics,
                                                 recent_fingerprints)

            man["stamps"] = {"cache_metrics": cache_metrics(),
                             "fingerprints": recent_fingerprints()}
        except Exception as e:
            man["stamps"] = {"error": repr(e)}
        return man

    def _prune(self) -> None:
        """Bound the on-disk footprint: rolling bundles beyond
        ``keep_rolling``, and everything beyond ``keep_bundles``,
        oldest first (triggered dumps outlive rolling ones)."""
        try:
            bundles = find_bundles(self.config.dir)
        except OSError:
            return
        rolling = [b for b in bundles if b.endswith("-rolling")]
        doomed = rolling[:-self.config.keep_rolling] if \
            len(rolling) > self.config.keep_rolling else []
        keep = [b for b in bundles if b not in doomed]
        if len(keep) > self.config.keep_bundles:
            doomed += keep[:len(keep) - self.config.keep_bundles]
        for b in doomed:
            # rename out of the bundle namespace FIRST: a SIGKILL
            # mid-rmtree must leave an invisible .tmp dir, never a
            # half-deleted bundle-* that looks published but torn
            tmp = os.path.join(
                self.config.dir,
                _TMP_PREFIX + "doomed-" + os.path.basename(b))
            try:
                os.rename(b, tmp)
            except OSError:
                tmp = b  # stale name collision: delete in place
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# content helpers
# ---------------------------------------------------------------------------


def _jsonl(records) -> str:
    return "".join(json.dumps(r, sort_keys=True, default=repr) + "\n"
                   for r in records)


def _spans_jsonl(tail: int) -> str:
    spans = profiler.get_spans(with_trace=True, tail=tail)
    out = []
    for name, t0, t1, tid, tname, trace in spans:
        rec = {"name": name, "t0": round(t0, 6), "t1": round(t1, 6),
               "thread_id": tid, "thread": tname}
        if trace is not None:
            rec["trace_id"], rec["span_id"], rec["parent_id"] = trace
        out.append(rec)
    return _jsonl(out)


def _walk_registry():
    """ONE traversal serving both per-tick consumers: the condensed
    history entry ({family: {label-string: value}}, counters + gauges;
    histograms ride in the full metrics.json at dump time) and the
    watchdog delta baseline ({(family, labels-tuple): value}, counters
    only, the Watchdogs._counter_values shape)."""
    condensed: Dict[str, Dict[str, object]] = {}
    counters: Dict = {}
    for fam in obs_metrics.REGISTRY.families():
        if fam.kind == "histogram":
            continue
        vals = {}
        for labels, child in fam.children():
            v = child.value
            vals[",".join("%s=%s" % kv
                          for kv in sorted(labels.items()))] = v
            if fam.kind == "counter":
                counters[(fam.name,
                          tuple(sorted(labels.items())))] = v
        if vals:
            condensed[fam.name] = vals
    return condensed, counters


def _faults_json() -> str:
    from ..resilience import faults

    plan = faults.active_plan()
    return json.dumps({
        "plan": plan.to_dict() if plan is not None else None,
        "hit_counts": faults.hit_counts(),
        "injections": faults.injections(),
        "log_tail": faults.injection_log()[-200:],
    }, sort_keys=True)


# ---------------------------------------------------------------------------
# bundle reading / validation (shared with tools.postmortem)
# ---------------------------------------------------------------------------


def find_bundles(dir: str) -> List[str]:
    """Published bundle dirs under ``dir``, oldest first (in-progress
    ``.tmp-bundle-*`` dirs are never listed — unpublished is
    invisible, the atomicity contract). A missing/unreadable dir is
    simply empty — collection paths must not crash on a worker that
    never got far enough to create it."""
    try:
        names = sorted(os.listdir(dir))
    except OSError:
        return []
    out = [os.path.join(dir, n) for n in names
           if n.startswith(BUNDLE_PREFIX)]
    return [p for p in out if os.path.isdir(p)]


def validate_bundle(path: str) -> List[str]:
    """Structural problems with one bundle (empty list = valid): the
    manifest parses at a known format version, every listed file exists
    with a matching sha256 digest, JSON/JSONL payloads parse line by
    line, and the required file set is complete."""
    problems: List[str] = []
    man_path = os.path.join(path, "MANIFEST.json")
    try:
        with open(man_path, "r", encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return ["MANIFEST.json unreadable: %s" % (e,)]
    if man.get("format") != FORMAT_VERSION:
        problems.append("unknown bundle format %r" % (man.get("format"),))
    for key in ("reason", "t", "pid", "files"):
        if key not in man:
            problems.append("manifest missing %r" % key)
    files = man.get("files") or {}
    missing = set(BUNDLE_FILES) - set(files)
    if missing:
        problems.append("manifest lists no %s" % sorted(missing))
    for name, meta in sorted(files.items()):
        fp = os.path.join(path, name)
        try:
            with open(fp, "rb") as f:
                data = f.read()
        except OSError as e:
            problems.append("%s unreadable: %s" % (name, e))
            continue
        digest = hashlib.sha256(data).hexdigest()
        if meta.get("sha256") != digest:
            problems.append("%s digest mismatch" % name)
            continue
        try:
            text = data.decode("utf-8")
            if name.endswith(".jsonl"):
                for i, line in enumerate(text.splitlines()):
                    if line.strip():
                        json.loads(line)
            elif name.endswith(".json"):
                json.loads(text)
        except (UnicodeDecodeError, ValueError) as e:
            problems.append("%s malformed: %s" % (name, e))
    return problems


def read_bundle(path: str) -> dict:
    """Parse one bundle into a dict: ``manifest`` plus each payload
    under its stem (JSONL files become record lists)."""
    out: dict = {}
    with open(os.path.join(path, "MANIFEST.json"), "r",
              encoding="utf-8") as f:
        out["manifest"] = json.load(f)
    for name in BUNDLE_FILES:
        fp = os.path.join(path, name)
        # metrics.prom keys as "prom": stripping extensions alone would
        # collide it with metrics.json's "metrics"
        stem = ("prom" if name == "metrics.prom"
                else name.rsplit(".", 1)[0])
        try:
            with open(fp, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            out[stem] = None
            continue
        if name.endswith(".jsonl"):
            out[stem] = [json.loads(ln) for ln in text.splitlines()
                         if ln.strip()]
        elif name.endswith(".json"):
            out[stem] = json.loads(text)
        else:
            out[stem] = text
    return out


def latest_bundle(dir: str, valid_only: bool = True) -> Optional[str]:
    """Newest bundle under ``dir`` (newest VALID one by default) —
    what a Supervisor collects after a worker dies."""
    try:
        bundles = find_bundles(dir)
    except OSError:
        return None
    for b in reversed(bundles):
        if not valid_only or not validate_bundle(b):
            return b
    return None


# ---------------------------------------------------------------------------
# module-level singleton: the hooks the codebase calls
# ---------------------------------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None


def enable(config: Optional[RecorderConfig] = None, **kw
           ) -> FlightRecorder:
    """Enable the process flight recorder (idempotent: an already
    enabled recorder is returned unchanged). Pass a
    :class:`RecorderConfig` or its kwargs (``dir=...`` at minimum)."""
    global _RECORDER
    if _RECORDER is not None:
        return _RECORDER
    rec = FlightRecorder(config or RecorderConfig(**kw))
    rec.start()
    _RECORDER = rec
    return rec


def disable() -> None:
    """Stop the recorder thread, restore signal/except hooks; the
    rings are discarded (bundles already on disk stay)."""
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    if rec is not None:
        rec.stop()


def enabled() -> bool:
    return _RECORDER is not None


def recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def dump(reason: str = "manual") -> Optional[str]:
    """Explicit bundle dump (``obs.dump()``); None while disabled."""
    rec = _RECORDER
    return rec.dump(reason) if rec is not None else None


def note_step(record: dict) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.note_step(record)


def note_error(exc: BaseException, context: Optional[str] = None) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.note_error(exc, context=context)


def note_degradation(frm: int, to: int, reason: str) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.note_degradation(frm, to, reason)


def _identity(exc: BaseException) -> tuple:
    """What ``_excepthook`` compares to recognize an exception that
    :func:`record_exception` already dumped, without holding it."""
    return (id(exc), type(exc))


def record_exception(exc: BaseException,
                     context: Optional[str] = None) -> Optional[str]:
    """The unhandled-exception hook the Trainer and the serving worker
    thread (the decode session's too) call on their way down: error
    ring + bundle. No-op (one None check) while the recorder is off."""
    rec = _RECORDER
    if rec is None:
        return None
    rec.note_error(exc, context=context)
    rec._last_exception = _identity(exc)  # the excepthook must not dump
    # it again
    try:
        return rec.dump("exception")
    except Exception:
        return None
