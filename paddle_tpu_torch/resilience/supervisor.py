"""Supervised elastic training runtime (counterpart of
paddle_tpu/resilience/supervisor.py, the same protocol and report).

The reference framework's production story has a supervisor in it: the
Fluid fleet's pserver/trainer jobs were babysat by the cluster — a dead
trainer was restarted and rejoined at whatever capacity remained. A
:class:`Supervisor` runs a trainer worker as a subprocess, watches
**step-progress heartbeats** (so it detects hangs, not just crashes),
and restarts it under the ONE shared
:class:`~paddle_tpu_torch.resilience.RetryPolicy` backoff.

Elasticity is composition: the worker restores the newest valid
checkpoint through ``ckpt.restore`` (N→M: each rank's blocks re-cut
from the saved blocks) onto whatever mesh its launch spec gives it — so
the ``launch`` callback choosing a smaller world size after a kill is
ALL it takes for "kill a host, rejoin at a different world size,
training continues".

A worker of several ranks is ``python -m paddle_tpu_torch.tools.launch
--nproc N script.py``: a launcher and N rank processes. The supervisor
starts the launcher in a session of its own and ends every attempt by
killing its whole process group (SIGKILL), so a killed or crashed
launcher never leaves ranks behind holding the store's port or the
card. (The JAX worker is one process; its supervisor signals one pid.)

Heartbeat protocol: the supervisor injects ``PDTPU_HEARTBEAT_FILE``
into the worker env; the worker calls :func:`note_progress` once per
step (the Trainer does this automatically). In a world of several
ranks only rank 0 writes the file: a hung rank stalls rank 0 at its
next collective, so the watchdog still sees the hang. Heartbeats are
atomic JSON replaces — a torn read is impossible, a missing file just
means "no progress yet". Watchdog expiry (no heartbeat change for
``watchdog_s``) is treated exactly like a crash: SIGKILL, backoff,
relaunch.

Everything is span-instrumented (``resilience/supervisor.attempt`` /
``.backoff`` / ``.recovery``) so recovery time is measurable from
profiler span totals.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

from ..profiler import RecordEvent
from .retry import RetryPolicy

HEARTBEAT_ENV = "PDTPU_HEARTBEAT_FILE"


def _beating_rank() -> bool:
    """Whether this process writes the heartbeat: always outside a
    world of ranks, else rank 0 only."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _kill_group(proc) -> None:
    """SIGKILL every process left in the worker's session (the launcher
    and its ranks); a group already gone is fine."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        pass


def note_progress(step: int, path: Optional[str] = None, **extra) -> None:
    """Worker-side heartbeat: atomically publish {step, time, **extra}.

    ``path`` defaults to the supervisor-injected env var; with neither,
    this is a no-op — a worker can call it unconditionally (the Trainer
    does, once per step) at the cost of one env lookup. In an
    initialized ``torch.distributed`` world of several ranks only rank
    0 writes."""
    path = path or os.environ.get(HEARTBEAT_ENV)
    if not path or not _beating_rank():
        return
    rec = {"step": int(step), "time": time.time(), "pid": os.getpid()}
    rec.update(extra)
    try:
        d = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(prefix=".hb_", dir=d)
        with os.fdopen(fd, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
    except OSError:
        pass  # a failing heartbeat must never kill the worker


def read_heartbeat(path: str) -> Optional[dict]:
    """Parsed heartbeat, or None when absent (atomic replaces mean a
    present file always parses; a torn write is impossible)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class WorkerReport:
    """Outcome of one supervised attempt."""

    def __init__(self, attempt: int):
        self.attempt = attempt
        self.returncode: Optional[int] = None
        self.reason = "done"        # "done" | "crash" | "hang" | "spawn"
        self.steps: Optional[int] = None   # last heartbeat step
        self.resumed_from: Optional[int] = None
        self.duration_s = 0.0
        self.recovery_s: Optional[float] = None  # prev death -> first beat
        self.world_size: Optional[int] = None
        # newest valid flight-recorder bundle collected from the
        # worker's PDTPU_RECORD_DIR (None when recording is off or the
        # worker died before its first flush)
        self.bundle: Optional[str] = None

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class SupervisorGaveUp(RuntimeError):
    """Raised by :meth:`Supervisor.run` when ``max_restarts``
    consecutive non-productive attempts are exhausted."""

    def __init__(self, message: str, report: dict):
        super().__init__(message)
        self.report = report


class Supervisor:
    """Run a worker subprocess to completion, restarting on crash/hang.

    launch(attempt, last) -> spec dict or None:
        called before every (re)launch with the attempt index and the
        previous :class:`WorkerReport` (None on the first). Returns
        ``{"argv": [...], "env": {...}, "cwd": ..., "stdout": path,
        "world_size": n}`` — only ``argv`` is required — or None to
        stop supervising (the job is done or cannot continue). This is
        where elasticity lives: pick the world size / device count /
        fault-plan env per attempt.
    policy: the shared backoff policy (default: 0.2 s base, x2, capped
        at 5 s, jittered) applied between consecutive failures; reset
        whenever an attempt makes forward progress, so a long-lived
        worker's eventual crash restarts fast.
    watchdog_s: hang detector — SIGKILL the worker when the heartbeat
        file does not change for this long (None disables).
    boot_grace_s: hang budget BEFORE the first heartbeat — backend
        init + first-step compile legitimately take far longer than a
        steady-state step, so the watchdog only tightens to
        ``watchdog_s`` once the worker has heartbeat at least once.
    max_restarts: consecutive failures WITHOUT forward progress before
        :class:`SupervisorGaveUp` (progress resets the budget — a fleet
        that advances, however slowly, is not a crash loop).
    """

    def __init__(self, launch: Callable[[int, Optional[WorkerReport]],
                                        Optional[dict]],
                 policy: Optional[RetryPolicy] = None,
                 watchdog_s: Optional[float] = 60.0,
                 boot_grace_s: float = 300.0,
                 poll_s: float = 0.05,
                 max_restarts: int = 8,
                 heartbeat_dir: Optional[str] = None,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        self.launch = launch
        self.policy = policy or RetryPolicy(
            max_attempts=max_restarts + 1, base_delay_s=0.2,
            max_delay_s=5.0, multiplier=2.0, jitter=0.25)
        self.watchdog_s = watchdog_s
        self.boot_grace_s = float(boot_grace_s)
        self.poll_s = float(poll_s)
        self.max_restarts = int(max_restarts)
        self.heartbeat_dir = heartbeat_dir
        self.on_event = on_event
        self.attempts: List[WorkerReport] = []

    # ------------------------------------------------------------------
    def _event(self, kind: str, **info) -> None:
        if self.on_event is not None:
            try:
                self.on_event(kind, info)
            except Exception:
                pass

    def _spawn(self, spec: dict, hb_path: str,
               record_dir: Optional[str] = None):
        env = dict(os.environ)
        env.update(spec.get("env") or {})
        env[HEARTBEAT_ENV] = hb_path
        # structured-trace inheritance across the process boundary (the
        # PDTPU_FAULT_PLAN env mold): a restarted worker's spans join
        # the supervisor's trace. Only injected while tracing is on —
        # default-off byte-identity of the worker env otherwise.
        from ..obs import record as obs_record
        from ..obs import trace as obs_trace

        if obs_trace.enabled() and obs_trace.ENV_VAR not in env:
            env[obs_trace.ENV_VAR] = obs_trace.env_value()
        # flight-recorder collection (same mold): each attempt gets its
        # own bundle dir; the worker auto-enables its recorder from the
        # env and the supervisor collects the newest valid bundle when
        # the attempt dies. Only injected while the parent records, and
        # only the SPEC's explicit value wins — the parent's own
        # ambient PDTPU_RECORD_DIR (how this process may itself have
        # been enabled) must not leak in, or every worker would dump
        # into the parent's dir and per-attempt collection would die
        if record_dir and obs_record.ENV_VAR not in (
                spec.get("env") or {}):
            env[obs_record.ENV_VAR] = record_dir
        stdout = spec.get("stdout")
        out = open(stdout, "ab") if isinstance(stdout, str) else None
        try:
            # a session (and process group) of its own: the attempt's
            # end kills the launcher's ranks with it
            proc = subprocess.Popen(
                spec["argv"], env=env, cwd=spec.get("cwd"),
                stdout=out if out is not None else None,
                stderr=subprocess.STDOUT if out is not None else None,
                start_new_session=True)
        finally:
            if out is not None:
                out.close()  # the child holds its own fd now
        return proc

    def run(self) -> dict:
        """Supervise until an attempt exits 0 (or ``launch`` returns
        None). Returns the summary report; raises
        :class:`SupervisorGaveUp` on an unproductive crash loop."""
        hb_dir = self.heartbeat_dir or tempfile.mkdtemp(
            prefix="pdtpu_supervisor_")
        os.makedirs(hb_dir, exist_ok=True)
        consecutive_failures = 0
        best_step = -1
        last: Optional[WorkerReport] = None
        pending_recovery: Optional[RecordEvent] = None
        recovery_t0: Optional[float] = None
        attempt = 0
        success = False
        while True:
            spec = self.launch(attempt, last)
            if spec is None:
                break
            report = WorkerReport(attempt)
            report.world_size = spec.get("world_size")
            hb_path = os.path.join(hb_dir, "hb_%d.json" % attempt)
            try:
                os.unlink(hb_path)
            except OSError:
                pass
            from ..obs import record as obs_record

            rec = obs_record.recorder()
            record_dir = (rec.child_dir("attempt_%d" % attempt)
                          if rec is not None else None)
            self._event("launch", attempt=attempt,
                        world_size=report.world_size)
            t_start = time.monotonic()
            with RecordEvent("resilience/supervisor.attempt"):
                try:
                    proc = self._spawn(spec, hb_path, record_dir)
                except OSError as e:
                    report.reason = "spawn"
                    report.returncode = -1
                    self._event("spawn_error", attempt=attempt,
                                error=repr(e))
                    proc = None
                hung = False
                last_raw = None
                last_change = time.monotonic()
                try:
                    while proc is not None and proc.poll() is None:
                        time.sleep(self.poll_s)
                        try:
                            with open(hb_path) as f:
                                raw = f.read()
                        except OSError:
                            raw = None
                        if raw and raw != last_raw:
                            last_raw = raw
                            last_change = time.monotonic()
                            if pending_recovery is not None:
                                # first sign of life of the replacement
                                # worker closes the recovery interval
                                pending_recovery.__exit__(None, None, None)
                                pending_recovery = None
                                report.recovery_s = (time.monotonic()
                                                     - recovery_t0)
                                self._event("recovered", attempt=attempt,
                                            recovery_s=report.recovery_s)
                        budget = (self.watchdog_s if last_raw is not None
                                  else max(self.watchdog_s or 0.0,
                                           self.boot_grace_s))
                        if (self.watchdog_s is not None
                                and time.monotonic() - last_change
                                > budget):
                            hung = True
                            self._event("hang", attempt=attempt,
                                        watchdog_s=self.watchdog_s)
                            _kill_group(proc)
                            proc.wait()
                            break
                except BaseException:
                    # the supervisor itself is stopping (an interrupt):
                    # its worker does not outlive it
                    _kill_group(proc)
                    raise
                if proc is not None:
                    report.returncode = proc.wait()
                    # whatever the launcher left behind dies with it
                    _kill_group(proc)
            report.duration_s = time.monotonic() - t_start
            hb = read_heartbeat(hb_path)
            if hb is not None:
                report.steps = hb.get("step")
                report.resumed_from = hb.get("resumed_from")
            if proc is not None:
                if hung:
                    report.reason = "hang"
                elif report.returncode == 0:
                    report.reason = "done"
                else:
                    report.reason = "crash"
            if record_dir is not None:
                # collect the dead (or finished) worker's black box:
                # SIGKILLed attempts leave their last rolling flush,
                # crashing ones their exception/alert dumps — the
                # newest VALID bundle is the post-mortem of record
                report.bundle = obs_record.latest_bundle(record_dir)
                if report.bundle is not None:
                    self._event("bundle", attempt=attempt,
                                bundle=report.bundle,
                                reason=report.reason)
            self.attempts.append(report)
            last = report
            if report.reason == "done":
                success = True
                break
            self._event(report.reason, attempt=attempt,
                        returncode=report.returncode, steps=report.steps)
            # forward progress resets the restart budget AND the backoff
            if report.steps is not None and report.steps > best_step:
                best_step = report.steps
                consecutive_failures = 1
                self.policy.reset()
            else:
                consecutive_failures += 1
            if consecutive_failures > self.max_restarts:
                if pending_recovery is not None:
                    pending_recovery.__exit__(None, None, None)
                raise SupervisorGaveUp(
                    "%d consecutive unproductive attempts (last: %s rc=%s)"
                    % (consecutive_failures, report.reason,
                       report.returncode), self.report(success=False))
            # open the recovery interval: death detection -> the next
            # worker's first heartbeat (span-measured).
            # If one is already open (the replacement died before ever
            # heartbeating), KEEP it — the system has been unrecovered
            # since the ORIGINAL death, and restarting the clock would
            # under-report exactly the crash-loop case
            if pending_recovery is None:
                recovery_t0 = time.monotonic()
                pending_recovery = RecordEvent(
                    "resilience/supervisor.recovery")
                pending_recovery.__enter__()
            delay = self.policy.delay_s(consecutive_failures - 1)
            if delay > 0:
                with RecordEvent("resilience/supervisor.backoff"):
                    time.sleep(delay)
            attempt += 1
        if pending_recovery is not None:
            pending_recovery.__exit__(None, None, None)
        return self.report(success=success)

    # ------------------------------------------------------------------
    def report(self, success: bool) -> dict:
        restarts = max(0, len(self.attempts) - 1)
        recoveries = [a.recovery_s for a in self.attempts
                      if a.recovery_s is not None]
        steps_lost: List[int] = []
        for prev, nxt in zip(self.attempts, self.attempts[1:]):
            if prev.steps is not None and nxt.resumed_from is not None:
                steps_lost.append(max(0, prev.steps - nxt.resumed_from))
        return {
            "success": success,
            "restarts": restarts,
            "hangs": sum(1 for a in self.attempts if a.reason == "hang"),
            "crashes": sum(1 for a in self.attempts
                           if a.reason == "crash"),
            "recoveries_s": recoveries,
            "steps_lost": steps_lost,
            "bundles": [a.bundle for a in self.attempts
                        if a.bundle is not None],
            "attempts": [a.to_dict() for a in self.attempts],
        }


def supervise(launch, **kw) -> Dict:
    """One-call convenience: ``Supervisor(launch, **kw).run()``."""
    return Supervisor(launch, **kw).run()


def worker_argv(script: str, *args) -> List[str]:
    """argv for a Python worker script run with THIS interpreter."""
    return [sys.executable, script] + [str(a) for a in args]
