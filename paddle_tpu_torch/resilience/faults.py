"""Deterministic fault-injection plane (counterpart of
paddle_tpu/resilience/faults.py; same sites, same plans, same
schedules).

The code paths that have failure semantics call :func:`fire` with their
site name (checkpoint publish, trainer step, DataLoader worker, the
serving and decoding steps, admission, prefix commits). A seeded
:class:`FaultPlan` of :class:`FaultRule` entries maps sites to injected
**crashes** (SIGKILL or a raised :class:`InjectedFault`), **delays** and
**payload corruption** on a reproducible schedule: explicit hit
indices, or per-rule seeded probability draws — same seed, same
schedule, every run, and the same schedule as the JAX package's for the
same plan and hit counts (the draws are Python's ``random.Random``
seeded by the same strings).

Activation: :func:`install_plan`, the ``fault_plan`` flag, or the
``PDTPU_FAULT_PLAN`` env var (inline JSON or a file path) — the env
route is how a subprocess inherits a plan.

Default off is byte-identical: with no plan installed, :func:`fire` is
one ``None`` check and returns its payload untouched. Faults are a
RUNTIME plane: they never rewrite programs. The sites fire on the host,
before a launch or a graph replay, never inside a captured region.

Every injection that fires is logged (:func:`injection_log`), counted
(:func:`injections`), and recorded as a ``resilience/fault.<site>``
profiler span.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from ..profiler import RecordEvent

ENV_VAR = "PDTPU_FAULT_PLAN"
KINDS = ("raise", "crash", "delay", "corrupt")

# The canonical fault-point registry: the JAX package's whole table, so
# a plan written for either package names the same sites (the port
# fires those its ported modules have; the fleet and store sites wait
# for their modules). Plans naming unknown sites get a loud warning
# (not an error — register_fault_point registrations are legitimate).
FAULT_POINTS: Dict[str, str] = {
    "parallel.init_distributed":
        "coordinator connect in parallel.env.init_distributed — "
        "exercises the bounded-timeout/retry path (DistributedInitError)",
    "trainer.step":
        "one training step dispatch (Trainer._run_step and supervised "
        "workers) — crash/hang here exercises supervisor restart + "
        "ckpt newest-valid restore",
    "reader.worker":
        "one item produced by the DataLoader's background worker "
        "(reader.prefetch.overlap_iter) — raise surfaces through the "
        "loader's error path, delay simulates a stalled input pipeline",
    "ckpt.publish":
        "a checkpoint serial/process-file publish (ckpt.saver) — delay "
        "widens the crash window, crash orphans a temp dir for the "
        "sweep to reclaim",
    "ckpt.payload":
        "a checkpoint payload file AFTER its digest is recorded — "
        "corrupt makes that serial invalid so restore must fall back "
        "to the newest valid one",
    "compile_cache.get":
        "a compile-cache store read (payload = entry dir) — corrupt "
        "exercises evict-and-recompile, delay a slow shared store",
    "tuning.get":
        "a tuning-store read (payload = entry dir) — corrupt exercises "
        "evict-and-resweep/fall-back-to-defaults",
    "serving.step":
        "one BucketedEngine batch execution — raise exercises the "
        "batcher's poison isolation and the server's circuit breaker",
    "decoding.prefill":
        "one prefill execution — raise exercises per-sequence "
        "re-prefill isolation",
    "decoding.step":
        "one decode-step execution — raise exercises the continuous "
        "batcher's re-step-through-retry-policy recovery",
    "decoding.draft_step":
        "one DRAFT-engine execution under speculative decoding "
        "(draft prefill or one draft decode step) — raise exercises "
        "the typed DraftEngineError permanent fallback to plain "
        "decode (streams stay bit-identical)",
    "decoding.verify_step":
        "one multi-token speculative verify step on the target — "
        "raise exercises the batcher's plain-decode isolation path "
        "for the round",
    "decoding.prefix_commit":
        "one prefix-cache publish (payload = the chain keys) — "
        "corrupt/raise degrade to publishing NOTHING (the blocks stay "
        "private, correctness preserved, sharing lost)",
    "serving.admission":
        "one decode-tier admission attempt (ContinuousBatcher) — "
        "raise leaves the request queued for the next worker poll "
        "(recoverable), delay simulates a slow admission path",
    "fleet.route":
        "one fleet routing decision (payload = the chosen replica "
        "name) — corrupt reroutes to the least-loaded live replica, "
        "raise surfaces the router's typed OverloadedError path, "
        "delay simulates a slow control plane",
    "fleet.migrate":
        "one KV-block migration fetch (payload = the entry path) — "
        "corrupt/raise degrade to re-prefilling the span locally "
        "(correctness preserved, migration benefit lost)",
    "fleet.replica_death":
        "one replica liveness window — crash SIGKILLs the replica "
        "process (subprocess workers), raise kills an in-process "
        "replica; either way the router resumes its in-flight "
        "streams on a survivor",
}


def register_fault_point(name: str, description: str) -> None:
    """Register an additional site (idempotent; first writer wins so a
    re-import cannot clobber a description tests already read)."""
    FAULT_POINTS.setdefault(str(name), str(description))


class InjectedFault(RuntimeError):
    """An error raised by the fault plane itself (kind="raise").

    Deliberately a plain RuntimeError subclass: injection must travel
    the SAME except-clauses real failures travel, never a special case.
    """

    def __init__(self, site: str, rule: int, hit: int):
        super().__init__(
            "injected fault at %r (rule %d, hit %d)" % (site, rule, hit))
        self.site = site
        self.rule = rule
        self.hit = hit


class FaultRule:
    """One scheduled injection at one site.

    site: a :data:`FAULT_POINTS` name.
    kind: "raise" | "crash" | "delay" | "corrupt".
    hits: explicit 0-based invocation indices of the site that fire
        (deterministic schedule); mutually exclusive with ``prob``.
    prob: per-invocation fire probability, drawn from a per-rule RNG
        seeded by (plan seed, site, rule index) — the draw happens on
        EVERY invocation so the schedule is identical run to run even
        after ``count`` exhausts.
    count: cap on total fires (default: len(hits) for hit rules,
        unbounded for prob rules).
    delay_ms: sleep length for kind="delay".
    """

    def __init__(self, site: str, kind: str,
                 hits: Optional[List[int]] = None,
                 prob: Optional[float] = None,
                 count: Optional[int] = None,
                 delay_ms: float = 50.0):
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, ", ".join(KINDS)))
        if (hits is None) == (prob is None):
            raise ValueError(
                "rule for %r needs exactly one of hits= or prob=" % site)
        self.site = str(site)
        self.kind = kind
        self.hits = None if hits is None else sorted(int(h) for h in hits)
        self.prob = None if prob is None else float(prob)
        self.count = (len(self.hits) if count is None and hits is not None
                      else count)
        self.delay_ms = float(delay_ms)

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"site": self.site, "kind": self.kind}
        if self.hits is not None:
            d["hits"] = list(self.hits)
        if self.prob is not None:
            d["prob"] = self.prob
        if self.count is not None:
            d["count"] = self.count
        if self.kind == "delay":
            d["delay_ms"] = self.delay_ms
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        return cls(d["site"], d["kind"], hits=d.get("hits"),
                   prob=d.get("prob"), count=d.get("count"),
                   delay_ms=d.get("delay_ms", 50.0))


class FaultPlan:
    """A seeded, serializable schedule of fault rules.

    The plan is pure data; running state (per-site counters, per-rule
    RNGs and fire counts, the injection log) lives in the module's
    installed-plan state so the SAME plan object can be installed twice
    and reproduce the identical schedule.
    """

    def __init__(self, seed: int = 0,
                 faults: Optional[List[FaultRule]] = None):
        self.seed = int(seed)
        self.faults = list(faults or [])
        unknown = sorted({r.site for r in self.faults}
                         - set(FAULT_POINTS))
        if unknown:
            import warnings

            warnings.warn("fault plan names unregistered sites: %s "
                          "(registered: %s)"
                          % (unknown, sorted(FAULT_POINTS)))

    def rule(self, site: str, kind: str, **kw) -> "FaultPlan":
        """Builder convenience: append a rule, return self."""
        self.faults.append(FaultRule(site, kind, **kw))
        return self

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "faults": [r.to_dict() for r in self.faults]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(d.get("seed", 0),
                   [FaultRule.from_dict(r) for r in d.get("faults", [])])

    def schedule(self, counts: Dict[str, int]) -> List[dict]:
        """Pure simulation: the injection log that WOULD be produced by
        ``counts[site]`` invocations of each site (no sleeping, no
        raising, no corruption). The determinism witness: a live run's
        :func:`injection_log` equals ``schedule`` of its hit counts."""
        state = _PlanState(self, dry=True)
        for site in sorted(counts):
            for _ in range(int(counts[site])):
                state.fire(site, None)
        return state.log


class _PlanState:
    """Running state of one installed plan."""

    def __init__(self, plan: FaultPlan, dry: bool = False):
        self.plan = plan
        self.dry = dry
        self.counters: Dict[str, int] = {}
        self.fired: Dict[int, int] = {}  # rule index -> fires
        self.log: List[dict] = []
        # sites fire from many threads (serving worker, reader
        # prefetch, clients): the counter/RNG/log read-modify-writes
        # must be atomic or the same-seed-same-schedule contract breaks
        self._lock = threading.RLock()
        # per-rule RNG: seeded from (plan seed, site, rule index) so a
        # rule's draw sequence is independent of every other rule's and
        # of how sites interleave
        self._rngs = [random.Random("%d:%s:%d"
                                    % (plan.seed, r.site, i))
                      for i, r in enumerate(plan.faults)]
        self._by_site: Dict[str, List[int]] = {}
        for i, r in enumerate(plan.faults):
            self._by_site.setdefault(r.site, []).append(i)

    def fire(self, site: str, payload):
        # matching + bookkeeping under the lock (atomic counters, RNG
        # draws, log); the ACTIONS run outside it — an injected delay
        # or raise must not serialize every other thread's fire()
        matched: List[tuple] = []  # (rule index, hit)
        with self._lock:
            hit = self.counters.get(site, 0)
            self.counters[site] = hit + 1
            for ri in self._by_site.get(site, ()):
                rule = self.plan.faults[ri]
                if rule.hits is not None:
                    match = hit in rule.hits
                else:
                    # draw EVERY invocation (determinism survives
                    # count caps)
                    match = self._rngs[ri].random() < rule.prob
                if not match:
                    continue
                if rule.count is not None and \
                        self.fired.get(ri, 0) >= rule.count:
                    continue
                self.fired[ri] = self.fired.get(ri, 0) + 1
                self.log.append({"site": site, "kind": rule.kind,
                                 "hit": hit, "rule": ri})
                matched.append((ri, hit))
        if self.dry:
            return payload
        for ri, hit in matched:
            rule = self.plan.faults[ri]
            with RecordEvent("resilience/fault." + site):
                if rule.kind == "delay":
                    time.sleep(rule.delay_ms / 1e3)
                elif rule.kind == "corrupt":
                    # corruption draws from the rule RNG: back under
                    # the lock so concurrent corrupts stay sequenced
                    with self._lock:
                        payload = _corrupt(payload, self._rngs[ri])
                elif rule.kind == "raise":
                    raise InjectedFault(site, ri, hit)
                elif rule.kind == "crash":
                    # an abrupt preemption: no cleanup, no atexit —
                    # the cluster reclaiming the host
                    os.kill(os.getpid(), signal.SIGKILL)
        return payload


def _corrupt(payload, rng: random.Random):
    """Corrupt a payload in a type-appropriate, seeded way.

    * ``bytes``/``bytearray`` — returns a copy with one byte flipped;
    * a path to a file — flips one byte of the file IN PLACE (so
      integrity digests recorded beforehand no longer verify);
    * a path to a directory — corrupts one deterministic regular file
      inside it (sorted walk);
    * numpy arrays — returns a copy with one element perturbed;
    * ``None``/anything else — returned untouched (the site carries no
      corruptible payload).
    """
    if payload is None:
        return payload
    if isinstance(payload, (bytes, bytearray)):
        if not payload:
            return payload
        data = bytearray(payload)
        i = rng.randrange(len(data))
        data[i] ^= 0xFF
        return bytes(data)
    if isinstance(payload, str) and os.path.isdir(payload):
        files = sorted(
            os.path.join(dp, f)
            for dp, _dn, fn in os.walk(payload) for f in fn)
        files = [f for f in files if os.path.getsize(f) > 0]
        if not files:
            return payload
        _corrupt_file(files[rng.randrange(len(files))], rng)
        return payload
    if isinstance(payload, str) and os.path.isfile(payload):
        _corrupt_file(payload, rng)
        return payload
    try:
        import numpy as np

        if isinstance(payload, np.ndarray) and payload.size:
            out = np.array(payload, copy=True)
            flat = out.reshape(-1)
            i = rng.randrange(flat.size)
            if out.dtype.kind == "f":
                flat[i] = np.inf
            else:
                flat[i] = flat[i] ^ -1 if out.dtype.kind == "i" else 0
            return out
    except Exception:
        pass
    return payload


def _corrupt_file(path: str, rng: random.Random) -> None:
    try:
        with open(path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if not size:
                return
            i = rng.randrange(size)
            f.seek(i)
            b = f.read(1)
            f.seek(i)
            f.write(bytes([b[0] ^ 0xFF]))
    except OSError:
        pass  # read-only payloads: the corruption simply doesn't land


# ---------------------------------------------------------------------------
# module state: the installed plan
# ---------------------------------------------------------------------------

_STATE: Optional[_PlanState] = None
_ENV_CHECKED = False


def load_plan(spec) -> FaultPlan:
    """Parse a plan from a FaultPlan, dict, inline-JSON string, or a
    path to a JSON file."""
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, dict):
        return FaultPlan.from_dict(spec)
    text = str(spec)
    if not text.lstrip().startswith("{"):
        with open(text) as f:
            text = f.read()
    return FaultPlan.from_dict(json.loads(text))


def install_plan(spec) -> FaultPlan:
    """Activate a plan in THIS process (fresh counters/log). Returns
    the parsed plan."""
    global _STATE, _ENV_CHECKED
    plan = load_plan(spec)
    _STATE = _PlanState(plan)
    _ENV_CHECKED = True  # explicit install wins over the env var
    return plan


def clear_plan() -> None:
    """Deactivate; :func:`fire` returns to the zero-cost default path
    (the env var is NOT re-read — cleared means cleared)."""
    global _STATE, _ENV_CHECKED
    _STATE = None
    _ENV_CHECKED = True


def active_plan() -> Optional[FaultPlan]:
    _maybe_load_env()
    return _STATE.plan if _STATE is not None else None


def plan_env(plan: FaultPlan) -> Dict[str, str]:
    """The env dict a launcher merges into a worker's environment
    so the subprocess inherits the plan (activated lazily at its first
    ``fire``)."""
    return {ENV_VAR: plan.to_json()}


def _maybe_load_env() -> None:
    global _STATE, _ENV_CHECKED
    if _ENV_CHECKED:
        return
    _ENV_CHECKED = True
    spec = os.environ.get(ENV_VAR)
    if not spec:
        try:
            from ..core import flags

            spec = flags.get_flag("fault_plan")
        except Exception:
            spec = None
    if spec:
        try:
            _STATE = _PlanState(load_plan(spec))
        except Exception as e:
            import warnings

            warnings.warn("ignoring unparseable fault plan: %s" % (e,))


def fire(site: str, payload=None):
    """The injection hook the registered code paths call.

    With no plan active this is one ``None`` check — the default-off
    byte-identical contract. With a plan, matching rules run in order:
    delays sleep, corruption transforms/overwrites the payload, raises
    raise :class:`InjectedFault`, crashes SIGKILL the process. Returns
    the (possibly corrupted) payload."""
    if _STATE is None:
        if _ENV_CHECKED:
            return payload
        _maybe_load_env()
        if _STATE is None:
            return payload
    return _STATE.fire(site, payload)


def injections() -> Dict[str, int]:
    """{"site:kind": fires} since the plan was installed."""
    if _STATE is None:
        return {}
    out: Dict[str, int] = {}
    for rec in injection_log():
        key = "%s:%s" % (rec["site"], rec["kind"])
        out[key] = out.get(key, 0) + 1
    return out


def injection_log() -> List[dict]:
    """Ordered log of every injection fired: [{site, kind, hit, rule}].
    Comparing this against :meth:`FaultPlan.schedule` of the observed
    hit counts is the reproducibility assertion."""
    if _STATE is None:
        return []
    with _STATE._lock:
        return list(_STATE.log)


def hit_counts() -> Dict[str, int]:
    """{site: invocations seen} — feed to :meth:`FaultPlan.schedule`."""
    if _STATE is None:
        return {}
    with _STATE._lock:
        return dict(_STATE.counters)
