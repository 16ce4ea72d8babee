"""Prefix-affinity fleet router (counterpart of
paddle_tpu/fleet/router.py).

One router fronts N replica handles (:class:`~paddle_tpu_torch.fleet
.LocalReplica` in-process, :class:`~paddle_tpu_torch.fleet.RemoteReplica`
across processes) and owns four decisions per request:

* **affinity** — the routing key is the prefix cache's content-hash
  chain: the router hashes each prompt's cacheable span with
  the SAME ``KVCacheManager.prefix_keys`` the replicas use and
  remembers which replica it last sent each key to, so repeat prefixes
  land on the warm replica (longest recorded chain wins; measured as
  ``prefill_tokens_avoided_total`` ticking on that replica).
* **spillover** — each replica's ``health()["pressure"]`` (queue
  depth, KV-pool occupancy and ladder stage folded to one 0–1 score) is polled by a monitor thread; an
  affinity-preferred replica above ``FleetConfig.spill_pressure``
  loses the request to the least-pressure live replica — warm cache
  never beats an overload ladder.
* **disaggregated prefill** — on an affinity MISS with a cacheable
  span, the router first asks a prefill-role replica to warm the
  migration store (``prefill`` op), so the decode replica's admission
  restores the span instead of recomputing it (fleet/migrate.py).
* **resume** — a stream interrupted by a replica death (in-process
  kill, SIGKILLed worker, cut connection) resurfaces as
  ``GenerationInterruptedError(tokens=partial)``; the router resubmits
  to a survivor with ``resume_tokens=partial``, and the session's
  resume contract (original-prompt coordinate frame + positional
  fold_in sampling keys + migrated-or-republished prefix blocks) makes
  the continued stream BIT-IDENTICAL, with no token re-streamed.

Typed overload stays typed fleet-wide: when every live decode replica
sheds (queue full, breaker open, ladder stage 4), the router raises
ONE :class:`~paddle_tpu_torch.serving.OverloadedError` whose
``retry_after_s`` is the max hint across replicas. The
``fleet.route`` fault point fires per routing decision (payload = the
chosen replica name): corrupt reroutes to the least-loaded live
replica, raise surfaces the typed overload path. Dead replicas'
flight-recorder bundles are collected Supervisor-style from their
handshake/``record_dir``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

from ..core.enforce import enforce
from ..decoding.cache import CacheConfig, KVCacheManager
from ..profiler import RecordEvent
from ..resilience import faults
from ..resilience.faults import InjectedFault
from ..serving.errors import (FatalServingError, OverloadedError,
                              RetriableServingError, ServerClosedError)
from .metrics import FleetMetrics
from .worker import _sampling_to_wire


class FleetConfig:
    """Router knobs.

    cache: the fleet's shared :class:`CacheConfig` — the router hashes
        routing keys with it, so it must match the replicas' geometry
        (chain keys digest the config, so a mismatch simply never
        matches — affinity lost, correctness kept). ``None`` or
        ``prefix_cache=False`` disables affinity (pure least-pressure
        routing).
    spill_pressure: pressure at/above which an affinity pick spills to
        the least-pressure live replica.
    health_interval_s: monitor poll cadence.
    max_attempts: replica attempts per request (routing + resume
        retries) before the last typed error surfaces.
    prefill_delegation: warm the migration store through a
        prefill-role replica on affinity misses.
    request_timeout_s: per-attempt wait on a replica future.
    policy: ``"affinity"`` (default — prefix-affinity scoring with
        pressure spillover) or ``"round_robin"`` (rotate over live
        decode replicas, ignoring warmth: the baseline that measures
        what affinity buys in fleet prefix hit rate).
    """

    POLICIES = ("affinity", "round_robin")

    def __init__(self, cache: Optional[CacheConfig] = None,
                 spill_pressure: float = 0.85,
                 health_interval_s: float = 0.25,
                 max_attempts: int = 4,
                 prefill_delegation: bool = True,
                 request_timeout_s: float = 600.0,
                 policy: str = "affinity"):
        enforce(policy in self.POLICIES,
                "FleetConfig.policy must be one of %s, got %r"
                % (self.POLICIES, policy))
        self.cache = cache
        self.spill_pressure = float(spill_pressure)
        self.health_interval_s = max(0.02, float(health_interval_s))
        self.max_attempts = max(1, int(max_attempts))
        self.prefill_delegation = bool(prefill_delegation)
        self.request_timeout_s = float(request_timeout_s)
        self.policy = str(policy)


class Router:
    """Schedule generations across replica handles (see module
    docstring). Thread-safe: submits may come from many client
    threads; each request runs on its own lightweight driver thread so
    a resume never blocks another stream."""

    def __init__(self, replicas: Sequence, config: Optional[FleetConfig]
                 = None, metrics: Optional[FleetMetrics] = None,
                 name: str = "fleet0"):
        self.name = str(name)
        self.config = config or FleetConfig()
        self.metrics = metrics or FleetMetrics(self.name)
        self.replicas: Dict[str, object] = {r.name: r for r in replicas}
        self._decode = [r for r in replicas
                        if getattr(r, "role", "decode") == "decode"]
        self._prefill = [r for r in replicas
                         if getattr(r, "role", "") == "prefill"]
        cache = self.config.cache
        self._hash = (KVCacheManager(cache)
                      if cache is not None and cache.prefix_cache
                      else None)
        self._affinity: Dict[str, str] = {}  # chain key -> replica name
        self._rr = 0  # round_robin policy rotation cursor
        self._health: Dict[str, Optional[dict]] = {}
        self._dead: set = set()
        self.bundles: Dict[str, Optional[str]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poll_once()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="pdtpu-fleet-monitor",
                                         daemon=True)
        self._monitor.start()

    # ------------------------------------------------------- monitoring
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            self._poll_once()

    def _poll_once(self) -> None:
        live = 0
        stage = 0
        for name, r in self.replicas.items():
            h = None
            try:
                h = r.health()
            except Exception:
                h = None
            with self._lock:
                was_live = name not in self._dead
                self._health[name] = h
            if h is None:
                if was_live:
                    self._on_death(name, r)
                continue
            live += 1
            stage = max(stage, int(h.get("degradation_stage") or 0))
        self.metrics.set_live(live)
        self.metrics.set_stage(stage)

    def _on_death(self, name: str, replica) -> None:
        """Supervisor-style post-mortem: mark dead, collect the
        replica's newest valid flight-recorder bundle."""
        with self._lock:
            if name in self._dead:
                return
            self._dead.add(name)
        self.metrics.inc("replica_deaths")
        record_dir = getattr(replica, "record_dir", None)
        bundle = None
        if record_dir:
            try:
                from ..obs import record as obs_record

                bundle = obs_record.latest_bundle(record_dir)
            except Exception:
                bundle = None
        self.bundles[name] = bundle
        if bundle:
            self.metrics.inc("bundles_collected")

    def _is_dead(self, replica) -> bool:
        return getattr(replica, "dead", False) \
            or replica.name in self._dead

    def _pressure(self, replica) -> float:
        h = self._health.get(replica.name)
        if not h:
            return 0.0
        try:
            return float(h.get("pressure") or 0.0)
        except (TypeError, ValueError):
            return 0.0

    # ---------------------------------------------------------- routing
    def _keys_for(self, prompt: Sequence[int]) -> List[str]:
        if self._hash is None:
            return []
        return self._hash.prefix_keys([int(t) for t in prompt])

    def _warm_depth(self, keys: List[str], name: str) -> int:
        depth = 0
        for key in keys:
            if self._affinity.get(key) != name:
                break
            depth += 1
        return depth

    def _route(self, keys: List[str], exclude: set):
        """One routing decision; returns (replica, affinity_depth).
        Raises OverloadedError when no live decode replica remains."""
        with self._lock:
            live = [r for r in self._decode
                    if not self._is_dead(r) and r.name not in exclude]
            if not live:
                raise OverloadedError(
                    "no live decode replica can take this request",
                    retry_after_s=1.0)
            if self.config.policy == "round_robin":
                # warmth-blind rotation: depth still reports whether
                # the pick HAPPENED to be warm, so the hit-rate
                # comparison against affinity routing is like for like
                chosen = live[self._rr % len(live)]
                self._rr += 1
                depth = self._warm_depth(keys, chosen.name)
            else:
                scored = [(self._warm_depth(keys, r.name), r)
                          for r in live]
                depth, chosen = max(
                    scored,
                    key=lambda dr: (dr[0], -self._pressure(dr[1])))
                if depth > 0 \
                        and self._pressure(chosen) \
                        >= self.config.spill_pressure:
                    coldest = min(live, key=self._pressure)
                    if coldest is not chosen:
                        chosen = coldest
                        depth = 0
                        self.metrics.inc("spillovers")
            try:
                out = faults.fire("fleet.route", chosen.name.encode())
            except InjectedFault:
                self.metrics.inc("route_overloaded")
                raise OverloadedError(
                    "fleet routing shed this request (injected)",
                    retry_after_s=0.5) from None
            if out != chosen.name.encode():
                # corrupted routing decision: fall back to the least-
                # loaded live replica (deterministic, always valid)
                chosen = min(live, key=self._pressure)
                depth = self._warm_depth(keys, chosen.name)
            for key in keys:
                self._affinity[key] = chosen.name
        self.metrics.inc("affinity_hits" if depth > 0
                         else "affinity_misses")
        self.metrics.routed(chosen.name)
        return chosen, depth

    def _delegate_prefill(self, prompt: List[int]) -> None:
        with self._lock:
            warmers = [r for r in self._prefill if not self._is_dead(r)]
        for r in warmers:
            out = None
            try:
                out = r.prefill(prompt)
            except Exception:
                out = None
            if out is not None:
                self.metrics.inc("prefills_delegated")
                return

    # --------------------------------------------------------- requests
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               on_token: Optional[Callable[[int], None]] = None,
               sampling=None, priority: Optional[int] = None) -> Future:
        """Route one generation across the fleet; returns a Future
        resolving to the FULL generated token list (resumed spans
        included — the same value a single replica's future resolves
        to). Fatal errors surface as-is; fleet-wide overload raises
        one typed OverloadedError with the max Retry-After hint."""
        prompt = [int(t) for t in prompt]
        payload = {"prompt": prompt, "max_new_tokens": max_new_tokens,
                   "eos_id": eos_id, "deadline_ms": deadline_ms,
                   "sampling": _sampling_to_wire(sampling),
                   "priority": priority}
        keys = self._keys_for(prompt)
        self.metrics.inc("requests")
        outer: Future = Future()
        threading.Thread(
            target=self._drive, name="pdtpu-fleet-request",
            args=(outer, payload, keys, on_token), daemon=True).start()
        return outer

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None, **kw) -> List[int]:
        return self.submit(prompt, max_new_tokens,
                           **kw).result(timeout=timeout)

    def _drive(self, outer: Future, payload: dict, keys: List[str],
               on_token) -> None:
        streamed: List[int] = []
        overload_hints: List[float] = []
        last_exc: Optional[BaseException] = None
        delegated = False
        exclude: set = set()

        def tee(tok: int) -> None:
            streamed.append(int(tok))
            if on_token is not None:
                try:
                    on_token(int(tok))
                except Exception:
                    pass

        for attempt in range(self.config.max_attempts):
            try:
                with RecordEvent("fleet/route"):
                    replica, depth = self._route(keys, exclude)
            except OverloadedError as e:
                if e.retry_after_s:
                    overload_hints.append(float(e.retry_after_s))
                last_exc = e
                break
            if depth == 0 and keys and not delegated \
                    and not streamed \
                    and self.config.prefill_delegation and self._prefill:
                self._delegate_prefill(payload["prompt"])
                delegated = True
            attempt_payload = dict(payload)
            if streamed:
                attempt_payload["resume_tokens"] = list(streamed)
            try:
                fut = replica.submit(attempt_payload, on_token=tee)
                tokens = fut.result(
                    timeout=self.config.request_timeout_s)
            except (ServerClosedError, ConnectionError, OSError):
                # the replica is gone: poll now (collect its bundle),
                # exclude it, resume whatever streamed on a survivor
                if hasattr(replica, "kill"):
                    replica.kill()
                self._poll_once()
                exclude.add(replica.name)
                if streamed:
                    self.metrics.inc("resumes")
                self.metrics.inc("retries")
                continue
            except RetriableServingError as e:
                last_exc = e
                if isinstance(e, OverloadedError) and e.retry_after_s:
                    overload_hints.append(float(e.retry_after_s))
                interrupted = getattr(e, "tokens", None)
                if interrupted is not None \
                        and len(interrupted) >= len(streamed):
                    streamed[:] = [int(t) for t in interrupted]
                if self._is_dead(replica) or interrupted is not None:
                    # death/interruption: resume on a survivor
                    self._poll_once()
                    exclude.add(replica.name)
                    if streamed:
                        self.metrics.inc("resumes")
                else:
                    # plain shed (queue full / breaker / ladder):
                    # spread to the next-least-loaded replica
                    exclude.add(replica.name)
                self.metrics.inc("retries")
                continue
            except FatalServingError as e:
                outer.set_exception(e)
                return
            except Exception as e:  # defensive: never hang the future
                outer.set_exception(e)
                return
            outer.set_result([int(t) for t in tokens])
            return
        if overload_hints or isinstance(last_exc, OverloadedError) \
                or last_exc is None:
            outer.set_exception(OverloadedError(
                "fleet overloaded: %d attempt(s) exhausted across "
                "replicas" % self.config.max_attempts,
                retry_after_s=(max(overload_hints)
                               if overload_hints else 1.0)))
        else:
            outer.set_exception(last_exc)

    # ----------------------------------------------------------- status
    def health(self) -> dict:
        """Fleet-level snapshot: per-replica health (None = dead), the
        live count, the max stage/pressure, and collected post-mortem
        bundles."""
        with self._lock:
            snap = {n: (dict(h) if h else None)
                    for n, h in self._health.items()}
        live = [h for h in snap.values() if h]
        return {
            "status": "serving" if live else "down",
            "replicas": snap,
            "live": len(live),
            "degradation_stage": max(
                [int(h.get("degradation_stage") or 0)
                 for h in live] or [0]),
            "pressure": max([float(h.get("pressure") or 0.0)
                             for h in live] or [0.0]),
            "bundles": dict(self.bundles),
            "fleet": self.metrics.report(),
        }

    def detach(self) -> None:
        """Stop this router's monitor WITHOUT draining the replicas —
        they stay live for another router (e.g. a policy A/B over one
        fleet). The replicas' owner still has to drain them
        eventually."""
        self._stop.set()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Gracefully drain every live replica, then stop the
        monitor."""
        self._stop.set()
        for r in self.replicas.values():
            if not self._is_dead(r):
                try:
                    r.drain(timeout=timeout)
                except Exception:
                    pass

    def close(self) -> None:
        self.drain()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
