"""Fleet observability: one scrape surface over N replicas
(counterpart of paddle_tpu/fleet/metrics.py; the same families, names
and exposition text).

Router-side counters live on the ordinary process registry
(:mod:`paddle_tpu_torch.obs.metrics`) under the ``pdtpu_fleet_*`` names:

* ``pdtpu_fleet_events_total{fleet,event}`` — control-plane events
  (requests, routed, affinity_hits, affinity_misses, spillovers,
  retries, resumes, replica_deaths, prefills_delegated,
  bundles_collected, route_overloaded);
* ``pdtpu_fleet_routed_total{fleet,replica}`` — per-replica routing
  decisions (the affinity skew is visible per replica);
* ``pdtpu_fleet_replicas_live{fleet}`` /
  ``pdtpu_fleet_degradation_stage{fleet}`` — liveness and the MAX
  ladder stage over live replicas (the router-level stage).

Aggregation reuses the exposition format as the wire: every replica
worker serves its own registry on an ephemeral ``/metrics`` port
(discovered via the handshake's ``metrics_port``, bound collision-free
by ``port=0``), and :func:`aggregate_scrape`
concatenates the router's local exposition with each replica's scrape
RELABELED with ``replica="<name>"`` — so one Prometheus target sees
the whole fleet with per-replica labels and zero push machinery.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..obs import metrics as obs_metrics

EVENTS = ("requests", "routed", "affinity_hits", "affinity_misses",
          "spillovers", "retries", "resumes", "replica_deaths",
          "prefills_delegated", "bundles_collected",
          "route_overloaded")


class FleetMetrics:
    """Router-side fleet counters on the process-wide registry, with a
    local mirror dict (``counts``) so reports/tests read plain ints
    without registry spelunking."""

    def __init__(self, fleet: str = "fleet0"):
        self.fleet = str(fleet)
        self.counts: Dict[str, int] = {e: 0 for e in EVENTS}
        self._events = obs_metrics.counter(
            "pdtpu_fleet_events_total",
            "fleet control-plane events by type",
            labels=("fleet", "event"))
        self._routed = obs_metrics.counter(
            "pdtpu_fleet_routed_total",
            "requests routed to each replica",
            labels=("fleet", "replica"))
        self._live = obs_metrics.gauge(
            "pdtpu_fleet_replicas_live",
            "replicas currently answering health probes",
            labels=("fleet",)).labels(fleet=self.fleet)
        self._stage = obs_metrics.gauge(
            "pdtpu_fleet_degradation_stage",
            "max degradation-ladder stage over live replicas",
            labels=("fleet",)).labels(fleet=self.fleet)

    def inc(self, event: str, n: int = 1) -> None:
        self.counts[event] = self.counts.get(event, 0) + n
        self._events.labels(fleet=self.fleet, event=event).inc(n)

    def routed(self, replica: str) -> None:
        self.inc("routed")
        self._routed.labels(fleet=self.fleet, replica=replica).inc()

    def set_live(self, n: int) -> None:
        self._live.set(int(n))

    def set_stage(self, stage: int) -> None:
        self._stage.set(int(stage))

    def report(self) -> Dict[str, int]:
        return dict(self.counts)


def relabel_exposition(text: str, replica: str) -> str:
    """Inject ``replica="<name>"`` into every sample line of a
    Prometheus text exposition (comments pass through untouched) — how
    one fleet scrape keeps N same-named registries apart."""
    esc = (replica.replace("\\", "\\\\").replace('"', '\\"')
           .replace("\n", "\\n"))
    inj = 'replica="%s"' % esc
    out: List[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        sp = line.find(" ")
        head = line if sp < 0 else line[:sp]
        br = head.find("{")
        if br >= 0:
            sep = "" if line[br + 1] == "}" else ","
            out.append(line[:br + 1] + inj + sep + line[br + 1:])
        elif sp < 0:
            out.append(line)  # not a sample line; pass through
        else:
            out.append(head + "{" + inj + "}" + line[sp:])
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def scrape_replica(handshake: dict,
                   timeout: float = 2.0) -> Optional[str]:
    """Fetch one replica worker's ``/metrics`` exposition (relabeled
    with its name) via the handshake's discovered ephemeral port;
    None when the replica is dead/unreachable (never raises)."""
    port = handshake.get("metrics_port")
    if not port:
        return None
    import urllib.request

    url = "http://%s:%d/metrics" % (handshake.get("host", "127.0.0.1"),
                                    int(port))
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            text = resp.read().decode("utf-8", "replace")
    except Exception:
        return None
    return relabel_exposition(text, handshake.get("name", "?"))


def aggregate_scrape(handshakes: Iterable[dict] = (),
                     local_replica: Optional[str] = None,
                     timeout: float = 2.0) -> str:
    """One fleet-wide exposition: this process's registry (optionally
    relabeled as ``local_replica``) plus every reachable remote
    replica's scrape with per-replica labels."""
    local = obs_metrics.render_prometheus()
    if local_replica:
        local = relabel_exposition(local, local_replica)
    parts = [local]
    for hs in handshakes:
        text = scrape_replica(hs, timeout=timeout)
        if text:
            parts.append(text)
    return "".join(p if p.endswith("\n") else p + "\n" for p in parts)
