"""ONE process-wide metrics registry: labeled Counters, Gauges and
Histograms with Prometheus text exposition and a JSON snapshot
(counterpart of paddle_tpu/obs/metrics.py; same families, same names,
same exposition text).

``serving.metrics``' ServingMetrics and DecodeMetrics keep their values
here (``pdtpu_serving_*`` families with a per-instance ``sink`` label),
so one ``/metrics`` read covers every serving stack in the process. An
opt-in HTTP thread (:func:`start_http_server`) exposes ``/metrics``
(Prometheus text format 0.0.4) and ``/healthz``, which composes the
``health()`` snapshots registered by serving stacks.

Idiom: Prometheus client exposition; reference lineage: the profiler's
aggregated host-event table, generalized from timings to counters.
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# 1-2-5 ladder bucket bounds in ms: 1 µs .. 500 s
DEFAULT_BOUNDS_MS = tuple(m * (10.0 ** k)
                          for k in range(-3, 6) for m in (1.0, 2.0, 5.0))


class Histogram:
    """Fixed-bound latency histogram with percentile estimates.

    Bounded memory (one counter per bucket) so a long-lived server never
    grows; percentiles interpolate within the winning bucket. This is
    the ONE histogram implementation — serving/metrics.py re-exports
    it.
    """

    def __init__(self, bounds_ms=DEFAULT_BOUNDS_MS, unit: str = "ms"):
        self.unit = unit
        self.bounds = tuple(bounds_ms)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, value_ms: float) -> None:
        i = 0
        while i < len(self.bounds) and value_ms > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += value_ms
        self.min = min(self.min, value_ms)
        self.max = max(self.max, value_ms)

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]) in ms."""
        if not self.count:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                # clamp to observed extremes so tiny samples don't report
                # a bucket bound nobody measured
                return float(min(max((lo + hi) / 2.0, self.min), self.max))
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        u = self.unit
        return {"count": self.count, f"mean_{u}": round(self.mean, 3),
                f"min_{u}": round(self.min if self.count else 0.0, 3),
                f"max_{u}": round(self.max, 3),
                f"p50_{u}": round(self.percentile(50), 3),
                f"p99_{u}": round(self.percentile(99), 3)}


class Counter:
    """Monotonic counter child (one label combination).

    All registry locks (children, families, health) are REENTRANT: the
    flight recorder's signal-handler dump snapshots the registry on
    whatever frame the signal interrupted — possibly one already inside
    an inc/labels call on the same thread, where a plain Lock would
    deadlock the dying process.
    """

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.RLock()

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Set-to-current-value child (one label combination)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.RLock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family: fixed label names, children per label
    value combination. ``labels()`` with no arguments (or a label-free
    family) returns the single default child, so ``counter("x").inc()``
    works without label ceremony."""

    def __init__(self, name: str, kind: str, help_str: str = "",
                 labels: Sequence[str] = (), **child_kwargs):
        self.name = name
        self.kind = kind
        self.help = help_str
        self.label_names = tuple(labels)
        self._child_kwargs = child_kwargs
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.RLock()

    def labels(self, **kv):
        key = tuple(str(kv.get(n, "")) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](**self._child_kwargs)
                self._children[key] = child
        return child

    # label-free convenience: the family proxies its default child
    def inc(self, n=1):
        self.labels().inc(n)

    def set(self, v):
        self.labels().set(v)

    def observe(self, v):
        self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value

    def remove(self, **kv) -> None:
        """Drop one label combination's child (exposition stops showing
        it). Long-lived processes that create per-instance sinks in a
        loop (a server per job, a DataLoader per epoch) should remove
        the dead sink's children — label children are otherwise kept
        for the life of the registry, the Prometheus client model."""
        key = tuple(str(kv.get(n, "")) for n in self.label_names)
        with self._lock:
            self._children.pop(key, None)

    def remove_matching(self, **kv) -> int:
        """Drop every child whose labels match the given subset (e.g.
        ``remove_matching(sink="servingmetrics-3")`` clears all of one
        stack's events). Returns how many children were dropped."""
        idx = [(i, str(v)) for i, n in enumerate(self.label_names)
               for k, v in kv.items() if k == n]
        with self._lock:
            doomed = [key for key in self._children
                      if all(key[i] == v for i, v in idx)]
            for key in doomed:
                del self._children[key]
        return len(doomed)

    def children(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.label_names, key)), child)
                for key, child in items]


class Registry:
    """Name -> Family map; ``get_or_create`` semantics so independent
    subsystems can share a family by name (kind/label mismatches are an
    error — two meanings under one name would corrupt exposition)."""

    def __init__(self):
        self._families: Dict[str, Family] = {}
        self._lock = threading.RLock()

    def _get_or_create(self, name, kind, help_str, labels, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help_str, labels, **kw)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.label_names != tuple(labels):
            raise ValueError(
                "metric %r already registered as %s%r; cannot re-register"
                " as %s%r" % (name, fam.kind, fam.label_names, kind,
                              tuple(labels)))
        return fam

    def counter(self, name, help_str="", labels=()):
        return self._get_or_create(name, "counter", help_str, labels)

    def gauge(self, name, help_str="", labels=()):
        return self._get_or_create(name, "gauge", help_str, labels)

    def histogram(self, name, help_str="", labels=(),
                  bounds_ms=DEFAULT_BOUNDS_MS, unit="ms"):
        return self._get_or_create(name, "histogram", help_str, labels,
                                   bounds_ms=bounds_ms, unit=unit)

    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def unregister(self, name: str) -> None:
        """Drop a whole family (tests / full teardown)."""
        with self._lock:
            self._families.pop(name, None)

    def remove_sink(self, sink: str) -> int:
        """Drop every child labeled with this ``sink`` across all
        families — the one-call teardown for a retired
        ServingMetrics/DecodeMetrics/PipelineMetrics instance, so a
        process that builds serving stacks in a loop doesn't grow its
        exposition without bound."""
        dropped = 0
        for fam in self.families():
            if "sink" in fam.label_names:
                dropped += fam.remove_matching(sink=sink)
        return dropped

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready view: {family: {type, help, values: [{labels,
        value|histogram snapshot}]}}."""
        out: Dict[str, object] = {}
        for fam in self.families():
            vals = []
            for labels, child in fam.children():
                if fam.kind == "histogram":
                    vals.append({"labels": labels,
                                 "histogram": child.snapshot()})
                else:
                    vals.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": vals}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: List[str] = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in fam.children():
                base = _label_str(labels)
                if fam.kind == "histogram":
                    cum = 0
                    for bound, c in zip(child.bounds, child.counts):
                        cum += c
                        lines.append("%s_bucket%s %s" % (
                            fam.name,
                            _label_str(dict(labels, le=repr(bound))),
                            cum))
                    lines.append("%s_bucket%s %s" % (
                        fam.name, _label_str(dict(labels, le="+Inf")),
                        child.count))
                    lines.append(f"{fam.name}_sum{base} {child.total}")
                    lines.append(f"{fam.name}_count{base} {child.count}")
                else:
                    lines.append(f"{fam.name}{base} {child.value}")
        return "\n".join(lines) + "\n"


def _escape_label_value(v) -> str:
    """Label-value escaping per the Prometheus text exposition format
    (0.0.4): backslash, double-quote and newline — in that order, so an
    already-present backslash never double-escapes the quote/newline
    replacements."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join('%s="%s"' % (k, _escape_label_value(v))
                     for k, v in sorted(labels.items()))
    return "{%s}" % inner


# ---------------------------------------------------------------------------
# The process-wide default registry + module-level conveniences.
# ---------------------------------------------------------------------------

REGISTRY = Registry()


def counter(name, help_str="", labels=()):
    return REGISTRY.counter(name, help_str, labels)


def gauge(name, help_str="", labels=()):
    return REGISTRY.gauge(name, help_str, labels)


def histogram(name, help_str="", labels=(), bounds_ms=DEFAULT_BOUNDS_MS,
              unit="ms"):
    return REGISTRY.histogram(name, help_str, labels, bounds_ms, unit)


def snapshot() -> Dict[str, object]:
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


# ---------------------------------------------------------------------------
# /healthz sources: serving stacks (and anything with a health() dict)
# register here; the HTTP endpoint composes every snapshot.
# ---------------------------------------------------------------------------

_HEALTH: Dict[str, Callable[[], dict]] = {}
_HEALTH_LOCK = threading.RLock()


def register_health(name: str, fn: Callable[[], dict]) -> None:
    """Register a named health() source (e.g. an InferenceServer's bound
    ``health`` method) for the /healthz endpoint. Re-registering a name
    replaces it; call unregister_health when the source shuts down."""
    with _HEALTH_LOCK:
        _HEALTH[name] = fn


def unregister_health(name: str) -> None:
    with _HEALTH_LOCK:
        _HEALTH.pop(name, None)


def health_snapshot() -> dict:
    """Composed health view: every registered source's snapshot plus an
    overall status ("ok" unless any source reports a non-serving state
    or raises)."""
    with _HEALTH_LOCK:
        sources = dict(_HEALTH)
    out: Dict[str, object] = {}
    ok = True
    for name, fn in sources.items():
        try:
            snap = fn()
            out[name] = snap
            status = str(snap.get("status", "ok")) if isinstance(
                snap, dict) else "ok"
            if status not in ("ok", "serving"):
                ok = False
        except Exception as e:
            out[name] = {"status": "error", "error": repr(e)}
            ok = False
    return {"status": "ok" if ok else "degraded", "sources": out}


# ---------------------------------------------------------------------------
# Opt-in HTTP exposition thread.
# ---------------------------------------------------------------------------


_HTTP_IDS = itertools.count()
_LAST_SERVER: Optional["MetricsServer"] = None


class MetricsServer:
    """Tiny daemon-thread HTTP server: /metrics (Prometheus text),
    /healthz (JSON). Opt-in — nothing listens unless start_http_server
    is called. ``port=0`` binds an ephemeral port (read ``.port``).

    Discovery: multiple replicas on one host each bind
    ``port=0`` — no collision — and the BOUND port is surfaced two
    ways so a router/scrape aggregator can find it without being told:
    the ``pdtpu_obs_http_port{server=...}`` gauge on the registry, and
    a ``metrics_http`` health source (``{"addr", "port"}``) composed
    into every ``/healthz`` snapshot. ``close()`` zeroes the gauge and
    drops the health source."""

    def __init__(self, port: int = 0, addr: str = "127.0.0.1",
                 registry: Optional[Registry] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry or REGISTRY

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] == "/metrics":
                    body = reg.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.split("?")[0] == "/healthz":
                    body = json.dumps(health_snapshot()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # keep stdout clean
                pass

        self._httpd = ThreadingHTTPServer((addr, port), _Handler)
        self.addr, self.port = self._httpd.server_address[:2]
        self.name = "http-%d" % next(_HTTP_IDS)
        # surface the BOUND port (ephemeral under port=0) for
        # router/scrape discovery: a registry gauge + a health source
        self._port_gauge = gauge(
            "pdtpu_obs_http_port",
            "bound /metrics HTTP port per exposition server "
            "(0 after close)", labels=("server",)).labels(
                server=self.name)
        self._port_gauge.set(self.port)
        register_health("metrics_http",
                        lambda: {"addr": self.addr, "port": self.port,
                                 "server": self.name})
        global _LAST_SERVER
        _LAST_SERVER = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pdtpu-obs-http",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._port_gauge.set(0)
        global _LAST_SERVER
        if _LAST_SERVER is self:
            _LAST_SERVER = None
            unregister_health("metrics_http")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_http_server(port: int = 0, addr: str = "127.0.0.1",
                      registry: Optional[Registry] = None) -> MetricsServer:
    """Start the opt-in /metrics + /healthz thread; returns the server
    (close() it, or let the daemon thread die with the process)."""
    return MetricsServer(port=port, addr=addr, registry=registry)


def http_endpoint() -> Optional[Tuple[str, int]]:
    """(addr, port) of the most recently started (and still open)
    exposition server in this process, or None — how a fleet replica
    worker discovers its own ephemeral bind to put in its handshake."""
    srv = _LAST_SERVER
    return None if srv is None else (srv.addr, srv.port)
