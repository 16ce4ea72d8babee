"""Counters and timings of one decode stack (a minimal counterpart of
paddle_tpu/serving/metrics.py's DecodeMetrics; the process-wide metrics
registry, Prometheus export and trace spans are not ported yet).

Times are host wall-clock milliseconds around work that ends in a
device synchronize (the executor synchronizes before it returns
fetches), so on the card they include the device time.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class DecodeMetrics:
    """Counters (``inc``) and millisecond samples (``observe``/``timer``)
    recorded by the engine and batcher: ``prefill_ms`` (full prefills),
    ``extend_ms`` (prefix-cache suffix prefills), ``decode_step_ms`` and
    ``ttft_ms`` samples, and the counters of ``COUNTERS``."""

    COUNTERS = (
        "tokens_generated", "sequences_completed", "request_errors",
        # one per prefill or suffix-prefill execution, and the prompt
        # tokens those executions computed
        "prefills_total", "prefill_tokens_computed_total",
        # prefix caching (the JAX package's names): admissions that
        # reused >= 1 cached prefix block / that found none, prompt
        # tokens whose prefill was skipped, cached blocks reclaimed
        # under memory pressure
        "prefix_cache_hits_total", "prefix_cache_misses_total",
        "prefill_tokens_avoided_total", "prefix_blocks_evicted_total")

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += int(n)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def observe(self, name: str, ms: float) -> None:
        with self._lock:
            self._samples[name].append(float(ms))

    @contextlib.contextmanager
    def timer(self, name: Optional[str]):
        """Record the block's wall time under ``name`` (None: don't)."""
        t0 = time.perf_counter()
        yield
        if name is not None:
            self.observe(name, (time.perf_counter() - t0) * 1e3)

    def report(self) -> dict:
        """Every counter (0 when never incremented), ``prefix_hit_rate``
        (hits / (hits + misses), 0.0 before any lookup), and
        count/mean/p50/p99 of every sample series."""
        with self._lock:
            out: dict = {n: 0 for n in self.COUNTERS}
            out.update(self._counters)
            lookups = (out["prefix_cache_hits_total"]
                       + out["prefix_cache_misses_total"])
            out["prefix_hit_rate"] = (
                round(out["prefix_cache_hits_total"] / lookups, 4)
                if lookups else 0.0)
            for name, xs in self._samples.items():
                a = np.asarray(xs)
                out[name] = {"count": int(a.size),
                             "mean": float(a.mean()),
                             "p50": float(np.percentile(a, 50)),
                             "p99": float(np.percentile(a, 99))}
        return out
