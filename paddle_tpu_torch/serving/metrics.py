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
    recorded by the engine and batcher: ``prefill_ms``,
    ``decode_step_ms`` and ``ttft_ms`` samples, ``tokens_generated`` and
    ``sequences_completed`` counters."""

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
        """Counters, plus count/mean/p50/p99 of every sample series."""
        with self._lock:
            out: dict = dict(self._counters)
            for name, xs in self._samples.items():
                a = np.asarray(xs)
                out[name] = {"count": int(a.size),
                             "mean": float(a.mean()),
                             "p50": float(np.percentile(a, 50)),
                             "p99": float(np.percentile(a, 99))}
        return out
