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
    ``extend_ms`` (prefix-cache suffix prefills), ``decode_step_ms``,
    ``verify_ms`` (speculative verify steps) and ``ttft_ms`` samples,
    the counters of ``COUNTERS``, and ``tokens_per_sec``, an EMA over
    decode iterations of the tokens they put into streams
    (``note_decode_step``)."""

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
        "prefill_tokens_avoided_total", "prefix_blocks_evicted_total",
        # speculative decoding: draft tokens proposed / accepted, and
        # multi-token verify steps executed on the target and the rows
        # they verified
        "spec_proposed_total", "spec_accepted_total",
        "verify_steps_total", "verify_rows_total")

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self.tokens_per_sec = 0.0

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

    def note_decode_step(self, tokens: int, dt_s: float) -> None:
        """Count the tokens one decode iteration put into streams and fold
        its rate into ``tokens_per_sec`` (EMA, weight 0.2 a step). Under
        speculation an iteration passes the tokens it ACCEPTED, not its
        rows, so the rate stays honest."""
        with self._lock:
            self._counters["tokens_generated"] += int(tokens)
            if dt_s > 0:
                inst = tokens / dt_s
                self.tokens_per_sec = (
                    inst if self.tokens_per_sec == 0.0
                    else 0.8 * self.tokens_per_sec + 0.2 * inst)

    def report(self) -> dict:
        """Every counter (0 when never incremented), ``prefix_hit_rate``
        (hits / (hits + misses), 0.0 before any lookup),
        ``spec_acceptance_rate`` (accepted / proposed draft tokens, 0.0
        before any), ``tokens_per_sec``, and count/mean/p50/p99 of every
        sample series."""
        with self._lock:
            out: dict = {n: 0 for n in self.COUNTERS}
            out.update(self._counters)
            lookups = (out["prefix_cache_hits_total"]
                       + out["prefix_cache_misses_total"])
            out["prefix_hit_rate"] = (
                round(out["prefix_cache_hits_total"] / lookups, 4)
                if lookups else 0.0)
            out["spec_acceptance_rate"] = (
                round(out["spec_accepted_total"]
                      / out["spec_proposed_total"], 4)
                if out["spec_proposed_total"] else 0.0)
            out["tokens_per_sec"] = round(self.tokens_per_sec, 2)
            for name, xs in self._samples.items():
                a = np.asarray(xs)
                out[name] = {"count": int(a.size),
                             "mean": float(a.mean()),
                             "p50": float(np.percentile(a, 50)),
                             "p99": float(np.percentile(a, 99))}
        return out
