"""The ONE retry policy object every recovery path shares (counterpart
of paddle_tpu/resilience/retry.py).

Capped exponential backoff with seeded jitter: the decode batcher's
solo re-steps, the degradation ladder's Retry-After hints and
client-side resubmits after a retriable serving error all go through
:class:`RetryPolicy`. Jitter is drawn from a policy-owned
``random.Random(seed)``, so a policy's delay sequence is reproducible,
and equal to the JAX package's for the same seed.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Sequence, Tuple, Type, Union

from ..profiler import RecordEvent

Retriable = Union[Type[BaseException],
                  Tuple[Type[BaseException], ...],
                  Callable[[BaseException], bool]]


class RetryError(RuntimeError):
    """Every attempt failed. ``last`` carries the final attempt's
    exception (also chained as ``__cause__``); ``attempts`` how many
    were made."""

    def __init__(self, message: str, attempts: int,
                 last: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = attempts
        self.last = last


class RetryPolicy:
    """Capped exponential backoff with seeded jitter.

    delay(attempt) = min(max_delay_s, base_delay_s * multiplier**attempt)
                     * (1 + jitter * u),   u ~ U[0, 1) from the seed

    ``max_attempts`` bounds total tries (not retries): attempts are
    numbered 0..max_attempts-1 and the delay is paid BETWEEN attempts.
    """

    def __init__(self, max_attempts: int = 5, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.25, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._sleep = sleep
        self._rng = random.Random(self.seed)

    def reset(self) -> None:
        """Rewind the jitter stream (a fresh run of the same policy
        reproduces the same delays)."""
        self._rng = random.Random(self.seed)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt + 1`` (0-based failed
        attempt). Draws one jitter sample — deterministic in sequence."""
        base = min(self.max_delay_s,
                   self.base_delay_s * (self.multiplier ** attempt))
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        return base * (1.0 + self.jitter * self._rng.random())

    def delays(self):
        """The full backoff sequence (length max_attempts - 1)."""
        return [self.delay_s(a) for a in range(self.max_attempts - 1)]

    # ------------------------------------------------------------------
    def call(self, fn: Callable, *, retriable: Retriable = Exception,
             on_retry: Optional[Callable] = None,
             span: str = "resilience/retry"):
        """Run ``fn()`` under this policy.

        ``retriable`` — exception type(s), or a predicate on the
        exception instance, deciding which failures are worth another
        attempt (e.g. ``serving.is_retriable``). Anything
        else propagates immediately. ``on_retry(attempt, exc)`` is
        called before each backoff sleep. Raises :class:`RetryError`
        (chaining the last failure) once attempts are exhausted."""
        if callable(retriable) and not isinstance(retriable, type):
            should_retry = retriable
        else:
            should_retry = lambda e: isinstance(e, retriable)  # noqa: E731
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if isinstance(e, (KeyboardInterrupt, SystemExit)) \
                        or not should_retry(e):
                    raise
                last = e
            if attempt + 1 >= self.max_attempts:
                break
            if on_retry is not None:
                on_retry(attempt, last)
            d = self.delay_s(attempt)
            if d > 0:
                with RecordEvent(span + ".backoff"):
                    self._sleep(d)
        err = RetryError(
            "all %d attempts failed (last: %r)"
            % (self.max_attempts, last), self.max_attempts, last)
        err.__cause__ = last
        raise err


def call(fn: Callable, policy: Optional[RetryPolicy] = None, **kw):
    """Module-level convenience: ``retry.call(fn)`` with a fresh
    default policy (or the one passed)."""
    return (policy or RetryPolicy()).call(fn, **kw)
