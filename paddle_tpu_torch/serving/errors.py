"""Typed serving errors (counterpart of paddle_tpu/serving/errors.py) —
clients branch on these, so they are part of the public surface.

RETRIABLE errors are transient load or availability: the same request
may succeed when resubmitted after a backoff. FATAL errors mean this
request can never succeed against this server or configuration. The
wire form the JAX package's fleet ships is not ported yet.
"""


class ServingError(RuntimeError):
    """Base class for every error the serving layer raises itself."""


class RetriableServingError(ServingError):
    """Transient: the same request may succeed if resubmitted."""


class FatalServingError(ServingError):
    """Permanent for this request/configuration."""


def is_retriable(exc: BaseException) -> bool:
    """The retriable-vs-fatal predicate."""
    return isinstance(exc, RetriableServingError)


class QueueFullError(RetriableServingError):
    """The bounded request queue is at capacity (backpressure)."""


class DeadlineExceededError(RetriableServingError):
    """The request's deadline passed (queued or mid-generation; a
    mid-generation expiry carries the partial stream in ``tokens``)."""


class ServerClosedError(FatalServingError):
    """Submitted to a server that is shut down (or shutting down)."""


class PromptTooLongError(FatalServingError):
    """The prompt (or prompt + max_new_tokens) exceeds the decode
    engine's cache geometry — it can never be admitted."""


class GenerationInterruptedError(RetriableServingError):
    """A generation was cut off mid-stream (non-drain shutdown or a
    failed step). ``tokens`` carries the tokens generated before the
    interruption — the partial stream is flushed, never dropped."""

    def __init__(self, message: str, tokens=None):
        super().__init__(message)
        self.tokens = list(tokens or [])
