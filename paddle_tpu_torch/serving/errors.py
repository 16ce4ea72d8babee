"""Typed serving errors (counterpart of paddle_tpu/serving/errors.py) —
clients branch on these, so they are part of the public surface.

RETRIABLE errors are transient load or availability: the same request
may succeed when resubmitted after a backoff (``resilience.retry_call``
spans queue drains and breaker reset timeouts). FATAL errors mean this
request can never succeed against this server or configuration.
``is_retriable`` is the one predicate clients and ``retry_call`` use.

Every class round-trips a STABLE wire form (``to_wire`` /
``from_wire``), the JAX package's: ``{"error": <class name>, "message":
<str>}`` plus ``retry_after_s`` (OverloadedError) and the partial
stream ``tokens`` (GenerationInterruptedError, a mid-generation
deadline) when present. An unknown class name deserializes to a plain
``RuntimeError`` — a newer server never crashes an older client.
"""


class ServingError(RuntimeError):
    """Base class for every error the serving layer raises itself."""

    def to_wire(self) -> dict:
        """The stable wire form: class name + message + the optional
        typed fields (``retry_after_s``, ``tokens``) when set."""
        out = {"error": type(self).__name__, "message": str(self)}
        tokens = getattr(self, "tokens", None)
        if tokens is not None:
            out["tokens"] = [int(t) for t in tokens]
        retry = getattr(self, "retry_after_s", None)
        if retry is not None:
            out["retry_after_s"] = retry
        return out


class RetriableServingError(ServingError):
    """Transient: the same request may succeed if resubmitted after a
    backoff (queue drained, breaker closed, engine recovered)."""


class FatalServingError(ServingError):
    """Permanent for this request/configuration: resubmitting the same
    request cannot succeed."""


def is_retriable(exc: BaseException) -> bool:
    """The retriable-vs-fatal predicate (pass to ``retry.call``)."""
    return isinstance(exc, RetriableServingError)


class QueueFullError(RetriableServingError):
    """The bounded request queue is at capacity (backpressure): the
    caller should retry later or shed load."""


class DeadlineExceededError(RetriableServingError):
    """The request's deadline passed (queued or mid-generation; a
    mid-generation expiry carries the partial stream in ``tokens``)."""


class CircuitOpenError(RetriableServingError):
    """The server's circuit breaker is open (error rate or sustained
    queue saturation) — load is being shed while the engine recovers;
    retry after a backoff at least ``reset_timeout_s`` long."""


class OverloadedError(RetriableServingError):
    """The degradation ladder (``resilience.degrade``, stage 4) is
    shedding this request's priority class under overload. Retriable by
    definition — ``retry_after_s`` carries the Retry-After-style hint
    derived from the shared ``resilience.RetryPolicy`` backoff; clients
    resubmitting through ``retry.call`` naturally honor it."""

    def __init__(self, message: str, retry_after_s=None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DraftEngineError(ServingError):
    """The speculative-decoding DRAFT engine failed (its prefill or one
    of its draft steps raised). Never surfaced to clients: the session
    falls back PERMANENTLY to plain decode — streams stay bit-identical
    because speculation only ever proposes tokens the target verifies —
    and this typed record is kept on the batcher (``draft_error``) and
    in ``health()`` so operators see why speculation is off."""


class ServerClosedError(FatalServingError):
    """Submitted to a server that is shut down (or shutting down)."""


class PromptTooLongError(FatalServingError):
    """A generation request's prompt (or prompt + max_new_tokens)
    exceeds the decode engine's cache geometry — it can never be
    admitted at this configuration."""


class GenerationInterruptedError(RetriableServingError):
    """A generation was cut off mid-stream (non-drain shutdown or a
    mid-flight failure). ``tokens`` carries the tokens generated before
    the interruption — the partial stream is flushed, never dropped.
    Retriable: a resubmit against a live (or restarted) server starts
    the generation over."""

    def __init__(self, message: str, tokens=None):
        super().__init__(message)
        self.tokens = list(tokens or [])


def from_wire(d: dict) -> BaseException:
    """Rebuild the typed error a peer serialized with ``to_wire``.

    The class is resolved by NAME against this module; typed
    constructor fields (``tokens``, ``retry_after_s``) are restored so
    ``is_retriable`` and resume paths see the same object either side
    of the wire. An unrecognized name (or a name that is not a
    ServingError subclass) degrades to ``RuntimeError`` carrying the
    original name + message — never a crash on version skew."""
    import sys

    mod = sys.modules[__name__]
    cls = getattr(mod, str(d.get("error", "")), None)
    msg = d.get("message", "")
    if cls is None or not (isinstance(cls, type)
                           and issubclass(cls, ServingError)):
        return RuntimeError("%s: %s" % (d.get("error"), msg))
    if issubclass(cls, GenerationInterruptedError):
        return cls(msg, tokens=d.get("tokens") or [])
    if issubclass(cls, OverloadedError):
        return cls(msg, retry_after_s=d.get("retry_after_s"))
    exc = cls(msg)
    if "tokens" in d:
        exc.tokens = list(d["tokens"])
    return exc
