"""paddle_tpu_torch.serving — dynamic-batching inference serving over a
program (counterpart of paddle_tpu/serving).

Requests enter a bounded queue, a dynamic batcher coalesces them for up
to ``batch_timeout_ms``, and the bucketed engine pads each batch to the
next bucket shape — on a card every bucket is one captured CUDA graph,
so arbitrary traffic replays at most ``len(buckets)`` graphs::

    server = serve_program(program, ["x"], [out], scope=scope)
    out, = server.infer({"x": batch})          # any batch size
    server.shutdown()                          # graceful drain

The decode tier (``paddle_tpu_torch.decoding``) serves on the same
server, errors, metrics, breaker and degradation ladder.
"""

from .batcher import DynamicBatcher, Request
from .engine import BucketedEngine, ServingConfig, default_buckets
from .errors import (CircuitOpenError, DeadlineExceededError,
                     DraftEngineError, FatalServingError,
                     GenerationInterruptedError, OverloadedError,
                     PromptTooLongError, QueueFullError,
                     RetriableServingError, ServerClosedError,
                     ServingError, from_wire, is_retriable)
from .metrics import DecodeMetrics, Histogram, ServingMetrics
from .server import InferenceServer, serve_program

__all__ = [
    "BucketedEngine",
    "CircuitOpenError",
    "DeadlineExceededError",
    "DraftEngineError",
    "DecodeMetrics",
    "DynamicBatcher",
    "FatalServingError",
    "GenerationInterruptedError",
    "Histogram",
    "InferenceServer",
    "OverloadedError",
    "PromptTooLongError",
    "QueueFullError",
    "Request",
    "RetriableServingError",
    "ServerClosedError",
    "ServingConfig",
    "ServingError",
    "ServingMetrics",
    "default_buckets",
    "from_wire",
    "is_retriable",
    "serve_program",
]
