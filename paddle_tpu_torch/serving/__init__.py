"""Serving layer of paddle_tpu_torch: typed errors, the server core the
decode session runs on, and its metrics."""

from .errors import (DeadlineExceededError, FatalServingError,
                     GenerationInterruptedError, PromptTooLongError,
                     QueueFullError, RetriableServingError,
                     ServerClosedError, ServingError, is_retriable)
from .metrics import DecodeMetrics
from .server import InferenceServer

__all__ = ["DeadlineExceededError", "DecodeMetrics", "FatalServingError",
           "GenerationInterruptedError", "InferenceServer",
           "PromptTooLongError", "QueueFullError", "RetriableServingError",
           "ServerClosedError", "ServingError", "is_retriable"]
