"""Thread-based server core (counterpart of the queue, worker and drain
of paddle_tpu/serving/server.py's InferenceServer, as far as the decode
session needs them): a bounded request queue, one worker thread that
owns the engine, and graceful drain-and-shutdown.

The dynamic batcher and bucketed engine of the JAX package's request
server, its circuit breaker and its degradation ladder are not ported
yet.
"""

from __future__ import annotations

import queue as _queue
import threading
from concurrent.futures import Future
from typing import Optional

import torch

from ..core.enforce import enforce
from .errors import ServerClosedError

_STOP = object()  # queue sentinel: wakes the worker for shutdown


def deliver(future: Future, result=None,
            exc: Optional[BaseException] = None) -> None:
    """Resolve a request future, tolerating client-side cancellation
    (set_result on a cancelled future raises InvalidStateError, which
    must never kill the worker)."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:
        pass  # cancelled/already resolved: the client gave up on it


class InferenceServer:
    """Base of a served engine: ``config`` carries ``queue_capacity``
    and ``warm_up``; ``self.engine`` (set by the subclass) has
    ``warm_up()`` and ``device``. Subclasses implement ``_worker_loop``
    and ``_fail_pending``. Use as a context manager for deterministic
    drain on exit."""

    def __init__(self, config, auto_start: bool = True):
        self.config = config
        self._queue: _queue.Queue = _queue.Queue(
            maxsize=self.config.queue_capacity)
        self._closed = False
        self._abort = False  # shutdown(drain=False): fail pending fast
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        if auto_start:
            self.start()

    @property
    def running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def start(self) -> "InferenceServer":
        with self._lock:
            enforce(not self._closed, "server is shut down")
            if self.running:
                return self
            if self.config.warm_up:
                self.engine.warm_up()
            self._worker = threading.Thread(
                target=self._worker_main, name="paddle-tpu-torch-serving",
                daemon=True)
            self._worker.start()
        return self

    def _worker_main(self) -> None:
        # the worker issues the engine's device work: pin the thread to
        # the engine's card (the default stream of that device)
        device = self.engine.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        self._worker_loop()

    def _worker_loop(self) -> None:
        raise NotImplementedError

    def _fail_pending(self) -> None:
        raise NotImplementedError

    def _admit(self) -> None:
        """Submit-side gate: a shut-down server fails fast."""
        if self._closed:
            raise ServerClosedError("server is shut down")

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the server. ``drain=True`` (graceful): stop accepting,
        finish every in-flight and queued request, then exit.
        ``drain=False``: fail queued requests with ServerClosedError and
        interrupt in-flight ones."""
        with self._lock:
            already = self._closed
            self._closed = True
            if not drain:
                self._abort = True
            worker = self._worker
        if worker is None or not worker.is_alive():
            self._fail_pending()
            return
        if not already:
            self._queue.put(_STOP)
        worker.join(timeout=timeout)

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown(drain=exc == (None, None, None))
        return False
