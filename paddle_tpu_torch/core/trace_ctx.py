"""Run-time execution context (counterpart of
paddle_tpu/core/trace_ctx.py).

While a sharded program runs, some ops need ambient information that is
not part of the program itself: the active device mesh (the tensor-
parallel ``fc`` ops and the dropout op read their rank's coordinates
from it) and the rematerialization policy. The JAX package publishes
both while it traces; the port runs its ops eagerly, so here they are
thread-local state active for the duration of a run.
"""

from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def current_mesh():
    """The DeviceMesh published by the active sharded run (None outside
    one: ops then compute on whole tensors)."""
    return getattr(_tls, "mesh", None)


@contextlib.contextmanager
def mesh_scope(mesh):
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def remat_enabled():
    """The active rematerialization policy.

    ``False`` — keep every activation (no remat); ``True`` — checkpoint
    the whole forward slice (the legacy all-or-nothing
    ``memory_optimize(level>=1)`` flag, or ``BuildStrategy.use_remat``);
    a ``frozenset`` of segment ids — checkpoint exactly the forward
    segments annotated with those ids (``op.attrs["_remat_segment"]``,
    written by the ``remat_policy`` pass). Truthiness is preserved, so
    ``if remat_enabled():`` keeps meaning "some remat is on"."""
    return getattr(_tls, "remat", False)


@contextlib.contextmanager
def remat_scope(enabled):
    """Publish a remat policy (bool or frozenset of segment ids) for the
    duration of a run."""
    prev = getattr(_tls, "remat", False)
    _tls.remat = enabled
    try:
        yield
    finally:
        _tls.remat = prev
