"""Error enforcement — equivalent of PADDLE_ENFORCE / EnforceNotMet
(reference: paddle/fluid/platform/enforce.h:105,241).

The reference throws ``EnforceNotMet`` with a captured call stack; we raise
:class:`EnforceError` (a RuntimeError) with the same role.
:class:`EOFException` is the reader-EOF signal (enforce.h:66) that ends a
data-driven loop (``Executor.run(feed=loader)`` past a loader's pass).
The enforce_eq/enforce_not_none helpers of the JAX package are not
ported: nothing in the port uses them.
"""

from __future__ import annotations


class EnforceError(RuntimeError):
    """Raised when an enforce() check fails (reference: EnforceNotMet)."""


class EOFException(Exception):
    """Raised when a data stream is exhausted (reference: EOFException,
    enforce.h:66)."""


def enforce(cond, msg="Enforce failed", *args):
    if not cond:
        raise EnforceError(msg % args if args else str(msg))


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a seam raises for a capability of the JAX package that
    the port does not have yet; ``item`` names the ROADMAP queue item
    that ports it."""
    return NotImplementedError("%s is not ported yet (ROADMAP %s)"
                               % (what, item))
