"""Error enforcement — equivalent of PADDLE_ENFORCE / EnforceNotMet
(reference: paddle/fluid/platform/enforce.h:105,241).

The reference throws ``EnforceNotMet`` with a captured call stack; we raise
:class:`EnforceError` (a RuntimeError) with the same role. The reader-EOF
signal and the enforce_eq/enforce_not_none helpers of the JAX package are
not ported yet: nothing on the serving path uses them.
"""

from __future__ import annotations


class EnforceError(RuntimeError):
    """Raised when an enforce() check fails (reference: EnforceNotMet)."""


def enforce(cond, msg="Enforce failed", *args):
    if not cond:
        raise EnforceError(msg % args if args else str(msg))

