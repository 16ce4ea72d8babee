"""Scope: hierarchical name -> tensor store (counterpart of
paddle_tpu/core/scope.py, without the fused flat-state views, which
belong to training).

Values are torch tensors on the executor's device. Ops may update a
scope tensor in place (the paged KV pools do); the executor then writes
the same object back, which copies nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

from .enforce import EnforceError


class Scope:
    def __init__(self, parent: "Optional[Scope]" = None):
        self._vars: Dict[str, Any] = {}
        self._parent = parent

    def var(self, name: str) -> Any:
        """Find or create (as None) a variable in *this* scope."""
        if name not in self._vars:
            self._vars[name] = None
        return self._vars[name]

    def find_var(self, name: str) -> Any:
        """Look up through the parent chain; returns None if absent."""
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return None

    def has_var(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s._parent
        return False

    def set_var(self, name: str, value: Any) -> None:
        """Set in the scope that owns the name (parent chain), else here."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s._parent
        self._vars[name] = value

    def get(self, name: str) -> Any:
        v = self.find_var(name)
        if v is None and not self.has_var(name):
            raise EnforceError(f"Variable '{name}' not found in scope")
        return v

    def local_var_names(self) -> Iterator[str]:
        return iter(self._vars)

    def __contains__(self, name: str) -> bool:
        return self.has_var(name)

    def __repr__(self):
        return f"Scope({list(self._vars)!r})"


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class scope_guard:
    """Temporarily swap the global scope."""

    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        global _global_scope
        self._old = _global_scope
        _global_scope = self._scope
        return self._scope

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self._old
        return False
