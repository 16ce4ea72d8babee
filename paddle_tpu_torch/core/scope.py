"""Scope: hierarchical name -> tensor store (counterpart of
paddle_tpu/core/scope.py).

Values are torch tensors on the executor's device. Ops may update a
scope tensor in place (the paged KV pools, the fused optimizer update);
the executor then writes the same object back, which copies nothing.

Flat-state views: under ``fuse_optimizer_state`` a parameter group and
each of its moments live in one flat buffer, and every per-name access
(a fetch, a checkpoint load) goes through a view
``name -> (flat_name, offset, size, shape, dtype)``. A read returns the
torch view ``flat[offset:offset + size].view(shape)``, which shares the
buffer's storage; a write copies into that slice.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import torch

from .enforce import EnforceError


class Scope:
    def __init__(self, parent: "Optional[Scope]" = None):
        self._vars: Dict[str, Any] = {}
        self._parent = parent
        self._flat_views: Dict[str, tuple] = {}

    # -- flat-state views --------------------------------------------------
    def adopt_flat_views(self, views: Dict[str, tuple]) -> None:
        """Register views over flat buffers and drop the per-name
        entries they replace (the startup program initializes the
        parameters per name before packing them; from here on the flat
        buffer is the one source of truth)."""
        for name, spec in views.items():
            if self._flat_views.get(name) == spec:
                continue
            self._flat_views[name] = spec
            self._vars.pop(name, None)

    def _find_view(self, name: str):
        s = self
        while s is not None:
            if name in s._flat_views:
                return s._flat_views[name]
            s = s._parent
        return None

    def _read_view(self, spec):
        flat_name, off, size, shape, _dtype = spec
        flat = self.find_var(flat_name)
        if flat is None:
            return None
        return flat[off:off + size].view(shape)

    def _write_view(self, name: str, spec, value) -> None:
        flat_name, off, size, _shape, _dtype = spec
        flat = self.find_var(flat_name)
        if flat is None:
            raise EnforceError(
                f"Flat storage {flat_name!r} for view {name!r} not in scope "
                "(run the startup program first)")
        val = torch.as_tensor(value).reshape(-1)
        if val.shape[0] != size:
            raise EnforceError(
                f"Value for {name!r} has {val.shape[0]} elements, view "
                f"expects {size}")
        with torch.no_grad():
            flat[off:off + size].copy_(val)

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
        spec = self._find_view(name)
        if spec is not None:
            return self._read_view(spec)
        return None

    def has_var(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s._parent
        spec = self._find_view(name)
        return spec is not None and self.find_var(spec[0]) is not None

    def set_var(self, name: str, value: Any) -> None:
        """Set in the scope that owns the name (parent chain), else here."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s._parent
        spec = self._find_view(name)
        if spec is not None:
            self._write_view(name, spec, value)
            return
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
