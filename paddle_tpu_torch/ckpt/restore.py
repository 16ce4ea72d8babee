"""Checkpoint readers: format auto-detection, restore, and batched
application into a Scope (counterpart of paddle_tpu/ckpt/restore.py).

A serial of either single-process format — the dense ``state.npz`` or
the elastic manifest, written by either package — loads as host values
assembled from its shard records. ``restore()`` is
the program-aware one-call entry: it lints the checkpoint against the
program's symbol table (``analysis.check_restore_state``: mismatches
surface as structured ``Diagnostic`` records) and applies the result to
a scope with :func:`apply_state`, which writes each fused flat buffer
once, however many of its views the checkpoint carries.

Host values: numpy arrays; a value the manifest records as bfloat16 is a
CPU ``torch.bfloat16`` tensor (numpy has no bfloat16); a raw two-byte
member that nothing names (a dense serial's bfloat16) stays a numpy
``'V2'`` array until :func:`apply_state` reads its dtype off the scope's
tensor or the program's variable (core/npz.py).

Re-slicing a checkpoint onto a sharded layout (``shardings=``,
``load_checkpoint_sharded``, ``program_state_shardings``) and the legacy
sharded format wait for multi-GPU support (ROADMAP Queue A 9).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import npz
from ..core.enforce import EnforceError, enforce, not_ported
from ..profiler import RecordEvent
from .base import (_TRAINER_PREFIX, _is_valid, _serial_dir,
                   latest_valid_serial, read_meta)
from .manifest import _sharded_not_ported, manifest_entries, read_index


def _read_trainer_args(d: str, trainer_id: int) -> Optional[dict]:
    p = os.path.join(d, f"{_TRAINER_PREFIX}_{trainer_id}.json")
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return json.load(f)


def _host_value(a: np.ndarray, dtype: str):
    """A recorded bfloat16 member as a CPU bfloat16 tensor; anything
    else as it was read."""
    if dtype == "bfloat16":
        return npz.to_tensor(a, torch.bfloat16)
    return a


def _load_indexed(index: Dict[str, list], shapes: Dict[str, tuple],
                  dtypes: Dict[str, str],
                  names: Optional[List[str]] = None) -> Dict[str, Any]:
    """Materialize host values from an elastic shard index: each tensor
    assembled from its shard pieces."""
    files: Dict[str, Any] = {}

    def z(path):
        if path not in files:
            files[path] = np.load(path, allow_pickle=False)
        return files[path]

    try:
        state: Dict[str, Any] = {}
        for name in (index if names is None else names):
            pieces = index[name]
            if len(pieces) == 1 and all(
                    a == 0 and b == s for (a, b), s in
                    zip(pieces[0][1], shapes[name])):
                full = z(pieces[0][2])[pieces[0][0]]  # one whole shard
            else:
                full = None
                for key, idx, path in pieces:
                    part = z(path)[key]
                    if full is None:
                        full = np.empty(shapes[name], part.dtype)
                    full[tuple(slice(a, b) for a, b in idx)] = part
            state[name] = _host_value(np.asarray(full).reshape(
                shapes[name]), dtypes[name])
    finally:
        for f in files.values():
            f.close()
    return state


def _serial_index(root: str, serial: int):
    """(index, shapes, dtypes) of an elastic serial, or None for a dense
    one; the legacy sharded format raises (ROADMAP Queue A 9)."""
    meta = read_meta(root, serial)
    d = _serial_dir(root, serial)
    if meta is None:
        return None
    if meta.get("format") == "elastic":
        index, shapes, dtypes, _specs = read_index(d, meta)
        return index, shapes, dtypes
    if meta.get("format") == "sharded":
        raise _sharded_not_ported()
    return None


def load_checkpoint(root: str, serial: Optional[int] = None,
                    trainer_id: int = 0):
    """Load (state_dict, trainer_args) from ``serial`` (default: newest
    valid) as host values — dense or elastic. Returns (None, None) when no
    valid checkpoint exists (reference: trainer.py:737
    load_checkpoint)."""
    if serial is None:
        serial = latest_valid_serial(root)
    if serial is None:
        return None, None
    if not _is_valid(root, serial):
        raise IOError(f"checkpoint_{serial} in {root} is missing or corrupt")
    d = _serial_dir(root, serial)
    indexed = _serial_index(root, serial)
    if indexed is not None:
        index, shapes, dtypes = indexed
        state = _load_indexed(index, shapes, dtypes)
    else:
        with np.load(os.path.join(d, "state.npz"),
                     allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
    return state, _read_trainer_args(d, trainer_id)


def load_checkpoint_sharded(root: str, serial: Optional[int] = None,
                            shardings: Optional[Dict[str, Any]] = None,
                            trainer_id: int = 0):
    """Restore onto sharded layouts: not ported."""
    raise not_ported("ckpt.load_checkpoint_sharded (restore re-sliced "
                     "onto a device mesh)", "Queue A 9, multi-GPU")


def program_state_shardings(program, shapes: Dict[str, tuple]
                            ) -> Optional[Dict[str, Any]]:
    """Target layouts (``sharding.mesh.Layout``) for checkpointed names,
    resolved through the program's attached ShardingPlan
    (``plan.state_sharding``, the resolution the sharded run holds state
    in). None when the program is unsharded."""
    plan = getattr(program, "_sharding_plan", None)
    if plan is None:
        return None
    gb = program.global_block()
    return {n: plan.state_sharding(gb, n, shape)
            for n, shape in shapes.items()}


def _place_on_mesh(program, scope, state) -> None:
    """After a restore into a sharded program's scope on a live mesh:
    each restored whole tensor replaced by this rank's block of it (the
    JAX package puts it onto its mesh sharding). Flat-view names are
    left to their buffers."""
    plan = getattr(program, "_sharding_plan", None)
    if plan is None or not plan.mesh.live:
        return
    layouts = program_state_shardings(program, {
        n: tuple(np.shape(v)) for n, v in state.items()})
    for n, layout in layouts.items():
        cur = scope.find_var(n)
        if any(layout.spec) and cur is not None and n in scope._vars:
            scope.set_var(n, plan.place(cur, layout))


def check_restore(root: str, program, serial: Optional[int] = None
                  ) -> List:
    """Restore-lint a checkpoint against a program WITHOUT loading any
    payload: ``Diagnostic`` records for shape/dtype mismatches between
    the checkpoint and the program's symbol table, missing persistables,
    and extra checkpoint entries. Empty list = clean."""
    from ..analysis import check_restore_state

    if serial is None:
        serial = latest_valid_serial(root)
    if serial is None:
        return []
    return check_restore_state(program, manifest_entries(root, serial))


def _device(scope, name: str, place) -> torch.device:
    """Where a restored value goes: the device of the scope's tensor of
    that name, else ``place``'s, else the default place's (the card)."""
    cur = scope.find_var(name)
    if isinstance(cur, torch.Tensor):
        return cur.device
    if place is not None:
        return place.torch_device()
    from ..core.place import default_place

    return default_place().torch_device()


def apply_state(scope, state: Dict[str, Any], program=None,
                place=None) -> None:
    """Write a restored state dict into ``scope`` as torch tensors, on
    the device of the scope's tensor of each name (else ``place``'s).

    Views of a fused flat buffer (``fuse_optimizer_state``) are grouped
    and the buffer is rebuilt on the host and written ONCE per group;
    when the state carries the flat buffer itself, its views are
    redundant and skipped. A raw two-byte member (bfloat16 bits whose
    dtype name was lost) takes the dtype of the scope's tensor or the
    program's variable, and raises when neither names bfloat16."""
    views = dict(getattr(program, "_flat_state_views", None) or {}) \
        if program is not None else {}

    def view_spec(name):
        spec = views.get(name)
        return spec if spec is not None else scope._find_view(name)

    grouped: Dict[str, list] = {}
    for n, v in state.items():
        spec = view_spec(n)
        if spec is None:
            dtype = (npz.declared_dtype(n, program, scope)
                     if npz.is_raw16(v) else None)
            scope.set_var(n, npz.to_tensor(v, dtype, _device(scope, n, place),
                                           name="checkpoint entry %r" % n))
        else:
            grouped.setdefault(spec[0], []).append((n, spec, v))
    for fname, items in grouped.items():
        if fname in state:
            # the flat buffer itself was restored above (fused-program
            # checkpoint): the per-name views are redundant copies
            continue
        flat = scope.find_var(fname)
        enforce(flat is not None,
                "restoring fused parameter(s) %s requires their flat "
                "storage %r in scope — run the startup program before "
                "restoring into a fused program"
                % (sorted(n for n, _, _ in items), fname))
        host = flat.detach().to("cpu", copy=True)
        for n, spec, v in items:
            _f, off, size, _shape, _d = spec
            val = npz.to_tensor(v, host.dtype if npz.is_raw16(v) else None,
                                name="checkpoint entry %r" % n)
            val = val.reshape(-1).to(host.dtype)
            enforce(val.shape[0] == size,
                    "restored value for %r has %d elements, its flat "
                    "view expects %d" % (n, val.shape[0], size))
            host[off:off + size] = val
        scope.set_var(fname, host.to(flat.device))


def restore(root: str, program=None, scope=None,
            serial: Optional[int] = None, trainer_id: int = 0,
            strict: bool = True, place=None):
    """One-call restore: newest valid serial (or ``serial``) →
    restore-lint against ``program`` → apply into ``scope``.

    Returns ``(state, trainer_args)``; ``(None, None)`` when no valid
    checkpoint exists. With ``strict=True`` (default) any shape/dtype
    mismatch between checkpoint and program raises EnforceError carrying
    the rendered Diagnostic records; ``strict=False`` skips the
    mismatched entries instead (they keep their startup values).
    ``scope=None`` loads without applying; ``place`` is where a value
    goes whose name the scope does not hold yet."""
    with RecordEvent("ckpt/restore"):
        if serial is None:
            serial = latest_valid_serial(root)
        if serial is None:
            return None, None
        if not _is_valid(root, serial):
            raise IOError(
                f"checkpoint_{serial} in {root} is missing or corrupt")
        drop: set = set()
        if program is not None:
            from ..analysis import check_restore_state
            from ..analysis.diagnostics import render

            diags = check_restore_state(
                program, manifest_entries(root, serial))
            errors = [dg for dg in diags if dg.is_error]
            if errors and strict:
                raise EnforceError(
                    "checkpoint_%d in %s does not fit the program (pass "
                    "strict=False to skip mismatched entries):\n%s"
                    % (serial, root, render(errors)))
            drop = {dg.var for dg in errors if dg.var}
        indexed = _serial_index(root, serial)
        d = _serial_dir(root, serial)
        if indexed is None:  # dense serial
            state, targs = load_checkpoint(root, serial, trainer_id)
        else:
            index, shapes, dtypes = indexed
            state = _load_indexed(index, shapes, dtypes,
                                  names=[n for n in index if n not in drop])
            targs = _read_trainer_args(d, trainer_id)
        if drop:
            state = {n: v for n, v in state.items() if n not in drop}
        if scope is not None:
            apply_state(scope, state, program, place=place)
            if program is not None:
                _place_on_mesh(program, scope, state)
        return state, targs
