"""Canonical, cross-process-stable fingerprints of compilation units
(counterpart of paddle_tpu/compile_cache/fingerprint.py: the same
canonical ids, desc and hash, so the two packages' fingerprints are
equal or unequal over the same program changes).

A compilation unit = (program topology + attrs, feed/fetch surface,
input shapes/dtypes, the site's config, backend + framework versions).
Two processes that would export the SAME graph must compute the SAME
fingerprint; any difference that could change the graph must change
it. Three rules make that hold:

* **No process-local state.** Nothing derived from ``id()``, dict
  insertion order of runtime containers, or filesystem paths enters the
  hash — everything is serialized through ``json.dumps(sort_keys=True)``
  over primitives.
* **Alpha-renaming invariance.** Internal variable names come from the
  global ``unique_name`` counters, so two structurally identical
  programs built in different name-scope orders (or after other
  programs) carry different raw names. Every internal name is therefore
  replaced by a *canonical id* assigned by walking the op list in
  program order: feeds first (their raw names are the external feed API
  and stay), then fetch targets positionally, then each op's inputs and
  outputs slot-by-slot. Corresponding tensors of alpha-equivalent
  programs land on the same id, so the fingerprint matches.
* **Environment pinning.** torch and CUDA versions, the platform and
  the card's name and compute capability are hashed in
  (``environment_signature``): an artifact from another torch or
  another card generation must miss.

Unknown extents use the symbol table's ``-1`` convention.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtype_utils

FORMAT_VERSION = 1


def environment_signature() -> Dict[str, str]:
    """The backend/version facts an exported artifact depends on. Part
    of every fingerprint AND recorded verbatim in each store entry's
    meta — the store cross-checks it on read so a skewed entry is
    evicted. The JAX package's keys whose meaning carries over
    (``python``, ``platform``, ``platform_version``, ``device_kind``,
    ``num_devices``), with ``torch`` and ``cuda`` where it pins ``jax``
    and ``jaxlib``. On a card: platform ``cuda``, the card's name, its
    compute capability; else platform ``cpu``."""
    import platform as _platform

    sig = {"torch": torch.__version__,
           "cuda": torch.version.cuda or "",
           # op fns are fingerprinted via their code objects' bytecode,
           # which is only stable within a Python version
           "python": _platform.python_version(),
           "platform": "cpu", "platform_version": "",
           "device_kind": "cpu", "num_devices": 1}
    try:
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            sig.update(platform="cuda",
                       platform_version="%d.%d" % (major, minor),
                       device_kind=torch.cuda.get_device_name(0),
                       num_devices=torch.cuda.device_count())
    except Exception:
        pass  # the card not initializable: still a usable (coarser) pin
    return sig


def _canon_value(v, cid, var_names=frozenset()):
    """Attr value -> JSON-able canonical form. Any attr difference that
    could change the traced computation must survive into the hash;
    values that cannot be introspected degrade to a type marker (two
    programs differing ONLY inside an opaque attr may collide — the op
    type + every serializable attr still separates real-world cases).

    String attrs that name a program variable (backward/optimizer ops
    stash e.g. the loss var's name) are replaced by the variable's
    canonical id — a raw auto-generated name there would break
    alpha-renaming invariance."""
    if isinstance(v, str):
        return ["var", cid(v)] if v in var_names else v
    if v is None or isinstance(v, (bool, int)):
        return v
    if isinstance(v, float):
        return repr(v)  # full precision, no locale
    if isinstance(v, np.generic):
        return _canon_value(v.item(), cid, var_names)
    if isinstance(v, np.ndarray):
        return ["ndarray", list(v.shape), str(v.dtype),
                hashlib.sha256(np.ascontiguousarray(v).tobytes())
                .hexdigest()]
    if isinstance(v, torch.dtype):
        return dtype_utils.name(v)
    if isinstance(v, (list, tuple)):
        return [_canon_value(x, cid, var_names) for x in v]
    if isinstance(v, dict):
        return [[str(k), _canon_value(v[k], cid, var_names)]
                for k in sorted(v)]
    # control-flow ops stash sub-Blocks/Programs in attrs: recurse over
    # their op lists with the SAME cid namespace (sub-block vars resolve
    # against the parent scope in this IR)
    ops = getattr(v, "ops", None)
    if ops is not None and hasattr(v, "idx"):  # Block
        return ["block", _ops_desc(ops, cid, var_names)]
    blocks = getattr(v, "blocks", None)
    if blocks is not None:  # Program
        return ["program",
                [_ops_desc(b.ops, cid, var_names) for b in blocks]]
    return ["opaque", type(v).__name__]


def _code_sig(code) -> str:
    """Stable digest of a code object. NOT ``marshal.dumps``: CPython's
    adaptive interpreter mutates the marshaled form as the function
    executes, which would change the fingerprint between a program's
    first and second resolution. Built from the immutable fields
    instead; set-typed constants are order-normalized (their iteration
    order varies under hash randomization across processes)."""
    import types

    h = hashlib.sha256()

    def feed(c):
        h.update(c.co_code)
        h.update(repr((c.co_names, c.co_varnames, c.co_freevars,
                       c.co_cellvars, c.co_argcount,
                       c.co_kwonlyargcount, c.co_flags)).encode())
        for const in c.co_consts:
            if isinstance(const, types.CodeType):
                feed(const)
            elif isinstance(const, frozenset):
                h.update(repr(sorted(const, key=repr)).encode())
            else:
                h.update(repr(const).encode())

    feed(code)
    return h.hexdigest()


def _canon_fn(fn, cid, var_names, depth=0):
    """Canonical identity of an op's torch function.

    Unlike the reference's OpDesc, an Operator here carries real Python
    — and layers bake configuration (a scale factor, a dropout rate, an
    axis, the bf16 rule read at build time) into the fn's CLOSURE rather
    than attrs. Two programs whose descs match but whose closures differ
    would export different graphs, so the fn's code object (:func:`_code_sig` covers bytecode
    + consts + nested code) and every closure cell value are hashed in.
    Cell
    values canonicalize like attrs; Variables and var-name strings map
    through the canonical ids so closed-over references cannot break
    alpha-renaming invariance; anything opaque degrades to a type
    marker (conservative: may merge units that differ only inside an
    un-introspectable object)."""
    if fn is None:
        return None
    if depth > 4:
        return ["fn-deep"]
    import functools

    if isinstance(fn, functools.partial):
        return ["partial", _canon_fn(fn.func, cid, var_names, depth + 1),
                [_canon_cell(a, cid, var_names, depth) for a in fn.args],
                [[k, _canon_cell(v, cid, var_names, depth)]
                 for k, v in sorted(fn.keywords.items())]]
    fn = getattr(fn, "__func__", fn)  # bound method -> function
    code = getattr(fn, "__code__", None)
    if code is None:
        return ["callable", type(fn).__name__]
    code_sig = _code_sig(code)
    cells = []
    for name, cell in zip(code.co_freevars, fn.__closure__ or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            v = ["unbound"]
        cells.append([name, _canon_cell(v, cid, var_names, depth)])
    defaults = [_canon_cell(v, cid, var_names, depth)
                for v in (fn.__defaults__ or ())]
    return ["fn", code_sig, cells, defaults]


def _canon_cell(v, cid, var_names, depth):
    """Closure-cell value -> canonical form (attr rules + Variables,
    nested functions, tensors)."""
    name = getattr(v, "name", None)
    if name is not None and hasattr(v, "block") and \
            isinstance(name, str):  # core.program.Variable
        return ["varref", cid(name) if name in var_names else name]
    if callable(v) and not isinstance(v, type):
        return _canon_fn(v, cid, var_names, depth + 1)
    if isinstance(v, torch.Tensor):
        try:  # hash the host bytes, bfloat16 included
            t = v.detach().cpu().contiguous()
            return ["tensor", list(t.shape), dtype_utils.name(t.dtype),
                    hashlib.sha256(t.reshape(-1).view(torch.uint8)
                                   .numpy().tobytes()).hexdigest()]
        except Exception:
            return ["opaque", type(v).__name__]
    return _canon_value(v, cid, var_names)


def _ops_desc(ops, cid, var_names=frozenset()) -> List:
    out = []
    for op in ops:
        out.append({
            "type": op.type,
            "in": [[slot, [cid(n) for n in names]]
                   for slot, names in sorted(op.inputs.items())],
            "out": [[slot, [cid(n) for n in names]]
                    for slot, names in sorted(op.outputs.items())],
            "attrs": [[k, _canon_value(v, cid, var_names)]
                      for k, v in sorted(op.attrs.items())],
            "fn": _canon_fn(op.fn, cid, var_names),
        })
    return out


def _aval_json(shape, dtype) -> List:
    return [list(int(s) for s in shape), dtype_utils.name(dtype)]


class CompilationUnit:
    """Canonical view of one (program, feed surface, fetch surface).

    Built once per compiled specialization; exposes the name->canonical
    id map (``canon``) the runtime layer uses to record/replay the flat
    calling convention, and :meth:`fingerprint` to key the store.
    """

    def __init__(self, program, feed_names: Sequence[str],
                 fetch_names: Sequence[str]):
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(fetch_names)
        self.canon: Dict[str, int] = {}

        def cid(name: str) -> int:
            i = self.canon.get(name)
            if i is None:
                i = self.canon[name] = len(self.canon)
            return i

        self._cid = cid
        # anchor the external surface first: feed names sorted (they are
        # the by-name feed API and appear raw in the desc), fetches in
        # caller order (positional outputs — canonicalized, so an
        # auto-generated fetch var name cannot break equivalence)
        for n in sorted(self.feed_names):
            cid(n)
        fetch_ids = [cid(n) for n in self.fetch_names]
        var_names = frozenset(
            n for b in program.blocks for n in b.vars)
        self._var_names = var_names
        blocks_desc = [_ops_desc(b.ops, cid, var_names)
                       for b in program.blocks]

        # declared symbol-table types per canonical id (first-resolution
        # wins, mirroring _find_var_recursive from the global block)
        vars_desc = []
        for name, i in sorted(self.canon.items(), key=lambda kv: kv[1]):
            v = None
            for b in program.blocks:
                v = b.vars.get(name)
                if v is not None:
                    break
            if v is None:
                vars_desc.append([i, None])
                continue
            vars_desc.append([i, [
                list(v.shape) if v.shape is not None else None,
                dtype_utils.name(v.dtype) if v.dtype is not None else None,
                bool(v.persistable), int(v.lod_level), str(v.type)]])

        self.desc = {
            "feeds": sorted(self.feed_names),
            "fetches": fetch_ids,
            "blocks": blocks_desc,
            "vars": vars_desc,
        }

    def cid(self, name: str) -> Optional[int]:
        """Canonical id of ``name`` (None when the program never
        mentions it — the caller must treat that as uncacheable)."""
        return self.canon.get(name)

    def local_name(self, i: int) -> Optional[str]:
        if not hasattr(self, "_inv"):
            self._inv = {v: k for k, v in self.canon.items()}
        return self._inv.get(i)

    def fingerprint(self,
                    feed_avals: Dict[str, Tuple],
                    state_avals: Dict[str, Tuple],
                    config: Optional[dict] = None,
                    env: Optional[dict] = None) -> str:
        """Hex fingerprint of this unit at concrete input types.

        ``feed_avals`` — {feed name: (shape, dtype)}; hashed under the
        raw feed names (sorted). ``state_avals`` — {state var name:
        (shape, dtype)}; hashed under canonical ids so param naming
        cannot split the cache. ``config`` — the site's knobs (its kind,
        the feed order, the trace's device, the program stamps).
        ``env`` — injectable for tests; defaults to the live
        :func:`environment_signature`.
        """
        state = []
        for n in sorted(state_avals, key=lambda n: self.canon.get(n, -1)):
            i = self.canon.get(n)
            shape, dtype = state_avals[n]
            state.append([i if i is not None else f"?{n}",
                          _aval_json(shape, dtype)])
        blob = {
            "format": FORMAT_VERSION,
            "desc": self.desc,
            "feed_avals": [[n, _aval_json(*feed_avals[n])]
                           for n in sorted(feed_avals)],
            "state_avals": state,
            "config": _canon_value(dict(config or {}), self._cid,
                                   self._var_names),
            "env": dict(env if env is not None
                        else environment_signature()),
        }
        data = json.dumps(blob, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(data.encode("utf-8")).hexdigest()


def module_fingerprint(text: str, env: Optional[dict] = None) -> str:
    """Content-address of a module's text (the unit is the module
    itself, no program desc needed) + the environment pin; the JAX
    package keys its native predictor's compiles so."""
    blob = {"format": FORMAT_VERSION, "kind": "pjrt_module",
            "sha": hashlib.sha256(text.encode("utf-8")).hexdigest(),
            "env": dict(env if env is not None
                        else environment_signature())}
    data = json.dumps(blob, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(data.encode("utf-8")).hexdigest()
