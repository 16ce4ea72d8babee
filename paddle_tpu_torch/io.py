"""Model persistence: save/load variables, params, persistables, and
the inference and decode models (counterpart of paddle_tpu/io.py, the
same files).

Replaces the reference's save/load op pair + Python wrappers
(reference: paddle/fluid/operators/save_op.cc:66, save_combine_op.cc:165;
python/paddle/fluid/io.py:85,200,248,291,550,653). Persistence is a host
operation over the Scope, with one ``.npz`` per save_combine-style call
or one ``.npy`` per var for save_vars parity. bfloat16 tensors are
written as the JAX package writes them, raw two-byte members
(``'<V2'``), and read back as bfloat16 where the program's variable,
the scope's tensor or the artifact's manifest names the dtype
(core/npz.py); else the read raises.

The inference model keeps the reference's two artifacts (io.py:550):
``__model__.json`` — the pruned program's symbol table and topology
(op types/slots/attrs), after the inference pass pipeline
(passes/manager.py) — and ``__params__.npz``. The JAX package also
lowers the forward to StableHLO for its native runner; the port's
counterpart (a ``torch.export`` artifact) is not built yet, so
``export_stablehlo=True`` takes the JAX package's best-effort branch:
it records ``stablehlo_error`` in the manifest and warns (ROADMAP
Queue A 6). The durable training-program artifact
(``save_trainable_program``) waits for the same item.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

from .core import dtype_utils, npz
from .core.enforce import EnforceError, enforce, not_ported
from .core.program import (Parameter, Program, Variable,
                           default_main_program)
from .core.scope import Scope, global_scope

__all__ = [
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model",
    "save_decode_model", "load_decode_model",
    "get_inference_program",
]

_NO_EXPORT = ("the torch.export artifact of the inference model (the "
              "StableHLO module's counterpart) is not ported yet (ROADMAP "
              "Queue A 6)")


def _is_persistable(var: Variable) -> bool:
    return bool(var.persistable)


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _scope_value(scope: Scope, name: str):
    """A host copy of a scope value (bfloat16 as raw two-byte bits)."""
    val = scope.find_var(name)
    enforce(val is not None, f"variable {name!r} has no value in scope "
            "(run the startup program first)")
    return npz.host_array(val)


def _place(executor):
    return getattr(executor, "place", None)


# -- save/load families (reference: io.py:85 save_vars etc.) -----------------

def save_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence] = None, predicate=None,
              filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> None:
    """reference: io.py:85. One file per var, or all in `filename` (the
    save_combine path, save_combine_op.cc:165) as an npz."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        enforce(predicate is not None, "need vars or predicate")
        vars = [v for v in program.list_vars() if predicate(v)]
    names = [v.name if isinstance(v, Variable) else str(v) for v in vars]
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        npz.savez(os.path.join(dirname, filename),
                  {n: _scope_value(scope, n) for n in names})
        return
    for n in names:
        npz.save(npz.npy_path(dirname, n), _scope_value(scope, n))


def save_params(executor, dirname: str, main_program=None, filename=None,
                scope=None) -> None:
    """reference: io.py:200."""
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename, scope=scope)


def save_persistables(executor, dirname: str, main_program=None,
                      filename=None, scope=None) -> None:
    """reference: io.py:248."""
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename, scope=scope)


def load_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence] = None, predicate=None,
              filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> None:
    """reference: io.py:291. Values land on the device of the scope's
    tensor of each name, else on ``executor``'s place.

    Fused flat state (``fuse_optimizer_state``): parameters are views of
    a flat buffer. When the file carries the flat buffer itself (a
    fused program's save), it loads once and the views are skipped;
    when it does not (an unfused program's save), the views are batched
    into one rebuild of the buffer per group (``ckpt.apply_state``)."""
    from .ckpt.restore import apply_state

    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        enforce(predicate is not None, "need vars or predicate")
        vars = [v for v in program.list_vars() if predicate(v)]
    names = [v.name if isinstance(v, Variable) else str(v) for v in vars]
    views = getattr(program, "_flat_state_views", None) or {}
    flats = {spec[0] for n, spec in views.items() if n in names}

    def _collect(get, available, where):
        state = {}
        for n in names:
            if available(n):
                state[n] = get(n)
                continue
            # a flat buffer rebuilt from its views, or a view whose flat
            # buffer the file carries
            covered = (n in flats and all(
                available(v) for v, s in views.items()
                if s[0] == n and v in names)) or (
                n in views and available(views[n][0]))
            enforce(covered, f"variable {n!r} missing from {where}")
        apply_state(scope, state, program, place=_place(executor))

    if filename is not None:
        path = os.path.join(dirname, filename)
        if not path.endswith(".npz"):
            path += ".npz"
        import numpy as np

        with np.load(path) as data:
            _collect(lambda n: data[n], lambda n: n in data.files, path)
        return

    import numpy as np

    _collect(lambda n: np.load(npz.npy_path(dirname, n)),
             lambda n: os.path.exists(npz.npy_path(dirname, n)), dirname)


def load_params(executor, dirname: str, main_program=None, filename=None,
                scope=None) -> None:
    """reference: io.py:407."""
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename, scope=scope)


def load_persistables(executor, dirname: str, main_program=None,
                      filename=None, scope=None) -> None:
    """reference: io.py:437."""
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename, scope=scope)


# -- inference model (reference: io.py:550,653) ------------------------------

def get_inference_program(target_vars, main_program=None) -> Program:
    """reference: io.py:480 — prune to inference targets."""
    program = main_program or default_main_program()
    targets = [v.name if isinstance(v, Variable) else str(v)
               for v in (target_vars if isinstance(target_vars, (list, tuple))
                         else [target_vars])]
    return program.prune(targets)


def _program_manifest(program: Program, feeds: List[str],
                      fetches: List[str]) -> dict:
    gb = program.global_block()
    return {
        "format_version": 1,
        "feed_names": feeds,
        "fetch_names": fetches,
        "vars": {
            name: {
                "shape": list(v.shape) if v.shape is not None else None,
                "dtype": dtype_utils.name(v.dtype),
                "persistable": bool(v.persistable),
                "is_data": bool(v.is_data),
                "parameter": isinstance(v, Parameter),
            } for name, v in gb.vars.items()
        },
        "ops": [
            {"type": op.type, "inputs": op.inputs, "outputs": op.outputs,
             "attrs": {k: v for k, v in op.attrs.items()
                       if isinstance(v, (int, float, str, bool, list,
                                         tuple, type(None)))}}
            for op in gb.ops
        ],
    }


def save_inference_model(dirname: str,
                         feeded_var_names: Sequence[str],
                         target_vars: Sequence,
                         executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None,
                         export_stablehlo: bool = True,
                         optimize: bool = True,
                         export_batch_sizes: Optional[Sequence[int]] = None
                         ) -> List[str]:
    """reference: io.py:550. Prunes to targets, runs the inference pass
    pipeline over the pruned program (``optimize``: transpose
    elimination, attention fusion, fc+act fusion, dead-code elimination;
    fused intermediates are no longer fetchable, which is the contract
    of the declared ``target_vars``), and saves ``__model__.json`` and
    ``__params__.npz`` — the persistables the pruned program's ops read.

    ``export_stablehlo`` (default on, as in the JAX package) records
    ``manifest["stablehlo_error"]`` and warns: the port's compiled
    artifact is not built yet (ROADMAP Queue A 6). An explicit
    ``export_batch_sizes`` request raises, as the JAX package does when
    the base lowering failed."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    target_vars = (target_vars if isinstance(target_vars, (list, tuple))
                   else [target_vars])
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    feeds = list(feeded_var_names)
    pruned = program.prune(fetch_names)
    if optimize:
        from .passes.manager import inference_pass_pipeline

        pruned = inference_pass_pipeline(fetch_names).apply(pruned)
    gb = pruned.global_block()

    os.makedirs(dirname, exist_ok=True)
    # persistables actually READ by the pruned program's ops — not every
    # persistable in the block (that would sweep in optimizer accumulators)
    read_names = set()
    for op in gb.ops:
        read_names.update(op.input_arg_names)
    param_names = sorted(
        n for n, v in gb.vars.items()
        if v.persistable and n in read_names)
    missing = [n for n in param_names if not scope.has_var(n)]
    enforce(not missing,
            "save_inference_model: params %s are not in the scope — run the "
            "startup program (and training) before exporting" % missing)
    npz.savez(os.path.join(dirname, params_filename or "__params__"),
              {n: _scope_value(scope, n) for n in param_names})

    manifest = _program_manifest(pruned, feeds, fetch_names)
    manifest["param_names"] = param_names

    if export_stablehlo:
        manifest["stablehlo_error"] = _NO_EXPORT
        warnings.warn("save_inference_model: StableHLO export failed (%s); "
                      "saving JSON program only" % _NO_EXPORT)
        if export_batch_sizes:
            raise EnforceError(
                "export_batch_sizes requested but the base StableHLO "
                "lowering failed: %s" % _NO_EXPORT)

    with open(os.path.join(dirname, model_filename or "__model__.json"),
              "w") as f:
        json.dump(manifest, f, indent=1)
    return fetch_names


def _load_params_file(path: str, scope: Scope, manifest: dict,
                      program: Optional[Program], place) -> None:
    """Every member of an artifact's params file into ``scope``; a raw
    two-byte member takes the dtype the manifest's var table records."""
    import numpy as np

    from .ckpt.restore import apply_state

    table = manifest.get("vars", {})
    state: Dict[str, object] = {}
    with np.load(path) as data:
        for n in data.files:
            a = data[n]
            rec = table.get(n)
            if npz.is_raw16(a) and rec is not None \
                    and rec.get("dtype") == "bfloat16":
                a = npz.to_tensor(a, "bfloat16", name=n)
            state[n] = a
    apply_state(scope, state, program, place=place)


def load_inference_model(dirname: str,
                         executor=None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None,
                         program: Optional[Program] = None):
    """reference: io.py:653. Returns (program, feed_names, fetch_names).

    The Python path needs the original in-memory ``program`` (op fns
    cannot be rebuilt from JSON): its pruned clone is returned with the
    params loaded into ``scope`` (on ``executor``'s place where the
    scope holds no tensor of that name). Without it this raises, as the
    JAX package does without its native runner."""
    scope = scope or global_scope()
    path = os.path.join(dirname, model_filename or "__model__.json")
    with open(path) as f:
        manifest = json.load(f)
    feeds, fetches = manifest["feed_names"], manifest["fetch_names"]
    params_path = os.path.join(dirname, params_filename or "__params__")
    if not params_path.endswith(".npz"):
        params_path += ".npz"
    _load_params_file(params_path, scope, manifest, program,
                      _place(executor))
    if program is not None:
        return program.prune(fetches), feeds, fetches
    raise EnforceError(
        "load_inference_model without the original Program needs a "
        "compiled artifact, which the port does not build yet (ROADMAP "
        "Queue A 6); pass `program=` for the Python path")


# ---------------------------------------------------------------------------
# Decode-serving artifact: the inference artifact plus a "decode_pair"
# manifest section describing the derived prefill/decode pair. The derived
# Programs are not serialized: the rewrite is a deterministic function of
# (base program, cache geometry), so the loader re-derives the pair.
# ---------------------------------------------------------------------------


def _unpallas(stamp: str) -> str:
    return stamp.replace("+pallas", "")


def save_decode_model(dirname: str, token_name: str, logits_var,
                      executor, main_program: Optional[Program] = None,
                      cache_config=None,
                      scope: Optional[Scope] = None,
                      sampling: bool = False) -> dict:
    """Export a decode-serving artifact for a causal forward program.

    Saves ``__model__.json`` + ``__params__.npz`` like
    :func:`save_inference_model` (un-optimized topology — the decode
    rewrite consumes the built forward as-is), then records the derived
    pair's wire contract under ``manifest["decode_pair"]``: cache
    geometry, per-layer KV pool specs, the prefill/decode feed/fetch
    surfaces and their stamps. Returns that section. ``sampling=True``
    and ``cache_config.kv_dtype`` are recorded only when on, as the JAX
    package records them."""
    from .decoding import CacheConfig, derive_decode_programs

    cache_config = cache_config or CacheConfig()
    program = main_program or default_main_program()
    logits_name = (logits_var.name if isinstance(logits_var, Variable)
                   else str(logits_var))
    pair = derive_decode_programs(program, token_name, logits_name,
                                  cache_config, sampling=sampling)
    save_inference_model(dirname, [token_name], [logits_name], executor,
                         main_program=program, scope=scope,
                         export_stablehlo=False, optimize=False)
    path = os.path.join(dirname, "__model__.json")
    with open(path) as f:
        manifest = json.load(f)
    section = {
        "token_name": token_name,
        "logits_name": logits_name,
        "cache": {
            "num_blocks": cache_config.num_blocks,
            "block_size": cache_config.block_size,
            "max_blocks_per_seq": cache_config.max_blocks_per_seq,
            "digest": cache_config.digest(),
        },
        **({"kv_dtype": cache_config.kv_dtype}
           if cache_config.kv_dtype else {}),
        **({"sampling": True} if sampling else {}),
        "prefill": {"feeds": pair.prefill_feeds, "fetches": pair.fetches,
                    "stamp": pair.prefill._decode_stamp},
        "decode": {"feeds": pair.decode_feeds, "fetches": pair.fetches,
                   "stamp": pair.decode._decode_stamp},
        "kv_pools": [{"name": n, "shape": [int(s) for s in shape],
                      "dtype": dtype_utils.name(dt)}
                     for n, shape, dt in pair.pool_specs],
        "pool_bytes": int(pair.pool_bytes),
        "n_layers": int(pair.n_layers),
    }
    manifest["decode_pair"] = section
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    return section


def load_decode_model(dirname: str, executor=None,
                      scope: Optional[Scope] = None,
                      program: Optional[Program] = None):
    """Load a :func:`save_decode_model` artifact — the port's or the JAX
    package's: params into ``scope``, then re-derive the prefill/decode
    pair at the recorded cache geometry. Returns ``(pair,
    decode_section)``.

    The re-derived pair's stamps must equal the recorded ones, ``+pallas``
    aside: it names the route the exporter's decode attention took (the
    port always takes the kernel; the JAX package only with
    ``pallas_paged_attention`` on), which changes no wire contract —
    feeds, fetches, pools and tokens are the same either way."""
    from .decoding import CacheConfig, derive_decode_programs

    path = os.path.join(dirname, "__model__.json")
    with open(path) as f:
        manifest = json.load(f)
    section = manifest.get("decode_pair")
    enforce(section is not None,
            "%s has no decode_pair section — was it saved with "
            "save_decode_model?" % path)
    base, _, _ = load_inference_model(dirname, executor, scope=scope,
                                      program=program)
    cache = CacheConfig(**{k: section["cache"][k]
                           for k in ("num_blocks", "block_size",
                                     "max_blocks_per_seq")},
                        kv_dtype=section.get("kv_dtype"))
    enforce(cache.digest() == section["cache"]["digest"],
            "decode_pair cache digest mismatch — manifest corrupt?")
    pair = derive_decode_programs(base, section["token_name"],
                                  section["logits_name"], cache,
                                  sampling=bool(
                                      section.get("sampling", False)))
    enforce(_unpallas(pair.prefill._decode_stamp)
            == _unpallas(section["prefill"]["stamp"])
            and _unpallas(pair.decode._decode_stamp)
            == _unpallas(section["decode"]["stamp"]),
            "re-derived pair stamps (%s, %s) disagree with the manifest's "
            "(%s, %s) — the decoding rewrite changed since this artifact "
            "was saved; re-export it"
            % (pair.prefill._decode_stamp, pair.decode._decode_stamp,
               section["prefill"]["stamp"], section["decode"]["stamp"]))
    return pair, section


# ---------------------------------------------------------------------------
# Durable TRAINING program artifact: not ported.
# ---------------------------------------------------------------------------


def save_trainable_program(dirname: str, feed_shapes: dict,
                           fetch_list: Sequence, executor=None,
                           main_program: Optional[Program] = None,
                           scope: Optional[Scope] = None) -> List[str]:
    """The serialized training step of the JAX package (``jax.export``):
    its counterpart needs the port's kernels as ``torch.library`` custom
    ops, which the port does not have yet."""
    raise not_ported("io.save_trainable_program (a serialized training "
                     "step)", "Queue A 6")


def load_trainable_program(dirname: str):
    """See :func:`save_trainable_program`."""
    raise not_ported("io.load_trainable_program (a serialized training "
                     "step)", "Queue A 6")
