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
(passes/manager.py) — and ``__params__.npz``. Where the JAX package
lowers the forward to StableHLO for its native runner, the port exports
it with ``torch.export`` (``__model__.pt2`` and one program per batch
bucket), which ``inference.NativePredictor`` runs. The durable
training-program artifact (``save_trainable_program``) exports the whole
step the same way.
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


def _batch_feeds(gb, feeds: Sequence[str], batch: int):
    """Zero tensors of each feed at ``batch``: the leading -1 is the
    batch axis, any other unknown dim 1 (as the JAX package lowers);
    None when a feed has no declared shape."""
    import torch

    out = []
    for n in feeds:
        v = gb._find_var_recursive(n)
        if v is None or v.shape is None:
            return None
        shape = tuple((batch if i == 0 else 1) if s == -1 else s
                      for i, s in enumerate(v.shape))
        out.append(torch.zeros(shape, dtype=dtype_utils.to_torch(v.dtype)))
    return out


def _shapes(tensors) -> List[tuple]:
    """(shape, dtype) of each tensor: the avals of a compile-cache key."""
    return [(tuple(t.shape), t.dtype) for t in tensors]


def _export_inference(dirname: str, program: Program, feeds: List[str],
                      fetch_names: List[str], param_names: List[str],
                      scope: Scope, manifest: dict,
                      export_batch_sizes: Optional[Sequence[int]]) -> None:
    """``save_inference_model``'s compiled artifact, the counterpart of
    the JAX package's StableHLO modules: the pruned forward exported with
    ``torch.export`` (``executor.export_program_ops``: feeds, then the
    parameters in ``param_names`` order, in; the fetches out) at batch 1
    as ``__model__.pt2`` and at each of ``export_batch_sizes`` as
    ``__model__.b<N>.pt2``, recorded under ``torch_export``,
    ``torch_export_batch_size`` and ``torch_export_buckets``
    (``torch_export_feeds``: the feeds the graph takes, those an op
    reads). The trace runs on the device the scope's parameters lie on;
    the loader moves the graph to its own. With the ``compile_cache_dir``
    flag set each bucket goes through ``compile_cache.runtime.
    cached_export``: a stored export of the same program at the same
    shapes is written verbatim instead of traced. An explicit bucket request is validated first
    and raises where it cannot be met; the batch-1 export is best-effort
    (a failure is recorded in ``torch_export_error`` with a warning, the
    JSON program staying canonical)."""
    import torch

    from .compile_cache import runtime as cc_runtime
    from .executor import export_program_ops, live_ops

    gb = program.global_block()
    if export_batch_sizes:
        for bsz in export_batch_sizes:
            enforce(int(bsz) >= 1, "export_batch_sizes must be >= 1")
        # a fixed-shape feed would bake its own batch into every bucket
        shapes = {n: getattr(gb._find_var_recursive(n), "shape", None)
                  for n in feeds}
        bad = [n for n, shape in shapes.items()
               if not shape or shape[0] != -1]
        enforce(not bad,
                "export_batch_sizes requires feeds with a declared -1 "
                "leading batch axis; offending feeds: %s" % bad)
    params = [scope.get(n) for n in param_names]
    device = params[0].device if params else torch.device("cpu")
    ops = live_ops(program, fetch_names)
    # a feed no op reads (a loss-only mask of a pruned training program)
    # is no input of the graph
    read = {n for op in ops for n in op.input_arg_names}
    graph_feeds = [n for n in feeds if n in read]

    def export(batch, fname):
        example = [f.to(device) for f in _batch_feeds(gb, graph_feeds,
                                                      batch)]
        # through the compile cache (with its flag set, a stored export
        # of this program at these shapes is written verbatim: the
        # parameters are graph inputs, so no weight is in it)
        data, _ = cc_runtime.cached_export(
            program, graph_feeds, fetch_names,
            dict(zip(graph_feeds, _shapes(example))),
            dict(zip(param_names, _shapes(params))),
            {"kind": "export", "device": cc_runtime._device_tag(device)},
            lambda: (export_program_ops(ops, graph_feeds, param_names,
                                        example + params,
                                        fetch_names)[0], {}))
        with open(os.path.join(dirname, fname), "wb") as f:
            f.write(data)

    if _batch_feeds(gb, graph_feeds, 1) is not None:
        try:
            export(1, "__model__.pt2")
            manifest["torch_export"] = "__model__.pt2"
            manifest["torch_export_batch_size"] = 1
            manifest["torch_export_feeds"] = graph_feeds
        except Exception as e:
            manifest["torch_export_error"] = "%s: %s" % (type(e).__name__,
                                                         e)
            warnings.warn("save_inference_model: torch.export failed (%s: "
                          "%s); saving JSON program only"
                          % (type(e).__name__, e))
    if export_batch_sizes:
        enforce("torch_export" in manifest,
                "export_batch_sizes requested but the batch-1 export "
                "failed: %s" % manifest.get("torch_export_error",
                                            "feeds lack declared shapes"))
        buckets = {}
        for bsz in sorted(set(int(b) for b in export_batch_sizes)):
            fname = ("__model__.pt2" if bsz == 1
                     else "__model__.b%d.pt2" % bsz)
            if bsz != 1:
                export(bsz, fname)
            buckets[str(bsz)] = fname
        manifest["torch_export_buckets"] = buckets


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

    ``export_stablehlo`` (default on; the JAX package's name is kept
    for callers) writes the compiled artifact, the forward exported with
    ``torch.export`` at batch 1, and ``export_batch_sizes`` one program
    per bucket (:func:`_export_inference`)."""
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
    # a parameter stored in another dtype than its variable declares
    # (cast by transpile_to_bfloat16): the loader reads it as stored
    stored = {n: dtype_utils.name(scope.get(n).dtype) for n in param_names
              if hasattr(scope.get(n), "dtype")}
    cast = {n: d for n, d in stored.items()
            if d != manifest["vars"].get(n, {}).get("dtype")}
    if cast:
        manifest["param_dtypes"] = cast

    # tuned kernel configs ship WITH the artifact: the deployment host
    # seeds its tuning store from the manifest, so its kernels launch
    # with the exporter's measured configs without sweeping. Key ABSENT
    # when nothing is tuned — untuned manifests stay as they were.
    from . import tuning as _tuning

    tuned = _tuning.export_configs(pruned)
    if tuned:
        manifest["tuned_configs"] = tuned

    if export_stablehlo:
        _export_inference(dirname, pruned, feeds, fetch_names, param_names,
                          scope, manifest, export_batch_sizes)

    with open(os.path.join(dirname, model_filename or "__model__.json"),
              "w") as f:
        json.dump(manifest, f, indent=1)
    return fetch_names


def _manifest_dtype(manifest: dict, name: str) -> Optional[str]:
    """The dtype an artifact's manifest records for ``name``: the stored
    one (``param_dtypes``: a parameter cast by ``transpile_to_bfloat16``)
    or else the var table's."""
    return (manifest.get("param_dtypes", {}).get(name)
            or manifest.get("vars", {}).get(name, {}).get("dtype"))


def _load_params_file(path: str, scope: Scope, manifest: dict,
                      program: Optional[Program], place) -> None:
    """Every member of an artifact's params file into ``scope``; a raw
    two-byte member takes the dtype the manifest records."""
    import numpy as np

    from .ckpt.restore import apply_state

    state: Dict[str, object] = {}
    with np.load(path) as data:
        for n in data.files:
            a = data[n]
            if npz.is_raw16(a) and _manifest_dtype(manifest, n) \
                    == "bfloat16":
                a = npz.to_tensor(a, "bfloat16", name=n)
            state[n] = a
    apply_state(scope, state, program, place=place)


def _seed_tuned_configs(manifest: dict) -> int:
    """Seed this process's tuning memo (and store, when one is active)
    from an artifact manifest's ``tuned_configs`` — records for another
    device kind or kernel version are skipped, a local sweep's entry is
    never overwritten. Returns the number seeded."""
    if not manifest.get("tuned_configs"):
        return 0
    from . import tuning as _tuning

    return _tuning.seed_configs(manifest["tuned_configs"])


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
    scope holds no tensor of that name). Without it this raises, naming
    the exported artifact's runner, ``inference.NativePredictor``."""
    scope = scope or global_scope()
    path = os.path.join(dirname, model_filename or "__model__.json")
    with open(path) as f:
        manifest = json.load(f)
    feeds, fetches = manifest["feed_names"], manifest["fetch_names"]
    _seed_tuned_configs(manifest)
    params_path = os.path.join(dirname, params_filename or "__params__")
    if not params_path.endswith(".npz"):
        params_path += ".npz"
    _load_params_file(params_path, scope, manifest, program,
                      _place(executor))
    if program is not None:
        return program.prune(fetches), feeds, fetches
    raise EnforceError(
        "load_inference_model without the original Program cannot "
        "rebuild its op fns from JSON: pass `program=` for the Python "
        "path, or run the exported artifact with "
        "paddle_tpu_torch.inference.create_paddle_predictor")


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
    # tuned configs for the DERIVED pair too (its op set differs from
    # the base forward's): same manifest key, loaders seed from it
    from . import tuning as _tuning

    tuned = _tuning.export_configs(program, pair.prefill, pair.decode)
    if tuned:
        manifest["tuned_configs"] = tuned
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
# Durable TRAINING program artifact: the whole step (forward, backward, the
# optimizer's updates) exported with torch.export, beside the persistable
# state and a symbol manifest. A fresh process loads it and continues
# training bit for bit, without the Python code that built the program. One
# artifact per feed-shape specialization.
# ---------------------------------------------------------------------------


def save_trainable_program(dirname: str, feed_shapes: dict,
                           fetch_list: Sequence, executor=None,
                           main_program: Optional[Program] = None,
                           scope: Optional[Scope] = None) -> List[str]:
    """Serialize the whole training step and its state so that a new
    process continues training (the JAX package's ``jax.export``
    artifact; reference: io.py:550 persisting the ProgramDesc with
    save_persistables).

    ``feed_shapes``: ``{feed name: shape}``, the batch specialization to
    export (dtypes from the program's symbol table). Writes
    ``__train_step__.pt2`` (``executor.export_program_ops``: the feeds
    in sorted order, then the state in ``train_state_names`` order, in;
    the fetches and the state written out of place out),
    ``__train_state__.npz`` (bf16 as raw two-byte members) and
    ``__train__.json`` (the JAX package's manifest keys, plus
    ``train_written_outputs``). The step is traced on the device the
    scope's state lies on. A program whose backward recomputes its
    forward (``memory_optimize(level>=1)``, the ``remat_policy`` pass)
    is refused: its checkpointed regions are not exported. With the
    ``compile_cache_dir`` flag set the step goes through the compile
    cache as ``save_inference_model``'s buckets do."""
    import torch

    from .compile_cache import runtime as cc_runtime
    from .executor import (_analyze_program_io, _reject_view_feeds,
                           _resolve_remat, _written_persistables,
                           export_program_ops, live_ops)

    program = main_program or default_main_program()
    scope = scope or global_scope()
    if _resolve_remat(program):
        raise not_ported("save_trainable_program of a program that "
                         "recomputes its forward (memory_optimize level "
                         ">= 1, remat_policy)", "Queue A 6")
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in (fetch_list if isinstance(fetch_list,
                                                      (list, tuple))
                             else [fetch_list])]
    gb = program.global_block()
    produced, needed, view_produced = _analyze_program_io(program)
    _reject_view_feeds(feed_shapes, view_produced)
    needed |= {n for n in fetch_names if n not in produced}
    state_names = tuple(sorted(
        n for n in needed if n not in feed_shapes and n not in
        view_produced and scope.has_var(n)))
    missing = [n for n in needed
               if n not in feed_shapes and not scope.has_var(n)
               and n not in produced]
    enforce(not missing,
            "save_trainable_program: %s neither fed nor in scope — run "
            "the startup program first" % missing)
    written_state = _written_persistables(program)
    feeds = sorted(feed_shapes)
    state = [scope.get(n) for n in state_names]
    device = state[0].device if state else torch.device("cpu")
    example = []
    for n in feeds:
        v = gb._find_var_recursive(n)
        enforce(v is not None, "unknown feed %r" % n)
        example.append(torch.zeros(
            tuple(int(s) for s in feed_shapes[n]),
            dtype=dtype_utils.to_torch(v.dtype or "float32"), device=device))
    def produce():
        exported, written_out = export_program_ops(
            live_ops(program, fetch_names), feeds, state_names,
            example + state, fetch_names, written_state)
        return exported, {"written_out": written_out}

    # through the compile cache, as _export_inference's buckets; the
    # names of the state the graph returns come back with the entry
    data, extra = cc_runtime.cached_export(
        program, feeds, fetch_names, dict(zip(feeds, _shapes(example))),
        dict(zip(state_names, _shapes(state))),
        {"kind": "export", "device": cc_runtime._device_tag(device),
         "written": list(written_state)}, produce)
    written_out = list(extra["written_out"])
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "__train_step__.pt2"), "wb") as f:
        f.write(data)
    npz.savez(os.path.join(dirname, "__train_state__"),
              {n: npz.host_array(t) for n, t in zip(state_names, state)})
    manifest = _program_manifest(program, feeds, fetch_names)
    manifest["train_feed_shapes"] = {n: list(map(int, s))
                                     for n, s in feed_shapes.items()}
    manifest["train_state_names"] = list(state_names)
    manifest["train_written_state"] = list(written_state)
    manifest["train_written_outputs"] = written_out
    manifest["torch_export"] = "__train_step__.pt2"
    with open(os.path.join(dirname, "__train__.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return fetch_names


def _npz_tensors(path: str, manifest: dict, device) -> Dict[str, object]:
    """Every member of an artifact's ``.npz`` as a tensor on ``device``;
    a raw two-byte member takes the dtype the manifest records (and
    raises where that is not bfloat16)."""
    import numpy as np

    with np.load(path) as data:
        return {n: npz.to_tensor(
            data[n], _manifest_dtype(manifest, n)
            if npz.is_raw16(data[n]) else None, device, name=n)
            for n in data.files}


def load_exported(path: str, device):
    """A ``torch.export`` artifact moved to ``device`` (the tensors its
    ops made on the exporter's device included): its module."""
    import torch
    from torch.export.passes import move_to_device_pass

    # the modules that register the graph's custom ops
    from .layers import nn  # noqa: F401
    from .ops import (dropout, flash_attention,  # noqa: F401
                      fused_optimizer, paged_attention)

    return move_to_device_pass(torch.export.load(path),
                               str(device)).module()


class TrainableProgram:
    """A reloaded training program (:func:`load_trainable_program`): one
    step per :meth:`run`, the state carried on the artifact's device in
    tensors that never move, so a captured CUDA graph can read and write
    them."""

    def __init__(self, module, manifest: dict, state: Dict[str, object],
                 device):
        import torch

        self._module = module
        self.manifest = manifest
        self.device = torch.device(device)
        self.feed_names = list(manifest["feed_names"])
        self.fetch_names = list(manifest["fetch_names"])
        self.feed_shapes = {n: tuple(s) for n, s in
                            manifest["train_feed_shapes"].items()}
        self._state_names = list(manifest["train_state_names"])
        self._written_out = list(manifest["train_written_outputs"])
        self._state = dict(state)
        table = manifest["vars"]
        self._feed_dtypes = {n: dtype_utils.to_torch(
            table.get(n, {}).get("dtype") or "float32")
            for n in self.feed_names}
        # steps -> the captured step of run_steps on a card
        self._graphs: Dict[int, "_StepGraph"] = {}

    def _feed(self, feed: dict, lead: tuple = ()):
        import numpy as np
        import torch

        enforce(set(feed) == set(self.feed_shapes),
                "TrainableProgram: feed must provide exactly %s"
                % sorted(self.feed_shapes))
        out = []
        for n in self.feed_names:
            a = feed[n]
            t = a if isinstance(a, torch.Tensor) \
                else torch.as_tensor(np.asarray(a))
            want = lead + self.feed_shapes[n]
            enforce(tuple(t.shape) == want,
                    "feed %r shape %s != exported specialization %s (one "
                    "artifact per shape; re-export for new shapes)"
                    % (n, tuple(t.shape), want))
            out.append(t.to(device=self.device,
                            dtype=self._feed_dtypes[n]))
        return out

    def _step(self, feeds) -> list:
        """One step over the state tensors: the fetches (new tensors);
        the state written out of place is copied into its tensor."""
        outs = self._module(*feeds,
                            *[self._state[n] for n in self._state_names])
        k = len(self.fetch_names)
        for n, v in zip(self._written_out, outs[k:]):
            if n in self._state:
                self._state[n].copy_(v)
            else:
                self._state[n] = v.clone()
        return list(outs[:k])

    def run(self, feed: dict, fetch_list=None, return_numpy: bool = True):
        """One step; the fetches (host arrays, or tensors without
        ``return_numpy``)."""
        from .executor import _to_numpy

        fetches = self._step(self._feed(feed))
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def run_steps(self, feed: dict, steps: int, return_numpy: bool = True):
        """``steps`` steps in one call, exactly ``steps`` calls of
        :meth:`run`: every feed carries a leading ``steps`` axis over the
        exported shape; the fetches come back stacked on it. On the CPU
        a loop of steps; on a card one captured CUDA graph of the step,
        replayed (a graph per ``steps``; its first call runs the first
        step eagerly and captures, as ``Executor.run_steps`` does)."""
        import torch

        from .executor import _to_numpy

        enforce(int(steps) >= 1, "steps must be >= 1")
        steps = int(steps)
        feeds = self._feed(feed, lead=(steps,))
        if self.device.type != "cuda":
            outs = [self._step([f[i] for f in feeds]) for i in range(steps)]
            stacked = [torch.stack([o[k] for o in outs])
                       for k in range(len(self.fetch_names))]
        else:
            graph = self._graphs.get(steps)
            if graph is None:
                graph = self._graphs[steps] = _StepGraph(self, feeds)
            stacked = graph(feeds)
        if return_numpy:
            return [_to_numpy(f) for f in stacked]
        return stacked

    def state_dict(self) -> Dict[str, object]:
        """The state tensors by name (live: the next step updates them)."""
        return dict(self._state)

    def save_state(self, dirname: str) -> None:
        """Write the state back into the artifact's ``__train_state__``."""
        npz.savez(os.path.join(dirname, "__train_state__"),
                  {n: npz.host_array(t) for n, t in self._state.items()})


class _StepGraph:
    """``steps`` steps of a :class:`TrainableProgram` on a card as one
    captured CUDA graph of the step, replayed: the feeds stacked in a
    buffer whose row a step counter on the card selects, the fetches
    written to the rows of a stacked buffer, the state in the program's
    own tensors. The first call runs step 0 eagerly on the capture
    stream (lazy initializations cannot be captured), then captures one
    step and replays it ``steps - 1`` times; later calls replay
    ``steps`` times. Launch counts count the replays."""

    def __init__(self, prog: TrainableProgram, feeds):
        import torch

        self.prog = prog
        self.steps = int(feeds[0].shape[0]) if feeds else 1
        self.feeds = [torch.empty_like(f) for f in feeds]
        self.idx = torch.zeros(1, dtype=torch.int64, device=prog.device)
        self.out = None
        self.graph = None
        self.per_replay = {}
        self.stream = torch.cuda.Stream(prog.device)

    def _one(self, out):
        import torch

        fetches = self.prog._step([b.index_select(0, self.idx)[0]
                                   for b in self.feeds])
        with torch.no_grad():
            if out is not None:
                for buf, v in zip(out, fetches):
                    buf.index_copy_(0, self.idx, v.unsqueeze(0))
            self.idx.add_(1)
        return fetches

    def __call__(self, feeds):
        import torch

        from .executor import capture_graph
        from .ops import _cuda

        self.idx.zero_()
        for buf, f in zip(self.feeds, feeds):
            buf.copy_(f)
        replays = self.steps
        if self.graph is None:
            main = torch.cuda.current_stream(self.prog.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                first = self._one(None)
            main.wait_stream(self.stream)
            for v in first:  # allocated on the side stream, read here
                v.record_stream(main)
            self.out = [torch.empty((self.steps,) + tuple(v.shape),
                                    dtype=v.dtype, device=self.prog.device)
                        for v in first]
            for buf, v in zip(self.out, first):
                buf[0].copy_(v)
            self.graph, self.per_replay = capture_graph(
                lambda: self._one(self.out), self.prog.device, self.stream,
                caller="TrainableProgram.run_steps (the eager first step "
                "had already updated the state)")
            replays = self.steps - 1
        for _ in range(replays):
            self.graph.replay()
        _cuda.add_launches(self.per_replay, replays)
        return [o.clone() for o in self.out]


def load_trainable_program(dirname: str, place=None) -> TrainableProgram:
    """Reload a :func:`save_trainable_program` artifact in any process,
    onto ``place`` (default ``CUDAPlace(0)``, which raises on a host
    without a card): a :class:`TrainableProgram` whose ``run(feed)``
    continues training where the saved state left off."""
    from .core.place import default_place

    place = place if place is not None else default_place()
    device = place.torch_device()
    with open(os.path.join(dirname, "__train__.json")) as f:
        manifest = json.load(f)
    enforce("torch_export" in manifest,
            "%s has no torch_export artifact (a JAX-written directory "
            "holds __train_step__.bin, which the port cannot run)"
            % dirname)
    module = load_exported(os.path.join(dirname, manifest["torch_export"]),
                           device)
    state = _npz_tensors(os.path.join(dirname, "__train_state__.npz"),
                         manifest, device)
    return TrainableProgram(module, manifest, state, device)
