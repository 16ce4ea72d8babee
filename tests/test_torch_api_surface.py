"""The JAX package's public surface in the port: every line of
``tests/api_spec.txt`` (read only), ``paddle_tpu.<name>(<signature>)``,
has ``paddle_tpu_torch.<name>`` with the same signature string, unless
the table below lists it.

The table has two parts:

* ``DIFFERENCES``: names that are deliberately absent or whose signature
  deliberately differs, each with its reason, matched by name;
* ``LATER``: names that wait for a later slice of the port, matched by
  name or, for an entry ending in ".", by prefix.

The test fails on a name that is missing or whose signature differs and
is not listed, and on a listed name that no longer needs its entry (it
now exists, or its signature now agrees), so the table only shrinks.
"""

import importlib
import inspect
import os

import pytest
import torch

torch.set_num_threads(1)

_SPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "api_spec.txt")

# the JAX package's print_signatures module list
MODULES = [
    "paddle_tpu", "paddle_tpu.layers", "paddle_tpu.optimizer",
    "paddle_tpu.regularizer", "paddle_tpu.clip", "paddle_tpu.metrics",
    "paddle_tpu.io", "paddle_tpu.amp", "paddle_tpu.analysis",
    "paddle_tpu.compile_cache", "paddle_tpu.executor", "paddle_tpu.trainer",
    "paddle_tpu.checkpoint", "paddle_tpu.ckpt", "paddle_tpu.inference",
    "paddle_tpu.serving", "paddle_tpu.decoding", "paddle_tpu.fleet",
    "paddle_tpu.sharding", "paddle_tpu.passes", "paddle_tpu.ops",
    "paddle_tpu.tuning", "paddle_tpu.resilience", "paddle_tpu.obs",
    "paddle_tpu.parallel", "paddle_tpu.reader",
    "paddle_tpu.reader.decorator", "paddle_tpu.v2.layer",
    "paddle_tpu.v2.networks",
]

_PLACE = ("a ``place=`` the JAX package does not take: the port's entry "
          "points run on the card unless the caller asks for the CPU")
_MESH = ("a mesh is named axes over torch devices and ranks of a "
         "torch.distributed world, not a jax.sharding.Mesh")
_TORCH_TYPES = "the annotation names a torch type where the JAX one names jax"

# deliberate differences: absent names and differing signatures
DIFFERENCES = {
    # absent
    "paddle_tpu.compile_cache.load_or_compile_hlo":
        "the port compiles no HLO module: its compile cache keeps tuned "
        "kernel configs and CUDA-graph capture fingerprints",
    "paddle_tpu.layers.List":
        "a typing name that leaks from the JAX layers/__init__.py",
    "paddle_tpu.layers.Optional":
        "a typing name that leaks from the JAX layers/__init__.py",
    "paddle_tpu.layers.Sequence":
        "a typing name that leaks from the JAX layers/__init__.py",
    "paddle_tpu.layers.Union":
        "a typing name that leaks from the JAX layers/__init__.py",
    # differing signatures
    "paddle_tpu.ParallelExecutor": _PLACE,
    "paddle_tpu.parallel.ParallelExecutor": _PLACE,
    "paddle_tpu.checkpoint.apply_state": _PLACE,
    "paddle_tpu.checkpoint.restore": _PLACE,
    "paddle_tpu.ckpt.apply_state": _PLACE,
    "paddle_tpu.ckpt.restore": _PLACE,
    "paddle_tpu.checkpoint.save_checkpoint":
        "the state may hold torch tensors (Dict[str, Any]), not only "
        "numpy arrays",
    "paddle_tpu.ckpt.save_checkpoint":
        "the state may hold torch tensors (Dict[str, Any]), not only "
        "numpy arrays",
    "paddle_tpu.amp.device_all_finite": _TORCH_TYPES,
    "paddle_tpu.executor.place_to_device":
        "returns the place's torch.device, not a jax.Device",
    "paddle_tpu.executor.run_program_ops":
        _TORCH_TYPES + "; ``device=`` places constant ops' tensors",
    "paddle_tpu.executor.FetchHandle":
        "``event=``: the CUDA event recorded after the run, which "
        "is_ready and block_until_ready wait for",
    "paddle_tpu.decoding.DecodeEngine":
        "DecodeMetrics annotation, and two private switches "
        "(``_capture`` eager runs on a card, ``_share_pool`` a graph "
        "pool per graph) for comparisons",
    "paddle_tpu.layers.switch_moe":
        "``mesh=``: the expert-parallel mesh of the torch.distributed "
        "world (the JAX package reads its mesh from the trace context)",
    "paddle_tpu.make_mesh": _MESH,
    "paddle_tpu.parallel.make_mesh": _MESH,
    "paddle_tpu.sharding.make_mesh": _MESH,
    "paddle_tpu.parallel.DeviceMesh": _MESH,
    "paddle_tpu.sharding.DeviceMesh": _MESH,
    "paddle_tpu.sharding.training_mesh": _MESH,
    "paddle_tpu.parallel.ring_attention": _MESH,
    "paddle_tpu.sharding.resolve_sharding":
        "returns the port's Layout (the blocks each rank holds), not a "
        "jax NamedSharding",
    "paddle_tpu.parallel.ShardedEmbedding":
        "its default dtype is torch.float32, not jax.numpy.float32",
    "paddle_tpu.sharding.ShardedEmbedding":
        "its default dtype is torch.float32, not jax.numpy.float32",
    "paddle_tpu.parallel.ReduceStrategy":
        "an Enum's constructor signature as this Python renders it",
    "paddle_tpu.parallel.init_distributed":
        "``backend=``: the torch.distributed backend (nccl on cards, "
        "gloo on the CPU)",
    "paddle_tpu.passes.inference_pipeline":
        "the return annotation renders as the port's qualified "
        "PassManager",
    "paddle_tpu.reader.prefetch_to_device":
        "``place=`` (a device place) instead of a jax ``sharding=``",
    "paddle_tpu.ops.flash_attention":
        "no ``interpret``/``block_q``/``block_k``: Pallas knobs; the "
        "Hopper kernel picks its own tiles and has no interpret mode",
    "paddle_tpu.ops.paged_window_attention":
        "``route=``/``config=`` select the Hopper kernel's route and "
        "launch config instead of the Pallas ``schedule``/"
        "``heads_per_tile``/``interpret``",
    "paddle_tpu.tuning.chained_grad_scan":
        "its timed closure returns the grads' tuple on the card",
    "paddle_tpu.tuning.current_device_kind":
        "``device=``: the torch device whose kind is asked for",
    "paddle_tpu.tuning.lookup":
        "``device=``: the torch device the record is for",
    "paddle_tpu.tuning.measure_min_ms":
        "``device=``/``host_paced=``: CUDA-event timing on a device",
    "paddle_tpu.tuning.sweep":
        "``device=`` instead of the Pallas ``interpret=``",
}

# names that wait for a later slice of the port
LATER = {
    "paddle_tpu.v2.": "v2 waits for its slice (ROADMAP Queue A (h4))",
}
for _reader in ("Preprocessor", "batch", "double_buffer", "load",
                "open_files", "open_recordio_file", "py_reader",
                "random_data_generator", "read_file", "shuffle"):
    LATER["paddle_tpu.layers." + _reader] = (
        "a reader of layers/io.py, waits for its slice (ROADMAP Queue A "
        "(h3))")


def _sig(obj) -> str:
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    return s.replace("'", "")


def _spec():
    out = []
    for line in open(_SPEC).read().splitlines():
        full, sig = line[:line.index("(")], line[line.index("("):]
        mod = max((m for m in MODULES if full.startswith(m + ".")),
                  key=len)
        out.append((full, mod, full[len(mod) + 1:], sig))
    return out


def _lookup(mod, name):
    """(found, signature) of the port's counterpart."""
    try:
        m = importlib.import_module("paddle_tpu_torch"
                                    + mod[len("paddle_tpu"):])
    except ImportError:
        return False, None
    obj = getattr(m, name, None)
    if obj is None:
        return False, None
    return True, _sig(obj.__init__ if inspect.isclass(obj) else obj)


def _listed(full):
    """The reason the table gives for ``full``, or None."""
    if full in DIFFERENCES:
        return DIFFERENCES[full]
    for prefix, why in LATER.items():
        if full == prefix or (prefix.endswith(".")
                              and full.startswith(prefix)):
            return why
    return None


def test_every_jax_name_is_in_the_port_or_listed():
    missing, differ = [], []
    for full, mod, name, sig in _spec():
        found, got = _lookup(mod, name)
        if _listed(full) is not None:
            continue
        if not found:
            missing.append(full)
        elif got != sig:
            differ.append("%s\n    jax:  %s\n    port: %s"
                          % (full, sig, got))
    assert not missing and not differ, (
        "MISSING (%d):\n  " % len(missing) + "\n  ".join(missing)
        + "\nDIFFERING (%d):\n  " % len(differ) + "\n  ".join(differ))


def test_the_table_only_lists_what_needs_it():
    """A listed absent name that now exists, or a listed signature that
    now agrees, must leave the table."""
    stale = []
    spec = {full: (mod, name, sig) for full, mod, name, sig in _spec()}
    for full in DIFFERENCES:
        assert full in spec, "%s is not in the JAX spec" % full
        mod, name, sig = spec[full]
        found, got = _lookup(mod, name)
        if found and got == sig:
            stale.append(full)
    for full in LATER:
        if full.endswith("."):
            continue
        mod, name, _ = spec[full]
        if _lookup(mod, name)[0]:
            stale.append(full)
    assert not stale, "listed but no longer needed: %s" % stale


@pytest.mark.parametrize("name", [
    "save_vars", "save_params", "save_persistables", "save_inference_model",
    "load_vars", "load_params", "load_persistables", "load_inference_model",
    "GradientClipByValue", "GradientClipByNorm", "GradientClipByGlobalNorm",
    "ErrorClipByValue", "set_gradient_clip", "default_place", "get_var",
    "calc_gradient", "WeightNormParamAttr", "CUDAPinnedPlace", "Tensor",
    "TPUPlace", "is_compiled_with_tpu", "force_cpu"])
def test_top_level_names(name):
    """The top-level names the port lacked before this slice, each the
    object of the module that defines it."""
    import paddle_tpu_torch as fluid

    assert getattr(fluid, name) is not None
    if name.startswith(("save_", "load_")):
        assert getattr(fluid, name) is getattr(fluid.io, name)
    if name in ("GradientClipByValue", "GradientClipByNorm",
                "GradientClipByGlobalNorm", "ErrorClipByValue",
                "set_gradient_clip"):
        assert getattr(fluid, name) is getattr(fluid.clip, name)


def test_places():
    """``TPUPlace`` is the card's place, ``is_compiled_with_tpu()`` is
    False, ``place_to_device`` gives the torch device, and
    ``CUDAPinnedPlace`` needs a card like ``CUDAPlace``."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import place_to_device

    assert fluid.TPUPlace is fluid.CUDAPlace
    assert fluid.is_compiled_with_tpu() is False
    assert place_to_device(fluid.CPUPlace()) == torch.device("cpu")
    if not torch.cuda.is_available():
        for cls in (fluid.CUDAPlace, fluid.CUDAPinnedPlace):
            with pytest.raises(fluid.EnforceError):
                cls(0)


def test_program_token_and_reexports():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference, layers
    from paddle_tpu_torch.executor import program_token

    a, b = fluid.Program(), fluid.Program()
    ta = program_token(a)
    assert program_token(a) == ta and program_token(b) != ta
    assert inference.EnforceError is fluid.EnforceError
    assert layers.Variable is fluid.Variable
    assert layers.LayerHelper("fc").layer_type == "fc"
    with pytest.raises(fluid.EnforceError):
        layers.enforce(False, "no")
    assert fluid.ops.flash_attention is importlib.import_module(
        "paddle_tpu_torch.ops.flash_attention").flash_attention
    assert fluid.ops.xla_window_attention is fluid.ops.plain_window_attention
