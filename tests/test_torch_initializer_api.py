"""paddle_tpu_torch's ``fluid.initializer`` namespace and ``average``
held to paddle_tpu's.

* The namespace exports the JAX package's names, aliases included.
* ``Constant``, ``NumpyArrayInitializer`` and ``Bilinear`` draw nothing:
  their startup values are bit-equal to the JAX package's, in f32 and
  bf16.
* ``MSRA`` and ``Xavier`` draw from another generator than the JAX
  package's, so their values differ; each stays within its stated bound
  (uniform: |w| <= limit, and the draw spans most of it; normal: the
  sample's standard deviation within 10 % of the stated one at 16384
  draws, the mean within 0.05 of it).
* ``init_on_cpu`` toggles ``force_init_on_cpu`` and restores it;
  ``WeightedAverage`` gives the JAX package's averages and errors.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

from _torch_port import package

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()


def test_namespace_equals_the_jax_package():
    def public(mod):
        return sorted(n for n in dir(mod) if not n.startswith("_")
                      and n[0].isupper() or n in ("force_init_on_cpu",
                                                  "init_on_cpu"))

    assert public(tfluid.initializer) == public(jfluid.initializer)
    for n in public(jfluid.initializer):
        jv, tv = getattr(jfluid.initializer, n), getattr(tfluid.initializer,
                                                         n)
        if isinstance(jv, type) and n.endswith("Initializer") \
                and n not in ("Initializer", "NumpyArrayInitializer"):
            # an alias names the same class, in both packages
            base = n[:-len("Initializer")]
            assert tv is getattr(tfluid.initializer, base)
            assert jv is getattr(jfluid.initializer, base)
    assert tfluid.average.__all__ == jfluid.average.__all__
    for n in ("amp", "average", "initializer", "GradientAccumulation",
              "ModelAverage"):
        assert hasattr(tfluid, n) and hasattr(jfluid, n), n


def _init(pkg, make, shape, dtype="float32"):
    """The startup value of one parameter initialized by ``make(init)``,
    as float32 numpy."""
    fluid, guard = package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 9
    with guard(), fluid.program_guard(main, startup):
        fluid.layers.create_parameter(
            shape=list(shape), dtype=dtype,
            default_initializer=make(fluid.initializer), name="w")
    if pkg == "jax":
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            jfluid.Executor(jfluid.CPUPlace()).run(startup)
            return np.asarray(scope.find_var("w")).astype(np.float32)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    return tfluid.fetch_var("w", scope)


VALUE = np.random.RandomState(4).randn(3, 5).astype(np.float32)
EXACT = {
    "constant": (lambda i: i.Constant(0.37), (4, 6)),
    "numpy": (lambda i: i.NumpyArrayInitializer(VALUE), (3, 5)),
    "bilinear": (lambda i: i.Bilinear(), (2, 3, 4, 4)),
    "bilinear_odd": (lambda i: i.BilinearInitializer(), (1, 2, 3, 3)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EXACT))
def test_deterministic_initializers_are_bit_equal(case, dtype):
    make, shape = EXACT[case]
    want = _init("jax", make, shape, dtype)
    got = _init("torch", make, shape, dtype)
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


def test_bilinear_refuses_what_the_jax_package_refuses():
    for shape in ((3, 4), (1, 1, 3, 4)):
        with pytest.raises(ValueError):
            tfluid.initializer.Bilinear().make_fn(shape, torch.float32, 0)


RANDOM = {
    # name: (make, shape, kind, bound: the limit or the std)
    "msra_uniform": (lambda i: i.MSRA(), (256, 64), "uniform",
                     math.sqrt(6.0 / 256)),
    "msra_normal": (lambda i: i.MSRA(uniform=False), (256, 64), "normal",
                    math.sqrt(2.0 / 256)),
    "msra_conv": (lambda i: i.MSRAInitializer(fan_in=50), (64, 16, 4, 4),
                  "uniform", math.sqrt(6.0 / 50)),
    "xavier_uniform": (lambda i: i.Xavier(), (256, 64), "uniform",
                       math.sqrt(6.0 / 320)),
    "xavier_normal": (lambda i: i.Xavier(uniform=False), (256, 64),
                      "normal", math.sqrt(2.0 / 320)),
}


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_initializers_draw_within_their_bounds(case):
    make, shape, kind, bound = RANDOM[case]
    got = _init("torch", make, shape)
    want = _init("jax", make, shape)
    assert got.shape == want.shape == shape
    for w in (got, want):
        if kind == "uniform":
            assert np.abs(w).max() <= bound * (1 + 1e-6)
            assert np.abs(w).max() > 0.95 * bound
        else:
            assert abs(w.std() - bound) < 0.1 * bound
            assert abs(w.mean()) < 0.05 * bound


def test_init_on_cpu_toggles():
    init = tfluid.initializer
    assert init.force_init_on_cpu() is False
    with init.init_on_cpu():
        assert init.force_init_on_cpu() is True
        with init.init_on_cpu():
            assert init.force_init_on_cpu() is True
        assert init.force_init_on_cpu() is True
    assert init.force_init_on_cpu() is False
    assert jfluid.initializer.force_init_on_cpu() is False


def test_weighted_average_matches_the_jax_package():
    vals = [(1.5, 2), (np.array([1.0, 3.0]), 0.5), (4, 3.0)]
    outs = {}
    for fluid in (jfluid, tfluid):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            avg = fluid.average.WeightedAverage()
        assert any("deprecated" in str(w.message) for w in caught)
        with pytest.raises(ValueError, match="no data"):
            avg.eval()
        for v, w in vals:
            avg.add(v, w)
        outs[fluid.__name__] = avg.eval()
        with pytest.raises(ValueError, match="number"):
            avg.add("x", 1)
        with pytest.raises(ValueError, match="weight"):
            avg.add(1.0, "w")
        avg.reset()
        avg.add(1.0, 0)
        with pytest.raises(ValueError, match="can not be 0"):
            avg.eval()
    np.testing.assert_array_equal(outs["paddle_tpu_torch"],
                                  outs["paddle_tpu"])
