"""The optimizer family of paddle_tpu_torch held to paddle_tpu's.

Momentum (plain and Nesterov), Adamax, DecayedAdagrad, Adadelta,
RMSProp (plain and centered, with momentum), Ftrl (lr_power -0.5 and
-0.25), ProximalGD and ProximalAdagrad:

* on a small two-``fc`` regression program built with the same calls
  in both packages, three steps from the JAX package's start state
  (``state_from_numpy``), in the per-parameter layout and under
  ``fuse_optimizer_state`` (the JAX package's group op through its
  Pallas kernel, ``pallas_fused_update``, in interpret mode), with f32
  and bf16 moments: losses within rtol 1e-5; every persistable within
  the cross-package rule of ROADMAP Queue C 2 — f32 rtol 1e-6 plus 1e-7
  of the buffer's max (XLA contracts ``a*b + c`` into a fused
  multiply-add, the port rounds op by op), bf16 moments within one bf16
  ulp;
* in the port, the flat-group route bit-equal to the per-parameter
  route (both run ``plain_flat_update`` of the kind on the CPU), but
  for Ftrl's power branch: torch's CPU ``pow`` takes a vectorized path
  over a long tensor and a scalar one over a short tensor's tail, and
  the two part in the last bit (on the card every element takes the
  same ``powf``), so there the routes agree within the cross-package
  rule below;
* every kind, SGD, Adagrad and Adam included, against the numpy
  recursions of tests/test_optimizer_oracles.py (the reference's
  per-op unit tests) over four steps of a linear model, in both
  layouts: rtol 2e-5;
* the classes keep the JAX package's op types, accumulator slots and
  names, defaults and aliases (checkpoints and ``state_from_numpy``
  depend on them).
"""

import inspect
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

from _torch_port import _flags, symbol_table

torch.set_num_threads(1)

LR, STEPS = 0.01, 3
# config -> (class name, hyperparameters)
CONFIGS = {
    "momentum": ("Momentum", {"momentum": 0.9}),
    "momentum_nesterov": ("Momentum", {"momentum": 0.9,
                                       "use_nesterov": True}),
    "adamax": ("Adamax", {}),
    "decayed_adagrad": ("DecayedAdagrad", {}),
    "adadelta": ("Adadelta", {}),
    "rmsprop": ("RMSProp", {"momentum": 0.9}),
    "rmsprop_centered": ("RMSProp", {"momentum": 0.9, "centered": True}),
    "ftrl": ("Ftrl", {"l1": 0.01, "l2": 0.01}),
    "ftrl_power": ("Ftrl", {"l1": 0.01, "l2": 0.01, "lr_power": -0.25}),
    "proximal_gd": ("ProximalGD", {"l1": 0.01, "l2": 0.01}),
    "proximal_adagrad": ("ProximalAdagrad", {"l1": 0.01, "l2": 0.01}),
}
NEW = ("Momentum", "Adamax", "DecayedAdagrad", "Adadelta", "RMSProp",
       "Ftrl", "ProximalGD", "ProximalAdagrad")


def _package(pkg):
    return ((jfluid, j_unique_name.guard) if pkg == "jax"
            else (tfluid, tfluid.unique_name.guard))


def _build(pkg, config):
    """(main, startup, avg_cost): x[6] -> fc 16 relu -> fc 1 -> mean
    squared error, minimized by the config's optimizer at LR."""
    fluid, guard = _package(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=1)
        cost = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        cls, kw = CONFIGS[config]
        getattr(fluid.optimizer, cls)(learning_rate=LR, **kw).minimize(cost)
    return main, startup, cost


def _feeds(seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(8, 6).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)} for _ in range(STEPS)]


def _jax_run(config, fuse, bf16):
    """(program, start state, losses, state after the steps) of the JAX
    package; persistables as numpy (bf16 widened to f32)."""
    values = {"fuse_optimizer_state": fuse, "pallas_fused_update": fuse,
              "bf16_moments": bf16}
    with warnings.catch_warnings(), _flags("jax", values):
        main, startup, cost = _build("jax", config)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            state = {v.name: np.asarray(scope.find_var(v.name))
                     for v in main.list_vars() if v.persistable}
            losses = [float(np.asarray(exe.run(main, feed=f,
                                               fetch_list=[cost])[0]))
                      for f in _feeds()]
            after = {n: np.asarray(jfluid.executor.fetch_var(n, scope))
                     .astype(np.float32) for n in state}
    return main, state, losses, after


def _port_run(config, fuse, bf16, state=None):
    """(program, losses, state after the steps) of the port, from
    ``state`` (else its own startup)."""
    with _flags("torch", {"fuse_optimizer_state": fuse,
                          "bf16_moments": bf16}):
        main, startup, cost = _build("torch", config)
    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.state_from_numpy(state, scope, place, program=main)
    losses = [float(exe.run(main, feed=f, fetch_list=[cost],
                            scope=scope)[0]) for f in _feeds()]
    names = [v.name for v in main.list_vars() if v.persistable]
    return main, losses, {n: tfluid.fetch_var(n, scope) for n in names}


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("fuse", [False, True], ids=["per_param", "fused"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_steps_match_the_jax_package(config, fuse, moments):
    bf16 = moments == "bf16"
    j_main, state, j_losses, j_after = _jax_run(config, fuse, bf16)
    t_main, t_losses, t_after = _port_run(config, fuse, bf16, state)
    assert symbol_table(t_main) == symbol_table(j_main)
    kind = getattr(tfluid.optimizer, CONFIGS[config][0])._OP_TYPE
    ops = [op.type for op in t_main.global_block().ops]
    assert ops == [op.type for op in j_main.global_block().ops]
    assert ops.count(kind + "_fused") == (1 if fuse else 0)
    assert ops.count(kind) == (0 if fuse else 4)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    storage = {v.name: v.dtype for v in t_main.list_vars()}
    for name, want in j_after.items():
        got = t_after[name]
        assert got.shape == want.shape, name
        if storage[name] is torch.bfloat16:
            assert np.all(np.abs(got - want) <= _bf16_ulp(want)), name
        else:
            np.testing.assert_allclose(
                got, want, rtol=1e-6,
                atol=1e-7 * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_route_is_bit_equal_to_per_param_route(config, moments):
    bf16 = moments == "bf16"
    per_main, per_losses, per_after = _port_run(config, False, bf16)
    _, f_losses, f_after = _port_run(config, True, bf16)
    for p in per_main.all_parameters():
        want = per_after[p.name]
        if config == "ftrl_power":
            np.testing.assert_allclose(
                f_after[p.name], want, rtol=1e-6,
                atol=1e-7 * float(np.abs(want).max()), err_msg=p.name)
        else:
            assert f_losses == per_losses
            np.testing.assert_array_equal(f_after[p.name], want,
                                          err_msg=p.name)


# ------------------------------------------------ the numpy oracles

_OLR = 0.05


def _oracle_w0():
    """The start weight of tests/test_optimizer_oracles.py's model: the
    JAX package's initialization at ``random_seed = 2``."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = 2
    with j_unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[3], dtype="float32")
        jfluid.layers.fc(x, size=1, bias_attr=False,
                         param_attr=jfluid.ParamAttr(name="w"))
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        return np.asarray(scope.find_var("w"))


def _oracle_train(opt, fuse, steps=4):
    """tests/test_optimizer_oracles.py's model and start in the port: a
    3 -> 1 linear map without bias, mean squared error; (x, y, w0, w
    after)."""
    rng = np.random.RandomState(0)
    xv = rng.rand(4, 3).astype(np.float32)
    yv = rng.rand(4, 1).astype(np.float32)
    with _flags("torch", {"fuse_optimizer_state": fuse}):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
            y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
            pred = tfluid.layers.fc(x, size=1, bias_attr=False,
                                    param_attr=tfluid.ParamAttr(name="w"))
            loss = tfluid.layers.mean(
                tfluid.layers.square_error_cost(pred, y))
            opt().minimize(loss)
    scope, place = tfluid.Scope(), tfluid.CPUPlace()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    w0 = _oracle_w0()
    tfluid.params_from_numpy({"w": w0}, scope, place, program=main)
    for _ in range(steps):
        exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss],
                scope=scope)
    return xv, yv, w0, tfluid.fetch_var("w", scope)


def _oracle_replay(xv, yv, w0, update, steps=4):
    w, state = w0.astype(np.float64), {}
    for _ in range(steps):
        g = 2.0 * xv.T @ (xv @ w - yv) / xv.shape[0]
        w = update(w, g, state)
    return w


def _momentum(nesterov):
    def update(w, g, s):
        v = 0.9 * s.get("v", np.zeros_like(w)) + g
        s["v"] = v
        return w - (g + 0.9 * v) * _OLR if nesterov else w - _OLR * v
    return update


def _adagrad(w, g, s):
    s["m"] = s.get("m", np.zeros_like(w)) + g * g
    return w - _OLR * g / (np.sqrt(s["m"]) + 1e-6)


def _decayed_adagrad(w, g, s):
    s["m"] = 0.95 * s.get("m", np.zeros_like(w)) + 0.05 * g * g
    return w - _OLR * g / (np.sqrt(s["m"]) + 1e-6)


def _adadelta(w, g, s):
    ag = 0.95 * s.get("ag", np.zeros_like(w)) + 0.05 * g * g
    ax = s.get("ax", np.zeros_like(w))
    dx = -np.sqrt((ax + 1e-6) / (ag + 1e-6)) * g
    s["ag"], s["ax"] = ag, 0.95 * ax + 0.05 * dx * dx
    return w + _OLR * dx


def _rmsprop(centered):
    def update(w, g, s):
        ms = 0.95 * s.get("ms", np.zeros_like(w)) + 0.05 * g * g
        mg = s.get("mg", np.zeros_like(w))
        if centered:
            mg = 0.95 * mg + 0.05 * g
            denom = np.sqrt(ms - mg * mg + 1e-6)
        else:
            denom = np.sqrt(ms + 1e-6)
        v = 0.9 * s.get("v", np.zeros_like(w)) + _OLR * g / denom
        s.update(ms=ms, mg=mg, v=v)
        return w - v
    return update


def _adam(w, g, s):
    b1p, b2p = s.get("b1p", 0.9), s.get("b2p", 0.999)
    m1 = 0.9 * s.get("m1", np.zeros_like(w)) + 0.1 * g
    m2 = 0.999 * s.get("m2", np.zeros_like(w)) + 0.001 * g * g
    lr_t = _OLR * np.sqrt(1 - b2p) / (1 - b1p)
    s.update(m1=m1, m2=m2, b1p=b1p * 0.9, b2p=b2p * 0.999)
    return w - lr_t * m1 / (np.sqrt(m2) + 1e-8)


def _adamax(w, g, s):
    b1p = s.get("b1p", 0.9)
    m = 0.9 * s.get("m", np.zeros_like(w)) + 0.1 * g
    inf = np.maximum(0.999 * s.get("inf", np.zeros_like(w)),
                     np.abs(g) + 1e-8)
    s.update(m=m, inf=inf, b1p=b1p * 0.9)
    return w - (_OLR / (1 - b1p)) * m / inf


def _ftrl(lrp):
    l1 = l2 = 0.01

    def update(w, g, s):
        sq = s.get("sq", np.zeros_like(w))
        new_sq = sq + g * g
        sigma = (np.power(new_sq, -lrp) - np.power(sq, -lrp)) / _OLR
        lin = s.get("lin", np.zeros_like(w)) + g - sigma * w
        x = l1 * np.sign(lin) - lin
        y = np.power(new_sq, -lrp) / _OLR + 2 * l2
        s["sq"], s["lin"] = new_sq, lin
        return np.where(np.abs(lin) > l1, x / y, np.zeros_like(w))
    return update


def _proximal(w, lr, l1=0.01, l2=0.01):
    return np.sign(w) * np.maximum(0.0, np.abs(w) - lr * l1) / (1 + lr * l2)


def _proximal_adagrad(w, g, s):
    s["m"] = s.get("m", np.zeros_like(w)) + g * g
    lr_t = _OLR / np.sqrt(s["m"] + 1e-12)
    return _proximal(w - lr_t * g, lr_t)


ORACLES = {
    "sgd": (lambda: tfluid.optimizer.SGD(learning_rate=_OLR),
            lambda w, g, s: w - _OLR * g),
    "momentum": (lambda: tfluid.optimizer.Momentum(_OLR, momentum=0.9),
                 _momentum(False)),
    "momentum_nesterov": (lambda: tfluid.optimizer.Momentum(
        _OLR, momentum=0.9, use_nesterov=True), _momentum(True)),
    "adagrad": (lambda: tfluid.optimizer.Adagrad(_OLR, epsilon=1e-6),
                _adagrad),
    "decayed_adagrad": (lambda: tfluid.optimizer.DecayedAdagrad(
        _OLR, decay=0.95, epsilon=1e-6), _decayed_adagrad),
    "adadelta": (lambda: tfluid.optimizer.Adadelta(
        _OLR, epsilon=1e-6, rho=0.95), _adadelta),
    "rmsprop": (lambda: tfluid.optimizer.RMSProp(
        _OLR, rho=0.95, epsilon=1e-6, momentum=0.9), _rmsprop(False)),
    "rmsprop_centered": (lambda: tfluid.optimizer.RMSProp(
        _OLR, rho=0.95, epsilon=1e-6, momentum=0.9, centered=True),
        _rmsprop(True)),
    "adam": (lambda: tfluid.optimizer.Adam(_OLR), _adam),
    "adamax": (lambda: tfluid.optimizer.Adamax(_OLR), _adamax),
    "ftrl": (lambda: tfluid.optimizer.Ftrl(_OLR, l1=0.01, l2=0.01),
             _ftrl(-0.5)),
    "ftrl_power": (lambda: tfluid.optimizer.Ftrl(
        _OLR, l1=0.01, l2=0.01, lr_power=-0.25), _ftrl(-0.25)),
    "proximal_gd": (lambda: tfluid.optimizer.ProximalGD(
        _OLR, l1=0.01, l2=0.01), lambda w, g, s: _proximal(w - _OLR * g,
                                                           _OLR)),
    "proximal_adagrad": (lambda: tfluid.optimizer.ProximalAdagrad(
        _OLR, l1=0.01, l2=0.01), _proximal_adagrad),
}


@pytest.mark.parametrize("fuse", [False, True], ids=["per_param", "fused"])
@pytest.mark.parametrize("name", sorted(ORACLES))
def test_matches_the_numpy_oracle(name, fuse):
    opt, update = ORACLES[name]
    xv, yv, w0, got = _oracle_train(opt, fuse)
    np.testing.assert_allclose(got, _oracle_replay(xv, yv, w0, update),
                               rtol=2e-5)


@pytest.mark.parametrize("name", NEW)
def test_classes_keep_the_jax_packages_contract(name):
    j_cls = getattr(jfluid.optimizer, name)
    t_cls = getattr(tfluid.optimizer, name)
    for attr in ("_OP_TYPE", "_FUSE_ACCS", "_FUSE_SHARED"):
        assert getattr(t_cls, attr) == getattr(j_cls, attr), attr
    j_sig = inspect.signature(j_cls.__init__).parameters
    t_sig = inspect.signature(t_cls.__init__).parameters
    assert list(t_sig) == list(j_sig)
    assert [p.default for p in t_sig.values()] == \
        [p.default for p in j_sig.values()]
    assert getattr(tfluid.optimizer, name + "Optimizer") is t_cls
    assert getattr(tfluid, name) is t_cls
