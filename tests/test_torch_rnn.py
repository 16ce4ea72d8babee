"""The port's recurrent layers against the JAX package: dynamic_lstm
(peepholes on and off, ``is_reverse``, initial states, other
activations), dynamic_gru, simple_rnn, lstm_unit, gru_unit and
dynamic_lstmp — outputs and the gradients of every parameter and of the
input, over the same seeded inputs and the JAX package's start weights.

``is_reverse`` flips the whole padded time axis (a reversed row's
leading pads hold the initial state); the rows here have lengths below
the padded width, so that convention is exercised.

Tolerances: rtol 1e-5 (atol 1e-6 of the largest magnitude) for f32 at
up to 32 steps; the 40-step recurrence uses rtol 1e-4 (noted at its
assert): summation order differs between XLA and torch, and a long
recurrence compounds it.
"""

import numpy as np
import pytest
import torch

from _torch_port import train_both

torch.set_num_threads(1)

B, T, H = 3, 7, 5
LENS = np.array([7, 3, 5], np.int32)


def _f(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def rnn_case(build, width, T=T, lens=LENS, extra=None, rtol=1e-5):
    """``build(L, x, v)`` over x = a sequence data var [B, T, width]
    times the parameter ``w``; fetches its outputs and every parameter's
    gradient of the sum of squares of the outputs; compares both
    packages."""
    feed = {"d": _f(B, T, width, seed=1), "d@LEN": lens}
    feed.update(extra or {})

    def b(pkg, fluid):
        L = fluid.layers
        d = L.data(name="d", shape=[B, T, width], dtype="float32",
                   append_batch_size=False, lod_level=1)
        w = L.create_parameter([B, T, width], "float32", name="w")
        v = {n: L.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False)
             for n, a in (extra or {}).items()}
        outs = build(L, L.elementwise_mul(d, w), v)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        loss = L.sums([L.reduce_sum(L.square(o)) for o in outs])
        grads = [g.name for _, g in fluid.append_backward(loss)]
        return outs + grads

    r = train_both(b, feed, 1,
                   params={"w": _f(B, T, width, seed=2, lo=0.5, hi=1.5)})
    for k, (t, j) in enumerate(zip(r["t_out"][0], r["j_out"][0])):
        t, j = np.asarray(t), np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(
            t, j, rtol=rtol, atol=1e-6 * max(float(np.abs(j).max()), 1.0),
            err_msg="fetch %d" % k)
    return r


@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_lstm(peep, reverse):
    rnn_case(lambda L, x, v: list(L.dynamic_lstm(
        x, 4 * H, use_peepholes=peep, is_reverse=reverse)), 4 * H)


@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_lstm_initial_states(reverse):
    extra = {"h0": _f(B, H, seed=3), "c0": _f(B, H, seed=4)}
    r = rnn_case(lambda L, x, v: list(L.dynamic_lstm(
        x, 4 * H, h_0=v["h0"], c_0=v["c0"], is_reverse=reverse)), 4 * H,
        extra=extra)
    h = r["t_out"][0][0]
    if reverse:
        # the reversed short row carries h0 through its leading pads;
        # its outputs past the length are masked to 0 all the same
        assert np.abs(h[1, LENS[1]:]).max() == 0.0


def test_dynamic_lstm_activations():
    rnn_case(lambda L, x, v: list(L.dynamic_lstm(
        x, 4 * H, gate_activation="sigmoid", cell_activation="relu",
        candidate_activation="identity")), 4 * H)


def test_dynamic_lstm_long_sequence():
    lens = np.array([40, 33, 12], np.int32)
    # 40 recurrent steps: rtol 1e-4 (a long recurrence compounds the
    # packages' different summation orders)
    rnn_case(lambda L, x, v: list(L.dynamic_lstm(x, 4 * H)), 4 * H, T=40,
             lens=lens, rtol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_gru(reverse):
    rnn_case(lambda L, x, v: L.dynamic_gru(x, H, is_reverse=reverse), 3 * H)


def test_dynamic_gru_initial_state_and_activations():
    rnn_case(lambda L, x, v: L.dynamic_gru(
        x, H, h_0=v["h0"], candidate_activation="relu"), 3 * H,
        extra={"h0": _f(B, H, seed=5)})


@pytest.mark.parametrize("act,reverse", [("tanh", False), ("relu", True)])
def test_simple_rnn(act, reverse):
    rnn_case(lambda L, x, v: L.simple_rnn(x, 6, act=act, is_reverse=reverse),
             6)


@pytest.mark.parametrize("peep,reverse", [(True, False), (False, True)])
def test_dynamic_lstmp(peep, reverse):
    rnn_case(lambda L, x, v: list(L.dynamic_lstmp(
        x, 4 * H, proj_size=3, use_peepholes=peep, is_reverse=reverse)),
        4 * H)


def test_dynamic_lstmp_named_weights_do_not_alias():
    r = rnn_case(lambda L, x, v: list(L.dynamic_lstmp(
        x, 4 * H, proj_size=3, param_attr="lw")), 4 * H)
    names = {p.name for p in r["t_main"].all_parameters()}
    assert {"lw", "lw.proj"} <= names


def test_lstm_unit():
    def b(L, x, v):
        x_t = L.reshape(L.slice(x, axes=[1], starts=[2], ends=[3]),
                        shape=[B, 4])
        return list(L.lstm_unit(x_t, v["h"], v["c"], forget_bias=0.5))

    rnn_case(b, 4, extra={"h": _f(B, H, seed=6), "c": _f(B, H, seed=7)})


def test_gru_unit():
    def b(L, x, v):
        x_t = L.reshape(L.slice(x, axes=[1], starts=[1], ends=[2]),
                        shape=[B, 3 * H])
        return list(L.gru_unit(x_t, v["h"], 3 * H))

    rnn_case(b, 3 * H, extra={"h": _f(B, H, seed=8)})


def test_stacked_lstms_train_three_steps():
    """Three Adam steps of two stacked LSTMs of opposite direction (the
    sentiment topology) hold the losses and every parameter."""
    feed = {"d": _f(B, T, 4, seed=1), "d@LEN": LENS,
            "y": _f(B, H, seed=9)}

    def b(pkg, fluid):
        L = fluid.layers
        # a symbolic batch, as the lengths' ([-1]): the fc after the
        # first LSTM needs its inferred width
        d = L.data(name="d", shape=[-1, T, 4], dtype="float32",
                   append_batch_size=False, lod_level=1)
        y = L.data(name="y", shape=[-1, H], dtype="float32",
                   append_batch_size=False)
        h1, _ = L.dynamic_lstm(L.fc(d, 4 * H, num_flatten_dims=2), 4 * H)
        h2, _ = L.dynamic_lstm(L.fc([d, h1], 4 * H, num_flatten_dims=2),
                               4 * H, is_reverse=True)
        loss = L.mean(L.square_error_cost(L.sequence_pool(h2, "max"), y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [loss]

    r = train_both(b, feed, 3)
    for j, t in zip(r["j_out"], r["t_out"]):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    for n in r["state"]:
        np.testing.assert_allclose(r["t_state"][n], r["j_state"][n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
