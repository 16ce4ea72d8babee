"""The sequence models in the port against the JAX package, at small
widths: the seq2seq attention NMT (``machine_translation``), sentiment
(``convolution_net`` and ``stacked_lstm_net``), semantic role labelling
(``db_lstm`` with its CRF) and the recommender — the same symbol
tables, and three training steps from the JAX package's start weights
with the same losses and parameters. Also ``nets.py``, and the oracles
of tests/test_models.py (sentiment forward shapes, MT training) and
tests/test_new_models.py (SRL builds and steps).

Feeds are padded by each package's own DataFeeder where the model's
slots allow it (the bucketed widths are the JAX package's).

Tolerances: losses and parameters at rtol 1e-5 (atol 1e-6), except
where a recurrence runs more than 32 steps (none here: the widest
padded length is 16).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid

from _torch_port import package, symbol_table, train_both

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _models(pkg):
    if pkg == "jax":
        from paddle_tpu.models import (label_semantic_roles,
                                       machine_translation, recommender,
                                       sentiment)
    else:
        from paddle_tpu_torch.models import (label_semantic_roles,
                                             machine_translation,
                                             recommender, sentiment)
    return dict(mt=machine_translation, sentiment=sentiment,
                srl=label_semantic_roles, rec=recommender)


MT = dict(src_dict_size=50, trg_dict_size=50, word_dim=8, hidden_dim=16)


def mt_rows(seed=2, B=4):
    """(src, trg, next) rows: source and target lengths 3..9, the
    target one longer for its start/end token (the wmt14 pattern)."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(B):
        src = rng.randint(2, 50, rng.randint(3, 10)).tolist()
        trg = [0] + rng.randint(2, 50, rng.randint(3, 10)).tolist()
        rows.append((src, trg, trg[1:] + [1]))
    return rows


def _mt(pkg, fluid):
    feeds, cost, _ = _models(pkg)["mt"].build_train(**MT)
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return [cost]


def _sentiment(model, **kw):
    def b(pkg, fluid):
        _, _, cost, acc, pred = _models(pkg)["sentiment"].build_train(
            100, model=model, **kw)
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
        return [cost, acc, pred]
    return b


SRL = dict(word_dim=8, mark_dim=4, hidden_dim=16, depth=3, max_len=8,
           word_dict_len=100, label_dict_len=10, pred_dict_len=50)


def _srl(pkg, fluid):
    _, cost, crf = _models(pkg)["srl"].db_lstm(**SRL)
    fluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return [cost, crf]


def _rec(pkg, fluid):
    cost, infer = _models(pkg)["rec"].build_train()
    fluid.optimizer.SGD(learning_rate=0.2).minimize(cost)
    return [cost, infer]


def feeder_feed(build, names, rows):
    """The feed both packages' DataFeeders make of ``rows`` for the
    program ``build`` makes (held equal first)."""
    feeds = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            build(pkg, fluid)
            feeds[pkg] = fluid.DataFeeder(
                feed_list=names, place=fluid.CPUPlace(),
                program=main).feed(rows)
    for n in feeds["jax"]:
        np.testing.assert_array_equal(feeds["torch"][n], feeds["jax"][n])
    return feeds["torch"]


def srl_feed(seed=3, B=3):
    rng = np.random.RandomState(seed)
    T = SRL["max_len"]
    ids = lambda hi: rng.randint(0, hi, (B, T)).astype("int64")  # noqa
    feed = {n: ids(100) for n in ["word_data", "ctx_n2_data", "ctx_n1_data",
                                  "ctx_0_data", "ctx_p1_data",
                                  "ctx_p2_data"]}
    feed.update(verb_data=ids(50), mark_data=ids(2), target=ids(10),
                **{"word_data@LEN": np.array([8, 5, 2], np.int32)})
    return feed


def rec_feed(seed=4, B=4):
    rng = np.random.RandomState(seed)
    return {
        "user_id": rng.randint(0, 6040, (B, 1)).astype("int64"),
        "gender_id": rng.randint(0, 2, (B, 1)).astype("int64"),
        "age_id": rng.randint(0, 7, (B, 1)).astype("int64"),
        "job_id": rng.randint(0, 21, (B, 1)).astype("int64"),
        "movie_id": rng.randint(0, 3952, (B, 1)).astype("int64"),
        "category_id": rng.randint(0, 19, (B, 3, 1)).astype("int64"),
        "category_id@LEN": np.array([3, 2, 1, 3], np.int32),
        "movie_title": rng.randint(0, 5175, (B, 8, 1)).astype("int64"),
        "movie_title@LEN": np.array([8, 5, 2, 6], np.int32),
        "score": (rng.rand(B, 1) * 5).astype("float32")}


MT_SLOTS = ["src_word_id", "target_language_word",
            "target_language_next_word"]


def _sentiment_feed():
    rng = np.random.RandomState(5)
    rows = [(rng.randint(0, 100, n).tolist(), [int(rng.randint(0, 2))])
            for n in (9, 3, 12, 1)]
    return feeder_feed(_sentiment("conv", emb_dim=8, hid_dim=6),
                       ["words", "label"], rows)


CASES = {
    "mt": (_mt, lambda: feeder_feed(_mt, MT_SLOTS, mt_rows())),
    "sentiment_lstm": (_sentiment("stacked_lstm", emb_dim=8, hid_dim=8),
                       _sentiment_feed),
    "sentiment_conv": (_sentiment("conv", emb_dim=8, hid_dim=6),
                       _sentiment_feed),
    "srl": (_srl, srl_feed),
    "recommender": (_rec, rec_feed),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_trains_like_the_jax_package(name):
    build, feed = CASES[name]
    r = train_both(build, feed(), 3)
    assert symbol_table(r["t_main"]) == symbol_table(r["j_main"])
    for j, t in zip(r["j_out"], r["t_out"]):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, **TOL)
    for n in r["state"]:
        np.testing.assert_allclose(r["t_state"][n], r["j_state"][n],
                                   err_msg=n, **TOL)
    losses = [float(np.asarray(o[0])) for o in r["t_out"]]
    assert losses[-1] < losses[0], losses


def test_mt_padding_follows_the_bucket():
    feed = feeder_feed(_mt, MT_SLOTS, mt_rows())
    assert feed["src_word_id"].shape[1] == 16
    np.testing.assert_array_equal(feed["target_language_word@LEN"],
                                  feed["target_language_next_word@LEN"])


def _run_port(build, feed, steps, place=None, scope=None):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        fetch = build("torch", tfluid)
    scope = scope or tfluid.Scope()
    exe = tfluid.Executor(place or tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(steps)]


def test_machine_translation_trains():
    """test_models.py's oracle: ten Adam steps on fresh batches."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        cost, = _mt("torch", tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feeder = tfluid.DataFeeder(MT_SLOTS, program=main)
    losses = [float(exe.run(main, feed=feeder.feed(mt_rows(seed=k)),
                            fetch_list=[cost], scope=scope)[0])
              for k in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("model", ["conv", "stacked_lstm"])
def test_sentiment_forward_shapes(model):
    out = _run_port(_sentiment(model, emb_dim=8, hid_dim=8),
                    _sentiment_feed(), 1)[0]
    assert out[2].shape == (4, 2) and np.isfinite(out[0]).all()


def test_srl_decodes_with_the_trained_transition():
    """The db-lstm's emissions decoded by crf_decoding against the
    transition the CRF trained (shared by name)."""
    def b(pkg, fluid):
        feeds, cost, crf = _models(pkg)["srl"].db_lstm(**SRL)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
        em = crf.block.program.global_block().ops
        emission = [op for op in em if op.type == "linear_chain_crf"][0]
        path = fluid.layers.crf_decoding(
            crf.block.var(emission.input("Emission")[0]),
            transition=crf._crf_transition,
            length=fluid.layers.length_var_of(feeds[0]))
        return [cost, path]

    r = train_both(b, srl_feed(), 2)
    for j, t in zip(r["j_out"], r["t_out"]):
        np.testing.assert_allclose(t[0], j[0], **TOL)
        np.testing.assert_array_equal(t[1], np.asarray(j[1]).astype(
            np.int64))


# ------------------------------------------------------------ nets


def _nets_case(build, inputs, grad=True):
    def b(pkg, fluid):
        L = fluid.layers
        v = {n: L.create_parameter(list(a.shape), "float32", name=n)
             for n, a in inputs.items()}
        out = build(fluid, v)
        names = []
        if grad:
            names = [g.name for _, g in fluid.append_backward(
                L.reduce_sum(L.square(out)))]
        return [out] + names

    r = train_both(b, {}, 1, params=inputs)
    for t, j in zip(r["t_out"][0], r["j_out"][0]):
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(j).max(), 1))


def _u(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def test_nets_glu():
    _nets_case(lambda f, v: f.nets.glu(v["x"], dim=-1), {"x": _u(3, 8)})


@pytest.mark.parametrize("heads", [1, 2])
def test_nets_scaled_dot_product_attention(heads):
    _nets_case(lambda f, v: f.nets.scaled_dot_product_attention(
        v["q"], v["k"], v["v"], num_heads=heads),
        {"q": _u(2, 3, 4), "k": _u(2, 5, 4, seed=1),
         "v": _u(2, 5, 4, seed=2)})


def test_nets_simple_img_conv_pool():
    _nets_case(lambda f, v: f.nets.simple_img_conv_pool(
        v["img"], num_filters=3, filter_size=3, pool_size=2, pool_stride=2,
        act="relu"), {"img": _u(2, 2, 8, 8)})


def test_nets_img_conv_group():
    _nets_case(lambda f, v: f.nets.img_conv_group(
        v["img"], conv_num_filter=[3, 4], pool_size=2, conv_act="tanh",
        conv_with_batchnorm=[False, True], is_test=True),
        {"img": _u(2, 2, 6, 6)})


def test_nets_sequence_conv_pool():
    def b(pkg, fluid):
        L = fluid.layers
        d = L.data(name="d", shape=[3, 6, 4], dtype="float32",
                   append_batch_size=False, lod_level=1)
        w = L.create_parameter([3, 6, 4], "float32", name="w")
        out = fluid.nets.sequence_conv_pool(L.elementwise_mul(d, w), 5, 3,
                                            act="tanh", pool_type="sqrt")
        return [out] + [g.name for _, g in fluid.append_backward(
            L.reduce_sum(L.square(out)))]

    r = train_both(b, {"d": _u(3, 6, 4), "d@LEN": np.array([6, 1, 4],
                                                           np.int32)}, 1,
                   params={"w": _u(3, 6, 4, seed=3)})
    for t, j in zip(r["t_out"][0], r["j_out"][0]):
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_static_tier_agrees_with_the_jax_package(name):
    """check_program's diagnostics and obs.cost.report's numbers over the
    sequence programs are the JAX package's: no crash and no false lint
    on sequence inputs, and the same ops left uncounted (the
    recurrences, the attention decoder, the CRF and the sequence ops
    have no cost rule in either package)."""
    import importlib

    build, feed_fn = CASES[name]
    feed = feed_fn()
    shapes = {n: tuple(v.shape) for n, v in feed.items()}
    got = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        root = "paddle_tpu" if pkg == "jax" else "paddle_tpu_torch"
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            fetch = build(pkg, fluid)
        rep = importlib.import_module(root + ".analysis").check_program(
            main, feed=tuple(feed), fetch_list=[
                f if isinstance(f, str) else f.name for f in fetch])
        cost = importlib.import_module(root + ".obs.cost").report(
            main, feed_shapes=shapes)
        got[pkg] = (sorted((d.severity, d.code) for d in rep.diagnostics),
                    cost.total_flops, sorted(cost.unknown_op_types()))
        assert rep.ok
    assert got["torch"] == got["jax"]
