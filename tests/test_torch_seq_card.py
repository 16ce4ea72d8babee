"""The sequence tier on the card (marked ``cuda``; skips without one).
This file imports no JAX: it runs on the card's machine with
``python -m pytest tests/test_torch_seq_card.py -m cuda --noconftest``.

* a program holding ``while`` runs eagerly through ``Executor.run`` and
  ``run_steps`` refuses it with GraphCaptureError naming the op, before
  any capture;
* StaticRNN/DynamicRNN steps and the sequence models at small widths
  (seq2seq NMT, stacked-LSTM sentiment, SRL db-lstm), with the fused
  flat update, replay as a captured CUDA graph bit-equal to eager steps;
* ``crf_decoding`` on the card equals the numpy Viterbi of
  ``chip_smoke.numpy_viterbi``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid

pytestmark = pytest.mark.cuda


@pytest.fixture
def place():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return fluid.CUDAPlace(0)


def _program(build, fuse=False):
    saved = fluid.get_flag("fuse_optimizer_state")
    fluid.set_flags({"fuse_optimizer_state": fuse})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid.layers)
    finally:
        fluid.set_flags({"fuse_optimizer_state": saved})
    return main, startup, fetch


def _while_sum(L):
    i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    total = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    limit = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    cond = L.less_than(i, limit)
    with L.While(cond).block():
        L.assign(L.elementwise_add(total, L.increment(i, value=1.0)), total)
        L.less_than(i, limit, cond=cond)
    return [total]


def test_run_steps_refuses_a_while_program(place):
    main, startup, fetch = _program(_while_sum)
    scope, exe = fluid.Scope(), fluid.Executor(place)
    exe.run(startup, scope=scope)
    (total,) = exe.run(main, fetch_list=fetch, scope=scope)
    assert float(np.squeeze(total)) == 55.0
    with pytest.raises(fluid.GraphCaptureError, match="'while'"):
        exe.run_steps(main, steps=2, fetch_list=fetch, scope=scope)
    assert exe.num_compiled == 0


def _rnn(dynamic, Bn=4, Tn=6, Dn=3, Hn=8):
    def build(L):
        x = L.data(name="x", shape=[Bn, Tn, Dn], dtype="float32",
                   append_batch_size=False, lod_level=1 if dynamic else 0)
        y = L.data(name="y", shape=[Bn, Hn], dtype="float32",
                   append_batch_size=False)
        h0 = L.fill_constant(shape=[Bn, Hn], dtype="float32", value=0.0)
        rnn = L.DynamicRNN() if dynamic else L.StaticRNN()
        with (rnn.block() if dynamic else rnn.step()):
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.fc(input=L.concat([x_t, h], axis=1), size=Hn, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        seq, = rnn()
        loss = L.mean(L.square_error_cost(L.reduce_sum(seq, dim=1), y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss]
    return build


def _eager_and_replayed(place, main, startup, fetch, feed, steps):
    out = []
    for mode in ("eager", "graph"):
        scope, exe = fluid.Scope(), fluid.Executor(place)
        exe.run(startup, scope=scope)
        if mode == "eager":
            out.append([float(exe.run(main, feed=feed, fetch_list=fetch[:1],
                                      scope=scope)[0])
                        for _ in range(steps)])
        else:
            got, = exe.run_steps(main, feed=feed, steps=steps,
                                 fetch_list=fetch[:1], scope=scope)
            out.append(np.asarray(got).reshape(-1).tolist())
            assert exe.num_compiled == 1
    return out


@pytest.mark.parametrize("dynamic", [False, True])
def test_rnn_run_steps_equals_eager_steps(place, dynamic):
    rng = np.random.RandomState(1)
    feed = {"x": rng.rand(4, 6, 3).astype("float32"),
            "y": rng.rand(4, 8).astype("float32")}
    if dynamic:
        feed["x@LEN"] = np.array([6, 2, 4, 1], np.int32)
    main, startup, fetch = _program(_rnn(dynamic))
    eager, graph = _eager_and_replayed(place, main, startup, fetch, feed, 4)
    assert eager == graph


def _seq2seq(L):
    from paddle_tpu_torch.models import machine_translation

    _, cost, _ = machine_translation.build_train(50, 50, 8, 16)
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return [cost]


def _sentiment(L):
    from paddle_tpu_torch.models import sentiment

    _, _, cost, _, _ = sentiment.build_train(100, emb_dim=8, hid_dim=8)
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return [cost]


def _srl(L):
    from paddle_tpu_torch.models import label_semantic_roles

    _, cost, _ = label_semantic_roles.db_lstm(
        word_dim=8, mark_dim=4, hidden_dim=16, depth=3, max_len=8,
        word_dict_len=100, label_dict_len=10, pred_dict_len=50)
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return [cost]


def _feed(name):
    rng = np.random.RandomState(3)
    if name == "srl":
        ids = lambda hi: rng.randint(0, hi, (3, 8)).astype("int64")  # noqa
        feed = {n: ids(100) for n in ["word_data", "ctx_n2_data",
                                      "ctx_n1_data", "ctx_0_data",
                                      "ctx_p1_data", "ctx_p2_data"]}
        feed.update(verb_data=ids(50), mark_data=ids(2), target=ids(10))
        feed["word_data@LEN"] = np.array([8, 5, 2], np.int32)
        return feed
    if name == "seq2seq":
        slots = ["src_word_id", "target_language_word",
                 "target_language_next_word"]
        rows = []
        for _ in range(4):
            trg = rng.randint(2, 50, rng.randint(3, 10)).tolist()
            rows.append((rng.randint(2, 50, rng.randint(3, 10)).tolist(),
                         [0] + trg, trg + [1]))
    else:
        slots = ["words", "label"]
        rows = [(rng.randint(0, 100, n).tolist(), [n % 2])
                for n in (9, 3, 12, 1)]
    main, _, _ = _program({"seq2seq": _seq2seq,
                           "sentiment": _sentiment}[name])
    return fluid.DataFeeder(slots, program=main).feed(rows)


@pytest.mark.parametrize("name", ["seq2seq", "sentiment", "srl"])
def test_sequence_model_run_steps_equals_eager_steps(place, name):
    """The sequence models' steps replayed as one captured CUDA graph,
    with the fused flat update, are bit-equal to eager steps."""
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    build = {"seq2seq": _seq2seq, "sentiment": _sentiment, "srl": _srl}[name]
    main, startup, fetch = _program(build, fuse=True)
    fused_flat_update.launches = 0
    eager, graph = _eager_and_replayed(place, main, startup, fetch,
                                       _feed(name), 3)
    assert eager == graph
    assert fused_flat_update.launches >= 3


def test_crf_decoding_equals_numpy_viterbi(place):
    import chip_smoke

    rng = np.random.RandomState(6)
    B, T, N = 5, 20, 7
    em = rng.randn(B, T, N).astype("float32")
    trans = rng.randn(N + 2, N).astype("float32")
    lens = np.array([20, 1, 7, 13, 2], np.int32)
    from paddle_tpu_torch.layers.crf import viterbi

    dev = place.torch_device()
    got = viterbi(torch.as_tensor(em, device=dev),
                  torch.as_tensor(trans, device=dev),
                  torch.as_tensor(lens, device=dev).to(torch.int64))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  chip_smoke.numpy_viterbi(em, trans, lens))
