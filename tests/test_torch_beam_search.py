"""The port's beam search against the JAX package and the oracles of
tests/test_beam_search.py and tests/test_nested_lod.py: ``beam_search``
(full beam = exhaustive search, beam against greedy, length penalty,
state that follows the beams), ``greedy_search``,
``beam_search_decode``'s parent back-trace, ``cross_entropy_over_beam``,
and the machine-translation beam-training path (a 2-level beam,
``sub_nested_seq`` picking the sub-beam, the beam loss trained until
gold ranks first).

Sequences, beams and back-traces are integers and must be equal; the
scores and losses are f32 at rtol 1e-5.
"""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid

from _torch_port import train_both

torch.set_num_threads(1)

# the modules (``layers.beam_search`` is also the function's name)
j_bs = importlib.import_module("paddle_tpu.layers.beam_search")
t_bs = importlib.import_module("paddle_tpu_torch.layers.beam_search")

V, T, EOS = 5, 3, 4


def _table(seed, T=T):
    tbl = np.random.RandomState(seed).randn(T, V, V).astype("float32")
    return tbl - np.log(np.exp(tbl).sum(-1, keepdims=True))


def _exhaustive_best(tbl, bos):
    best, best_s = None, -np.inf
    for path in itertools.product(range(V), repeat=T):
        s, prev, done = 0.0, bos, False
        for t, tok in enumerate(path):
            if done:
                if tok != EOS:
                    s = -np.inf
                    break
                continue
            s += tbl[t, prev, tok]
            prev = tok
            done = tok == EOS
        if s > best_s:
            best, best_s = path, s
    return np.array(best), best_s


def _both_searches(seed, B, K, max_len=T, length_penalty=0.0, greedy=False):
    tbl = _table(seed, max_len)
    tt, jt = torch.as_tensor(tbl), jnp.asarray(tbl)

    def t_step(tokens, state):
        return tt[state["t"]][tokens], {"t": state["t"] + 1,
                                        "last": tokens.clone()}

    def j_step(tokens, state):
        return jt[state["t"]][tokens], {"t": state["t"] + 1,
                                        "last": tokens.astype(jnp.int32)}

    if greedy:
        t = t_bs.greedy_search(t_step, {"t": 0, "last": torch.zeros(
            B, dtype=torch.int64)}, B, V, 0, EOS, max_len)
        j = j_bs.greedy_search(j_step, {"t": 0, "last": jnp.zeros(
            B, jnp.int32)}, B, V, 0, EOS, max_len)
    else:
        t = t_bs.beam_search(t_step, {"t": 0, "last": torch.zeros(
            B * K, dtype=torch.int64)}, B, K, V, 0, EOS, max_len,
            length_penalty=length_penalty)
        j = j_bs.beam_search(j_step, {"t": 0, "last": jnp.zeros(
            B * K, jnp.int32)}, B, K, V, 0, EOS, max_len,
            length_penalty=length_penalty)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-5)
    return t, tbl


def test_full_beam_finds_the_optimum():
    (seqs, scores), tbl = _both_searches(0, B=2, K=V)
    want_path, want_score = _exhaustive_best(tbl, 0)
    for b in range(2):
        np.testing.assert_array_equal(seqs[b, 0].numpy(), want_path)
        np.testing.assert_allclose(float(scores[b, 0]), want_score,
                                   rtol=1e-5)


@pytest.mark.parametrize("seed,K", [(7, 3), (3, 2), (11, 4)])
def test_beam_search_matches(seed, K):
    (seqs, scores), _ = _both_searches(seed, B=3, K=K, max_len=6)
    assert np.all(np.diff(scores.numpy(), axis=1) <= 1e-6)


def test_beam_search_length_penalty_matches():
    _both_searches(5, B=2, K=3, max_len=5, length_penalty=0.6)


def test_greedy_matches_and_beam_is_no_worse():
    (g_seq, g_score), _ = _both_searches(7, B=1, K=1, greedy=True)
    (b_seq, b_score), _ = _both_searches(7, B=1, K=3)
    assert float(b_score[0, 0]) >= float(g_score[0]) - 1e-6


def test_beam_search_state_follows_the_beams():
    """A per-beam state leaf is reordered with its beam: a history of
    the tokens each beam consumed, plus the tokens of the last step,
    gives the prefixes of the final sequences."""
    tbl = torch.as_tensor(_table(3, T=4))
    seen = []

    def step(tokens, state):
        seen.append(torch.cat([state["hist"], tokens[:, None]], 1))
        return tbl[state["t"]][tokens], {"t": state["t"] + 1,
                                         "hist": seen[-1]}

    seqs, _ = t_bs.beam_search(
        step, {"t": 0, "hist": torch.zeros((3, 0), dtype=torch.int64)},
        1, 3, V, 0, EOS, 4)
    prefixes = {tuple(h[1:].tolist()) for h in seen[-1]}
    for k in range(3):
        assert tuple(seqs[0, k, :3].tolist()) in prefixes


def test_beam_search_decode_backtraces_parents():
    Tn, Bn, K = 5, 2, 3
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 9, (Tn, Bn, K)).astype("int64")
    scores = np.cumsum(rng.randn(Tn, Bn, K), 0).astype("float32")
    parents = rng.randint(0, K, (Tn, Bn, K)).astype("int32")

    def b(pkg, fluid):
        L = fluid.layers
        i = L.data(name="ids", shape=[Tn, Bn, K], dtype="int64",
                   append_batch_size=False)
        s = L.data(name="sc", shape=[Tn, Bn, K], dtype="float32",
                   append_batch_size=False)
        p = L.data(name="par", shape=[Tn, Bn, K], dtype="int32",
                   append_batch_size=False)
        return list(L.beam_search_decode(i, s, K, EOS, parents=p)) + list(
            L.beam_search_decode(i, s, K, EOS))

    r = train_both(b, {"ids": ids, "sc": scores, "par": parents}, 1)
    for t, j in zip(r["t_out"][0], r["j_out"][0]):
        if np.asarray(j).dtype.kind in "iu":
            np.testing.assert_array_equal(np.asarray(t),
                                          np.asarray(j).astype(np.int64))
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6)
    seqs = r["t_out"][0][0]
    # the best beam's last token is the last step's best selection
    best = np.argmax(scores[-1], axis=1)
    np.testing.assert_array_equal(seqs[:, 0, -1],
                                  ids[-1, np.arange(Bn), best])


def _beam_ce_oracle(ids, scores, gold, lens, gold_len):
    losses = []
    for b in range(ids.shape[0]):
        K = ids.shape[1]
        label = K
        for k in range(K):
            if lens[b, k] == gold_len[b] and np.array_equal(
                    ids[b, k, :lens[b, k]], gold[b, :lens[b, k]]):
                label = k
                break
        aug = np.concatenate([scores[b], [0.0 if label == K else -1e9]])
        losses.append(-(aug[label] - aug.max()
                        - np.log(np.exp(aug - aug.max()).sum())))
    return np.mean(losses)


@pytest.mark.parametrize("with_lens", [True, False])
def test_cross_entropy_over_beam(with_lens):
    Bn, K, Tn = 3, 4, 5
    rng = np.random.RandomState(1)
    ids = rng.randint(1, 9, size=(Bn, K, Tn)).astype("int64")
    lens = rng.randint(1, Tn + 1, size=(Bn, K)).astype("int32")
    scores = rng.randn(Bn, K).astype("float32")
    gold = rng.randint(1, 9, size=(Bn, Tn)).astype("int64")
    gold_len = rng.randint(1, Tn + 1, size=(Bn,)).astype("int32")
    gold_len[0] = lens[0, 2]
    gold[0, :gold_len[0]] = ids[0, 2, :gold_len[0]]
    gold[1] = ids[1, 3]
    lens[1, 3] = Tn

    def b(pkg, fluid):
        L = fluid.layers
        iv = L.data(name="ids", shape=[Bn, K, Tn], dtype="int64",
                    append_batch_size=False)
        sv = L.create_parameter([Bn, K], "float32", name="sc")
        gv = L.data(name="gold", shape=[Bn, Tn], dtype="int64",
                    append_batch_size=False)
        kw = {}
        if with_lens:
            kw = dict(beam_lengths=L.data(name="lens", shape=[Bn, K],
                                          dtype="int32",
                                          append_batch_size=False),
                      gold_length=L.data(name="glen", shape=[Bn],
                                         dtype="int32",
                                         append_batch_size=False))
        loss = L.cross_entropy_over_beam(iv, sv, gv, **kw)
        fluid.append_backward(loss)
        return [loss, "sc@GRAD"]

    feed = {"ids": ids, "gold": gold}
    if with_lens:
        feed.update(lens=lens, glen=gold_len)
    r = train_both(b, feed, 1, params={"sc": scores})
    for t, j in zip(r["t_out"][0], r["j_out"][0]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    if with_lens:
        np.testing.assert_allclose(
            float(r["t_out"][0][0]),
            _beam_ce_oracle(ids, scores, gold, lens, gold_len), rtol=1e-5)


def _mt_beam_program(V_=12, D=16, Tn=4, Bn=4, K=4, S=6):
    def b(pkg, fluid):
        L = fluid.layers
        sv = L.data(name="src", shape=[Bn, Tn], dtype="int64",
                    append_batch_size=False)
        ids_v = L.data(name="bids", shape=[Bn, S, Tn], dtype="int64",
                       append_batch_size=False, lod_level=2)
        sel_v = L.data(name="sel", shape=[Bn, K], dtype="int32",
                       append_batch_size=False)
        gv = L.data(name="gold", shape=[Bn, Tn], dtype="int64",
                    append_batch_size=False)
        ids_sel = L.sub_nested_seq(ids_v, sel_v)
        ctx = L.reduce_mean(L.embedding(sv, size=[V_, D]), dim=1)
        cvec = L.reduce_mean(L.embedding(ids_sel, size=[V_, D]), dim=2)
        scores = L.reduce_sum(L.elementwise_mul(
            cvec, L.unsqueeze(ctx, axes=[1])), dim=-1)
        loss = L.cross_entropy_over_beam(ids_sel, scores, gv)
        fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
        return [loss, scores]
    return b


def _mt_beam_feed(V_=12, Tn=4, Bn=4, K=4, S=6):
    rng = np.random.RandomState(7)
    src = rng.randint(2, V_, size=(Bn, Tn)).astype("int64")
    gold = ((src + 1) % (V_ - 2) + 2).astype("int64")
    cand = rng.randint(2, V_, size=(Bn, S, Tn)).astype("int64")
    cand[:, 2, :] = gold
    beams = tfluid.LoDTensor(cand, np.full((Bn, S), Tn, np.int32),
                             outer_lengths=np.full((Bn,), S, np.int32))
    assert beams.lod()[0] == list(range(0, Bn * S + 1, S))
    return {"src": src, "bids": np.asarray(beams),
            "bids@LEN": beams.lengths, "bids@LEN0": beams.outer_lengths,
            "sel": np.tile(np.array([2, 0, 3, 5], np.int32)[None], (Bn, 1)),
            "gold": gold}


def test_machine_translation_beam_training_matches_the_jax_package():
    r = train_both(_mt_beam_program(), _mt_beam_feed(), 3)
    for j, t in zip(r["j_out"], r["t_out"]):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for n in r["state"]:
        np.testing.assert_allclose(r["t_state"][n], r["j_state"][n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_machine_translation_beam_training_end_to_end():
    """test_nested_lod.py's acceptance path on the port: 150 Adam steps
    drop the beam loss below 0.15 of its start and rank gold first."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 5
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss, scores = _mt_beam_program()("torch", tfluid)
    feed = _mt_beam_feed()
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(150):
        out, sc = exe.run(main, feed=feed, fetch_list=[loss, scores],
                          scope=scope)
        losses.append(float(out))
    assert losses[-1] < losses[0] * 0.15, (losses[0], losses[-1])
    assert (np.argmax(sc, axis=1) == 0).all(), sc
