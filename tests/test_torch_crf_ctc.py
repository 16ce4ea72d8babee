"""The port's CRF, CTC, edit distance, greedy CTC decoding and
``chunk_eval`` against the JAX package and against the brute-force
numpy oracles of tests/test_crf_ctc.py (every path, every alignment).

Tolerances: the CRF and CTC losses and their gradients at rtol 1e-5
against the JAX package (atol 1e-6 of the largest magnitude), at rtol
1e-4 against the enumerations (as the oracle test); Viterbi paths, CTC
decodes, edit distances and chunk counts exact.
"""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid

from _torch_port import package, train_both

torch.set_num_threads(1)


def crf_brute(em, trans, length):
    N = em.shape[1]
    start, stop, tr = trans[0], trans[1], trans[2:]
    scores = {}
    for path in itertools.product(range(N), repeat=length):
        s = start[path[0]] + em[0, path[0]]
        for t in range(1, length):
            s += tr[path[t - 1], path[t]] + em[t, path[t]]
        scores[path] = s + stop[path[length - 1]]
    vals = np.array(list(scores.values()))
    m = vals.max()
    return m + np.log(np.exp(vals - m).sum()), np.array(
        max(scores, key=scores.get))


def ctc_brute(lp, labels, T):
    total = -np.inf
    for align in itertools.product(range(lp.shape[1]), repeat=T):
        collapsed, prev = [], None
        for a in align:
            if a != prev:
                collapsed.append(a)
            prev = a
        if [c for c in collapsed if c != 0] == list(labels):
            total = np.logaddexp(total, sum(lp[t, align[t]]
                                            for t in range(T)))
    return -total


def compare(r, rtol=1e-5):
    for k, (t, j) in enumerate(zip(r["t_out"][0], r["j_out"][0])):
        t, j = np.asarray(t), np.asarray(j)
        assert t.shape == j.shape, k
        if j.dtype.kind in "biu":
            np.testing.assert_array_equal(t.astype(np.int64),
                                          j.astype(np.int64), "fetch %d" % k)
        else:
            np.testing.assert_allclose(
                t, j, rtol=rtol,
                atol=1e-6 * max(float(np.nanmax(np.abs(j))), 1),
                err_msg="fetch %d" % k)
    return r["t_out"][0]


B, T, N = 3, 4, 3
LENS = np.array([4, 2, 3], np.int64)


def _crf(seed, decode=None, with_len=True, named=False):
    rng = np.random.RandomState(seed)
    em = rng.randn(B, T, N).astype("float32")
    lbl = rng.randint(0, N, (B, T)).astype("int64")
    trans = (rng.randn(N + 2, N) * 0.5).astype("float32")
    feed = {"em": em, "lbl": lbl}
    if with_len:
        feed["em@LEN"] = LENS

    def b(pkg, fluid):
        L = fluid.layers
        x = L.data(name="em", shape=[B, T, N], dtype="float32",
                   append_batch_size=False, lod_level=1 if with_len else 0)
        w = L.create_parameter([B, T, N], "float32", name="w")
        y = L.data(name="lbl", shape=[B, T], dtype="int64",
                   append_batch_size=False)
        xw = L.elementwise_mul(x, w)
        attr = "crfw" if named else None
        nll = L.linear_chain_crf(xw, y, param_attr=attr)
        out = [nll]
        if decode == "path":
            out.append(L.crf_decoding(xw, param_attr=attr))
        elif decode == "label":
            out.append(L.crf_decoding(xw, param_attr=attr, label=y))
        grads = [g.name for _, g in fluid.append_backward(L.mean(nll))]
        return out + grads

    tname = "crfw" if named else "crf_transition_0"
    r = train_both(b, feed, 1, params={
        tname: trans, "w": np.ones((B, T, N), np.float32)})
    return r, em, lbl, trans


@pytest.mark.parametrize("with_len", [True, False])
def test_linear_chain_crf_matches(with_len):
    r, em, lbl, trans = _crf(0, with_len=with_len)
    nll = compare(r)[0]
    for b in range(B):
        L = int(LENS[b]) if with_len else T
        log_z, _ = crf_brute(em[b], trans, L)
        gold = (trans[0][lbl[b, 0]] + em[b, 0, lbl[b, 0]]
                + sum(trans[2 + lbl[b, t - 1]][lbl[b, t]] + em[b, t, lbl[b, t]]
                      for t in range(1, L)) + trans[1][lbl[b, L - 1]])
        np.testing.assert_allclose(nll[b, 0], log_z - gold, rtol=1e-4)


@pytest.mark.parametrize("named", [False, True])
def test_crf_decoding_matches(named):
    r, em, _, trans = _crf(1, decode="path", named=named)
    path = compare(r)[1]
    for b in range(B):
        L = int(LENS[b])
        _, best = crf_brute(em[b], trans, L)
        np.testing.assert_array_equal(path[b, :L], best)
        assert np.all(path[b, L:] == 0)


def test_crf_decoding_against_labels():
    r, *_ = _crf(2, decode="label")
    hits = compare(r)[1]
    assert set(np.unique(hits)) <= {0, 1}


def test_crf_decoding_ties_pick_the_lower_tag():
    em = np.zeros((1, 3, 3), np.float32)
    trans = np.zeros((5, 3), np.float32)
    from paddle_tpu_torch.layers.crf import viterbi

    path = viterbi(torch.as_tensor(em), torch.as_tensor(trans),
                   torch.tensor([3]))
    assert path.tolist() == [[0, 0, 0]]


def _ctc(norm=False, with_len=True):
    Bc, Tc, C, S = 2, 4, 3, 2
    rng = np.random.RandomState(2)
    logits = rng.randn(Bc, Tc, C).astype("float32")
    labels = np.array([[1, 2], [2, 0]], "int64")
    feed = {"logits": logits, "lbl": labels}
    if with_len:
        feed.update({"logits@LEN": np.array([4, 3], "int64"),
                     "lbl@LEN": np.array([2, 1], "int64")})

    def b(pkg, fluid):
        L = fluid.layers
        lvl = 1 if with_len else 0
        x = L.data(name="logits", shape=[Bc, Tc, C], dtype="float32",
                   append_batch_size=False, lod_level=lvl)
        w = L.create_parameter([Bc, Tc, C], "float32", name="w")
        y = L.data(name="lbl", shape=[-1, S], dtype="int64",
                   append_batch_size=False, lod_level=lvl)
        loss = L.warpctc(L.elementwise_mul(x, w), y, norm_by_times=norm)
        grads = [g.name for _, g in fluid.append_backward(L.mean(loss))]
        return [loss] + grads

    r = train_both(b, feed, 1, params={"w": np.ones((Bc, Tc, C), "f")})
    return compare(r)[0], logits, labels


@pytest.mark.parametrize("norm", [False, True])
def test_warpctc_matches(norm):
    loss, logits, labels = _ctc(norm)
    for b, (Tb, nl) in enumerate([(4, 2), (3, 1)]):
        lp = logits[b, :Tb].astype(np.float64)
        lp = lp - np.log(np.exp(lp).sum(1, keepdims=True))
        want = ctc_brute(lp, list(labels[b, :nl]), Tb)
        np.testing.assert_allclose(loss[b, 0], want / (Tb if norm else 1),
                                   rtol=1e-4)


def test_warpctc_without_length_companions():
    loss, logits, labels = _ctc(with_len=False)
    lp = logits[1].astype(np.float64)
    lp = lp - np.log(np.exp(lp).sum(1, keepdims=True))
    np.testing.assert_allclose(loss[1, 0], ctc_brute(lp, [2], 4), rtol=1e-4)


def _int_program(build, feed):
    out = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            fetch = build(fluid.layers)
        kw = {} if pkg == "jax" else {"scope": tfluid.Scope()}
        out[pkg] = [np.asarray(o) for o in fluid.Executor(
            fluid.CPUPlace()).run(main, feed=feed, fetch_list=fetch, **kw)]
    return compare({"t_out": [out["torch"]], "j_out": [out["jax"]]})


HYP = np.array([[1, 2, 3, 0], [1, 1, 0, 0], [4, 5, 6, 7]], "int64")
REF = np.array([[1, 3, 3], [2, 2, 2], [4, 6, 0]], "int64")


@pytest.mark.parametrize("normalized,ignored", [(False, None), (True, None),
                                                (False, [1]), (True, [3, 6])])
def test_edit_distance(normalized, ignored):
    def build(L):
        x = L.data(name="hyp", shape=[-1, 4], dtype="int64",
                   append_batch_size=False, lod_level=1)
        y = L.data(name="ref", shape=[-1, 3], dtype="int64",
                   append_batch_size=False, lod_level=1)
        return list(L.edit_distance(x, y, normalized=normalized,
                                    ignored_tokens=ignored))

    d, err = _int_program(build, {"hyp": HYP, "ref": REF,
                                  "hyp@LEN": np.array([3, 2, 4], "int64"),
                                  "ref@LEN": np.array([3, 3, 2], "int64")})
    if not normalized and ignored is None:
        np.testing.assert_allclose(d[:, 0], [1.0, 3.0, 2.0])
        np.testing.assert_array_equal(err, [1, 1, 1])


def test_ctc_greedy_decoder():
    rng = np.random.RandomState(4)
    x = rng.rand(3, 7, 4).astype("float32")
    x[0, :, 0] += 0.8 * (np.arange(7) % 2)      # blanks between repeats

    def build(L):
        v = L.data(name="x", shape=[-1, 7, 4], dtype="float32",
                   append_batch_size=False, lod_level=1)
        return list(L.ctc_greedy_decoder(v, blank=0))

    _int_program(build, {"x": x, "x@LEN": np.array([7, 3, 5], np.int32)})


@pytest.mark.parametrize("scheme,types,excluded", [
    ("IOB", 2, None), ("IOE", 2, None), ("IOBES", 2, None),
    ("plain", 3, None), ("IOB", 3, [1])])
def test_chunk_eval(scheme, types, excluded):
    rng = np.random.RandomState(5)
    n_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    hi = types * n_tags + 1          # the last id is Other
    feed = {"inf": rng.randint(0, hi, (4, 9)).astype("int64"),
            "lab": rng.randint(0, hi, (4, 9)).astype("int64"),
            "inf@LEN": np.array([9, 5, 1, 7], np.int32)}
    feed["lab"][1] = feed["inf"][1]

    def build(L):
        inf = L.data(name="inf", shape=[-1, 9], dtype="int64",
                     append_batch_size=False, lod_level=1)
        lab = L.data(name="lab", shape=[-1, 9], dtype="int64",
                     append_batch_size=False)
        return list(L.chunk_eval(inf, lab, scheme, types,
                                 excluded_chunk_types=excluded))

    _int_program(build, feed)
