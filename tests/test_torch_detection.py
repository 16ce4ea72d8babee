"""paddle_tpu_torch.layers.detection held to paddle_tpu.layers.detection:
every test of tests/test_detection_ssd.py but the reader one (the
program readers are ROADMAP Queue A 6), run in both packages on the
same seeded inputs (parameters carried over with ``state_from_numpy``)
with its numpy oracles applied to the port; and the detection ops of
tests/test_parity_ops.py (``prior_box``, ``box_coder``,
``multiclass_nms``), ``iou_similarity``, a random ``detection_output``,
the NMS launch count, the ``_host_sync`` refusal of ``detection_map``
and build-time shape inference of every op.

Kept indices, labels and match indices are exactly equal; float
outputs within 1e-5 of the array's largest magnitude.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

from _torch_port import package, symbol_table

torch.set_num_threads(1)

TOL = 1e-5
# each layer of the module -> the tests here that hold it to the JAX
# package ("test[case]": one case of the file's parametrised table)
PARITY = {
    "iou_similarity": ("test_iou_similarity",),
    "prior_box": ("test_prior_box_shapes_and_range",),
    "box_coder": ("test_box_coder_roundtrip",),
    "multiclass_nms": ("test_multiclass_nms_suppresses_overlaps",),
    "bipartite_match": ("test_bipartite_match",
                        "test_bipartite_match_per_prediction",
                        "test_bipartite_match_from_lengths_and_one_instance"),
    "target_assign": ("test_target_assign", "test_target_assign_negatives",
                      "test_target_assign_pairwise_targets"),
    "ssd_loss": ("test_ssd_loss_properties", "test_ssd_loss_random"),
    "detection_output": ("test_detection_output_and_map",
                         "test_detection_output_random"),
    "detection_map": ("test_detection_output_and_map",),
    "multi_box_head": ("test_multi_box_head_shapes",
                       "test_multi_box_head_sizes_steps_and_caffe_order"),
    "anchor_generator": ("test_anchor_generator",),
    "rpn_target_assign": ("test_rpn_target_assign",
                          "test_rpn_target_assign_random_batch"),
    "nms_jax": ("test_nms_jax_matches_the_jax_package",),
    "update_map_from_padded": (
        "test_update_map_from_padded_matches_the_jax_package",),
}


def _data(L, name, shape, dtype="float32", lod_level=0):
    return L.data(name=name, shape=shape, dtype=dtype,
                  append_batch_size=False, lod_level=lod_level)


def run_both(build, feeds, fetch_n=1):
    """{pkg: fetched arrays} of ``build(layers)``'s first ``fetch_n``
    outputs, one run in each package, the port from the JAX package's
    persistables; the programs' symbol tables are equal."""
    progs = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            outs = build(fluid.layers)
            outs = list(outs) if isinstance(outs, (list, tuple)) \
                else [outs]
        progs[pkg] = main, startup, [o.name for o in outs[:fetch_n]]
    assert symbol_table(progs["torch"][0]) == symbol_table(progs["jax"][0])
    main, startup, names = progs["jax"]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
        j_out = [np.asarray(o) for o in exe.run(main, feed=feeds,
                                                fetch_list=names)]
    main, _, names = progs["torch"]
    place, t_scope = tfluid.CPUPlace(), tfluid.Scope()
    tfluid.state_from_numpy(state, t_scope, place, program=main)
    t_out = tfluid.Executor(place).run(main, feed=feeds, fetch_list=names,
                                       scope=t_scope)
    return {"jax": j_out, "torch": t_out}


def close(got, want, name="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def same(res, exact=()):
    """The port's outputs against the JAX package's: those at positions
    ``exact`` equal in value, the rest within the tolerance."""
    for i, (got, want) in enumerate(zip(res["torch"], res["jax"])):
        if i in exact:
            np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                          np.asarray(want).astype(np.int64))
        else:
            close(got, want, "output %d" % i)
    return res["torch"]


def same_rows(got, want):
    """Detection rows: labels exactly, the rest within the tolerance."""
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    close(got, want)


rng = np.random.RandomState(3)


def _np_bipartite(dist, nvalid):
    """Numpy oracle for greedy bipartite matching (reference
    bipartite_match_op.cc BipartiteMatch)."""
    K, M = dist.shape
    d = dist.copy()
    d[nvalid:, :] = -1e9
    row_of_col = np.full(M, -1, np.int32)
    dist_of_col = np.zeros(M, np.float32)
    for _ in range(min(K, M)):
        r, c = np.unravel_index(np.argmax(d), d.shape)
        if d[r, c] <= 0:
            break
        row_of_col[c] = r
        dist_of_col[c] = d[r, c]
        d[r, :] = -1e9
        d[:, c] = -1e9
    return row_of_col, dist_of_col


def test_bipartite_match():
    B, K, M = 2, 3, 5
    dist = rng.rand(B, K, M).astype("f")
    cnt = np.array([3, 2], np.int32)
    idx, dst = same(run_both(
        lambda L: L.bipartite_match(_data(L, "d", [-1, K, M]),
                                    gt_count=_data(L, "n", [-1], "int32")),
        {"d": dist, "n": cnt}, fetch_n=2), exact=(0,))
    for b in range(B):
        ri, rd = _np_bipartite(dist[b], cnt[b])
        np.testing.assert_array_equal(idx[b], ri)
        np.testing.assert_allclose(dst[b], rd, rtol=1e-5)


def test_bipartite_match_per_prediction():
    # per_prediction adds argmax-row matches for unmatched cols over thr
    dist = np.array([[[0.9, 0.8, 0.1, 0.75]]], np.float32)
    cnt = np.array([1], np.int32)
    idx, dst = same(run_both(
        lambda L: L.bipartite_match(
            _data(L, "d", [-1, 1, 4]), match_type="per_prediction",
            dist_threshold=0.7, gt_count=_data(L, "n", [-1], "int32")),
        {"d": dist, "n": cnt}, fetch_n=2), exact=(0,))
    np.testing.assert_array_equal(idx[0], [0, 0, -1, 0])
    np.testing.assert_allclose(dst[0], [0.9, 0.8, 0.0, 0.75], rtol=1e-5)


def test_bipartite_match_from_lengths_and_one_instance():
    """Row counts from the ``@LEN`` companion of a sequence input, and a
    2-D matrix (one instance); ties go to the lower flat index."""
    B, K, M = 3, 4, 6
    dist = rng.rand(B, K, M).astype("f")
    dist[1, 0, 2] = dist[1, 1, 4] = dist[1].max()
    lens = np.array([4, 2, 1], np.int64)
    same(run_both(
        lambda L: L.bipartite_match(_data(L, "d", [-1, K, M],
                                          lod_level=1)),
        {"d": dist, "d@LEN": lens}, fetch_n=2), exact=(0,))
    same(run_both(
        lambda L: L.bipartite_match(_data(L, "d", [K, M])),
        {"d": dist[0]}, fetch_n=2), exact=(0,))


def test_target_assign():
    B, G, P, K = 2, 3, 4, 2
    x = rng.randn(B, G, K).astype("f")
    midx = np.array([[1, -1, 0, 2], [0, 0, -1, 1]], np.int32)
    out, w = same(run_both(
        lambda L: L.target_assign(
            _data(L, "x", [-1, G, K]), _data(L, "m", [-1, P], "int32"),
            mismatch_value=7.0),
        {"x": x, "m": midx}, fetch_n=2))
    for b in range(B):
        for j in range(P):
            if midx[b, j] >= 0:
                np.testing.assert_allclose(out[b, j], x[b, midx[b, j]],
                                           rtol=1e-6)
                assert w[b, j, 0] == 1.0
            else:
                np.testing.assert_allclose(out[b, j], 7.0)
                assert w[b, j, 0] == 0.0


def test_target_assign_negatives():
    B, G, P = 1, 2, 5
    x = rng.randn(B, G, 1).astype("f")
    midx = np.array([[0, -1, 1, -1, -1]], np.int32)
    neg = np.array([[1, 4, -1]], np.int32)   # padded with -1
    out, w = same(run_both(
        lambda L: L.target_assign(
            _data(L, "x", [-1, G, 1]), _data(L, "m", [-1, P], "int32"),
            negative_indices=_data(L, "neg", [-1, 3], "int32"),
            mismatch_value=0.0),
        {"x": x, "m": midx, "neg": neg}, fetch_n=2))
    np.testing.assert_array_equal(w[0, :, 0], [1, 1, 1, 0, 1])
    assert out[0, 1, 0] == 0.0 and out[0, 4, 0] == 0.0


def test_target_assign_pairwise_targets():
    B, G, P, K = 2, 3, 5, 4
    x = rng.randn(B, G, P, K).astype("f")
    midx = np.array([[2, -1, 0, 1, 1], [-1, 0, 2, 2, -1]], np.int32)
    same(run_both(
        lambda L: L.target_assign(
            _data(L, "x", [-1, G, P, K]), _data(L, "m", [-1, P], "int32"),
            mismatch_value=-1.0),
        {"x": x, "m": midx}, fetch_n=2))


def _ssd_case():
    B, P, C, G = 2, 8, 4, 3
    prior = np.zeros((P, 4), np.float32)
    for i in range(P):
        prior[i] = [i / P, 0.2, (i + 1) / P, 0.8]
    pvar = np.full((P, 4), 0.1, np.float32)
    gt = np.zeros((B, G, 4), np.float32)
    gt[0, 0] = prior[1]
    gt[0, 1] = prior[5]
    gt[1, 0] = prior[3]
    lab = np.zeros((B, G), np.int64)
    lab[0, 0], lab[0, 1], lab[1, 0] = 1, 2, 3
    cnt = np.array([2, 1], np.int32)
    return (B, P, C, G), prior, pvar, gt, lab, cnt


def _ssd_loss(dims, feed, **kw):
    B, P, C, G = dims
    return same(run_both(
        lambda L: L.ssd_loss(
            _data(L, "loc", [-1, P, 4]), _data(L, "conf", [-1, P, C]),
            _data(L, "gt", [-1, G, 4]), _data(L, "lab", [-1, G], "int64"),
            _data(L, "prior", [P, 4]), _data(L, "pvar", [P, 4]),
            gt_count=_data(L, "n", [-1], "int32"), **kw), feed))[0]


def test_ssd_loss_properties():
    dims, prior, pvar, gt, lab, cnt = _ssd_case()
    B, P, C, G = dims
    base = {"gt": gt, "lab": lab, "prior": prior, "pvar": pvar, "n": cnt}
    bad = _ssd_loss(dims, {**base, "loc": rng.randn(B, P, 4).astype("f") * 3,
                           "conf": rng.randn(B, P, C).astype("f")})
    # perfect predictions: loc == encoded gt (0 offset since gt == prior),
    # confidence peaked on the right class
    conf_good = np.zeros((B, P, C), np.float32)
    conf_good[:, :, 0] = 20.0
    for b_, p_, c_ in [(0, 1, 1), (0, 5, 2), (1, 3, 3)]:
        conf_good[b_, p_, 0] = 0.0
        conf_good[b_, p_, c_] = 20.0
    good = _ssd_loss(dims, {**base, "loc": np.zeros((B, P, 4), np.float32),
                            "conf": conf_good})
    assert np.all(np.isfinite(bad)) and np.all(np.isfinite(good))
    assert good.sum() < bad.sum() * 0.05
    assert good.shape == (B, 1)


@pytest.mark.parametrize("kw", [
    dict(), dict(match_type="bipartite"), dict(normalize=False),
    dict(sample_size=1, neg_pos_ratio=10.0), dict(overlap_threshold=0.3,
                                                  neg_overlap=0.2)],
    ids=["default", "bipartite", "unnormalized", "sample_size",
         "thresholds"])
def test_ssd_loss_random(kw):
    """Random boxes against random priors: matching, mining and the
    loss in both packages."""
    r = np.random.RandomState(11)
    B, P, C, G = 3, 40, 5, 4

    def boxes(*shape):
        lo = r.rand(*shape, 2) * 0.7
        return np.concatenate([lo, lo + 0.05 + r.rand(*shape, 2) * 0.3],
                              -1).astype(np.float32)

    feed = {"loc": r.randn(B, P, 4).astype("f"),
            "conf": r.randn(B, P, C).astype("f"), "gt": boxes(B, G),
            "lab": r.randint(1, C, (B, G)).astype(np.int64),
            "prior": boxes(P), "pvar": np.full((P, 4), 0.1, np.float32),
            "n": np.array([4, 1, 2], np.int32)}
    loss = _ssd_loss((B, P, C, G), feed, **kw)
    assert np.isfinite(loss).all()


def test_detection_output_and_map():
    B, P, C = 1, 6, 3
    prior = np.zeros((P, 4), np.float32)
    for i in range(P):
        prior[i] = [i / P, 0.1, (i + 0.9) / P, 0.9]
    pvar = np.full((P, 4), 0.1, np.float32)
    loc = np.zeros((B, P, 4), np.float32)           # decode → priors
    scores = np.zeros((B, P, C), np.float32)
    scores[0, :, 0] = 5.0                           # background
    scores[0, 2, :] = [0.0, 9.0, 0.0]               # prior2 → class 1
    scores[0, 4, :] = [0.0, 0.0, 9.0]               # prior4 → class 2
    res = run_both(
        lambda L: L.detection_output(
            _data(L, "loc", [-1, P, 4]), _data(L, "sc", [-1, P, C]),
            _data(L, "prior", [P, 4]), _data(L, "pvar", [P, 4]),
            keep_top_k=4, score_threshold=0.5),
        {"loc": loc, "sc": scores, "prior": prior, "pvar": pvar})
    same_rows(res["torch"][0], res["jax"][0])
    det = res["torch"][0]
    assert det.shape == (B, 4, 6)
    kept = det[0][det[0, :, 0] >= 0]
    assert sorted(kept[:, 0].tolist()) == [1.0, 2.0]
    row1 = kept[kept[:, 0] == 1.0][0]
    np.testing.assert_allclose(row1[2:], prior[2], atol=1e-5)

    # those detections and matching GT into detection_map → mAP 1.0
    gt = np.full((B, 3, 6), -1.0, np.float32)
    gt[0, 0] = [1, 0, *prior[2]]
    gt[0, 1] = [2, 0, *prior[4]]
    mp, = same(run_both(
        lambda L: L.detection_map(
            _data(L, "det", [-1, 4, 6]), _data(L, "gt", [-1, 3, 6]),
            class_num=C, overlap_threshold=0.5),
        {"det": det, "gt": gt}), exact=())
    np.testing.assert_allclose(mp, 1.0, atol=1e-6)


def _random_detection(B, P, C, seed):
    r = np.random.RandomState(seed)
    lo = r.rand(P, 2) * 0.8
    prior = np.concatenate([lo, lo + 0.05 + r.rand(P, 2) * 0.2],
                           -1).astype(np.float32)
    return {"loc": (r.randn(B, P, 4) * 0.5).astype("f"),
            "sc": (r.randn(B, P, C) * 2).astype("f"), "prior": prior,
            "pvar": np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                            (P, 1))}


@pytest.mark.parametrize("nms_top_k,keep_top_k,background", [
    (20, 30, 0), (50, 10, 2), (8, 64, -1)])
def test_detection_output_random(nms_top_k, keep_top_k, background):
    """Dense overlapping random boxes over several classes: the kept rows
    (labels exactly), their order and the -1 padding equal the JAX
    package's."""
    B, P, C = 2, 50, 5
    res = run_both(
        lambda L: L.detection_output(
            _data(L, "loc", [-1, P, 4]), _data(L, "sc", [-1, P, C]),
            _data(L, "prior", [P, 4]), _data(L, "pvar", [P, 4]),
            background_label=background, nms_threshold=0.45,
            nms_top_k=nms_top_k, keep_top_k=keep_top_k,
            score_threshold=0.05),
        _random_detection(B, P, C, 5))
    got, want = res["torch"][0], res["jax"][0]
    same_rows(got, want)
    assert (got[..., 0] >= 0).sum() > 10     # NMS kept something, and
    assert (got[..., 0] < 0).any() or keep_top_k <= 30  # padded where short


def test_multiclass_nms_suppresses_overlaps():
    """tests/test_parity_ops.py's case and a random one, both packages."""
    boxes = np.array([[0, 0, 1, 1], [0.05, 0.05, 1.05, 1.05],
                      [3, 3, 4, 4]], "float32")
    scores = np.array([[0.1, 0.1, 0.1], [0.9, 0.8, 0.7]], "float32")

    def build(L):
        return L.multiclass_nms(
            _data(L, "b", [3, 4]), _data(L, "s", [2, 3]),
            score_threshold=0.2, nms_top_k=3, keep_top_k=3,
            nms_threshold=0.5)

    res = run_both(build, {"b": boxes, "s": scores})
    same_rows(res["torch"][0], res["jax"][0])
    out = res["torch"][0]
    kept = out[out[:, 0] >= 0]
    assert kept.shape[0] == 2
    np.testing.assert_allclose(sorted(kept[:, 1]), [0.7, 0.9], rtol=1e-6)


def test_nms_launches_do_not_grow_with_the_class_count():
    """The port's NMS runs every (image, class) row in one loop: the ops
    ``detection_output`` dispatches are the same for 3 and 21 classes."""
    from paddle_tpu_torch.layers.detection import _multiclass_nms

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for C in (3, 21):
        d = _random_detection(2, 30, C, 7)
        boxes = torch.from_numpy(d["prior"])[None].expand(2, -1, -1)
        scores = torch.softmax(torch.from_numpy(d["sc"]), -1).transpose(1, 2)
        with Count() as c:
            _multiclass_nms(boxes, scores, 0.01, 16, 20, 0.45, 0)
        counts[C] = c.n
    assert counts[3] == counts[21], counts
    assert counts[3] > 16          # the 16-step loop dispatched once


def test_multi_box_head_shapes():
    B = 2
    feeds = {"f1": rng.randn(B, 8, 8, 8).astype("f"),
             "f2": rng.randn(B, 8, 4, 4).astype("f"),
             "f3": rng.randn(B, 8, 2, 2).astype("f"),
             "img": rng.randn(B, 3, 32, 32).astype("f")}

    def build(L):
        return L.multi_box_head(
            inputs=[_data(L, "f1", [-1, 8, 8, 8]),
                    _data(L, "f2", [-1, 8, 4, 4]),
                    _data(L, "f3", [-1, 8, 2, 2])],
            image=_data(L, "img", [-1, 3, 32, 32]),
            num_classes=5, min_ratio=20, max_ratio=90,
            aspect_ratios=[[2.0], [2.0, 3.0], [2.0]], base_size=32,
            flip=True, clip=True, offset=0.5)

    loc, conf, boxes, vars_ = same(run_both(build, feeds, fetch_n=4))
    n_total = boxes.shape[0]
    assert loc.shape == (B, n_total, 4)
    assert conf.shape == (B, n_total, 5)
    assert vars_.shape == (n_total, 4)
    assert np.all(boxes >= 0.0) and np.all(boxes <= 1.0)   # clip=True


def test_multi_box_head_sizes_steps_and_caffe_order():
    """Explicit min/max sizes, steps and the Caffe prior order
    (``min_max_aspect_ratios_order``), a 3x3 head with padding."""
    B = 1
    feeds = {"f1": rng.randn(B, 4, 5, 5).astype("f"),
             "f2": rng.randn(B, 4, 3, 3).astype("f"),
             "img": rng.randn(B, 3, 40, 40).astype("f")}
    same(run_both(lambda L: L.multi_box_head(
        inputs=[_data(L, "f1", [-1, 4, 5, 5]),
                _data(L, "f2", [-1, 4, 3, 3])],
        image=_data(L, "img", [-1, 3, 40, 40]), base_size=40,
        num_classes=3, aspect_ratios=[[2.0], [2.0, 3.0]],
        min_sizes=[8.0, 20.0], max_sizes=[[], 30.0], steps=[8.0, 13.0],
        kernel_size=3, pad=1, min_max_aspect_ratios_order=True),
        feeds, fetch_n=4))


def test_anchor_generator():
    feat = rng.randn(1, 4, 2, 3).astype("f")
    anc, var = same(run_both(
        lambda L: L.anchor_generator(
            _data(L, "f", [-1, 4, 2, 3]), anchor_sizes=[64.0],
            aspect_ratios=[1.0, 2.0], stride=[16.0, 16.0], offset=0.5),
        {"f": feat}, fetch_n=2))
    assert anc.shape == (2, 3, 2, 4) and var.shape == (2, 3, 2, 4)
    np.testing.assert_allclose(anc[0, 0, 0], [8 - 32, 8 - 32,
                                              8 + 32, 8 + 32], rtol=1e-5)
    w = np.sqrt(64.0 ** 2 / 2.0)
    np.testing.assert_allclose(anc[0, 0, 1],
                               [8 - w / 2, 8 - w, 8 + w / 2, 8 + w],
                               rtol=1e-5)
    np.testing.assert_allclose(var[0, 0, 0], [0.1, 0.1, 0.2, 0.2])


def test_rpn_target_assign():
    B, M, G, S = 1, 16, 2, 8
    anchors = np.zeros((M, 4), np.float32)
    for i in range(M):
        anchors[i] = [i * 10, 0, i * 10 + 10, 10]
    gt = np.zeros((B, G, 4), np.float32)
    gt[0, 0] = anchors[3]                       # exact overlap → positive
    gt[0, 1] = [50.5, 0, 60.5, 10]              # near anchor 5
    cnt = np.array([2], np.int32)
    loc = rng.randn(B, M, 4).astype("f")
    sc = rng.rand(B, M, 1).astype("f")
    sp, lp, tl, tb = same(run_both(
        lambda L: L.rpn_target_assign(
            _data(L, "loc", [-1, M, 4]), _data(L, "sc", [-1, M, 1]),
            _data(L, "anc", [M, 4]), _data(L, "gt", [-1, G, 4]),
            rpn_batch_size_per_im=S, fg_fraction=0.25,
            gt_count=_data(L, "n", [-1], "int32")),
        {"loc": loc, "sc": sc, "anc": anchors, "gt": gt, "n": cnt},
        fetch_n=4))
    F = int(S * 0.25)
    assert sp.shape == (B * S, 1) and tl.shape == (B * S, 1)
    assert lp.shape == (B * F, 4) and tb.shape == (B * F, 4)
    assert set(np.unique(tl)).issubset({0.0, 1.0})
    assert tl.sum() == 2.0
    zero_rows = np.all(np.abs(tb) < 1e-6, axis=1)
    assert zero_rows.sum() >= F - 2 + 1


def test_rpn_target_assign_random_batch():
    """Several images, padded GT rows and tied IoUs (many anchors at
    IoU 0): the samples and targets equal the JAX package's."""
    r = np.random.RandomState(4)
    B, M, G, S = 3, 60, 4, 16
    lo = r.rand(M, 2) * 80
    anchors = np.concatenate([lo, lo + 8 + r.rand(M, 2) * 20],
                             -1).astype(np.float32)
    glo = r.rand(B, G, 2) * 80
    gt = np.concatenate([glo, glo + 10 + r.rand(B, G, 2) * 20],
                        -1).astype(np.float32)
    same(run_both(
        lambda L: L.rpn_target_assign(
            _data(L, "loc", [-1, M, 4]), _data(L, "sc", [-1, M, 2]),
            _data(L, "anc", [M, 4]), _data(L, "gt", [-1, G, 4]),
            rpn_batch_size_per_im=S, fg_fraction=0.5,
            rpn_positive_overlap=0.5, rpn_negative_overlap=0.2,
            gt_count=_data(L, "n", [-1], "int32")),
        {"loc": r.randn(B, M, 4).astype("f"),
         "sc": r.rand(B, M, 2).astype("f"), "anc": anchors, "gt": gt,
         "n": np.array([4, 1, 3], np.int32)}, fetch_n=4))


def test_prior_box_shapes_and_range():
    feat = np.zeros((1, 8, 4, 4), "float32")
    img = np.zeros((1, 3, 32, 32), "float32")
    boxes, variances = same(run_both(
        lambda L: L.detection.prior_box(
            _data(L, "f", [-1, 8, 4, 4]), _data(L, "im", [-1, 3, 32, 32]),
            min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[2.0],
            flip=True, clip=True),
        {"f": feat, "im": img}, fetch_n=2))
    assert boxes.shape == (4, 4, 4, 4)
    assert variances.shape == boxes.shape
    assert boxes.min() >= 0.0 and boxes.max() <= 1.0


def test_box_coder_roundtrip():
    r = np.random.RandomState(3)
    prior = np.abs(r.rand(6, 4)).astype("float32")
    prior[:, 2:] = prior[:, :2] + 0.5
    pvar = np.full((6, 4), 0.1, "float32")
    target = prior + 0.05

    def build(code_type):
        return lambda L: L.detection.box_coder(
            _data(L, "p", [-1, 4]), _data(L, "v", [-1, 4]),
            _data(L, "t", [-1, 4]), code_type)

    enc, = same(run_both(build("encode_center_size"),
                         {"p": prior, "v": pvar, "t": target}))
    dec, = same(run_both(build("decode_center_size"),
                         {"p": prior, "v": pvar, "t": enc}))
    np.testing.assert_allclose(dec, target, rtol=1e-4, atol=1e-5)


def test_iou_similarity():
    r = np.random.RandomState(8)
    lo = r.rand(7, 2)
    x = np.concatenate([lo, lo + r.rand(7, 2)], -1).astype("f")
    y = np.concatenate([lo[:5] + 0.1, lo[:5] + 0.1 + r.rand(5, 2)],
                       -1).astype("f")
    iou, = same(run_both(lambda L: L.iou_similarity(
        _data(L, "x", [-1, 4]), _data(L, "y", [-1, 4])), {"x": x, "y": y}))
    assert iou.shape == (7, 5) and (iou >= 0).all() and (iou <= 1).all()


def test_package_level_exports():
    for n in ["exponential_decay", "noam_decay", "piecewise_decay",
              "ssd_loss", "multi_box_head", "anchor_generator",
              "detection_map"]:
        assert hasattr(tfluid.layers, n), n
    assert tfluid.layers.detection.update_map_from_padded


def test_detection_map_refuses_capture():
    """The mAP op reads the device on the host: ``run_steps`` and
    ``run_graph`` refuse a program that holds it (the in-graph op or the
    evaluator's), and a detection program without it passes."""
    main = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(main, tfluid.Program()):
        L = tfluid.layers
        det = L.detection_output(
            _data(L, "loc", [-1, 6, 4]), _data(L, "sc", [-1, 6, 3]),
            _data(L, "prior", [6, 4]), _data(L, "pvar", [6, 4]))
        plain = main.clone()
        L.detection_map(det, _data(L, "gt", [-1, 3, 6]), class_num=3)
    tfluid.executor.check_capturable(plain)
    with pytest.raises(tfluid.GraphCaptureError, match="detection_map"):
        tfluid.executor.check_capturable(main)
    ev_main = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(ev_main, tfluid.Program()):
        L = tfluid.layers
        tfluid.evaluator.DetectionMAP(
            _data(L, "det", [-1, 4, 6]), _data(L, "gl", [-1, 3, 1]),
            _data(L, "gb", [-1, 3, 4]))
    with pytest.raises(tfluid.GraphCaptureError, match="detection_map"):
        tfluid.executor.check_capturable(ev_main)


def test_shape_inference_of_every_op():
    """Every detection op in one program with a symbolic batch: the
    build-time shapes (abstract evaluation on meta tensors) equal the
    JAX package's, and ``check_program`` finds no error."""
    P, C, G = 12, 4, 3

    def build(L):
        loc = _data(L, "loc", [-1, P, 4])
        conf = _data(L, "conf", [-1, P, C])
        prior = _data(L, "prior", [P, 4])
        pvar = _data(L, "pvar", [P, 4])
        gt = _data(L, "gt", [-1, G, 4], lod_level=1)
        lab = _data(L, "lab", [-1, G], "int64")
        feat = _data(L, "feat", [-1, 8, 3, 4])
        img = _data(L, "img", [-1, 3, 24, 32])
        outs = [L.iou_similarity(prior, pvar),
                L.detection.box_coder(prior, pvar, prior),
                L.multiclass_nms(prior, _data(L, "cs", [C, P]), 0.1, 5, 7)]
        outs += list(L.detection.prior_box(feat, img, [4.0], [8.0], [2.0],
                                           flip=True))
        outs += list(L.bipartite_match(_data(L, "d", [-1, G, P],
                                             lod_level=1)))
        outs += list(L.target_assign(gt, _data(L, "m", [-1, P], "int32")))
        outs.append(L.ssd_loss(loc, conf, gt, lab, prior, pvar))
        det = L.detection_output(loc, conf, prior, pvar, nms_top_k=6,
                                 keep_top_k=9)
        outs += [det, L.detection_map(det, _data(L, "gl", [-1, G, 6]),
                                      class_num=C)]
        outs += list(L.anchor_generator(feat, [16.0], [0.5, 1.0],
                                        stride=[8.0, 8.0]))
        outs += list(L.rpn_target_assign(loc, conf, prior, gt,
                                         rpn_batch_size_per_im=8))
        return outs

    tables, shapes = {}, {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            outs = build(fluid.layers)
        tables[pkg] = symbol_table(main)
        shapes[pkg] = [tuple(o.shape) for o in outs]
    assert shapes["torch"] == shapes["jax"]
    assert tables["torch"] == tables["jax"]
    assert all(s is not None for s in shapes["torch"])
    report = tfluid.analysis.check_program(main)
    assert not report.errors, str(report)


@pytest.mark.parametrize("max_out", [1, 5, 12, 15])
def test_nms_jax_matches_the_jax_package(max_out):
    """The single-class helper: kept indices and validity equal, under a
    budget below, at and above the candidate count (the JAX package's
    clipped scatter fills the last slot and the invalid ones)."""
    import jax.numpy as jnp
    from paddle_tpu.layers import detection as j_detection

    t_detection = tfluid.layers.detection

    for seed in range(4):
        r = np.random.RandomState(seed)
        lo = r.rand(12, 2)
        boxes = np.concatenate([lo, lo + 0.3], -1).astype("f")
        scores = r.rand(12).astype("f")
        for thr in (-1.0, 0.2, 0.9):
            jk, jv = j_detection.nms_jax(jnp.asarray(boxes),
                                         jnp.asarray(scores), 0.3, max_out,
                                         thr)
            tk, tv = t_detection.nms_jax(torch.from_numpy(boxes),
                                         torch.from_numpy(scores), 0.3,
                                         max_out, thr)
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("width", [6, 5])
def test_update_map_from_padded_matches_the_jax_package(width):
    """Padded detections and ground truth (with the difficult flag, or
    without) parsed into each package's ``metrics.DetectionMAP``."""
    from paddle_tpu.layers import detection as j_detection

    r = np.random.RandomState(width)
    det = np.full((3, 7, 6), -1.0, np.float32)
    lab = np.full((3, 4, width), -1.0, np.float32)
    for b in range(3):
        n = 2 + b
        lo = r.rand(n, 2) * 0.6
        gt = np.concatenate([lo, lo + 0.25], -1)
        lab[b, :n, 0] = r.randint(1, 3, n)
        lab[b, :n, -4:] = gt
        if width == 6:
            lab[b, :n, 1] = r.rand(n) < 0.3
        det[b, :n, 0] = lab[b, :n, 0]
        det[b, :n, 1] = r.rand(n)
        det[b, :n, 2:] = gt + r.randn(n, 4) * 0.05
        det[b, n, :] = [2, 0.9, 0.0, 0.0, 0.2, 0.2]
    maps = []
    for fluid, mod in ((jfluid, j_detection),
                       (tfluid, tfluid.layers.detection)):
        m = fluid.metrics.DetectionMAP(evaluate_difficult=False)
        mod.update_map_from_padded(m, det, lab)
        maps.append(m.eval())
    assert maps[0] == maps[1] and 0.0 < maps[1] < 1.0
