"""The port's general layer surface held to the JAX package's on the CPU.

Every public function of ``paddle_tpu/layers/{ops,tensor,nn}.py`` and
the metrics ``accuracy``, ``auc``, ``mean_iou`` and ``precision_recall``
is exported by ``paddle_tpu_torch.layers`` under the same name, and has
a case here (one per function, or per mode). A case builds the same
small program in both packages from the same calls: its inputs are
``data`` feeds, or parameters (``create_parameter``) where the function
is differentiable. Parameters, the function's own ones included, start
from the JAX package's values (``params_from_numpy``). Each run fetches
every output; where the case has parameters it also fetches their
gradients through ``append_backward`` of ``sum(out * c)`` for a seeded
cotangent ``c``. Cases that draw from the shared counter (the random
generators, ``dropout``, ``sampling_id``, ``random_crop``) and counters
(``increment``, ``autoincreased_step_counter``) run two steps.

Tolerances, per case (``rtol``/``atol`` of ``assert_allclose``):

* f32 outputs and gradients: rtol 1e-6 (about 8 ulps), atol 0, unless
  the case says otherwise — the two packages' libms (XLA's polynomial
  ``exp``/``log``/``tanh``/``erf`` against torch's) may part by a few
  ulps, and a reduction summed in another order by a few ulps of its
  sum: cases through a transcendental or a reduction whose terms cancel
  take atol 1e-6 of their values' scale (written in the case);
* integer and bool outputs (indices, ids, counts): equal values (the
  port's index outputs are int64, the JAX package's int32 in its 32-bit
  mode); ``topk``/``argsort``/``accuracy`` on inputs with ties, where
  the lower index comes first in both;
* ``uniform_random``, ``sampling_id``, ``random_crop`` and ``dropout``:
  bit-equal; ``gaussian_random``: within 8 ulps (``sqrt(2) *
  erfinv(u)`` of bit-equal ``u``, torch's ``erfinv`` against XLA's
  polynomial: up to 7 measured on these draws).

``embedding(is_distributed=True)`` (the repair: a plain lookup on one
device) is held with its table's gradient, ``is_sparse`` ignored.
``chunk_eval`` reads its sequences' lengths through ``length=`` here
(tests/test_torch_crf_ctc.py has it over sequence inputs).
"""

import ast
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.enforce import EnforceError

from _torch_port import package

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Case:
    """``build(layers, vars)`` -> output Variable(s) over ``inputs``
    (name -> array); ``params`` names the inputs made parameters; the
    parameters' gradients are fetched when there are any, or with
    ``grad`` (the function's own parameters)."""

    def __init__(self, build, inputs, params=(), rtol=1e-6, atol=0.0,
                 steps=1, ulps=None, grad=False):
        self.build, self.inputs, self.params = build, inputs, tuple(params)
        self.rtol, self.atol, self.steps, self.ulps = rtol, atol, steps, ulps
        self.grad = grad or bool(self.params)


def _rng(seed):
    return np.random.RandomState(seed)


def _f(*shape, seed=0, lo=-2.0, hi=2.0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _i(*shape, hi=5, seed=0, lo=0):
    return _rng(seed).randint(lo, hi, shape).astype(np.int64)


X = {"x": _f(3, 5)}
XPOS = {"x": _f(3, 5, lo=0.1, hi=3.0)}
XY = {"x": _f(3, 5), "y": _f(3, 5, seed=1)}
TIES = np.array([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 1.0, 2.0, -1.0],
                 [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)


def _unary(fn, inputs=X, **kw):
    return Case(lambda L, v: fn(L)(v["x"]), inputs, params=["x"], **kw)


def _binary(name, inputs=XY, **kw):
    return Case(lambda L, v: getattr(L, name)(v["x"], v["y"]), inputs,
                params=list(inputs), **kw)


def _elementwise_cases():
    out = {}
    for op in ("add", "sub", "mul", "div", "max", "min", "pow"):
        name = "elementwise_" + op
        xy = ({"x": _f(3, 5, lo=0.5, hi=2.0), "y": _f(3, 5, seed=1)}
              if op == "pow" else
              {"x": _f(3, 5), "y": _f(3, 5, seed=1, lo=0.5, hi=2.0)}
              if op == "div" else XY)
        out[name] = Case(lambda L, v, n=name: getattr(L, n)(v["x"], v["y"]),
                         xy, params=["x", "y"])
        # y [4] aligned at axis 1 of x [2, 4, 3]
        xb = {"x": _f(2, 4, 3, lo=0.5), "y": _f(4, seed=2, lo=0.5)}
        out[name + "_axis"] = Case(
            lambda L, v, n=name: getattr(L, n)(v["x"], v["y"], axis=1),
            xb, params=["x", "y"])
    out["elementwise_max_const"] = Case(
        lambda L, v: L.elementwise_max(v["x"], 0.25), X, params=["x"])
    out["elementwise_add_act"] = Case(
        lambda L, v: L.elementwise_add(v["x"], v["y"], act="tanh"), XY,
        params=["x", "y"], atol=1e-6)
    return out


def _random(name, seed, batch_like=False):
    def build(L, v):
        fn = getattr(L, name)
        if batch_like:
            return fn(v["ref"], shape=[-1, 7], seed=seed)
        return fn(shape=[4, 33], seed=seed)

    ulps = 8 if "gaussian" in name else 0
    return Case(build, {"ref": _f(3, 2)} if batch_like else {},
                steps=2, ulps=ulps)


def _all_cases():
    c = {}
    # ---------------------------------------------------- activations
    for name in ("relu", "sigmoid", "tanh", "abs", "ceil", "floor", "round",
                 "square", "softsign", "softplus", "sin", "cos",
                 "logsigmoid", "tanh_shrink", "relu6", "gelu"):
        c[name] = _unary(lambda L, n=name: getattr(L, n),
                         atol=1e-6 if name in ("tanh_shrink", "sin",
                                               "cos") else 0.0)
    for name in ("exp", "log", "sqrt", "rsqrt", "reciprocal"):
        c[name] = _unary(lambda L, n=name: getattr(L, n), XPOS)
    c["relu_ties"] = _unary(lambda L: L.relu,
                            {"x": np.array([[-1.0, 0.0, 2.0]], np.float32)})
    c["relu6_wide"] = _unary(lambda L: L.relu6, {"x": _f(3, 5, lo=-8,
                                                         hi=8)})
    c["leaky_relu"] = _unary(lambda L: lambda x: L.leaky_relu(x, 0.1))
    c["elu"] = _unary(lambda L: lambda x: L.elu(x, 0.7), atol=1e-7)
    c["hard_sigmoid"] = _unary(lambda L: L.hard_sigmoid,
                               {"x": _f(3, 5, lo=-4, hi=4)})
    c["brelu"] = _unary(lambda L: lambda x: L.brelu(x, -1.0, 1.5))
    c["soft_relu"] = _unary(lambda L: lambda x: L.soft_relu(x, 1.5))
    c["pow"] = _unary(lambda L: lambda x: L.pow(x, 2.5), XPOS)
    c["hard_shrink"] = _unary(lambda L: lambda x: L.hard_shrink(x, 0.7))
    c["softshrink"] = _unary(lambda L: lambda x: L.softshrink(x, 0.7))
    c["stanh"] = _unary(lambda L: L.stanh)
    c["swish"] = _unary(lambda L: lambda x: L.swish(x, 1.5))
    c["thresholded_relu"] = _unary(
        lambda L: lambda x: L.thresholded_relu(x, 0.3))
    c["scale"] = _unary(lambda L: lambda x: L.scale(x, 1.5, 0.25))
    c["scale_bias_first"] = _unary(
        lambda L: lambda x: L.scale(x, 1.5, 0.25, bias_after_scale=False))
    c["clip"] = _unary(lambda L: lambda x: L.clip(x, -0.5, 1.0))
    c["clip_by_norm_clipped"] = _unary(
        lambda L: lambda x: L.clip_by_norm(x, 1.0))
    c["clip_by_norm_kept"] = _unary(
        lambda L: lambda x: L.clip_by_norm(x, 100.0))
    c.update(_elementwise_cases())
    c["logical_xor"] = Case(
        lambda L, v: L.logical_xor(v["a"], v["b"]),
        {"a": _i(3, 4, hi=2).astype(bool), "b": _i(3, 4, hi=2,
                                                  seed=1).astype(bool)})
    c["maxout"] = Case(lambda L, v: L.maxout(v["x"], 3),
                       {"x": _f(2, 6, 3, 2)}, params=["x"])
    c["maxout_2d"] = Case(lambda L, v: L.maxout(v["x"], 2),
                          {"x": _f(3, 8)}, params=["x"])
    for overwrite in (True, False):
        c["scatter_" + ("set" if overwrite else "add")] = Case(
            lambda L, v, o=overwrite: L.scatter(v["x"], v["ids"], v["upd"],
                                                overwrite=o),
            {"x": _f(5, 3), "ids": np.array([3, 0], np.int64),
             "upd": _f(2, 3, seed=1)}, params=["x", "upd"])
    c["scatter_add_repeats"] = Case(
        lambda L, v: L.scatter(v["x"], v["ids"], v["upd"], overwrite=False),
        {"x": _f(5, 3), "ids": np.array([1, 4, 1], np.int64),
         "upd": _f(3, 3, seed=1)}, params=["x", "upd"])
    c["sum"] = Case(lambda L, v: L.sum([v["x"], v["y"]]), XY,
                    params=["x", "y"])
    c["polygon_box_transform"] = Case(
        lambda L, v: L.polygon_box_transform(v["x"]), {"x": _f(2, 4, 3, 5)},
        params=["x"])
    for name in ("uniform_random", "gaussian_random"):
        c[name] = _random(name, 0)
        c[name + "_fixed_seed"] = _random(name, 7)
        c[name + "_batch_size_like"] = _random(
            name + "_batch_size_like", 0, batch_like=True)
    # ---------------------------------------------------- tensor.py
    c["create_tensor"] = Case(
        lambda L, v: L.assign(v["x"], output=L.create_tensor("float32")), X)
    c["create_global_var"] = Case(
        lambda L, v: L.elementwise_add(
            v["x"], L.create_global_var([3, 5], 0.5, "float32",
                                        persistable=True)), X)
    c["fill_constant"] = Case(
        lambda L, v: L.fill_constant([2, 3], "float32", 1.25), {})
    c["fill_constant_0d"] = Case(
        lambda L, v: L.elementwise_add(
            L.reduce_sum(v["x"]), L.fill_constant([], "float32", 1e-6)),
        X, params=["x"])
    c["fill_constant_batch_size_like"] = Case(
        lambda L, v: L.fill_constant_batch_size_like(v["x"], [-1, 4],
                                                     "float32", 2.0), X)
    c["cast"] = Case(lambda L, v: L.cast(v["x"], "int32"), X)
    c["cast_bfloat16"] = Case(lambda L, v: L.cast(L.cast(v["x"],
                                                         "bfloat16"),
                                                  "float32"),
                              X, params=["x"])
    c["assign"] = Case(lambda L, v: L.assign(v["x"]), X, params=["x"])
    c["assign_value"] = Case(
        lambda L, v: L.elementwise_mul(v["x"], L.assign(_f(3, 5, seed=4))),
        X, params=["x"])
    c["sums"] = Case(lambda L, v: L.sums([v["x"], v["y"], v["x"]]), XY,
                     params=["x", "y"])
    c["increment"] = Case(
        lambda L, v: L.increment(L.create_global_var(
            [], 3.0, "float32", persistable=True), 2.0), {}, steps=2)
    c["increment_out_of_place"] = Case(
        lambda L, v: L.increment(v["x"], 2.0, in_place=False), X,
        params=["x"])
    c["zeros"] = Case(lambda L, v: L.zeros([4], "int64"), {})
    c["ones"] = Case(lambda L, v: L.ones([2, 2], "float32"), {})
    c["argmin"] = Case(lambda L, v: L.argmin(v["x"], axis=1),
                       {"x": -TIES})
    c["cumsum"] = Case(lambda L, v: L.cumsum(v["x"], axis=1), X,
                       params=["x"], atol=1e-6)
    c["shape"] = Case(lambda L, v: L.shape(v["x"]), X)
    c["argsort"] = Case(lambda L, v: list(L.argsort(v["x"], axis=1)),
                        {"x": TIES}, params=["x"])
    c["argsort_axis0"] = Case(lambda L, v: list(L.argsort(v["x"], axis=0)),
                              {"x": TIES})
    c["reverse"] = Case(lambda L, v: L.reverse(v["x"], [0, 1]), X,
                        params=["x"])
    c["create_parameter"] = Case(
        lambda L, v: L.elementwise_mul(
            v["x"], L.create_parameter([5], "float32", name="cp_w")), X,
        params=["x"])
    # ---------------------------------------------------- nn.py
    c["fc"] = Case(lambda L, v: L.fc(v["x"], 4, act="sigmoid"), X,
                   params=["x"])
    c["mul"] = Case(lambda L, v: L.mul(v["x"], v["y"], x_num_col_dims=2),
                    {"x": _f(2, 3, 4), "y": _f(4, 5, seed=1)},
                    params=["x", "y"])
    c["matmul"] = Case(lambda L, v: L.matmul(v["x"], v["y"]),
                       {"x": _f(3, 4), "y": _f(4, 5, seed=1)},
                       params=["x", "y"])
    c["matmul_transposed_batched"] = Case(
        lambda L, v: L.matmul(v["x"], v["y"], transpose_x=True,
                              transpose_y=True, alpha=0.5),
        {"x": _f(2, 4, 3), "y": _f(2, 5, 4, seed=1)}, params=["x", "y"],
        atol=1e-6)
    for sparse in (False, True):
        c["embedding_distributed" + ("_sparse" if sparse else "")] = Case(
            lambda L, v, s=sparse: L.embedding(
                v["ids"], size=[11, 4], is_distributed=True, is_sparse=s),
            {"ids": _i(3, 5, hi=11)}, grad=True)
    c["embedding_padding_idx"] = Case(
        lambda L, v: L.embedding(v["ids"], size=[11, 4], padding_idx=2),
        {"ids": _i(3, 1, hi=4)}, grad=True)
    c["mean"] = Case(lambda L, v: L.mean(v["x"]), X, params=["x"])
    c["square_error_cost"] = _binary("square_error_cost")
    probs = _rng(3).dirichlet(np.ones(5), 4).astype(np.float32)
    c["cross_entropy"] = Case(
        lambda L, v: L.cross_entropy(v["p"], v["y"]),
        {"p": probs, "y": _i(4, 1)}, params=["p"])
    c["cross_entropy_soft"] = Case(
        lambda L, v: L.cross_entropy(v["p"], v["y"], soft_label=True),
        {"p": probs, "y": _rng(4).dirichlet(np.ones(5), 4).astype(
            np.float32)}, params=["p"])
    c["sigmoid_cross_entropy_with_logits"] = Case(
        lambda L, v: L.sigmoid_cross_entropy_with_logits(v["x"], v["z"]),
        {"x": _f(4, 3, lo=-4, hi=4), "z": _i(4, 3, hi=2).astype(
            np.float32)}, params=["x"])
    c["softmax_with_cross_entropy"] = Case(
        lambda L, v: list(L.softmax_with_cross_entropy(
            v["x"], v["y"], return_softmax=True)),
        {"x": _f(4, 6), "y": _i(4, 1, hi=6)}, params=["x"])
    c["softmax_with_cross_entropy_smoothed"] = Case(
        lambda L, v: L.softmax_with_cross_entropy(v["x"], v["y"],
                                                  smooth_eps=0.1),
        {"x": _f(2, 3, 6), "y": _i(2, 3, hi=6)}, params=["x"], atol=1e-6)
    c["fused_linear_softmax_ce"] = Case(
        lambda L, v: list(L.fused_linear_softmax_ce(v["x"], v["y"], 7)),
        {"x": _f(2, 3, 5), "y": _i(2, 3, hi=7)}, params=["x"], atol=1e-6)
    c["softmax"] = _unary(lambda L: L.softmax)
    c["log_softmax"] = _unary(lambda L: L.log_softmax, atol=1e-6)
    for name in ("sum", "mean", "max", "min", "prod"):
        c["reduce_" + name] = Case(
            lambda L, v, n=name: getattr(L, "reduce_" + n)(v["x"], dim=1),
            {"x": _f(3, 4, 2, lo=0.5)}, params=["x"])
        c["reduce_%s_all" % name] = Case(
            lambda L, v, n=name: getattr(L, "reduce_" + n)(v["x"]),
            {"x": _f(3, 4, lo=0.5)}, params=["x"])
        c["reduce_%s_dims_keep" % name] = Case(
            lambda L, v, n=name: getattr(L, "reduce_" + n)(
                v["x"], dim=[0, 2], keep_dim=True),
            {"x": _f(3, 4, 2, lo=0.5)}, params=["x"])
    c["reduce_max_ties"] = Case(lambda L, v: L.reduce_max(v["x"], dim=1),
                                {"x": TIES}, params=["x"])
    c["reshape"] = Case(lambda L, v: L.reshape(v["x"], [0, -1, 2]),
                        {"x": _f(3, 4, 2)}, params=["x"])
    c["reshape_act"] = Case(lambda L, v: L.reshape(v["x"], [-1],
                                                   act="sigmoid"),
                            X, params=["x"])
    c["transpose"] = Case(lambda L, v: L.transpose(v["x"], [2, 0, 1]),
                          {"x": _f(3, 4, 2)}, params=["x"])
    c["concat"] = Case(lambda L, v: L.concat([v["x"], v["y"]], axis=1),
                       {"x": _f(3, 2), "y": _f(3, 4, seed=1)},
                       params=["x", "y"])
    c["slice"] = Case(lambda L, v: L.slice(v["x"], axes=[0, 2],
                                           starts=[1, 0], ends=[3, 100]),
                      {"x": _f(4, 3, 5)}, params=["x"])
    c["slice_negative"] = Case(lambda L, v: L.slice(
        v["x"], axes=[1], starts=[-2], ends=[-1]), {"x": _f(4, 3, 5)},
        params=["x"])
    c["split"] = Case(lambda L, v: L.split(v["x"], 3, dim=1),
                      {"x": _f(2, 6)}, params=["x"])
    c["split_sections"] = Case(lambda L, v: L.split(v["x"], [1, 3, 2],
                                                    dim=-1),
                               {"x": _f(2, 6)}, params=["x"])
    c["stack"] = Case(lambda L, v: L.stack([v["x"], v["y"]], axis=1), XY,
                      params=["x", "y"])
    c["squeeze"] = Case(lambda L, v: L.squeeze(v["x"], axes=[1]),
                        {"x": _f(3, 1, 4)}, params=["x"])
    c["unsqueeze"] = Case(lambda L, v: L.unsqueeze(v["x"], axes=[2, 0]),
                          X, params=["x"])
    c["dropout"] = Case(lambda L, v: L.dropout(v["x"], 0.4, seed=3),
                        {"x": _f(4, 9)}, steps=2)
    c["dropout_test"] = Case(lambda L, v: L.dropout(v["x"], 0.4,
                                                    is_test=True),
                             X, params=["x"])
    c["sampling_id"] = Case(
        lambda L, v: L.sampling_id(v["p"]),
        {"p": _rng(5).dirichlet(np.ones(7), 6).astype(np.float32)},
        steps=2)
    c["topk"] = Case(lambda L, v: list(L.topk(v["x"], 3)), {"x": TIES},
                     params=["x"])
    c["argmax"] = Case(lambda L, v: L.argmax(v["x"], axis=1), {"x": TIES})
    c["one_hot"] = Case(lambda L, v: L.one_hot(v["ids"], 5),
                        {"ids": np.array([[0], [4], [2], [7]], np.int64)})
    c["cos_sim"] = _binary("cos_sim", atol=1e-7)
    c["l2_normalize"] = Case(lambda L, v: L.l2_normalize(v["x"], axis=1),
                             X, params=["x"], atol=1e-6)
    c["smooth_l1"] = _binary("smooth_l1", inputs={"x": _f(3, 5, lo=-1,
                                                          hi=1),
                                                  "y": _f(3, 5, seed=1,
                                                          lo=-1, hi=1)})
    c["smooth_l1_weights"] = Case(
        lambda L, v: L.smooth_l1(v["x"], v["y"], inside_weight=v["iw"],
                                 outside_weight=v["ow"], sigma=2.0),
        {"x": _f(3, 5), "y": _f(3, 5, seed=1), "iw": _f(3, 5, seed=2,
                                                        lo=0, hi=1),
         "ow": _f(3, 5, seed=3, lo=0, hi=1)}, params=["x", "y"])
    c["smooth_l1_outside_only"] = Case(
        lambda L, v: L.smooth_l1(v["x"], v["y"], outside_weight=v["ow"]),
        {"x": _f(3, 5), "y": _f(3, 5, seed=1),
         "ow": _f(3, 5, seed=3, lo=0, hi=1)}, params=["x", "y"])
    c["label_smooth"] = Case(lambda L, v: L.label_smooth(v["y"], epsilon=0.2),
                             {"y": np.eye(5, dtype=np.float32)[[1, 3, 0]]})
    c["label_smooth_prior"] = Case(
        lambda L, v: L.label_smooth(v["y"], prior_dist=v["p"], epsilon=0.2),
        {"y": np.eye(5, dtype=np.float32)[[1, 3, 0]],
         "p": _rng(6).dirichlet(np.ones(5), 1).astype(np.float32)})
    c["multiplex"] = Case(
        lambda L, v: L.multiplex([v["a"], v["b"], v["c"]], v["ids"]),
        {"a": _f(4, 3), "b": _f(4, 3, seed=1), "c": _f(4, 3, seed=2),
         "ids": np.array([[2], [0], [1], [2]], np.int64)},
        params=["a", "b", "c"])
    c["dice_loss"] = Case(lambda L, v: L.dice_loss(v["p"], v["y"]),
                          {"p": _f(3, 4, 2, lo=0, hi=1),
                           "y": _i(3, 4, 2, hi=2)}, params=["p"])
    c["pad"] = Case(lambda L, v: L.pad(v["x"], [1, 0, 2, 3],
                                       pad_value=-1.5), X, params=["x"])
    c["crop"] = Case(lambda L, v: L.crop(v["x"], shape=[2, 3],
                                         offsets=[1, 2]), X, params=["x"])
    c["gather"] = Case(lambda L, v: L.gather(v["x"], v["ids"]),
                       {"x": _f(5, 3), "ids": np.array([4, 0, 4],
                                                       np.int64)},
                       params=["x"])
    c["random_crop"] = Case(lambda L, v: L.random_crop(v["x"], [2, 3, 4]),
                            {"x": _f(3, 2, 6, 7)}, steps=2)
    c["row_conv"] = Case(lambda L, v: L.row_conv(v["x"], 2, act="tanh"),
                         {"x": _f(2, 5, 3)}, params=["x"], atol=1e-6)
    c["autoincreased_step_counter"] = Case(
        lambda L, v: L.autoincreased_step_counter(begin=3, step=2), {},
        steps=2)
    # ---------------------------------------------------- metric_op.py
    c["accuracy"] = Case(lambda L, v: L.accuracy(v["x"], v["y"]),
                         {"x": TIES, "y": np.array([[1], [0], [0]],
                                                   np.int64)})
    c["accuracy_top2"] = Case(lambda L, v: L.accuracy(v["x"], v["y"], k=2),
                              {"x": TIES, "y": np.array([[2], [3], [2]],
                                                        np.int64)})
    c["auc"] = Case(lambda L, v: L.auc(v["p"], v["y"]),
                    {"p": np.concatenate(
                        [_f(64, 1, lo=0, hi=1),
                         np.array([[0.0], [1.0], [0.5]], np.float32)]),
                     "y": _i(67, 1, hi=2)})
    c["auc_two_columns"] = Case(
        lambda L, v: L.auc(v["p"], v["y"], num_thresholds=17),
        {"p": _rng(7).dirichlet(np.ones(2), 40).astype(np.float32),
         "y": _i(40, 1, hi=2, seed=3)})
    for scheme, types in (("IOB", 2), ("IOE", 2), ("IOBES", 1),
                          ("plain", 3)):
        n_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
        c["chunk_eval_" + scheme] = Case(
            lambda L, v, s=scheme, k=types: list(L.chunk_eval(
                v["inf"], v["lab"], s, k, length=v["len"])),
            {"inf": _i(3, 8, hi=types * n_tags + 1, seed=4),
             "lab": _i(3, 8, hi=types * n_tags + 1, seed=5),
             "len": np.array([8, 3, 6], np.int64)})
    c["chunk_eval_excluded"] = Case(
        lambda L, v: list(L.chunk_eval(v["inf"], v["lab"], "IOB", 3,
                                       excluded_chunk_types=[0],
                                       length=v["len"])),
        {"inf": _i(3, 8, hi=7, seed=6), "lab": _i(3, 8, hi=7, seed=6),
         "len": np.array([5, 8, 1], np.int64)})
    c["mean_iou"] = Case(lambda L, v: list(L.mean_iou(v["p"], v["y"], 4)),
                         {"p": _i(3, 5, hi=3), "y": _i(3, 5, hi=4,
                                                      seed=1)})
    c["precision_recall"] = Case(
        lambda L, v: L.precision_recall(v["s"], v["y"], 4),
        {"s": _f(9, 4), "y": _i(9, 1, hi=4)})
    c["precision_recall_weighted"] = Case(
        lambda L, v: L.precision_recall(v["s"], v["y"], 4, weights=v["w"]),
        {"s": _f(9, 4), "y": _i(9, 1, hi=4), "w": _f(9, 1, lo=0, hi=1)})
    return c


CASES = _all_cases()


def _build(pkg, case):
    """(main, startup, feed, fetch names) of a case in one package."""
    fluid, guard = package(pkg)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        v = {}
        for n, a in case.inputs.items():
            if n in case.params:
                v[n] = L.create_parameter(list(a.shape), str(a.dtype),
                                          name=n)
            else:
                v[n] = L.data(name=n, shape=list(a.shape),
                              dtype=str(a.dtype), append_batch_size=False)
        outs = case.build(L, v)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        fetch = [o.name for o in outs]
        feed = {n: a for n, a in case.inputs.items() if n not in case.params}
        if case.grad:
            shape = tuple(outs[0].shape)
            assert all(s > 0 for s in shape), shape
            cot = L.data(name="cot", shape=list(shape), dtype="float32",
                         append_batch_size=False)
            feed["cot"] = _rng(99).uniform(-1, 1, shape).astype(np.float32)
            loss = L.reduce_sum(L.elementwise_mul(L.cast(outs[0],
                                                         "float32"), cot))
            fluid.append_backward(loss)
            fetch += [p.name + "@GRAD" for p in main.all_parameters()]
    return main, startup, feed, fetch


def _run_jax(case):
    """(main, fetch names, each step's fetches, the parameters' start
    values: the case's inputs, the JAX package's initial values for the
    function's own)."""
    import warnings

    import jax.numpy as jnp

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main, startup, feed, fetch = _build("jax", case)
        params = {}
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            for p in main.all_parameters():
                if p.name in case.inputs:
                    scope.set_var(p.name, jnp.asarray(case.inputs[p.name]))
                params[p.name] = np.asarray(scope.find_var(p.name))
            steps = [[np.asarray(o) for o in exe.run(
                main, feed=feed, fetch_list=fetch)]
                for _ in range(case.steps)]
    return main, fetch, steps, params


def _run_torch(case, params):
    """(main, each step's fetches) from the parameters ``params``."""
    main, startup, feed, fetch = _build("torch", case)
    place, scope = tfluid.CPUPlace(), tfluid.Scope()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    tfluid.params_from_numpy({p.name: params[p.name]
                              for p in main.all_parameters()}, scope, place,
                             program=main)
    return main, [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                  for _ in range(case.steps)]


def _ulps(a, b):
    """The distance of two f32 arrays in units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_the_jax_package(name):
    case = CASES[name]
    j_main, fetch, j_steps, params = _run_jax(case)
    t_main, t_steps = _run_torch(case, params)
    assert sorted(p.name for p in t_main.all_parameters()) == \
        sorted(p.name for p in j_main.all_parameters())
    for step, (j_out, t_out) in enumerate(zip(j_steps, t_steps)):
        assert len(t_out) == len(j_out)
        for k, (t, j) in enumerate(zip(t_out, j_out)):
            msg = "%s: step %d, fetch %s" % (name, step, fetch[k])
            t, j = np.asarray(t), np.asarray(j)
            assert t.shape == j.shape, msg
            if j.dtype.kind in "biu":
                np.testing.assert_array_equal(t.astype(np.int64),
                                              j.astype(np.int64), msg)
            elif case.ulps is not None:
                assert int(_ulps(t, j).max(initial=0)) <= case.ulps, msg
            else:
                np.testing.assert_allclose(
                    t, j, rtol=case.rtol,
                    atol=case.atol * max(float(np.abs(j).max(initial=0)),
                                         1.0), err_msg=msg)
    if case.steps > 1:  # the draws (or the counter) moved between steps
        assert not np.array_equal(t_steps[0][0], t_steps[1][0]) \
            or "fixed_seed" in name


def _public(path):
    tree = ast.parse(open(os.path.join(_ROOT, path)).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


# the rest of the op tier: module -> the test files holding its cases
OP_TIER_CASES = {
    "conv": ("test_torch_conv.py", "test_torch_op_tier.py"),
    "image": ("test_torch_op_tier.py",),
    "detection": ("test_torch_detection.py",),
    "sampled": ("test_torch_sampled.py",),
    "quantize": ("test_torch_quantize_layers.py",),
    "moe": ("test_torch_moe.py",),
}


@pytest.mark.parametrize("module", ["ops", "tensor", "nn", "metric_op"]
                         + sorted(OP_TIER_CASES))
def test_layers_export_the_jax_surface(module):
    want = _public("paddle_tpu/layers/%s.py" % module)
    # the JAX package's layers namespace exports most of a module's
    # names; the rest (detection's nms_jax, update_map_from_padded) are
    # reached through the module, in both packages
    top = {n for n in want if hasattr(jfluid.layers, n)}
    missing = sorted(n for n in top if not hasattr(tfluid.layers, n))
    assert not missing
    assert top <= set(tfluid.layers.__all__)
    sub = getattr(tfluid.layers, module)
    assert not sorted(n for n in want - top if not hasattr(sub, n))
    assert all(callable(getattr(sub, n)) for n in want)
    if module not in OP_TIER_CASES:
        # every exported function of the module has a case here (named
        # by it, or by it and a mode)
        assert not sorted(n for n in want if n not in CASES and not any(
            k.startswith(n + "_") for k in CASES))
        return
    # every function has a parity case in the module's test files, named
    # in their PARITY tables
    parity = {}
    for f in OP_TIER_CASES[module]:
        for n, tests in _parity_table(f).items():
            parity.setdefault(n, []).extend(tests)
    assert not sorted(n for n in want if not parity.get(n))


def _parity_table(path):
    """A test file's ``PARITY`` table, {layer: tests}, each test a test
    function of the file, and each ``test[case]`` a key of one of the
    file's module-level dict tables."""
    tree = ast.parse(open(os.path.join(_ROOT, "tests", path)).read())
    tests, keys, table = set(), set(), None
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) \
                and node.name.startswith("test_"):
            tests.add(node.name)
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Dict):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if names == ["PARITY"]:
                table = ast.literal_eval(node.value)
            else:
                keys.update(k.value for k in node.value.keys
                            if isinstance(k, ast.Constant))
    assert table, "%s has no PARITY table" % path
    for layer, cases in table.items():
        for case in cases:
            fn, _, key = case.partition("[")
            assert fn in tests, (path, layer, case)
            assert not key or key[:-1] in keys, (path, layer, case)
    return table


def test_chunk_eval_names_its_roadmap_item():
    """chunk_eval is ported (its cases above), and so is the rest of its
    family: the detection mAP metric and evaluator equal the JAX
    package's on the same detections — the metric over per-image rows,
    the evaluator's batch and accumulated mAP over padded batches (two
    runs, a reset, one more)."""
    assert CASES["chunk_eval_IOB"]
    rng = np.random.RandomState(12)

    def rows(n, classes=4, with_score=True):
        lo = rng.rand(n, 2) * 0.6
        box = np.concatenate([lo, lo + 0.1 + rng.rand(n, 2) * 0.3], -1)
        lab = rng.randint(0, classes, (n, 1))
        if with_score:
            return np.concatenate([lab, rng.rand(n, 1), box], -1)
        return np.concatenate([lab, box, rng.rand(n, 1) < 0.2], -1)

    for ap in ("integral", "11point"):
        for difficult in (False, True):
            maps = {}
            for pkg, fluid in (("jax", jfluid), ("torch", tfluid)):
                m = fluid.metrics.DetectionMAP(
                    overlap_threshold=0.4, evaluate_difficult=difficult,
                    ap_version=ap)
                r = np.random.RandomState(4)
                for _ in range(3):
                    rng.seed(int(r.randint(1 << 30)))
                    gts = rows(5, with_score=False).tolist()
                    dets = rows(8).tolist()
                    # a detection on top of each of two ground truths
                    dets += [[g[0], 0.95] + g[1:5] for g in gts[:2]]
                    m.update(dets, gts)
                maps[pkg] = m.eval()
            assert maps["torch"] == maps["jax"], (ap, difficult)

    def declare(fluid):
        L = fluid.layers
        det = L.data(name="det", shape=[-1, 6, 6], dtype="float32",
                     append_batch_size=False)
        lab = L.data(name="gl", shape=[-1, 4, 1], dtype="int32",
                     append_batch_size=False)
        box = L.data(name="gb", shape=[-1, 4, 4], dtype="float32",
                     append_batch_size=False)
        diff = L.data(name="gd", shape=[-1, 4, 1], dtype="int32",
                      append_batch_size=False)
        return fluid.evaluator.DetectionMAP(
            det, lab, box, diff, class_num=4, overlap_threshold=0.5,
            evaluate_difficult=False, ap_version="11point")

    feeds = []
    for _ in range(3):
        lo = rng.rand(2, 4, 2) * 0.6
        gb = np.concatenate([lo, lo + 0.2], -1).astype(np.float32)
        gl = rng.randint(1, 4, (2, 4, 1)).astype(np.int32)
        gl[:, 3] = -1                          # a padding row an image
        det = np.full((2, 6, 6), -1.0, np.float32)
        det[:, :3, 0] = gl[:, :3, 0]
        det[:, :3, 1] = rng.rand(2, 3)
        det[:, :3, 2:] = gb[:, :3] + rng.randn(2, 3, 4) * 0.03
        det[:, 3, :] = [1, 0.5, 0.1, 0.1, 0.3, 0.3]
        feeds.append({"det": det, "gl": gl, "gb": gb,
                      "gd": (rng.rand(2, 4, 1) < 0.3).astype(np.int32)})
    got = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main = fluid.Program()
        with guard(), fluid.program_guard(main, fluid.Program()):
            ev = declare(fluid)
        names = [v.name for v in ev.get_map_var()]
        exe = fluid.Executor(fluid.CPUPlace())
        out = []
        for i, feed in enumerate(feeds):
            if i == 2:
                ev.reset(exe)
            if pkg == "jax":
                with jfluid.scope_guard(jfluid.Scope()):
                    out.append([float(np.asarray(v)) for v in exe.run(
                        main, feed=feed, fetch_list=names)])
            else:
                out.append([float(v) for v in exe.run(
                    main, feed=feed, fetch_list=names)])
        got[pkg] = out
    assert got["torch"] == got["jax"]
    assert got["torch"][1][1] != got["torch"][1][0]   # it accumulated


def test_embedding_distributed_is_annotated_and_dense():
    main = tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                          tfluid.Program()):
        ids = tfluid.layers.data(name="ids", shape=[-1, 3], dtype="int64",
                                 append_batch_size=False)
        tfluid.layers.embedding(ids, size=[7, 2], is_distributed=True,
                                is_sparse=True)
    w, = main.all_parameters()
    assert w.sharding_spec == ("ep", None) and not w.sparse_grad
    op, = [op for op in main.global_block().ops if op.type == "lookup_table"]
    assert op.attrs["is_distributed"] and op.attrs["is_sparse"]


def test_random_draws_refuse_other_dtypes():
    with tfluid.unique_name.guard(), tfluid.program_guard(tfluid.Program(),
                                                          tfluid.Program()):
        with pytest.raises(EnforceError, match="float32"):
            tfluid.layers.uniform_random([3], dtype="float16")
