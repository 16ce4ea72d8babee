"""paddle_tpu_torch.obs.cost — static per-op FLOP/byte attribution —
held to paddle_tpu.obs.cost.

* The five BASELINE configurations' training programs at full width,
  built statically (no run, no weights) with the same calls in both
  packages: fit_a_line, ResNet-50 at B=64 224x224 (bench_resnet.py's
  program, bf16 flags), Transformer-base at B=32 T=256 (bench.py's
  recipe: sparse embeddings, bf16 flags), DeepFM at its defaults and
  B=4096, and BERT-base pretraining phase 1 (B=64, T=128, 20
  predictions, dropout 0.1, f32). ``report`` gives exactly the JAX
  package's per-op families, FLOPs and bytes, so ``total_flops``,
  ``total_bytes``, ``by_family()``, ``unknown_op_types()`` and
  ``render()`` are equal.
* BERT-base phase 1 under the bf16 flags: the same FLOPs everywhere;
  the bytes differ only on the six ops of the pooler and next-sentence
  head. The pooler's ``mul`` takes the f32 [CLS] row and gives bf16
  (the fn's bf16 rule): the port's inference asks the fn, the JAX
  package's ``mul`` rule takes X's dtype and counts that chain in f32
  (ROADMAP Queue C), so the port counts fewer bytes there.
* Without bound shapes an op over a symbolic batch degrades to unknown
  in both, never to a guessed number.
* The closed-form formulas, ``achieved`` and ``roofline`` equal the JAX
  package's; ``roofline(comm_report=...)`` raises naming ROADMAP Queue
  A 9.
"""

import warnings

import pytest
import torch

from paddle_tpu.obs import cost as j_cost
from paddle_tpu_torch.obs import cost as t_cost

from _torch_port import _flags, package

torch.set_num_threads(1)

BF16 = {"use_bfloat16": True, "bf16_activations": True,
        "bf16_moments": True}


def _models(pkg, name):
    from importlib import import_module

    root = "paddle_tpu" if pkg == "jax" else "paddle_tpu_torch"
    return import_module(root + ".models." + name)


def _fit_a_line(pkg, fluid):
    _, _, avg_cost, _ = _models(pkg, "fit_a_line").build_train()
    fluid.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)
    return dict(batch_size=64)


def _resnet50(pkg, fluid):
    img = fluid.layers.data(name="img", shape=[-1, 3, 224, 224],
                            dtype="float32", append_batch_size=False)
    lbl = fluid.layers.data(name="lbl", shape=[-1, 1], dtype="int64",
                            append_batch_size=False)
    predict = _models(pkg, "resnet").resnet_imagenet(img, class_dim=1000)
    avg = fluid.layers.mean(fluid.layers.cross_entropy(input=predict,
                                                       label=lbl))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(avg)
    fluid.memory_optimize(fluid.default_main_program())
    return dict(feed_shapes={"img": (64, 3, 224, 224), "lbl": (64, 1)})


def _transformer_base(pkg, fluid):
    _, avg, _ = _models(pkg, "transformer").transformer_base(
        src_vocab_size=32000, trg_vocab_size=32000, max_length=256,
        n_layer=6, n_head=8, d_model=512, d_inner_hid=2048,
        dropout_rate=0.0, sparse_embedding=True, attn_impl="pallas")
    fluid.optimizer.Adam(learning_rate=1e-4).minimize(avg)
    return dict(feed_shapes={n: (32, 256) for n in (
        "src_word", "trg_word", "lbl_word", "src_mask", "trg_mask")})


def _deepfm(pkg, fluid):
    _models(pkg, "deepfm").deepfm()
    return dict(batch_size=4096)


def _bert_phase1(pkg, fluid):
    _, total, _ = _models(pkg, "bert").bert_pretrain(
        vocab_size=30522, n_layer=12, n_head=12, d_model=768,
        d_inner=3072, max_pos=512, max_predictions=20, dropout=0.1,
        attn_impl="pallas")
    fluid.optimizer.Adam(learning_rate=1e-4).minimize(total)
    B, T, P = 64, 128, 20
    return dict(feed_shapes={
        "src_ids": (B, T), "sent_ids": (B, T), "pos_ids": (B, T),
        "input_mask": (B, T), "mask_pos": (B, P), "mask_label": (B, P),
        "mask_weight": (B, P), "ns_label": (B, 1)})


CONFIGS = {"fit_a_line": (_fit_a_line, {}),
           "resnet50": (_resnet50, BF16),
           "transformer_base": (_transformer_base, BF16),
           "deepfm": (_deepfm, {}),
           "bert_phase1": (_bert_phase1, {})}


def _reports(name, bind=True, flags=None):
    build, default = CONFIGS[name]
    flags = default if flags is None else flags
    out = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        main, startup = fluid.Program(), fluid.Program()
        # the JAX package reads the bf16 rule when it traces: keep its
        # flags on through the walk's abstract evaluation
        with _flags(pkg, flags), warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="flash_attention")
            with guard(), fluid.program_guard(main, startup):
                kw = build(pkg, fluid)
            out[pkg] = fluid.obs.cost.report(main, **(kw if bind else {}))
    return out


def _ops(rep):
    return [(o.op_type, o.family, o.flops, o.bytes) for o in rep.ops]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_report_equals_the_jax_package_at_full_width(name):
    rep = _reports(name)
    j, t = rep["jax"], rep["torch"]
    assert _ops(t) == _ops(j)
    assert (t.total_flops, t.total_bytes) == (j.total_flops, j.total_bytes)
    assert t.by_family() == j.by_family()
    assert t.unknown_op_types() == j.unknown_op_types()
    assert t.render() == j.render()
    fam = t.by_family()
    for f in ("matmul", "conv", "attention"):
        assert fam.get(f, {"unknown": 0})["unknown"] == 0, (name, f)
    assert t.total_flops > 0


def test_bert_bf16_differs_only_on_the_pooler_chain():
    rep = _reports("bert_phase1", flags=BF16)
    j, t = _ops(rep["jax"]), _ops(rep["torch"])
    assert [o[:3] for o in t] == [o[:3] for o in j]
    assert rep["torch"].total_flops == rep["jax"].total_flops
    differ = [(a[0], b[3] < a[3]) for a, b in zip(j, t) if a != b]
    assert differ == [("mul", True), ("elementwise_add", True),
                      ("tanh", True), ("mul", True),
                      ("elementwise_add", True),
                      ("softmax_with_cross_entropy", True)]


@pytest.mark.parametrize("name", ["fit_a_line", "deepfm"])
def test_symbolic_batch_degrades_to_unknown_in_both(name):
    rep = _reports(name, bind=False)
    assert _ops(rep["torch"]) == _ops(rep["jax"])
    assert rep["torch"].unknown_op_types() == rep["jax"].unknown_op_types()
    assert rep["torch"].by_family()["matmul"]["unknown"] > 0


def test_formulas_achieved_and_roofline_equal_the_jax_package():
    assert t_cost.matmul_flops(3, 5, 7, 2) == j_cost.matmul_flops(3, 5, 7,
                                                                  2)
    assert t_cost.conv2d_flops((2, 8, 5, 5), 3, 3, 3) == \
        j_cost.conv2d_flops((2, 8, 5, 5), 3, 3, 3)
    for kw in ({}, {"causal": True}, {"train": True, "head_dim_v": 32}):
        assert t_cost.attention_flops(2, 4, 128, 256, 64, **kw) == \
            j_cost.attention_flops(2, 4, 128, 256, 64, **kw)
    for args in ((1e12, 0.5, 989e12), (1e12, 0.5), (None, 1.0),
                 (1e9, 0.0)):
        assert t_cost.achieved(*args) == j_cost.achieved(*args)
    rep = _reports("fit_a_line")
    spans = {"dispatch": 0.25}
    assert t_cost.roofline(rep["torch"], spans, steps=10,
                           peak_flops=67e12) == \
        j_cost.roofline(rep["jax"], spans, steps=10, peak_flops=67e12)
    # the comm join, once refused naming Queue A 9, is ported: a
    # planless report adds the JAX package's keys and values
    # (tests/test_torch_comm.py joins a sharded program's)
    from paddle_tpu import analysis as j_analysis
    from paddle_tpu import Program as JProgram
    from paddle_tpu_torch import analysis as t_analysis
    from paddle_tpu_torch import Program as TProgram

    joined = t_cost.roofline(rep["torch"], spans,
                             comm_report=t_analysis.analyze_comm(TProgram()))
    assert joined == j_cost.roofline(
        rep["jax"], spans, comm_report=j_analysis.analyze_comm(JProgram()))
    assert joined["static_ici_bytes_per_step"] is None
