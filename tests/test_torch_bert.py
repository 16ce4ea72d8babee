"""paddle_tpu_torch.models.bert held to paddle_tpu.models.bert on the CPU.

``bert_pretrain`` at a small width (2 layers, 2 heads, d_model 32,
d_inner 64, vocab 128, T=16, P=4 masked positions, B=2) with ``Adam``,
built with the same calls in both packages. The batch has a ragged
``input_mask`` (lengths 16 and 9), a masked position repeated within a
row, and padded ``mask_pos`` slots pointing at position 0 with weight
0. The JAX package's start state is carried into the port with
``state_from_numpy``. Four cases: dropout 0 and 0.1 (49 sites at full
depth, 9 here), each under ``attn_impl`` ``"fused"`` and ``"pallas"``
(the plain flash versions on the CPU; the JAX package's kernel falls
back to its XLA attention off a TPU).

* The symbol tables are equal, and the two builds drew the same number
  of seeds (dropout sites and parameters interleave alike).
* Step 0's total, masked-LM and next-sentence losses agree within rtol
  1e-5.
* Three ``Adam`` steps: every loss within rtol 1e-5 and every parameter
  update within 0.02 of the learning rate, element by element (the
  bound tests/test_torch_dropout.py holds); the dropout counter equal
  (the masks are the JAX package's, bit for bit).
* ``gather_masked``'s gradient sums repeated positions, as the JAX
  package's ``take_along_axis`` transpose does.

The ``cuda`` test runs three steps on a card (``attn_impl="pallas"``,
dropout 0.1, d_model 128: head dim 64): the flash kernels launch once each per layer and step,
the dropout kernel twice per site, and the losses equal the same steps
on the host within rtol 1e-4; it skips here. On the card::

    python -m pytest tests/test_torch_bert.py -m cuda --noconftest -q

JAX is imported inside the tests that use it (the card's machine has
none).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models.bert import (bert_pretrain, gather_masked,
                                          tied_projection)

torch.set_num_threads(1)

CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, d_inner=64,
           max_pos=16, max_predictions=4)
B, T = 2, 16
LENGTHS = (16, 9)
LR = 1e-3
STEPS = 3
UPDATE_TOL = 0.02  # |update_port - update_jax| / lr, element by element
COUNTER = "_dropout_rng_counter"
CASES = [(0.0, "fused"), (0.0, "pallas"), (0.1, "fused"), (0.1, "pallas")]
# the card's flash kernels take head dims 64 and 128
CUDA_CFG = dict(CFG, d_model=128, d_inner=256)


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    V, P = CFG["vocab_size"], CFG["max_predictions"]
    lens = np.asarray(LENGTHS)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    sent = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int64)
    # row 0 repeats position 5; row 1 has two padded slots at 0
    pos = np.array([[5, 11, 5, 2], [3, 7, 0, 0]], np.int64)
    weight = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    assert pos.shape == (B, P)
    return {"src_ids": rng.randint(1, V, (B, T)).astype(np.int64),
            "sent_ids": sent * mask.astype(np.int64),
            "pos_ids": np.tile(np.arange(T, dtype=np.int64), (B, 1)),
            "input_mask": mask, "mask_pos": pos,
            "mask_label": rng.randint(1, V, (B, P)).astype(np.int64),
            "mask_weight": weight,
            "ns_label": rng.randint(0, 2, (B, 1)).astype(np.int64)}


def _model(pkg, fluid, dropout, attn_impl, cfg=CFG):
    """``bert_pretrain`` + ``Adam`` of one package appended to the
    current programs; [total, mlm, ns]."""
    if pkg == "jax":
        from paddle_tpu.models.bert import bert_pretrain as build
    else:
        build = bert_pretrain
    _, total, (mlm, ns) = build(**cfg, dropout=dropout, attn_impl=attn_impl)
    fluid.optimizer.Adam(learning_rate=LR).minimize(total)
    return [total, mlm, ns]


_RUNS = {}


def _run(case):
    """STEPS steps of (total, mlm, ns) in both packages from the JAX
    package's start state (``_torch_port.train_both``)."""
    if case not in _RUNS:
        import warnings

        from _torch_port import train_both

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="flash_attention")
            _RUNS[case] = train_both(
                lambda pkg, fluid: _model(pkg, fluid, *case), _feed(),
                STEPS)
    return _RUNS[case]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-%s" % c)
def test_bert_builds_the_jax_program(case):
    from _torch_port import symbol_table

    run = _run(case)
    j_main, t_main = run["j_main"], run["t_main"]
    assert symbol_table(t_main) == symbol_table(j_main)
    assert [op.type for op in t_main.global_block().ops] == \
        [op.type for op in j_main.global_block().ops]
    assert t_main._seed_counter == j_main._seed_counter
    sites = sum(op.type == "dropout" for op in t_main.global_block().ops)
    # one at the embeddings, four an encoder layer
    assert sites == (1 + 4 * CFG["n_layer"] if case[0] else 0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-%s" % c)
def test_bert_step0_losses_match_the_jax_package(case):
    run = _run(case)
    for name, t, j in zip(("total", "mlm", "ns"), run["t_out"][0],
                          run["j_out"][0]):
        np.testing.assert_allclose(t, j, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-%s" % c)
def test_bert_trains_as_the_jax_package(case):
    run = _run(case)
    for t_o, j_o in zip(run["t_out"], run["j_out"]):
        np.testing.assert_allclose(t_o[0], j_o[0], rtol=1e-5)
    params = [p.name for p in run["t_main"].all_parameters()]
    assert "word_embedding" in params and "mlm_out_bias" in params
    for name in params:
        p0 = run["state"][name]
        j_up = (run["j_state"][name] - p0) / LR
        t_up = (run["t_state"][name] - p0) / LR
        np.testing.assert_allclose(t_up, j_up, rtol=0, atol=UPDATE_TOL,
                                   err_msg=name)
    n_sites = sum(op.type == "dropout"
                  for op in run["t_main"].global_block().ops)
    if n_sites:
        assert int(run["t_state"][COUNTER]) == \
            int(run["j_state"][COUNTER]) == STEPS * n_sites
    else:
        assert COUNTER not in run["t_state"]


def test_gather_masked_sums_repeated_positions():
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    e = rng.randn(B, T, 8).astype(np.float32)
    pos = np.array([[5, 11, 5, 2], [3, 0, 0, 0]], np.int64)
    g = rng.randn(B, 4, 8).astype(np.float32)

    def jgather(ev):
        return jnp.take_along_axis(ev, jnp.asarray(pos, jnp.int32)[..., None],
                                   axis=1)

    want, vjp = jax.vjp(jgather, jnp.asarray(e))
    et = torch.tensor(e, requires_grad=True)
    got = gather_masked(et, torch.tensor(pos))
    got.backward(torch.tensor(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=1e-6, atol=1e-7)


def test_tied_projection_promotes_a_bf16_input():
    h = torch.randn(2, 3, 4).to(torch.bfloat16)
    table = torch.randn(5, 4)
    b = torch.randn(5)
    got = tied_projection(h, table, b)
    assert got.dtype == torch.float32
    want = torch.einsum("bph,vh->bpv", h.float(), table) + b
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_bert_steps_launch_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import dropout as dr
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = _model("torch", tfluid, 0.1, "pallas", CUDA_CFG)
    sites = sum(op.type == "dropout" for op in main.global_block().ops)
    feed = _feed()
    outs = {}
    for place in (tfluid.CPUPlace(), tfluid.CUDAPlace(0)):
        scope = tfluid.Scope()
        exe = tfluid.Executor(place)
        exe.run(startup, scope=scope)
        for fn in _cuda.LAUNCHERS:
            for name in getattr(fn, "counts", ("launches",)):
                setattr(fn, name, 0)
        outs[place.torch_device().type] = [
            exe.run(main, feed=feed, fetch_list=loss, scope=scope)[0]
            for _ in range(STEPS)]
    n = CFG["n_layer"] * STEPS
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (n, n, n)
    assert dr.dropout_apply.launches == 2 * sites * STEPS
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=1e-4)
