"""The card's leg of the multi-GPU slice (JAX-free, so it runs on a
machine without JAX): two gloo ranks sharing card 0
(``tests/_torch_ranks.py``) hold dp=2 to one rank, a sharded step's
``run_steps`` is refused over gloo before any capture, Reduce launches
the fused update on each rank's slice of the flat group, and the
dropout kernel's element offset draws a block of the whole mask; the
other model-parallel axes (the pipelined Transformer at pp=2 through
the flash kernels, the ring Transformer at sp=2, the MoE layer at ep=2
with a packed fused launch) held to one card, the MoE state saved from
both ranks restored on one card, and the dropout kernel's keyed launch
held to its plain version and to the counter-keyed launch. Every
test is marked ``cuda`` and skips on a host without a card; the CPU
side is held to the JAX package in tests/test_torch_parallel.py and
tests/test_torch_sharding.py.

Run on a card: ``python -m pytest tests/test_torch_parallel_card.py -m
cuda --noconftest -q``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid

import _torch_ranks as R


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _state(path, main, startup):
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    np.savez(path, **{v.name: fluid.fetch_var(v.name, scope)
                      for v in main.list_vars()
                      if v.persistable and scope.has_var(v.name)})


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    _card()
    out = tmp_path_factory.mktemp("card_ranks")
    _state(str(out / "card.npz"), *R.build_fused(fluid, True, 4)[:2])
    _state(str(out / "mlp.npz"), *R.build_mlp(fluid)[:2])
    return out, R.launch(2, ["card"], str(out), timeout=300)["card"]


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_hold_dp2_to_one_rank(card_ranks):
    out, ranks = card_ranks
    main, startup, loss = R.build_fused(fluid, True, 4)
    exe, scope = R._start(fluid, main, startup, str(out / "card.npz"),
                          fluid.CUDAPlace(0))
    feed = R.fused_feed(4)
    one = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0]) for _ in range(3)]
    for r in ranks:
        assert r["AllReduce"] == ranks[0]["AllReduce"]
        # a rank's products over half the rows round as the card tiles
        # them: f32 sums in another order
        np.testing.assert_allclose(r["AllReduce"], one, rtol=1e-5)
        np.testing.assert_allclose(r["Reduce"], r["AllReduce"], rtol=1e-6)


@pytest.mark.cuda
def test_sharded_steps_over_gloo_refuse_capture(card_ranks):
    for r in card_ranks[1]:
        assert np.isfinite(r["plan_loss"])
        for key in ("AllReduce_capture", "Reduce_capture", "plan_capture"):
            assert r[key] and "gloo" in r[key], (key, r[key])


@pytest.mark.cuda
def test_reduce_launches_the_fused_update_on_aligned_slices(card_ranks):
    for r in card_ranks[1]:
        assert r["Reduce_launches"] == 3 == r["AllReduce_launches"]
        for whole, held, misalign, device in r["Reduce_moments"].values():
            assert held == [whole[0] // 2] and misalign == 0
            assert device == "cuda"


@pytest.mark.cuda
def test_dropout_offset_draws_a_block_of_the_whole_mask():
    _card()
    from paddle_tpu_torch.ops import dropout as dr

    dev = torch.device("cuda", 0)
    x = torch.randn(8, 33, 64, device=dev)
    counter = torch.tensor([7], dtype=torch.int32, device=dev)
    whole = dr.dropout_apply(x, 5, counter, 0.3)
    for i in range(4):
        blk = x[2 * i:2 * i + 2].contiguous()
        got = dr.dropout_apply(blk, 5, counter, 0.3,
                               offset=i * blk.numel())
        assert torch.equal(got, whole[2 * i:2 * i + 2])
        assert torch.equal(got, dr.plain_dropout(blk.cpu(), 5,
                                                 counter.cpu(), 0.3,
                                                 i * blk.numel()).to(dev))


@pytest.fixture(scope="module")
def leg_ranks(tmp_path_factory):
    _card()
    from paddle_tpu_torch.models.transformer import transformer_base

    out = tmp_path_factory.mktemp("card_legs")
    _state(str(out / "card_pp.npz"),
           *R.build_pp_tb(fluid, transformer_base, **R.CARD_PP)[:2])
    _state(str(out / "card_ring.npz"),
           *R.build_ring_tb(fluid, transformer_base, "ring")[:2])
    _state(str(out / "card_moe.npz"), *R.build_moe(fluid, cap=0.5)[:2])
    return out, R.launch(2, ["card_legs"], str(out),
                         timeout=300)["card_legs"]


def _one_card(out, state, build, feed, steps=3):
    main, startup, loss = build()[:3]
    exe, scope = R._start(fluid, main, startup, str(out / state),
                          fluid.CUDAPlace(0))
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(steps)], \
        main, exe, scope


@pytest.mark.cuda
def test_pp_sp_ep_legs_hold_to_one_card(leg_ranks):
    from paddle_tpu_torch.models.transformer import transformer_base

    out, ranks = leg_ranks
    pp = _one_card(out, "card_pp.npz", lambda: R.build_pp_tb(
        fluid, transformer_base, **R.CARD_PP), R.pp_feed())[0]
    sp = _one_card(out, "card_ring.npz", lambda: R.build_ring_tb(
        fluid, transformer_base, "fused"), R.ring_feed())[0]
    moe = _one_card(out, "card_moe.npz", lambda: R.build_moe(
        fluid, cap=0.5), {"x": R.moe_feed()})[0]
    for r in ranks:
        assert r["pp"] == ranks[0]["pp"]
        np.testing.assert_allclose(r["pp"], pp, rtol=1e-4)
        np.testing.assert_allclose(r["sp"], sp, rtol=2e-4)
        np.testing.assert_allclose(r["moe"], moe, rtol=1e-4)
        # each stage's layer a microbatch (2) a step (3), and the
        # decoder's two layers' two attentions a step at the whole batch
        assert r["pp_flash"] == 1 * 2 * 3 + 2 * 2 * 3
        # the experts' pack once a step (the router's update is a
        # per-parameter one: no flat group without fuse_optimizer_state)
        assert r["moe_fused"] == 3


@pytest.mark.cuda
def test_ep_state_saved_from_two_ranks_restores_on_one_card(leg_ranks):
    from paddle_tpu_torch import ckpt

    out, _ranks = leg_ranks
    main, startup, loss = R.build_moe(fluid, cap=0.5)[:3]
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    state, _ = ckpt.restore(str(out / "card_ckpt"), program=main,
                            scope=scope)
    experts = [p for p in main.all_parameters()
               if tuple(p.shape)[:1] == (4,)]
    assert len(experts) == 4
    for p in experts:
        assert tuple(scope.find_var(p.name).shape) == tuple(p.shape)
        assert scope.find_var(p.name).device.type == "cuda"
    got = float(exe.run(main, feed={"x": R.moe_feed()}, fetch_list=[loss],
                        scope=scope)[0])
    assert np.isfinite(got)


@pytest.mark.cuda
def test_keyed_dropout_launch_equals_plain_and_counter_keyed():
    _card()
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.ops import dropout as dr

    dev = torch.device("cuda", 0)
    counter = torch.tensor([7], dtype=torch.int32, device=dev)
    key = prng.fold_in(prng.prng_key(torch.tensor(5, device=dev)),
                       counter.reshape(()))
    words = dr.key_words(key)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(8, 33, 64, device=dev).to(dtype)
        got = dr.dropout_apply_keyed(x, words, 0.3)
        assert torch.equal(got, dr.dropout_apply(x, 5, counter, 0.3))
        assert torch.equal(got.cpu(), dr.plain_dropout_keyed(
            x.cpu(), words.cpu(), 0.3))
        xt = x.clone().requires_grad_(True)
        y = dr.dropout_keyed(xt, key, 0.3)
        y.backward(torch.ones_like(y))
        assert torch.equal(xt.grad, (got != 0).to(dtype))
