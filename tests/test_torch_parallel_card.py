"""The card's leg of the multi-GPU slice (JAX-free, so it runs on a
machine without JAX): two gloo ranks sharing card 0
(``tests/_torch_ranks.py``) hold dp=2 to one rank, a sharded step's
``run_steps`` is refused over gloo before any capture, Reduce launches
the fused update on each rank's slice of the flat group, and the
dropout kernel's element offset draws a block of the whole mask. Every
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
