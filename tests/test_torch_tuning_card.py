"""The tuning tier on the card (marked ``cuda``; skips without one).
This file imports no JAX: it runs on the card's machine with
``python -m pytest tests/test_torch_tuning_card.py -m cuda --noconftest``.

* every candidate config of the paged kernel's space, at the decode
  and verify shapes on f32, bf16 and int8 pools, launches and agrees
  with the split route's plain version at the same split count and
  length (atol 1e-4 f32, 3e-2 bf16: sums in another order);
* every grid cap of the fused update gives the plain version's bits;
* a sweep on the card measures device time, records no candidate
  error, keys its record by the card's name, and a second sweep reuses
  it.
"""

import pytest
import torch

from paddle_tpu_torch import tuning
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.fused_optimizer import (fused_flat_update,
                                                  plain_flat_update)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _problem(B, T, dtype, quant, dev, H=8, D=64, bs=16, mb=32):
    gen = torch.Generator(device=dev).manual_seed(B * 100 + T)
    nb = B * mb + 1
    q = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
    if quant:
        kp, vp = (torch.randint(-127, 128, (nb, bs, H, D), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        kw = {n: torch.rand(nb, bs, generator=gen, device=dev) * 0.05
              for n in ("k_scale", "v_scale")}
    else:
        kp, vp = (torch.randn(nb, bs, H, D, generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        kw = {}
    tables = torch.randperm(nb - 1, generator=gen, device=dev)[
        :B * mb].to(torch.int32).reshape(B, mb)
    cached = torch.randint(0, mb * bs - T + 1, (B,), generator=gen,
                           device=dev, dtype=torch.int32)
    return (q, kp, vp, tables, cached), kw


@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.float32, True)],
                         ids=["f32", "bf16", "int8"])
def test_every_paged_candidate_matches_its_plain_split(dev, dtype, quant):
    k = tuning.get_tunable("paged_attention")
    for B, T in ((1, 1), (16, 1), (16, 4), (2, 9), (1, 64)):
        args, kw = _problem(B, T, dtype, quant, dev)
        problem = pa.tuning_problem(B, T, 8, 64, 32, 16, quant)
        for cfg in k.candidates(problem):
            plan = pa.plan_route(B, T, 8, 64, 64, 32, 16, dtype, quant,
                                 config=cfg)
            out = pa.paged_window_attention(*args, **kw, config=cfg)
            ref = pa.plain_split_window_attention(
                *args, **kw, n_splits=plan.n_splits,
                split_len=plan.split_len)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            assert err <= TOL[dtype], (B, T, cfg, plan, err)


def test_every_grid_cap_gives_the_plain_bits(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 1_000_003
    p0 = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    m0 = [0.1 * torch.randn(n, generator=gen, device=dev),
          torch.randn(n, generator=gen, device=dev) ** 2]
    lr = torch.tensor(1e-3, device=dev)
    shared = [torch.tensor(0.9 ** 3, device=dev),
              torch.tensor(0.999 ** 3, device=dev)]
    consts = (1.0, 0.9, 0.999, 1e-8)
    want = plain_flat_update("adam", p0, g, lr, m0, shared, True, consts)
    for cap in tuning.get_tunable("fused_optimizer_update").space[
            "blocks_per_sm"]:
        p, accs = p0.clone(), [m.clone() for m in m0]
        got = fused_flat_update("adam", p, g, lr, accs, shared, True,
                                consts, blocks_per_sm=cap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), cap


def test_sweep_on_the_card_measures_and_reuses(dev, tmp_path):
    flags.set_flags({"tuning_cache_dir": str(tmp_path)})
    tuning.clear_memo()
    tuning.reset_tuning_metrics()
    try:
        problem = pa.tuning_problem(16, 1, 8, 64, 32, 16, False)
        rec = tuning.sweep("paged_attention", problem, iters=8, samples=2,
                           device=dev)
        assert rec.device_kind == torch.cuda.get_device_name(0)
        assert not any("error" in m for m in rec.measurements)
        assert {m["timing"] for m in rec.measurements} == {"device"}
        assert 0 < rec.best_ms < 1.0
        again = tuning.sweep("paged_attention", problem, device=dev)
        assert again.config == rec.config
        assert tuning.tuning_metrics()["sweep_reused"] == 1
        assert tuning.lookup("paged_attention", problem,
                             device=dev) == rec.config
    finally:
        flags.set_flags({"tuning_cache_dir": ""})
        tuning.clear_memo()
