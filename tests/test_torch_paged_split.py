"""The split route of the paged-attention kernel, modelled on the CPU.

``plain_split_window_attention`` computes what the split route's two
kernels compute — per-split partial (m, l, acc) in f32, then the merge
weighing each split by ``exp(m_s - M)`` — in the kernels' order. These
tests hold it to ``plain_window_attention`` and to the JAX package's
``xla_window_attention`` on every row with a valid key (f32 rtol/atol
1e-5: the frameworks sum in different orders), and check the cases the
kernel must not turn into NaN: splits lying wholly on ``-1`` pages or
past the last visible position, and the inactive row (position -1),
which comes out as zeros. They also pin the route planner's choices at
the serving path's shapes. JAX is imported only inside the tests that
compare with it.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import (paged_window_attention,
                                  plain_split_window_attention,
                                  plain_window_attention, plan_route)
from test_torch_paged_attention import (GEOM_IDS, GEOMS, _jax_run, _mk,
                                        _torch_run)

torch.set_num_threads(1)

# the serving configuration's long window: 32 pages of 16, cached up to
# 511 (T=1) and a verify-sized window at the route threshold
LONG = dict(H=8, Dk=64, Dv=64, mb=32, bs=16, nb=160)


def _valid_rows(tables, cached, T, bs):
    pos = cached.long()[:, None] + torch.arange(T)
    page_ok = (tables.long() >= 0).repeat_interleave(bs, dim=1)
    keys = torch.arange(page_ok.shape[1])
    return ((keys[None, None, :] <= pos[:, :, None])
            & page_ok[:, None, :]).any(-1)                    # [B, T]


def _check(prob, n_splits, split_len=None, jax_too=False):
    """The split model against the plain version (and the JAX XLA path)
    on rows with a valid key; rows without one must be zeros."""
    q, kp, vp, tables, cached, ks, vs = _torch_run(prob)
    out, m, l, acc = plain_split_window_attention(
        q, kp, vp, tables, cached, k_scale=ks, v_scale=vs,
        n_splits=n_splits, split_len=split_len, partials=True)
    ref = plain_window_attention(q, kp, vp, tables, cached, k_scale=ks,
                                 v_scale=vs)
    bs = kp.shape[1]
    valid = _valid_rows(tables, cached, q.shape[1], bs)
    assert torch.isfinite(out).all()
    assert torch.isfinite(l).all() and torch.isfinite(acc).all()
    assert not torch.isnan(m).any()
    np.testing.assert_allclose(out[valid].numpy(), ref[valid].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (out[~valid] == 0).all()
    if jax_too:
        from paddle_tpu.ops import xla_window_attention as j_xla
        want = _jax_run(j_xla, prob)
        np.testing.assert_allclose(out[valid].numpy(), want[valid.numpy()],
                                   rtol=1e-5, atol=1e-5)
    return out, m, l, acc


@pytest.mark.parametrize("n_splits", [1, 2, 3])
@pytest.mark.parametrize("inactive_row", [False, True],
                         ids=["all_active", "inactive_row"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_split_model_matches_plain(geom, quant, inactive_row, n_splits):
    prob = _mk(*geom, quant=quant, seed=GEOMS.index(geom) * 5 + n_splits,
               inactive_row=inactive_row)
    _check(prob, n_splits)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_split_model_matches_jax_xla(geom, quant):
    prob = _mk(*geom, quant=quant, seed=40 + GEOMS.index(geom),
               inactive_row=True)
    _check(prob, 2, jax_too=True)


def _long_problem(B, T, quant, seed, cached=None):
    geo = LONG
    prob = list(_mk(B, T, geo["H"], geo["Dk"], geo["Dv"], geo["mb"],
                    geo["bs"], geo["nb"], quant=quant, seed=seed))
    rng = np.random.RandomState(seed + 1)
    S = geo["mb"] * geo["bs"]
    tables = rng.permutation(geo["nb"])[:B * geo["mb"]].reshape(
        B, geo["mb"]).astype(np.int32)
    prob[3] = tables
    prob[4] = (np.asarray(cached, np.int32) if cached is not None
               else rng.randint(0, S - T + 1, B).astype(np.int32))
    return prob


@pytest.mark.parametrize("T", [1, pa.SPLIT_MAX_T],
                         ids=["decode", "threshold"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_split_model_long_window(T, quant):
    """The serving geometry with the planner's own split count at B=4
    (cached lengths up to 511), against plain and the JAX XLA path."""
    B = 4
    prob = _long_problem(B, T, quant, seed=7 + T,
                         cached=[511 - T + 1, 0, 200, 17])
    plan = plan_route(B, T, LONG["H"], LONG["Dk"], LONG["Dv"], LONG["mb"],
                      LONG["bs"], torch.float32, quant)
    assert plan.route == "split" and plan.n_splits > 1
    _check(tuple(prob), plan.n_splits, plan.split_len, jax_too=True)


def test_splits_on_masked_pages_and_past_the_end_weigh_nothing():
    """Splits lying wholly on -1 pages, or starting past the last visible
    position, hold m = -inf, l = 0, acc = 0, and the merge still gives
    the plain version's rows (no NaN from exp(-inf - -inf))."""
    prob = _long_problem(3, 1, False, seed=3, cached=[511, 100, 40])
    tables = prob[3]
    tables[0, 8:16] = -1  # keys 128..255 of row 0: splits 4..7 of 32
    prob[3] = tables
    out, m, l, acc = _check(tuple(prob), 16, 32)
    assert torch.isneginf(m[0, :, 4:8]).all()
    assert (l[0, :, 4:8] == 0).all() and (acc[0, :, 4:8] == 0).all()
    # row 1 sees keys 0..100: splits 4.. start past its last position
    assert torch.isneginf(m[1, :, 4:]).all() and (l[1, :, 4:] == 0).all()
    assert torch.isfinite(m[1, :, :4]).all()
    # row 2 sees keys 0..40: two splits
    assert torch.isfinite(m[2, :, :2]).all()
    assert torch.isneginf(m[2, :, 2:]).all()


def test_inactive_row_writes_zeros_and_no_split_sees_a_key():
    """Position -1 with an all -1 table (how the engine pads a decode
    batch): every split is empty and the row comes out as zeros."""
    prob = _long_problem(2, 1, True, seed=5, cached=[-1, 300])
    prob[3][0] = -1
    out, m, l, _ = _check(tuple(prob), 4, 128)
    assert torch.isneginf(m[0]).all() and (l[0] == 0).all()
    assert (out[0] == 0).all()


def test_split_count_does_not_change_the_result():
    """Any split count gives the same rows as one split (up to f32
    rounding of the merge)."""
    prob = tuple(_long_problem(2, 3, False, seed=11, cached=[509, 250]))
    one = _check(prob, 1)[0]
    for n, length in ((2, 256), (5, 128), (16, 32)):
        np.testing.assert_allclose(_check(prob, n, length)[0].numpy(),
                                   one.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [pa.SPLIT_MAX_T, pa.SPLIT_MAX_T + 1],
                         ids=["at_threshold", "past_threshold"])
def test_route_threshold(T):
    geo = (2, T, 8, 64, 64, 32, 16)
    assert plan_route(*geo, torch.float32, False).route == (
        "split" if T <= pa.SPLIT_MAX_T else "tile")
    assert plan_route(*geo, torch.bfloat16, False).route == (
        "split" if T <= pa.SPLIT_MAX_T else "tile_mma")
    assert plan_route(*geo, torch.bfloat16, True).route == (
        "split" if T <= pa.SPLIT_MAX_T else "tile_mma")


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_planner_at_the_decode_buckets(B, quant):
    """Decode at every bucket of the serving path (T=1, H=8, D=64, 32
    pages of 16): the split route, with ``TARGET_BLOCKS`` blocks (8
    waves of 132 SMs) unless the window has fewer 32-key tiles than that
    needs."""
    plan = plan_route(B, 1, 8, 64, 64, 32, 16, torch.float32, quant)
    assert plan.route == "split"
    assert plan.split_len % pa.SPLIT_TILE == 0
    assert plan.n_splits == math.ceil(512 / plan.split_len)
    assert (B * 8 * plan.n_splits >= pa.TARGET_BLOCKS
            or plan.split_len == pa.SPLIT_TILE)
    assert plan.scratch == ((B, 8, plan.n_splits, 1, 2),
                            (B, 8, plan.n_splits, 1, 64))
    if B == 16:
        assert (plan.n_splits, plan.split_len) == (16, 32)


@pytest.mark.parametrize("T", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512])
def test_planner_at_the_suffix_buckets(T):
    """The extend program's suffix buckets: split up to the threshold,
    the query-tile route past it (tensor cores with bf16 queries)."""
    for q_dtype, quant, tile in ((torch.float32, False, "tile"),
                                 (torch.float32, True, "tile"),
                                 (torch.bfloat16, False, "tile_mma"),
                                 (torch.bfloat16, True, "tile_mma")):
        route = plan_route(1, T, 8, 64, 64, 32, 16, q_dtype, quant).route
        assert route == ("split" if T <= pa.SPLIT_MAX_T else tile)


@pytest.mark.parametrize("B, T, splits", [(16, 64, (8, 64)),
                                          (1, 64, (8, 64)),
                                          (16, 512, (1, 512)),
                                          (1, 512, (8, 64))])
def test_planner_splits_keys_of_small_query_tile_grids(B, T, splits):
    """A query-tile grid under ``TILE_SPLIT_BELOW`` blocks splits its
    keys toward ``TILE_TARGET_BLOCKS`` (64-key multiples; partials
    merged as on the split route); a fuller one writes ``out`` itself,
    with no scratch."""
    plan = plan_route(B, T, 8, 64, 64, 32, 16, torch.float32, False)
    assert plan.route == "tile" and (plan.n_splits, plan.split_len) == splits
    if plan.n_splits == 1:
        assert plan.scratch == ((), ())
    else:
        assert plan.scratch == ((B, 8, plan.n_splits, T, 2),
                                (B, 8, plan.n_splits, T, 64))
        assert B * 8 * -(-T // pa.QUERY_TILE) * plan.n_splits >= \
            pa.TILE_TARGET_BLOCKS or plan.split_len == pa.KEY_TILE


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_split_model_at_a_split_query_tile_plan(quant):
    """The merge algebra the query-tile route uses when it splits keys
    (T=64 at B=2, the planner's own splits) gives the plain rows."""
    prob = _long_problem(2, 64, quant, seed=21, cached=[448, 100])
    plan = plan_route(2, 64, LONG["H"], LONG["Dk"], LONG["Dv"], LONG["mb"],
                      LONG["bs"], torch.float32, quant)
    assert plan.route == "tile" and plan.n_splits > 1
    _check(tuple(prob), plan.n_splits, plan.split_len)


@pytest.mark.parametrize("dims", [(5, 7), (8, 8), (24, 40), (136, 64),
                                  (64, 136)])
def test_planner_sends_unaligned_dims_to_the_generic_route(dims):
    Dk, Dv = dims
    for q_dtype, quant in ((torch.float32, False), (torch.bfloat16, False),
                           (torch.float32, True)):
        route = plan_route(2, 1, 3, Dk, Dv, 4, 6, q_dtype, quant).route
        fits = all(d % 8 == 0 and d <= 128 and (d * (1 if quant else
                   (4 if q_dtype == torch.float32 else 2))) % 16 == 0
                   for d in dims)
        assert (route == "generic") == (not fits), (dims, q_dtype, quant)


def test_planner_sends_long_block_tables_to_the_generic_route():
    for mb, route in ((pa.MAX_TABLE, "split"), (pa.MAX_TABLE + 1,
                                                "generic")):
        assert plan_route(1, 1, 8, 64, 64, mb, 16, torch.float32,
                          False).route == route


def test_cpu_wrapper_counts_nothing_and_refuses_unknown_routes():
    q, kp, vp, tables, cached, _, _ = _torch_run(_mk(*GEOMS[0]))
    before = {n: getattr(paged_window_attention, n)
              for n in pa.LAUNCH_COUNTS}
    paged_window_attention(q, kp, vp, tables, cached, route="generic")
    assert {n: getattr(paged_window_attention, n)
            for n in pa.LAUNCH_COUNTS} == before
    with pytest.raises(EnforceError, match="route must be None or"):
        paged_window_attention(q, kp, vp, tables, cached, route="nope")
