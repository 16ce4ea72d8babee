"""paddle_tpu_torch.ops.paged_window_attention, held to paddle_tpu's.

On the CPU the wrapper runs its plain version (the torch transcription
of the JAX package's ``xla_window_attention``); it must agree with the
JAX package's XLA gather path and with its Pallas kernel (interpret
mode, ``assemble`` schedule) on every row — fully masked rows included,
since the plain version reproduces ``jnp.take(mode="fill")``'s wrap of
negative indices — at f32 rtol/atol 1e-5 (the two frameworks sum in
different orders).

The CUDA kernel itself — its split, query-tile (f32 and tensor-core)
and generic routes, f32/bf16 pools and int8 pools with scales, windows
up to T=512 — is compared with the plain version by the tests marked
``cuda``, which skip on a host without a card; each asserts the route
counters, so a geometry is known to take the route it tests. JAX is imported
inside the tests that use it, so the card test also runs on a machine
that has no JAX:

    python -m pytest tests/test_torch_paged_attention.py -m cuda --noconftest -q
"""

import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import (_cuda, paged_window_attention,
                                  plain_window_attention, plan_route)
from paddle_tpu_torch.ops.paged_attention import LAUNCH_COUNTS, SPLIT_MAX_T

torch.set_num_threads(1)

# (B, T, H, Dk, Dv, mb, bs, nb): decode (T=1), verify/extend (T>1,
# Dk != Dv), odd unaligned dims — the geometries of
# tests/test_paged_attention_kernel.py
GEOMS = [(2, 1, 2, 8, 8, 3, 8, 10),
         (1, 3, 2, 8, 16, 4, 8, 6),
         (2, 2, 3, 5, 7, 2, 6, 5)]
GEOM_IDS = ["decode", "multi_tok", "odd_dims"]


def _mk(B, T, H, Dk, Dv, mb, bs, nb, quant=False, seed=0,
        inactive_row=False):
    """A random paged-window problem as numpy arrays: pools, a block
    table with trailing -1 padding pages (optionally a fully inactive
    row), and cached lengths consistent with the table."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, T, H, Dk)).astype(np.float32)
    if quant:
        kp = rng.randint(-127, 128, (nb, bs, H, Dk)).astype(np.int8)
        vp = rng.randint(-127, 128, (nb, bs, H, Dv)).astype(np.int8)
        ks = rng.uniform(1e-3, 0.1, (nb, bs)).astype(np.float32)
        vs = rng.uniform(1e-3, 0.1, (nb, bs)).astype(np.float32)
    else:
        kp = rng.standard_normal((nb, bs, H, Dk)).astype(np.float32)
        vp = rng.standard_normal((nb, bs, H, Dv)).astype(np.float32)
        ks = vs = None
    tables = rng.randint(0, nb, (B, mb)).astype(np.int32)
    for b in range(B):
        pad = rng.randint(0, mb)
        if pad:
            tables[b, mb - pad:] = -1
    if inactive_row:
        tables[0, :] = -1
    cached = np.array([max(0, int((row >= 0).sum()) * bs - T)
                       for row in tables], dtype=np.int32)
    if inactive_row:
        cached[0] = 0
    return q, kp, vp, tables, cached, ks, vs


def _torch_run(prob, device="cpu", dtype=torch.float32):
    q, kp, vp, tables, cached, ks, vs = prob

    def t(a, dt=None):
        return None if a is None else torch.from_numpy(a).to(device, dt)

    fdt = None if kp.dtype == np.int8 else dtype
    return (t(q, dtype), t(kp, fdt), t(vp, fdt), t(tables), t(cached),
            t(ks), t(vs))


def _jax_run(fn, prob, **kw):
    """Jit the JAX side, as tests/test_paged_attention_kernel.py does
    (XLA:CPU's eager and jitted reductions differ by ~1 ulp)."""
    import jax
    import jax.numpy as jnp

    q, kp, vp, tables, cached, ks, vs = (
        None if a is None else jnp.asarray(a) for a in prob)
    if ks is None:
        f = jax.jit(lambda a, b, c, d, e: fn(a, b, c, d, e, **kw))
        return np.asarray(f(q, kp, vp, tables, cached))
    f = jax.jit(lambda a, b, c, d, e, s1, s2: fn(
        a, b, c, d, e, k_scale=s1, v_scale=s2, **kw))
    return np.asarray(f(q, kp, vp, tables, cached, ks, vs))


def _port(prob):
    q, kp, vp, tables, cached, ks, vs = _torch_run(prob)
    out = paged_window_attention(q, kp, vp, tables, cached,
                                 k_scale=ks, v_scale=vs)
    return out.numpy()


@pytest.mark.parametrize("inactive_row", [False, True],
                         ids=["all_active", "inactive_row"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_plain_matches_jax_xla_and_pallas(geom, quant, inactive_row):
    from paddle_tpu.ops import paged_window_attention as j_kernel
    from paddle_tpu.ops import xla_window_attention as j_xla

    prob = _mk(*geom, quant=quant, seed=GEOMS.index(geom) * 7 + 1,
               inactive_row=inactive_row)
    launches = paged_window_attention.launches
    out = _port(prob)
    assert paged_window_attention.launches == launches  # no kernel on CPU
    ref = _jax_run(j_xla, prob)
    pallas = _jax_run(j_kernel, prob, schedule="assemble",
                      heads_per_tile=0, interpret=True)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)


def test_plain_wraps_negative_table_indices_like_jnp_take():
    """An all -1 table row attends over what the wrapped indices gather
    (the last ``bs`` slots of the pool, uniformly) — not over zeros."""
    prob = _mk(2, 1, 2, 8, 8, 3, 8, 10, seed=3, inactive_row=True)
    out = _port(prob)
    vp = prob[2]
    want = vp.reshape(-1, 2, 8)[-8:].mean(axis=0)    # [H, Dv]
    np.testing.assert_allclose(out[0, 0], want, rtol=1e-5, atol=1e-6)


def test_wrapper_refuses_mixed_devices():
    q, kp, vp, tables, cached, _, _ = _torch_run(_mk(*GEOMS[0]))
    with pytest.raises(EnforceError, match="q is on cpu but an input is on"
                                           " meta"):
        paged_window_attention(q, kp.to("meta"), vp, tables, cached)


def test_kernel_build_is_keyed_by_source_and_needs_nvcc():
    """The library lands under build/paddle_tpu_torch/, named by a hash
    of the source and flags; without nvcc the build raises (the CPU
    never stands in for the card)."""
    path = _cuda.library_path("paged_attention")
    assert path.parent == _cuda.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "paddle_tpu_torch")
    assert path.name.startswith("paged_attention-") and path.suffix == ".so"
    if shutil.which("nvcc") or (_cuda.Path("/usr/local/cuda/bin/nvcc")
                                .exists()):
        pytest.skip("nvcc is installed here: the refusal cannot be shown")
    with pytest.raises(EnforceError, match="nvcc not found"):
        _cuda.build("paged_attention")


# (B, T, H, Dk, Dv, mb, bs, nb) on the card: the slice's decode shape,
# a verify-sized window, and odd dims with Dk != Dv
CUDA_GEOMS = [(16, 1, 8, 64, 64, 32, 16, 512),
              (4, 4, 8, 64, 64, 32, 16, 512),
              (3, 3, 3, 5, 7, 4, 6, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(dtype):
    """The kernel against the plain version on the card: rows with a
    valid key within atol 1e-4 (f32) / 3e-2 (bf16) — the sums run in
    another order — and the inactive row finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    for i, geom in enumerate(CUDA_GEOMS):
        prob = _mk(*geom, seed=i, inactive_row=True)
        args = _torch_run(prob, "cuda", dtype)[:5]
        before = _counts()
        out = paged_window_attention(*args)
        torch.cuda.synchronize()
        _assert_one_launch(before, _route_of(geom, dtype, False), False)
        ref = plain_window_attention(*args)
        assert torch.isfinite(out).all()
        q, _, _, tables, cached = args
        bs = geom[6]
        pos = cached.long()[:, None] + torch.arange(q.shape[1],
                                                    device="cuda")
        page_ok = (tables.long() >= 0).repeat_interleave(bs, dim=1)
        keys = torch.arange(page_ok.shape[1], device="cuda")
        valid = ((keys[None, None, :] <= pos[:, :, None])
                 & page_ok[:, None, :]).any(-1)            # [B, T]
        assert not valid[0].any() and valid[1:].all()
        err = (out.float() - ref.float()).abs()[valid].max().item()
        assert err <= tol, (geom, err)


def _quantized_pools(rng, nb, bs, H, Dk, Dv):
    """int8 code pools and their f32 ``[nb, bs]`` scale pools quantized
    from standard-normal K/V rows as the decode rewrite writes them
    (absmax/127 per slot)."""
    out = []
    for d in (Dk, Dv):
        x = rng.standard_normal((nb, bs, H, d)).astype(np.float32)
        scale = np.abs(x).max(axis=(2, 3)) / np.float32(127)
        codes = np.clip(np.round(x / scale[..., None, None]), -127, 127)
        out += [codes.astype(np.int8), scale.astype(np.float32)]
    return out  # k codes, k scales, v codes, v scales


# (B, T, H, Dk, Dv, mb, bs, nb) on the card for the query-tile grid:
# one full tile, one row past it, and the largest suffix window of the
# serving configuration (T=512, 8 tiles) — grids small enough that the
# route splits their keys — and a grid of 384 blocks that it does not
# split (T=130, a ragged third tile)
TILE_GEOMS = [(3, 64, 8, 64, 64, 8, 16, 64),
              (2, 65, 4, 64, 64, 8, 16, 40),
              (2, 512, 8, 64, 64, 40, 16, 100),
              (16, 130, 8, 64, 64, 12, 16, 200)]


def _counts():
    return {n: getattr(paged_window_attention, n) for n in LAUNCH_COUNTS}


def _route_of(geom, dtype, quant):
    B, T, H, Dk, Dv, mb, bs, _ = geom
    return plan_route(B, T, H, Dk, Dv, mb, bs, dtype, quant).route


def _assert_one_launch(before, route, quant):
    """Exactly one launch since ``before``, on ``route``."""
    want = dict(before)
    want["launches"] += 1
    want["int8_launches"] += int(quant)
    if route == "tile_mma":
        want["tile_launches"] += 1
        want["mma_launches"] += 1
    else:
        want[route + "_launches"] += 1
    assert _counts() == want, route


def _cuda_check(geom, seed, dtype, quant, route=None, prob=None):
    """Run the kernel once on a problem with an inactive first row and
    hold it to the plain version; returns the max abs error over rows
    with a valid key. Asserts the launch took ``route`` (default: the
    planner's route for these shapes)."""
    B, T, H, Dk, Dv, mb, bs, nb = geom
    want_route = route or _route_of(geom, dtype, quant)
    if prob is None:
        prob = _mk(*geom, seed=seed, inactive_row=True)
    prob = list(prob)
    if quant:
        rng = np.random.RandomState(seed + 100)
        prob[1], prob[5], prob[2], prob[6] = _quantized_pools(
            rng, nb, bs, H, Dk, Dv)
    args = _torch_run(tuple(prob), "cuda", dtype)
    q, kp, vp, tables, cached, ks, vs = args
    before = _counts()
    out = paged_window_attention(q, kp, vp, tables, cached,
                                 k_scale=ks, v_scale=vs, route=route)
    torch.cuda.synchronize()
    _assert_one_launch(before, want_route, quant)
    ref = plain_window_attention(q, kp, vp, tables, cached, k_scale=ks,
                                 v_scale=vs)
    assert out.shape == ref.shape == (B, T, H, Dv) and out.dtype == dtype
    assert torch.isfinite(out).all()
    pos = cached.long()[:, None] + torch.arange(T, device="cuda")
    page_ok = (tables.long() >= 0).repeat_interleave(bs, dim=1)
    keys = torch.arange(page_ok.shape[1], device="cuda")
    valid = ((keys[None, None, :] <= pos[:, :, None])
             & page_ok[:, None, :]).any(-1)                # [B, T]
    assert not valid[0].any() and valid[1:].all()
    assert (out[0] == 0).all()  # the inactive row writes zeros
    return (out.float() - ref.float()).abs()[valid].max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_int8_kernel_matches_plain(dtype):
    """The int8 dequantize-on-gather kernel against the plain version on
    the card, f32 and bf16 queries, at the decode and verify shapes and
    across the query-tile grid up to T=512: within atol 1e-4 (f32) /
    3e-2 (bf16) on rows with a valid key; the inactive row zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    for i, geom in enumerate(CUDA_GEOMS + TILE_GEOMS):
        err = _cuda_check(geom, i, dtype, quant=True)
        assert err <= tol, (geom, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernel_query_tiles_match_plain(dtype):
    """f32/bf16 pools across the query-tile grid (T = 64, 65, 512): each
    block holds only its tile's rows and stops its key walk at the
    tile's last visible position."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    for i, geom in enumerate(TILE_GEOMS):
        err = _cuda_check(geom, 50 + i, dtype, quant=False)
        assert err <= tol, (geom, err)


# (B, T, H, Dk, Dv, mb, bs, nb) at the edges of the routes: decode at
# full context (every split busy or masked), the route threshold and one
# row past it
EDGE_GEOMS = [(16, 1, 8, 64, 64, 32, 16, 600),
              (4, SPLIT_MAX_T, 8, 64, 64, 32, 16, 200),
              (4, SPLIT_MAX_T + 1, 8, 64, 64, 32, 16, 200)]


def _full_context(geom, seed):
    """A problem whose second row sees its whole window (cached = mb*bs
    - T) and whose third has -1 pages in the middle (splits lying wholly
    on masked pages); the first row is inactive."""
    B, T, H, Dk, Dv, mb, bs, nb = geom
    prob = list(_mk(*geom, seed=seed, inactive_row=True))
    rng = np.random.RandomState(seed + 7)
    tables = rng.permutation(nb)[:B * mb].reshape(B, mb).astype(np.int32)
    tables[0] = -1
    tables[2, 8:20] = -1
    cached = rng.randint(0, mb * bs - T + 1, B).astype(np.int32)
    cached[0] = -1 if T == 1 else 0
    cached[1] = cached[2] = mb * bs - T
    prob[3], prob[4] = tables, cached
    return tuple(prob)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_routes_at_their_edges(dtype, quant):
    """The split route at full context with masked splits, T at the
    route threshold (split) and one past it (query tile; tensor cores
    with bf16 queries), every pool type: each launch takes the route it
    is meant to test and matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    want = ["split", "split",
            "tile_mma" if dtype == torch.bfloat16 else "tile"]
    for i, (geom, route) in enumerate(zip(EDGE_GEOMS, want)):
        assert _route_of(geom, dtype, quant) == route
        prob = _full_context(geom, 80 + i)
        err = _cuda_check(geom, 80 + i, dtype, quant, prob=prob)
        assert err <= tol, (geom, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_generic_route_on_demand(dtype):
    """``route="generic"`` runs the generic kernel on shapes the fast routes
    take (the A/B yardstick of chip_smoke.py), still within tolerance;
    any other route name raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    for i, geom in enumerate([CUDA_GEOMS[0], TILE_GEOMS[1]]):
        err = _cuda_check(geom, 90 + i, dtype, False, route="generic")
        assert err <= tol, (geom, err)
    args = _torch_run(_mk(*CUDA_GEOMS[0]), "cuda", dtype)[:5]
    with pytest.raises(EnforceError, match="route must be None or"):
        paged_window_attention(*args, route="split")


# (B, T, H, Dk, Dv, mb, bs, nb) at Dk = Dv = 128, where sqrt(Dk) rounds
# in bf16 (11.3125 against 11.3137): a decode window (split route) and
# one row past a query tile (tensor-core route)
DK128_GEOMS = [(4, 1, 4, 128, 128, 16, 16, 80),
               (2, 65, 4, 128, 128, 8, 16, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_cuda_dk128_bf16_matches_plain(quant):
    """bf16 queries at Dk=128: the kernel scales by the reciprocal of
    sqrt(Dk) rounded to bf16, as the plain version (and the JAX package)
    divide by it; within atol 3e-2 of the plain version on both routes,
    bf16 and int8 pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for i, geom in enumerate(DK128_GEOMS):
        err = _cuda_check(geom, 110 + i, torch.bfloat16, quant)
        assert err <= 3e-2, (geom, err)

