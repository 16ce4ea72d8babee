"""paddle_tpu_torch.ops.paged_window_attention, held to paddle_tpu's.

On the CPU the wrapper runs its plain version (the torch transcription
of the JAX package's ``xla_window_attention``); it must agree with the
JAX package's XLA gather path and with its Pallas kernel (interpret
mode, ``assemble`` schedule) on every row — fully masked rows included,
since the plain version reproduces ``jnp.take(mode="fill")``'s wrap of
negative indices — at f32 rtol/atol 1e-5 (the two frameworks sum in
different orders).

The CUDA kernel itself is compared with the plain version by the test
marked ``cuda``, which skips on a host without a card. JAX is imported
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
                                  plain_window_attention)

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
    with pytest.raises(EnforceError, match="on the CPU"):
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
        before = paged_window_attention.launches
        out = paged_window_attention(*args)
        torch.cuda.synchronize()
        assert paged_window_attention.launches == before + 1
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
