"""paddle_tpu_torch.ops.flash_attention, held to paddle_tpu's.

On the CPU the port's flash attention runs its plain versions
(``plain_flash_forward`` / ``plain_flash_backward``), which carry the
CUDA kernels' math and masking. They must agree with the JAX package's
Pallas kernels run in interpret mode — ``_mha_forward`` /
``_mha_backward`` for o, lse, dq, dk and dv, and ``jax.grad`` through
the public ``flash_attention(..., interpret=True)`` — and with its
``_xla_attention`` and its ``jax.grad`` on rows that have a valid key,
at f32 rtol/atol 1e-5 (the frameworks sum in different orders). The
inputs are made with numpy from a seed and handed to both.

The CUDA kernels themselves are compared with the plain versions by the
tests marked ``cuda``, which skip on a host without a card. JAX is
imported inside the tests that use it, so the card tests also run on a
machine without JAX:

    python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest -q
"""

import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd,
                                                  plain_flash_backward,
                                                  plain_flash_forward)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (B, Tq, Tk, H, D, causal, mask kind); mask kinds: None, "ragged"
# (random valid lengths, at least one key), "dead" (batch row 0 has no
# valid key: every row of it is fully masked)
CASES = {
    "causal": (2, 32, 32, 2, 16, True, None),
    "key_masked": (2, 32, 32, 2, 16, False, "ragged"),
    "causal_masked": (1, 32, 32, 2, 16, True, "ragged"),
    "fully_masked_row": (2, 32, 32, 2, 16, False, "dead"),
}
# ragged Tq != Tk, neither a multiple of the kernels' 64-row tiles
CROSS = (2, 20, 36, 2, 16, False, "ragged")


def _inputs(B, Tq, Tk, H, D, causal, mask_kind, seed=0):
    """(q, k, v, do, mask) as numpy: f32 normals, a [B, Tk] 0/1 mask or
    None."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    do = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    mask = None
    if mask_kind is not None:
        lens = rng.randint(1, Tk + 1, size=B)
        mask = (np.arange(Tk)[None, :] < lens[:, None]).astype(np.float32)
        if mask_kind == "dead":
            mask[0] = 0.0
    return q, k, v, do, mask


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(device, dtype)


def _hm(a):
    """[B, T, H, D] -> JAX head-major [B*H, T, D]."""
    B, T, H, D = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * H, T, D))


def _from_hm(a, B, H):
    BH, T, D = a.shape
    return np.asarray(a).reshape(B, H, T, D).transpose(0, 2, 1, 3)


def _need_interpret():
    import _capability

    if not _capability.pallas_interpret_available():
        pytest.skip(_capability.pallas_skip_reason())


# ------------------------------------------------ plain vs Pallas kernels


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_pallas_kernels(case):
    """o, lse, dq, dk, dv of the plain versions against the JAX
    package's ``_mha_forward`` / ``_mha_backward`` in interpret mode
    (16-row blocks, so the kernels walk several q and k tiles and skip
    causal ones). A fully masked row gives o = 0 and lse = +inf in both."""
    _need_interpret()
    import jax.numpy as jnp

    from paddle_tpu.ops.flash_attention import _mha_backward, _mha_forward

    B, Tq, Tk, H, D, causal, mk = CASES[case]
    q, k, v, do, mask = _inputs(B, Tq, Tk, H, D, causal, mk)
    scale = D ** -0.5
    jm = None if mask is None else jnp.asarray(mask)
    jo, jlse = _mha_forward(jnp.asarray(_hm(q)), jnp.asarray(_hm(k)),
                            jnp.asarray(_hm(v)), jm, causal, scale, True,
                            H, (16, 16))
    jdq, jdk, jdv = _mha_backward(
        jnp.asarray(_hm(q)), jnp.asarray(_hm(k)), jnp.asarray(_hm(v)), jm,
        jo, jlse, jnp.asarray(_hm(do)), causal, scale, True, H, (16, 16))

    o, lse = plain_flash_forward(_t(q), _t(k), _t(v), causal, scale,
                                 _t(mask))
    dq, dk, dv = plain_flash_backward(_t(q), _t(k), _t(v), o, lse, _t(do),
                                      causal, scale, _t(mask))
    np.testing.assert_allclose(o.numpy(), _from_hm(jo, B, H), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, H, Tq), **TOL)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _from_hm(want, B, H), **TOL)
    if mk == "dead":
        assert (o[0] == 0).all() and torch.isinf(lse[0]).all()
        assert (lse[0] > 0).all() and torch.isfinite(lse[1]).all()
        assert (dq[0] == 0).all() and torch.isfinite(dk).all()


@pytest.mark.parametrize("case", ["causal", "key_masked", "cross"])
def test_flash_attention_grad_matches_pallas_public_api(case):
    """The port's differentiable ``flash_attention`` against ``jax.grad``
    through the JAX package's public ``flash_attention(interpret=True)``
    (which pads ragged lengths to its blocks and masks them)."""
    _need_interpret()
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.flash_attention import \
        flash_attention as j_flash_attention

    B, Tq, Tk, H, D, causal, mk = CROSS if case == "cross" else CASES[case]
    q, k, v, do, mask = _inputs(B, Tq, Tk, H, D, causal, mk, seed=1)
    jm = None if mask is None else jnp.asarray(mask)

    def j_loss(q_, k_, v_):
        o = j_flash_attention(q_, k_, v_, causal=causal, kv_mask=jm,
                              interpret=True)
        return jnp.sum(o * jnp.asarray(do)), o

    (_, jo), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                     has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal, kv_mask=_t(mask))
    grads = torch.autograd.grad((o * _t(do)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------ plain vs XLA attention


@pytest.mark.parametrize("case", ["causal", "key_masked", "causal_masked",
                                  "cross", "fully_masked_row"])
def test_plain_versions_match_xla_attention_on_valid_rows(case):
    """Against ``_xla_attention`` and its ``jax.grad`` (it runs
    everywhere). That oracle masks with -1e30, so a fully masked row
    averages v where the kernels write 0: only rows with a valid key are
    compared, and such a row feeds no gradient in the port."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.flash_attention import _xla_attention

    B, Tq, Tk, H, D, causal, mk = CROSS if case == "cross" else CASES[case]
    q, k, v, do, mask = _inputs(B, Tq, Tk, H, D, causal, mk, seed=2)
    scale = D ** -0.5
    jm = None if mask is None else jnp.asarray(mask)
    rows = np.ones((B, Tq), bool)                 # rows with a valid key
    if mask is not None:
        rows &= mask.any(-1)[:, None]
    w = do * rows[:, :, None, None]               # cotangent on those rows

    def j_loss(q_, k_, v_):
        o = _xla_attention(q_, k_, v_, causal, scale, jm)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, jo), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                     has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = plain_flash_forward(_t(q), _t(k), _t(v), causal, scale,
                                 _t(mask))
    grads = plain_flash_backward(_t(q), _t(k), _t(v), o, lse, _t(w),
                                 causal, scale, _t(mask))
    np.testing.assert_allclose(o.numpy()[rows], np.asarray(jo)[rows], **TOL)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------ wrapper contract


def test_cpu_tensors_take_the_plain_versions():
    """The launchers run the plain version for CPU tensors and count no
    launch; the autograd op's backward is the plain backward."""
    q, k, v, do, mask = _inputs(*CASES["causal_masked"])
    before = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    o, lse = flash_fwd(_t(q), _t(k), _t(v), True, None, _t(mask))
    want_o, want_lse = plain_flash_forward(_t(q), _t(k), _t(v), True, None,
                                           _t(mask))
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, kv_mask=_t(mask))
    assert torch.equal(out.detach(), want_o)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    want = plain_flash_backward(_t(q), _t(k), _t(v), want_o, want_lse,
                                _t(do), True, None, _t(mask))
    for got, w in zip(grads, want):
        assert torch.equal(got, w)
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == before
    with pytest.raises(EnforceError, match="unsupported device"):
        flash_bwd_dq(_t(q), _t(k), _t(v), o, lse, _t(do))


def test_kernel_build_is_keyed_by_source_and_needs_nvcc():
    path = _cuda.library_path("flash_attention")
    assert path.parent == _cuda.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    assert path != _cuda.library_path("paged_attention")
    if shutil.which("nvcc") or (_cuda.Path("/usr/local/cuda/bin/nvcc")
                                .exists()):
        pytest.skip("nvcc is installed here: the refusal cannot be shown")
    with pytest.raises(EnforceError, match="nvcc not found"):
        _cuda.build_all(["flash_attention", "paged_attention"])


# ------------------------------------------------ the kernels, on the card

# (B, Tq, Tk, H, D, causal, mask kind): the training path's shape
# (B=32, T=256, H=8, D=64) plain, causal and key-masked, a ragged cross
# shape, D=128, and a fully masked batch row
CUDA_CASES = [(32, 256, 256, 8, 64, False, None),
              (32, 256, 256, 8, 64, True, None),
              (32, 256, 256, 8, 64, False, "ragged"),
              (3, 100, 77, 2, 64, False, "ragged"),
              (3, 77, 100, 2, 64, True, "ragged"),
              (2, 130, 130, 2, 128, True, "dead")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernels_match_plain(dtype):
    """The three kernels against the plain versions on the card: o
    within atol 1e-4 (f32) / 3e-2 (bf16), lse within 1e-4 where finite,
    dq/dk/dv within 1e-3 (f32) / 3e-2 (bf16) of their max magnitude —
    the sums run in another order — and everything finite but the
    +inf lse of fully masked rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tol_o = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    tol_g = {torch.float32: 1e-3, torch.bfloat16: 3e-2}[dtype]
    for i, case in enumerate(CUDA_CASES):
        q, k, v, do, mask = (_t(a, "cuda", dtype) if a is not None
                             and a.ndim == 4 else _t(a, "cuda")
                             for a in _inputs(*case, seed=i))
        causal = case[5]
        before = flash_fwd.launches, flash_bwd_dq.launches, \
            flash_bwd_dkv.launches
        o, lse = flash_fwd(q, k, v, causal, None, mask)
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal, None, mask)
        dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal, None, mask)
        torch.cuda.synchronize()
        assert (flash_fwd.launches, flash_bwd_dq.launches,
                flash_bwd_dkv.launches) == tuple(b + 1 for b in before)
        ro, rlse = plain_flash_forward(q, k, v, causal, None, mask)
        # the backward is held to the plain version fed the kernel's o
        rdq, rdk, rdv = plain_flash_backward(q, k, v, o, lse, do, causal,
                                             None, mask)
        assert (o.float() - ro.float()).abs().max().item() <= tol_o, case
        fin = torch.isfinite(rlse)
        assert torch.equal(torch.isfinite(lse), fin), case
        assert (lse[fin] - rlse[fin]).abs().max().item() <= 1e-4, case
        for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert torch.isfinite(got).all(), case
            scale = want.float().abs().max().item() or 1.0
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol_g * scale, (case, err, scale)
        assert torch.isfinite(o).all() and torch.isfinite(delta).all()


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q = torch.zeros((1, 8, 2, 32), device="cuda")
    with pytest.raises(EnforceError, match="head dim 32"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(EnforceError, match="float32 or bfloat16"):
        flash_attention(q, q, q)
