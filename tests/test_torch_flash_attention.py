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
from paddle_tpu_torch.ops.flash_attention import (bf16_flip_bounds,
                                                  bf16_ulps, flash_attention,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd,
                                                  plain_flash_backward,
                                                  plain_flash_backward_bf16,
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
    launch; the autograd op's backward is the plain backward, and so are
    the two backward launchers."""
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
    # the backward ops run their plain versions on the CPU too (each is
    # a custom op whose CPU kernel is the plain version)
    dq, delta = flash_bwd_dq(_t(q), _t(k), _t(v), o, lse, _t(do), True,
                             None, _t(mask))
    dk, dv = flash_bwd_dkv(_t(q), _t(k), _t(v), lse, delta, _t(do), True,
                           None, _t(mask))
    for got, w in zip((dq, dk, dv), want):
        assert torch.equal(got, w)
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == before


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


def test_kernel_build_key_sees_the_headers(tmp_path, monkeypatch):
    """Both kernel sources include ``csrc/hopper.cuh``: editing a header
    changes every library's path, so a stale library never loads."""
    names = ("flash_attention", "paged_attention", "fused_optimizer")
    real = {n: _cuda.library_path(n) for n in names}
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    assert {n: _cuda.library_path(n) for n in names} == real
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: _cuda.library_path(n) for n in names}
    assert all(edited[n] != real[n] for n in names)
    assert all(p.parent == _cuda.BUILD_DIR for p in edited.values())


def test_bf16_rounding_model_stays_within_the_bf16_gradient_tolerance():
    """``plain_flash_backward_bf16`` (p and ds rounded to bf16 before the
    second products, as the bf16 kernels do) against
    ``plain_flash_backward`` on bf16 inputs: within 3e-2 of max |grad|,
    the bf16 tolerance the kernels are held to, and not equal to it (the
    rounding happens)."""
    for i, case in enumerate(list(CASES.values()) + [CROSS]):
        B, Tq, Tk, H, D, causal, mk = case
        q, k, v, do, mask = (None if a is None else
                             _t(a, dtype=torch.bfloat16 if a.ndim == 4
                                else torch.float32)
                             for a in _inputs(*case, seed=10 + i))
        o, lse = plain_flash_forward(q, k, v, causal, None, mask)
        want = plain_flash_backward(q, k, v, o, lse, do, causal, None, mask)
        got = plain_flash_backward_bf16(q, k, v, o, lse, do, causal, None,
                                        mask)
        differs = False
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == torch.bfloat16
            scale = w.float().abs().max().item()
            err = (g.float() - w.float()).abs().max().item()
            assert err <= 3e-2 * scale, (case, err, scale)
            differs |= not torch.equal(g, w)
        assert differs, case


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
    # the forward copies rows 16 bytes at a time too: a pointer or a
    # time stride off 16 bytes raises, and nothing is launched
    before = flash_fwd.launches
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 8, 2, 64), device="cuda", dtype=dtype)
        shifted = torch.empty(q.numel() + 1, device="cuda",
                              dtype=dtype)[1:].view(q.shape)
        with pytest.raises(EnforceError, match="16-byte aligned"):
            flash_fwd(shifted, q, q)
        wide = torch.zeros((1, 8, 2 * 64 + 1), device="cuda", dtype=dtype)
        odd = wide.as_strided((1, 8, 2, 64), (8 * 129, 129, 64, 1))
        with pytest.raises(EnforceError, match="16-byte aligned"):
            flash_fwd(q, odd, q)
    assert flash_fwd.launches == before


def _bf16_card_case(i, device):
    """The inputs of card case i for the bf16 model checks."""
    case = CUDA_CASES[i]
    return tuple(_t(a, device, torch.bfloat16) if a is not None
                 and a.ndim == 4 else _t(a, device)
                 for a in _inputs(*case, seed=20 + i))


def test_bf16_model_check_rejects_the_unrounded_backward():
    """The element check that holds the bf16 kernels to their rounding
    model (``bf16_ulps`` at most 1, with the model's flip bounds) sees
    the rounding: on each card case's shape and inputs the unrounded
    ``plain_flash_backward`` fails it for at least one of dq, dk, dv."""
    for i, case in enumerate(CUDA_CASES):
        q, k, v, do, mask = _bf16_card_case(i, "cpu")
        causal = case[5]
        o, lse = plain_flash_forward(q, k, v, causal, None, mask)
        model = plain_flash_backward_bf16(q, k, v, o, lse, do, causal, None,
                                          mask)
        plain = plain_flash_backward(q, k, v, o, lse, do, causal, None,
                                     mask)
        bounds = bf16_flip_bounds(q, k, v, o, lse, do, causal, None, mask)
        assert max(bf16_ulps(p, m, b) for p, m, b in
                   zip(plain, model, bounds)) > 1.0, case


def _kernel_order_backward(q, k, v, o, lse, do, causal, mask):
    """The bf16 backward as a kernel computes it, in another order than
    the model: scores and dP summed in float64 and rounded to f32,
    ``p = exp2(s * scale * log2(e) - lse * log2(e))`` with the two
    factors rounded to f32, delta summed in float64; p and ds rounded to
    bf16, the second products summed in float64."""
    D = q.shape[-1]
    scale, l2e = D ** -0.5, 1.4426950408889634
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()).float()
    valid = torch.ones_like(s, dtype=torch.bool)
    if mask is not None:
        valid = valid & (mask[:, None, None, :] > 0)
    if causal:
        valid = valid & torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    sc2 = torch.tensor(scale * l2e, dtype=torch.float32).double()
    lse2 = (lse * torch.tensor(l2e, dtype=torch.float32)).double()
    arg = (s.double() * sc2 - lse2[..., None]).float()
    p = torch.where(valid, torch.exp2(arg), torch.zeros_like(arg))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double()).float()
    delta = (do.double() * o.double()).sum(-1).float().permute(0, 2, 1)
    ds = p * (dp - delta[..., None]) * scale
    pb, dsb = (x.to(torch.bfloat16).double() for x in (p, ds))
    return (torch.einsum("bhqk,bkhd->bqhd", dsb, k.double()),
            torch.einsum("bhqk,bqhd->bkhd", dsb, q.double()),
            torch.einsum("bhqk,bqhd->bkhd", pb, do.double()))


@pytest.mark.parametrize("seed", range(3))
def test_bf16_flip_bounds_cover_another_order_of_sums(seed):
    """A backward that rounds p and ds to bf16 as the kernels do but sums
    in another order (``_kernel_order_backward``) stays within the check
    with the model's flip bounds, on the key-masked training shape at
    4 sentences; the bounds are local (a p or ds near a bf16 rounding
    boundary moves only the elements its products reach): on average
    below 1e-4 of max |grad|."""
    case = (4, 256, 256, 8, 64, False, "ragged")
    q, k, v, do, mask = (_t(a, "cpu", torch.bfloat16) if a is not None
                         and a.ndim == 4 else _t(a, "cpu")
                         for a in _inputs(*case, seed=40 + seed))
    o, lse = plain_flash_forward(q, k, v, False, None, mask)
    got = [g.to(torch.bfloat16) for g in
           _kernel_order_backward(q, k, v, o, lse, do, False, mask)]
    model = plain_flash_backward_bf16(q, k, v, o, lse, do, False, None, mask)
    bounds = bf16_flip_bounds(q, k, v, o, lse, do, False, None, mask)
    for g, m, b in zip(got, model, bounds):
        assert bf16_ulps(g, m, b) <= 1.0
        assert b.shape == m.shape and bool((b >= 0).all())
        assert float(b.mean()) <= 1e-4 * float(m.float().abs().max())


@pytest.mark.cuda
def test_cuda_bf16_kernels_match_their_rounding_model():
    """dq, dk, dv of the bf16 kernels against
    ``plain_flash_backward_bf16``: every element within one bf16 ulp
    plus ``BF16_MODEL_FLOOR`` of max |grad| plus its flip bound
    (``bf16_ulps`` at most 1), every card case. The unrounded plain
    version is held at 3e-2 of max |grad|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for i, case in enumerate(CUDA_CASES):
        q, k, v, do, mask = _bf16_card_case(i, "cuda")
        causal = case[5]
        o, lse = flash_fwd(q, k, v, causal, None, mask)
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal, None, mask)
        dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal, None, mask)
        want = plain_flash_backward_bf16(q, k, v, o, lse, do, causal, None,
                                         mask)
        bounds = bf16_flip_bounds(q, k, v, o, lse, do, causal, None, mask)
        for got, w, b in zip((dq, dk, dv), want, bounds):
            assert bf16_ulps(got, w, b) <= 1.0, case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_backward_is_deterministic(dtype):
    """No atomics: two runs of the backward pair give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do, mask = (_t(a, "cuda", dtype) if a is not None
                         and a.ndim == 4 else _t(a, "cuda")
                         for a in _inputs(*CUDA_CASES[2], seed=30))
    o, lse = flash_fwd(q, k, v, False, None, mask)
    runs = []
    for _ in range(2):
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, False, None, mask)
        runs.append((dq, delta) + flash_bwd_dkv(q, k, v, lse, delta, do,
                                                False, None, mask))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_backward_refuses_misaligned_inputs():
    """The backward kernels copy rows 16 bytes at a time: a pointer or a
    (batch, time, head) stride off 16 bytes raises; nothing is copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    B, T, H, D = 2, 64, 2, 64
    q, k, v, do, _ = (_t(a, "cuda") for a in _inputs(B, T, T, H, D, False,
                                                     None, seed=40))
    o, lse = flash_fwd(q, k, v)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    before = flash_bwd_dq.launches, flash_bwd_dkv.launches
    with pytest.raises(EnforceError, match="16-byte aligned"):
        flash_bwd_dq(shifted, k, v, o, lse, do)
    with pytest.raises(EnforceError, match="16-byte aligned"):
        flash_bwd_dkv(k, shifted, v, lse, torch.zeros_like(lse), do)
    # a time stride of H * D + 1 elements (4 bytes past a 16-byte step)
    wide = torch.zeros((B, T, H * D + 1), device="cuda")
    odd = wide.as_strided((B, T, H, D), (T * (H * D + 1), H * D + 1, D, 1))
    with pytest.raises(EnforceError, match="16-byte aligned"):
        flash_bwd_dq(q, k, v, o, lse, odd)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
