"""The flash forward's bf16 rounding, and the forward kernels on the card.

The bf16 forward kernel feeds p to the tensor cores as two bf16 parts
(hi = bf16(p), lo = bf16(p - hi)), tile by tile with a running max, and
sums l from the unrounded p: ``plain_flash_forward_bf16`` models that.
On the CPU, at the shapes of ``chip_smoke.FLASH_CASES`` with the batch
cut, the model must sit within one bf16 ulp per element of the
unrounded ``plain_flash_forward`` (``bf16_ulps`` at most 1, the check
the card holds the kernel to) and within the bf16 tolerance (3e-2) of
the JAX package's forward through its XLA path; a single bf16 rounding
of p would not pass that check at long context. The inputs are made
with numpy from a seed.

The tests marked ``cuda`` hold the kernels to the plain versions on the
card and skip on a host without one:

    python -m pytest tests/test_torch_flash_forward.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops.flash_attention import (bf16_ulps, flash_fwd,
                                                  plain_flash_forward,
                                                  plain_flash_forward_bf16)

torch.set_num_threads(1)

BF16_TOL = 3e-2  # chip_smoke.TOL[bf16]: bf16 outputs, sums in another order
LSE_TOL = 1e-4
# chip_smoke.FLASH_CASES with the batch cut to fit a CPU test's time
CASES = {label: (min(B, 1 if Tq * Tk > 10 ** 6 else 2), Tq, Tk, H, D,
                 causal, masked)
         for label, B, Tq, Tk, H, D, causal, masked, _ in
         chip_smoke.FLASH_CASES}


def _inputs(B, Tq, Tk, H, D, masked, seed, device="cpu",
            dtype=torch.bfloat16):
    """q, k, v as chip_smoke.flash_inputs makes them (standard normals;
    a [B, Tk] key mask with ragged tails keeping at least half the
    keys), on ``device`` in ``dtype``."""
    rng = np.random.RandomState(seed)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
    q, k, v = t(B, Tq, H, D), t(B, Tk, H, D), t(B, Tk, H, D)
    mask = None
    if masked:
        lens = rng.randint(Tk // 2, Tk + 1, size=B)
        mask = torch.from_numpy((np.arange(Tk)[None, :] < lens[:, None])
                                .astype(np.float32)).to(device)
    return q, k, v, mask


def _lse_err(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


# ------------------------------------------------ the rounding model


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_forward_model_within_one_ulp_of_plain(case):
    """The card check admits the kernel's rounding: the model's o is
    within one bf16 ulp (plus 1e-3 of max |o|) of the unrounded plain
    forward at every element, its lse within 1e-4."""
    B, Tq, Tk, H, D, causal, masked = CASES[case]
    q, k, v, mask = _inputs(B, Tq, Tk, H, D, masked, seed=0)
    o, lse = plain_flash_forward(q, k, v, causal, None, mask)
    mo, mlse = plain_flash_forward_bf16(q, k, v, causal, None, mask)
    assert mo.dtype == torch.bfloat16 and mo.shape == o.shape
    assert bf16_ulps(mo, o) <= 1.0, case
    assert _lse_err(mlse, lse) <= LSE_TOL, case


def test_single_bf16_rounding_of_p_fails_the_check_at_long_context():
    """Why the kernel splits p in two bf16 parts: one bf16 rounding of p
    (``p_parts=1``) puts o more than one bf16 ulp from the unrounded
    forward at the long-context shape (T=2048: an element of a small
    average moves by two ulps), while the split stays within one."""
    B, Tq, Tk, H, D, causal, masked = CASES["long"]
    q, k, v, mask = _inputs(B, Tq, Tk, H, D, masked, seed=0)
    o, _ = plain_flash_forward(q, k, v, causal, None, mask)
    one, _ = plain_flash_forward_bf16(q, k, v, causal, None, mask,
                                      p_parts=1)
    two, _ = plain_flash_forward_bf16(q, k, v, causal, None, mask)
    assert bf16_ulps(one, o) > 1.0
    assert bf16_ulps(two, o) <= 1.0
    assert not torch.equal(one, two)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_forward_model_matches_the_jax_forward(case):
    """The model against the JAX package's forward on the same bf16
    inputs, through its XLA path (``_xla_attention``, what its public
    ``flash_attention`` runs off the TPU): within the bf16 tolerance on
    every row (each keeps at least one valid key)."""
    import jax.numpy as jnp

    from paddle_tpu.ops.flash_attention import _xla_attention

    B, Tq, Tk, H, D, causal, masked = CASES[case]
    q, k, v, mask = _inputs(B, Tq, Tk, H, D, masked, seed=1)
    mo, _ = plain_flash_forward_bf16(q, k, v, causal, D ** -0.5, mask)

    def j(x):
        return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)

    jo = _xla_attention(j(q), j(k), j(v), causal, D ** -0.5,
                        None if mask is None else jnp.asarray(mask.numpy()))
    want = np.asarray(jo.astype(jnp.float32))
    err = np.abs(mo.float().numpy() - want).max()
    assert err <= BF16_TOL, (case, err)


def test_bf16_forward_model_semantics():
    """A batch row with no valid key gives o = 0 and lse = +inf, as the
    plain forward does; f32 inputs keep their dtype; ``p_parts`` other
    than 1 or 2 is refused."""
    q, k, v, mask = _inputs(2, 70, 130, 2, 64, True, seed=2,
                            dtype=torch.float32)
    mask[0] = 0.0
    o, lse = plain_flash_forward_bf16(q, k, v, False, None, mask)
    ro, rlse = plain_flash_forward(q, k, v, False, None, mask)
    assert o.dtype == torch.float32
    assert (o[0] == 0).all() and torch.isinf(lse[0]).all()
    assert (lse[0] > 0).all() and torch.isfinite(lse[1]).all()
    assert float((o - ro).abs().max()) <= 1e-2
    assert _lse_err(lse, rlse) <= LSE_TOL
    with pytest.raises(EnforceError, match="p_parts"):
        plain_flash_forward_bf16(q, k, v, p_parts=3)


# ------------------------------------------------ the kernels, on the card

# (B, Tq, Tk, H, D, causal, masked): the training shape (B=32, T=256,
# H=8, D=64) key-masked, ragged cross shapes, D=128 causal, and one
# query row or one key
CUDA_CASES = [(32, 256, 256, 8, 64, False, True),
              (3, 100, 77, 2, 64, True, True),
              (4, 200, 333, 8, 64, False, True),
              (2, 130, 130, 2, 128, True, True),
              (2, 1, 9, 2, 64, True, True),
              (2, 9, 1, 2, 128, False, False)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_bf16_forward_within_one_ulp_of_plain_and_model():
    """The bf16 forward kernel against the unrounded plain forward and
    its rounding model: ``bf16_ulps`` at most 1 for both, lse within
    1e-4, every card case and every chip_smoke flash case."""
    _need_card()
    shapes = CUDA_CASES + [(B, Tq, Tk, H, D, causal, masked)
                           for _, B, Tq, Tk, H, D, causal, masked, _ in
                           chip_smoke.FLASH_CASES]
    for i, (B, Tq, Tk, H, D, causal, masked) in enumerate(shapes):
        q, k, v, mask = _inputs(B, Tq, Tk, H, D, masked, seed=50 + i,
                                device="cuda")
        o, lse = flash_fwd(q, k, v, causal, None, mask)
        ro, rlse = plain_flash_forward(q, k, v, causal, None, mask)
        mo, _ = plain_flash_forward_bf16(q, k, v, causal, None, mask)
        assert bf16_ulps(o, ro) <= 1.0, (i, bf16_ulps(o, ro))
        assert bf16_ulps(o, mo) <= 1.0, (i, bf16_ulps(o, mo))
        assert _lse_err(lse, rlse) <= LSE_TOL, i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_forward_is_deterministic(dtype):
    """No atomics: two runs of the forward give the same bits."""
    _need_card()
    for B, Tq, Tk, H, D, causal, masked in CUDA_CASES:
        q, k, v, mask = _inputs(B, Tq, Tk, H, D, masked, seed=60,
                                device="cuda", dtype=dtype)
        o1, lse1 = flash_fwd(q, k, v, causal, None, mask)
        o2, lse2 = flash_fwd(q, k, v, causal, None, mask)
        assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_forward_row_without_keys(dtype):
    """A batch row whose mask lets no key through writes o = 0 and
    lse = +inf (its query tiles walk nothing), causal or not; the other
    rows stay finite."""
    _need_card()
    for causal in (False, True):
        for D in (64, 128):
            q, k, v, mask = _inputs(3, 150, 150, 2, D, True, seed=70,
                                    device="cuda", dtype=dtype)
            mask[1] = 0.0
            o, lse = flash_fwd(q, k, v, causal, None, mask)
            torch.cuda.synchronize()
            assert (o[1] == 0).all()
            assert torch.isinf(lse[1]).all() and (lse[1] > 0).all()
            assert torch.isfinite(o).all()
            assert torch.isfinite(lse[0]).all() and torch.isfinite(lse[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_cuda_forward_skips_masked_key_tails(dtype, causal):
    """Masks that leave whole key tiles masked at the tail (some rows
    keep fewer than T/2 keys, one keeps a single key), so the walk
    stops at the last valid key: o within 1e-4 (f32) / one bf16 ulp and
    3e-2 (bf16) of the plain forward, lse within 1e-4."""
    _need_card()
    B, T, H = 4, 320, 4
    for D in (64, 128):
        q, k, v, _ = _inputs(B, T, T, H, D, False, seed=80, device="cuda",
                             dtype=dtype)
        lens = torch.tensor([1, 70, 150, 300], device="cuda")
        mask = (torch.arange(T, device="cuda")[None, :]
                < lens[:, None]).float()
        before = flash_fwd.launches
        o, lse = flash_fwd(q, k, v, causal, None, mask)
        assert flash_fwd.launches == before + 1
        ro, rlse = plain_flash_forward(q, k, v, causal, None, mask)
        err = float((o.float() - ro.float()).abs().max())
        if dtype == torch.float32:
            assert err <= 1e-4, (D, err)
        else:
            assert err <= BF16_TOL and bf16_ulps(o, ro) <= 1.0, (D, err)
        assert _lse_err(lse, rlse) <= LSE_TOL, D
