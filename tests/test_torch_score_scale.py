"""The bf16 attention-score scale of paddle_tpu_torch, held to paddle_tpu.

The JAX package divides attention scores by ``jnp.sqrt(jnp.asarray(Dk,
q.dtype))``: with bfloat16 queries that is sqrt(Dk) rounded to bf16
(11.3125 for Dk=128, where f32 gives 11.3137). The port divides by the
same rounded value (``core.dtype_utils.rounded_sqrt``) in the fused
attention op and in the paged window's plain version. At Dk=64 the two
roundings agree, so these cases run at Dk=128 with bf16 queries, where
an unrounded divisor changes about one score in fifty by a bf16 ulp.

Both sides run eagerly, op by op (a jitted XLA program fuses the chain
and rounds elsewhere), on the same bf16 inputs made with numpy from a
seed, and are held to bit equality of the bf16 outputs.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu.models.transformer import \
    multi_head_attention as j_multi_head_attention
from paddle_tpu_torch.core.dtype_utils import rounded_sqrt
from paddle_tpu_torch.models.transformer import \
    multi_head_attention as t_multi_head_attention
from paddle_tpu_torch.ops.paged_attention import plain_window_attention

torch.set_num_threads(1)

B, T, H, DK = 2, 16, 2, 128


def test_rounded_sqrt_is_the_divisor_in_each_dtype():
    assert rounded_sqrt(128, torch.bfloat16) == 11.3125
    assert rounded_sqrt(128, torch.float32) == float(np.sqrt(np.float32(128)))
    assert rounded_sqrt(64, torch.bfloat16) == rounded_sqrt(64,
                                                            torch.float32) == 8


def _fused_fns(causal, masked):
    """The ``fused_attention`` op's function of each package, from the
    same ``multi_head_attention(attn_impl="fused")`` call."""
    fns = []
    for pkg, mha, guard in ((jfluid, j_multi_head_attention,
                             j_unique_name.guard),
                            (tfluid, t_multi_head_attention,
                             tfluid.unique_name.guard)):
        main, startup = pkg.Program(), pkg.Program()
        with guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [T, H * DK], dtype="float32")
            mask = (pkg.layers.data("mask", [T], dtype="float32")
                    if masked else None)
            mha(x, x, x, DK, DK, H * DK, n_head=H, causal=causal,
                kv_mask=mask, attn_impl="fused")
        op, = [o for o in main.global_block().ops
               if o.type == "fused_attention"]
        fns.append(op.fn)
    return fns


@pytest.mark.parametrize("causal,masked", [(False, False), (False, True),
                                           (True, False), (True, True)],
                         ids=["plain", "key_masked", "causal",
                              "causal_masked"])
def test_fused_attention_matches_jax_at_dk128_bf16(causal, masked):
    import jax.numpy as jnp

    j_fn, t_fn = _fused_fns(causal, masked)
    rng = np.random.RandomState(3)
    q, k, v = (rng.standard_normal((B, T, H * DK)).astype(np.float32)
               for _ in range(3))
    lens = rng.randint(T // 2, T + 1, size=B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    j_args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    t_args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    if masked:
        j_args.append(jnp.asarray(mask))
        t_args.append(torch.from_numpy(mask))
    want = np.asarray(j_fn(*j_args).astype(jnp.float32))
    got = t_fn(*t_args)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pools",
                                                      "int8_pools"])
def test_plain_window_attention_matches_xla_at_dk128_bf16(quant):
    import jax.numpy as jnp

    from paddle_tpu.ops.paged_attention import xla_window_attention

    Tw, mb, bs, nb = 4, 3, 8, 10
    rng = np.random.RandomState(5)
    q = rng.standard_normal((B, Tw, H, DK)).astype(np.float32)
    tables = rng.randint(0, nb, (B, mb)).astype(np.int32)
    tables[1, 2] = -1
    cached = np.array([mb * bs - Tw, 2 * bs - Tw], dtype=np.int32)
    if quant:
        kp, vp = (rng.randint(-127, 128, (nb, bs, H, DK)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(1e-3, 0.1, (nb, bs)).astype(np.float32)
                  for _ in range(2))
        j_pools = [jnp.asarray(kp), jnp.asarray(vp)]
        t_pools = [torch.from_numpy(kp), torch.from_numpy(vp)]
        j_kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        t_kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        kp, vp = (rng.standard_normal((nb, bs, H, DK)).astype(np.float32)
                  for _ in range(2))
        j_pools = [jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp,
                                                              jnp.bfloat16)]
        t_pools = [torch.from_numpy(kp).to(torch.bfloat16),
                   torch.from_numpy(vp).to(torch.bfloat16)]
        j_kw = t_kw = {}
    want = xla_window_attention(jnp.asarray(q, jnp.bfloat16), *j_pools,
                                jnp.asarray(tables), jnp.asarray(cached),
                                **j_kw)
    got = plain_window_attention(torch.from_numpy(q).to(torch.bfloat16),
                                 *t_pools, torch.from_numpy(tables),
                                 torch.from_numpy(cached), **t_kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
