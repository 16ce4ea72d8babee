"""paddle_tpu_torch.ops.fused_optimizer, held to paddle_tpu's flat update.

``plain_flat_update`` — the math the CUDA kernel carries and the CPU
runs — against the JAX package's flat-group update: the optimizer's
``_make_update_fn`` applied to the flat buffers under ``jax.jit`` with
the group op's output-dtype pin (the XLA flat path, ``pallas_fused_update``
off, which the JAX package's own tests pin equal to its Pallas kernel).
SGD, Adagrad and Adam; Adam with and without the beta-power advance
(``owns``); f32 and bf16 moments; flat sizes 1, 127, 1000 and
128*7+37 (ragged against the kernel's 128-lane tiles).

Tolerances: f32 rtol 1e-6 (parameters drawn away from zero), plus an
atol of 1e-7 of the buffer's largest magnitude, where a moment's sum
``b*m + (1-b)*g`` nearly cancels and one rounding of its larger term
dominates; bf16 moments within one bf16 ulp. The two are not bit-equal
across packages: XLA contracts ``a*b + c`` into a fused multiply-add,
and the port rounds op by op — the test below holds the port's plain
version bit-equal to numpy's op-by-op float32 arithmetic, which is the
order the kernel reproduces.

The kernel itself is compared with the plain version by the tests
marked ``cuda`` (bit-equal), which skip on a host without a card. JAX
is imported inside the tests that use it, so the card tests also run
on a machine without JAX:

    python -m pytest tests/test_torch_fused_optimizer.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops.fused_optimizer import (KINDS, fused_flat_update,
                                                  plain_flat_update)

torch.set_num_threads(1)

SIZES = [1, 127, 1000, 128 * 7 + 37]
LR, SCALE = 1e-3, 0.5
HYPER = {"sgd": {}, "adagrad": {"epsilon": 1e-6},
         "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}}
CONSTS = {"sgd": (SCALE,), "adagrad": (SCALE, 1e-6),
          "adam": (SCALE, 0.9, 0.999, 1e-8)}
# (kind, moment dtype, owns)
CASES = ([("sgd", None, False)]
         + [("adagrad", m, False) for m in ("f32", "bf16")]
         + [("adam", m, o) for m in ("f32", "bf16") for o in (False, True)])


def _ids(case):
    kind, mdt, owns = case
    return "-".join([kind] + ([mdt] if mdt else []) + (["owns"] if owns
                                                       else []))


def _inputs(kind, n, mdt, seed=0):
    """numpy float32 (p, g, lr, accs, shared); the parameters are
    +-[0.5, 1.5], moments bf16-representable under ``mdt="bf16"``."""
    rng = np.random.RandomState(seed + n)
    p = (rng.choice([-1.0, 1.0], n) * rng.uniform(0.5, 1.5, n)).astype(
        np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    accs = []
    for i in range(KINDS[kind][0]):
        a = (rng.uniform(0.0, 1.0, n) if (kind, i) != ("adam", 0)
             else 0.1 * rng.standard_normal(n)).astype(np.float32)
        if mdt == "bf16":
            a = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        accs.append(a)
    shared = ([np.float32(0.9 ** 3), np.float32(0.999 ** 3)]
              if kind == "adam" else [])
    return p, g, np.float32(LR), accs, shared


def _torch(p, g, lr, accs, shared, mdt, device="cpu"):
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt,  # noqa: E731
                                                  device=device)
    mt = torch.bfloat16 if mdt == "bf16" else torch.float32
    return (t(p), t(g), t(lr), tuple(t(a, mt) for a in accs),
            tuple(t(s) for s in shared))


def _jax_flat_update(kind, owns, p, g, lr, accs, shared, mdt):
    """The JAX package's group update body on the flat buffers."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu as jfluid

    opt = {"sgd": jfluid.optimizer.SGD, "adagrad": jfluid.optimizer.Adagrad,
           "adam": jfluid.optimizer.Adam}[kind](learning_rate=LR,
                                                **HYPER[kind])
    fn = opt._make_update_fn(SCALE, owns)
    mt = jnp.bfloat16 if mdt == "bf16" else jnp.float32
    jaccs = [jnp.asarray(a, mt) for a in accs]
    dtypes = [jnp.float32] + [mt] * len(accs) + [jnp.float32] * 2

    def group(*args):
        out = fn(*args)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return tuple(v.astype(d) for v, d in zip(out, dtypes))

    out = jax.jit(group)(jnp.asarray(p), jnp.asarray(g), jnp.asarray(lr),
                         *jaccs, *[jnp.asarray(s) for s in shared])
    return [np.asarray(o, dtype=np.float32) for o in out]


def _close_f32(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-7 * float(np.abs(want).max()))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plain_flat_update_matches_jax_flat_update(case, n):
    kind, mdt, owns = case
    arrays = _inputs(kind, n, mdt)
    want = _jax_flat_update(kind, owns, *arrays, mdt)
    got = plain_flat_update(kind, *_torch(*arrays, mdt), owns=owns,
                            consts=CONSTS[kind])
    got = [t.float().numpy() for t in got]
    assert len(got) == len(want) == (1 + KINDS[kind][0]
                                     + (2 if owns else 0))
    _close_f32(got[0], want[0])
    for i in range(1, 1 + KINDS[kind][0]):
        if mdt == "bf16":
            assert np.all(np.abs(got[i] - want[i]) <= _bf16_ulp(want[i])), i
        else:
            _close_f32(got[i], want[i])
    for i in range(1 + KINDS[kind][0], len(got)):  # the advanced powers
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_flat_update_is_op_by_op_float32(kind):
    """The plain version rounds after every operation, in the order the
    kernel's ``_rn`` intrinsics follow: bit-equal to numpy float32."""
    f = np.float32
    p, g, lr, accs, shared = _inputs(kind, 1000, "f32", seed=3)
    scale = f(SCALE)
    if kind == "sgd":
        want = [p - (lr * scale) * g]
    elif kind == "adagrad":
        m = accs[0] + g * g
        want = [p - (lr * scale) * g / (np.sqrt(m) + f(1e-6)), m]
    else:
        b1, b2 = f(0.9), f(0.999)
        c1, c2 = f(1 - 0.9), f(1 - 0.999)
        m1 = b1 * accs[0] + c1 * g
        m2 = b2 * accs[1] + (c2 * g) * g
        lr_t = (lr * scale) * np.sqrt(f(1) - shared[1]) / (f(1) - shared[0])
        want = [p - (lr_t * m1) / (np.sqrt(m2) + f(1e-8)), m1, m2,
                shared[0] * b1, shared[1] * b2]
    got = plain_flat_update(kind, *_torch(p, g, lr, accs, shared, "f32"),
                            owns=True, consts=CONSTS[kind])
    assert len(got) == len(want)
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w, np.float32))


def test_launcher_takes_the_plain_version_on_the_cpu():
    arrays = _inputs("adam", 300, "bf16", seed=5)
    args = _torch(*arrays, "bf16")
    before = fused_flat_update.launches
    got = fused_flat_update("adam", *args, owns=True, consts=CONSTS["adam"])
    want = plain_flat_update("adam", *args, owns=True, consts=CONSTS["adam"])
    assert fused_flat_update.launches == before
    assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32,
                                      torch.float32]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in args[:3]]
    out = fused_flat_update("sgd", *meta, consts=(1.0,))
    assert out[0].shape == (300,) and out[0].device.type == "meta"
    with pytest.raises(EnforceError, match="unknown kind"):
        fused_flat_update("momentum", *args[:3], consts=(1.0,))


def test_kernel_build_is_keyed_by_its_source():
    path = _cuda.library_path("fused_optimizer")
    assert path.parent == _cuda.BUILD_DIR
    assert path.name.startswith("fused_optimizer-") and path.suffix == ".so"
    assert _cuda.CSRC.joinpath("fused_optimizer.cu").exists()


# ------------------------------------------------ the kernel, on the card


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_cuda_kernel_is_bit_equal_to_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kind, mdt, owns = case
    for n in SIZES + [1 << 20]:
        p, g, lr, accs, shared = _torch(*_inputs(kind, n, mdt), mdt, "cuda")
        want = plain_flat_update(kind, p, g, lr, accs, shared, owns,
                                 CONSTS[kind])
        before = fused_flat_update.launches
        # the kernel updates p and the moments in place: give it copies
        got = fused_flat_update(kind, p.clone(), g, lr,
                                [a.clone() for a in accs], shared, owns,
                                CONSTS[kind])
        torch.cuda.synchronize()
        assert fused_flat_update.launches == before + 1
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (case, n)


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    p, g, lr, accs, shared = _torch(*_inputs("adam", 64, "f32"), "f32",
                                    "cuda")
    with pytest.raises(EnforceError, match="takes 2 moments"):
        fused_flat_update("adam", p, g, lr, accs[:1], shared,
                          consts=CONSTS["adam"])
    with pytest.raises(EnforceError, match="all float32 or all bfloat16"):
        fused_flat_update("adam", p, g, lr,
                          (accs[0], accs[1].to(torch.bfloat16)), shared,
                          consts=CONSTS["adam"])
    with pytest.raises(EnforceError, match="contiguous flat float32"):
        fused_flat_update("sgd", p.reshape(8, 8), g, lr, consts=(1.0,))
