"""paddle_tpu_torch.ops.fused_optimizer, held to paddle_tpu's flat update.

``plain_flat_update`` — the math the CUDA kernel carries and the CPU
runs — against the JAX package's flat-group update: the optimizer's
``_make_update_fn`` applied to the flat buffers under ``jax.jit`` with
the group op's output-dtype pin (the XLA flat path, ``pallas_fused_update``
off, which the JAX package's own tests pin equal to its Pallas kernel).
Every kind of ``KINDS`` and each branch: SGD, Adagrad, Adam, Momentum
(plain and Nesterov), Adamax, DecayedAdagrad, Adadelta, RMSProp (plain
and centered), Ftrl (lr_power -0.5 and -0.25), ProximalGD and
ProximalAdagrad; Adam and Adamax with and without the beta-power
advance (``owns``); f32 and bf16 moments; flat sizes 1, 127, 1000 and
128*7+37 (ragged against the kernel's 128-lane tiles).

Tolerances: f32 rtol 1e-6 (parameters drawn away from zero), plus an
atol of 1e-7 of the buffer's largest magnitude, where a moment's sum
``b*m + (1-b)*g`` nearly cancels and one rounding of its larger term
dominates (4e-7 for Ftrl's power branch: ``_ATOL``); bf16 moments
within one bf16 ulp. The two are not bit-equal
across packages: XLA contracts ``a*b + c`` into a fused multiply-add,
and the port rounds op by op — the test below holds the port's plain
version bit-equal to numpy's op-by-op float32 arithmetic, which is the
order the kernel reproduces.

The gate (``apply``, the JAX package's ``mask_update_op``): for every
case, the plain version with the flag true is bit-equal to the ungated
update and with it false gives back every input bit for bit (the owner's
scalars at their step-start values); the op on the CPU updates in place
accordingly.

The kernel itself is compared with the plain version by the tests
marked ``cuda`` (bit-equal, gated with each flag value too), which skip
on a host without a card. JAX
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
# config -> (kind, the JAX optimizer's class and hyperparameters, the
# port's consts)
CONFIGS = {
    "sgd": ("sgd", "SGD", {}, (SCALE,)),
    "adagrad": ("adagrad", "Adagrad", {"epsilon": 1e-6}, (SCALE, 1e-6)),
    "adam": ("adam", "Adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             (SCALE, 0.9, 0.999, 1e-8)),
    "momentum": ("momentum", "Momentum", {"momentum": 0.9},
                 (SCALE, 0.9, False)),
    "momentum_nesterov": ("momentum", "Momentum",
                          {"momentum": 0.9, "use_nesterov": True},
                          (SCALE, 0.9, True)),
    "adamax": ("adamax", "Adamax",
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
               (SCALE, 0.9, 0.999, 1e-8)),
    "decayed_adagrad": ("decayed_adagrad", "DecayedAdagrad",
                        {"decay": 0.95, "epsilon": 1e-6},
                        (SCALE, 0.95, 1e-6)),
    "adadelta": ("adadelta", "Adadelta", {"rho": 0.95, "epsilon": 1e-6},
                 (SCALE, 0.95, 1e-6)),
    "rmsprop": ("rmsprop", "RMSProp",
                {"rho": 0.95, "epsilon": 1e-6, "momentum": 0.9},
                (SCALE, 0.95, 1e-6, 0.9, False)),
    "rmsprop_centered": ("rmsprop", "RMSProp",
                         {"rho": 0.95, "epsilon": 1e-6, "momentum": 0.9,
                          "centered": True},
                         (SCALE, 0.95, 1e-6, 0.9, True)),
    "ftrl": ("ftrl", "Ftrl", {"l1": 0.01, "l2": 0.02, "lr_power": -0.5},
             (SCALE, 0.01, 0.02, -0.5)),
    "ftrl_power": ("ftrl", "Ftrl",
                   {"l1": 0.01, "l2": 0.02, "lr_power": -0.25},
                   (SCALE, 0.01, 0.02, -0.25)),
    "proximal_gd": ("proximal_gd", "ProximalGD", {"l1": 0.01, "l2": 0.02},
                    (SCALE, 0.01, 0.02)),
    "proximal_adagrad": ("proximal_adagrad", "ProximalAdagrad",
                         {"l1": 0.01, "l2": 0.02}, (SCALE, 0.01, 0.02)),
}
# (config, moment dtype, owns)
CASES = ([(c, None, False) for c in CONFIGS
          if KINDS[CONFIGS[c][0]][0] == 0]
         + [(c, m, o) for c in CONFIGS if KINDS[CONFIGS[c][0]][0]
            for m in ("f32", "bf16")
            for o in ((False, True) if KINDS[CONFIGS[c][0]][1]
                      else (False,))])


def _ids(case):
    kind, mdt, owns = case
    return "-".join([kind] + ([mdt] if mdt else []) + (["owns"] if owns
                                                       else []))


# moments drawn signed (first moments, velocities, Ftrl's linear term,
# RMSProp's mean gradient); the others are uniform on [0, 1)
_SIGNED = {("adam", 0): 0.1, ("adamax", 0): 0.1, ("momentum", 0): 0.1,
           ("rmsprop", 0): 0.01, ("rmsprop", 2): 0.1, ("ftrl", 1): 0.1}


def _inputs(kind, n, mdt, seed=0):
    """numpy float32 (p, g, lr, accs, shared); the parameters are
    +-[0.5, 1.5], moments bf16-representable under ``mdt="bf16"``."""
    rng = np.random.RandomState(seed + n)
    p = (rng.choice([-1.0, 1.0], n) * rng.uniform(0.5, 1.5, n)).astype(
        np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    accs = []
    for i in range(KINDS[kind][0]):
        a = (rng.uniform(0.0, 1.0, n) if (kind, i) not in _SIGNED
             else _SIGNED[kind, i] * rng.standard_normal(n)
             ).astype(np.float32)
        accs.append(a)
    if kind == "rmsprop":
        # mean_square >= 2 mean_grad^2: the centered variance stays
        # positive after the moments are rounded to bf16
        accs[1] = accs[1] + 2 * accs[2] * accs[2]
    if mdt == "bf16":
        accs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                for a in accs]
    shared = [np.float32(0.9 ** 3), np.float32(0.999 ** 3)][:KINDS[kind][1]]
    return p, g, np.float32(LR), accs, shared


def _torch(p, g, lr, accs, shared, mdt, device="cpu"):
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt,  # noqa: E731
                                                  device=device)
    mt = torch.bfloat16 if mdt == "bf16" else torch.float32
    return (t(p), t(g), t(lr), tuple(t(a, mt) for a in accs),
            tuple(t(s) for s in shared))


def _jax_flat_update(config, owns, p, g, lr, accs, shared, mdt):
    """The JAX package's group update body on the flat buffers."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu as jfluid

    _kind, cls, hyper, _consts = CONFIGS[config]
    opt = getattr(jfluid.optimizer, cls)(learning_rate=LR, **hyper)
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


# Ftrl's power branch: XLA's pow and torch's differ by one ulp on a
# few percent of the elements, and sigma divides the difference of two
# powers by lr; the parameters then part by up to ~2e-7 of their max
_ATOL = {"ftrl_power": 4e-7}


def _close_f32(got, want, atol=1e-7):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=atol * float(np.abs(want).max()))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plain_flat_update_matches_jax_flat_update(case, n):
    config, mdt, owns = case
    kind, consts = CONFIGS[config][0], CONFIGS[config][3]
    arrays = _inputs(kind, n, mdt)
    want = _jax_flat_update(config, owns, *arrays, mdt)
    got = plain_flat_update(kind, *_torch(*arrays, mdt), owns=owns,
                            consts=consts)
    got = [t.float().numpy() for t in got]
    assert len(got) == len(want) == (1 + KINDS[kind][0]
                                     + (KINDS[kind][1] if owns else 0))
    atol = _ATOL.get(config, 1e-7)
    _close_f32(got[0], want[0], atol)
    for i in range(1, 1 + KINDS[kind][0]):
        if mdt == "bf16":
            assert np.all(np.abs(got[i] - want[i]) <= _bf16_ulp(want[i])), i
        else:
            _close_f32(got[i], want[i], atol)
    for i in range(1 + KINDS[kind][0], len(got)):  # the advanced powers
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("kind", ["adagrad", "adam", "sgd"])
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
                            owns=True, consts=CONFIGS[kind][3])
    assert len(got) == len(want)
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w, np.float32))


def test_launcher_takes_the_plain_version_on_the_cpu():
    arrays = _inputs("adam", 300, "bf16", seed=5)
    args = _torch(*arrays, "bf16")
    before = fused_flat_update.launches
    consts = CONFIGS["adam"][3]
    # the launcher updates p and the moments in place on the CPU too, as
    # the kernel does on the card: the plain version runs on copies first
    copies = [tuple(t.clone() for t in a) if isinstance(a, tuple)
              else a.clone() for a in args]
    want = plain_flat_update("adam", *copies, owns=True, consts=consts)
    got = fused_flat_update("adam", *args, owns=True, consts=consts)
    assert fused_flat_update.launches == before
    assert got[0] is args[0] and got[1] is args[3][0]
    assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32,
                                      torch.float32]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in args[:3]]
    out = fused_flat_update("sgd", *meta, consts=(1.0,))
    assert out[0].shape == (300,) and out[0].device.type == "meta"
    with pytest.raises(EnforceError, match="unknown kind"):
        fused_flat_update("lamb", *args[:3], consts=(1.0,))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_gated_plain_update_is_the_update_or_nothing(case):
    config, mdt, owns = case
    kind, consts = CONFIGS[config][0], CONFIGS[config][3]
    p, g, lr, accs, shared = _torch(*_inputs(kind, 1000, mdt, seed=7), mdt)
    want = plain_flat_update(kind, p, g, lr, accs, shared, owns, consts)
    ins = (p,) + accs + (shared if owns else ())
    for flag in (True, False):
        got = plain_flat_update(kind, p, g, lr, accs, shared, owns, consts,
                                apply=torch.tensor(flag))
        assert len(got) == len(want)
        for a, b in zip(got, want if flag else ins):
            assert a.dtype == b.dtype and torch.equal(a, b), (case, flag)
        # the op on the CPU: in place, the advanced scalars new tensors
        pc, ac = p.clone(), [a.clone() for a in accs]
        out = fused_flat_update(kind, pc, g, lr, ac, shared, owns, consts,
                                apply=torch.tensor(flag))
        assert out[0] is pc
        for a, b in zip(out, want if flag else ins):
            assert a.dtype == b.dtype and torch.equal(a, b), (case, flag)


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
    config, mdt, owns = case
    kind, consts = CONFIGS[config][0], CONFIGS[config][3]
    for n in SIZES + [1 << 20]:
        p, g, lr, accs, shared = _torch(*_inputs(kind, n, mdt), mdt, "cuda")
        want = plain_flat_update(kind, p, g, lr, accs, shared, owns, consts)
        before = fused_flat_update.launches
        # the kernel updates p and the moments in place: give it copies
        got = fused_flat_update(kind, p.clone(), g, lr,
                                [a.clone() for a in accs], shared, owns,
                                consts)
        torch.cuda.synchronize()
        assert fused_flat_update.launches == before + 1
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (case, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_cuda_gated_kernel_is_bit_equal_to_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    config, mdt, owns = case
    kind, consts = CONFIGS[config][0], CONFIGS[config][3]
    for n in SIZES + [1 << 20]:
        p, g, lr, accs, shared = _torch(*_inputs(kind, n, mdt), mdt, "cuda")
        ins = (p,) + accs + (shared if owns else ())
        for flag in (True, False):
            apply = torch.tensor(flag, device="cuda")
            want = plain_flat_update(kind, p, g, lr, accs, shared, owns,
                                     consts, apply)
            before = (fused_flat_update.launches,
                      fused_flat_update.gated_launches)
            got = fused_flat_update(kind, p.clone(), g, lr,
                                    [a.clone() for a in accs], shared, owns,
                                    consts, apply)
            torch.cuda.synchronize()
            assert (fused_flat_update.launches,
                    fused_flat_update.gated_launches) == (before[0] + 1,
                                                          before[1] + 1)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    (case, n, flag)
            if not flag:  # nothing written, the scalars step-start
                for a, b in zip(got, ins):
                    assert torch.equal(a, b), (case, n)


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    p, g, lr, accs, shared = _torch(*_inputs("adam", 64, "f32"), "f32",
                                    "cuda")
    with pytest.raises(EnforceError, match="takes 2 moments"):
        fused_flat_update("adam", p, g, lr, accs[:1], shared,
                          consts=CONFIGS["adam"][3])
    with pytest.raises(EnforceError, match="all float32 or all bfloat16"):
        fused_flat_update("adam", p, g, lr,
                          (accs[0], accs[1].to(torch.bfloat16)), shared,
                          consts=CONFIGS["adam"][3])
    with pytest.raises(EnforceError, match="contiguous flat float32"):
        fused_flat_update("sgd", p.reshape(8, 8), g, lr, consts=(1.0,))
    with pytest.raises(EnforceError, match="apply flag"):
        fused_flat_update("sgd", p, g, lr, consts=(1.0,),
                          apply=torch.tensor(True))  # on the host
