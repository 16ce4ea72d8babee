"""paddle_tpu_torch.parallel.ring_attention against paddle_tpu's.

On a world of four gloo ranks on the CPU (``tests/_torch_ranks.py``),
numpy-seeded ``[2, 32, 4, 16]`` queries, keys and values, whole on
every rank:

* sp=4 and dp=2 x sp=2, causal (zigzag by the auto rule, and
  contiguous) and not (with a padded key tail): the output against the
  JAX package's ``_plain_attention`` (and, for two of the cases, its
  ``ring_attention`` on a mesh of the same shape) at rtol/atol 2e-5
  (tests/test_ring_attention.py:30), and the gradients of
  ``sum(o ** 2)`` against the plain attention's (rtol 2e-4, atol 2e-5,
  tests/test_ring_attention.py:159) — the same on every rank, each
  block's once;
* bf16 inputs within bf16 resolution of the f32 ring
  (tests/test_ring_attention.py:133);
* zigzag with an odd local block refused;
* the ring Transformer (``attn_impl="ring"``) at dp=2 x sp=2: three
  Adam steps against the JAX package's run of it on the same mesh and
  against the port's one-process fused run, at rtol 2e-4
  (tests/test_transformer_ring.py:38).

In one process: the fallback without an ``sp`` axis, and the zigzag
layout's half-blocks where the JAX package's exchange puts them.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

import _torch_ranks as R

torch.set_num_threads(1)

OUT_TOL = 2e-5   # tests/test_ring_attention.py:37
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5  # tests/test_ring_attention.py:175
TB_RTOL = 2e-4   # tests/test_transformer_ring.py:80


def _devices(n):
    import jax

    if len(jax.devices()) < n:
        pytest.skip("needs %d virtual devices" % n)
    return jax.devices()[:n]


def _qkv():
    rng = np.random.RandomState(0)
    q, k, v = [rng.randn(2, 32, 4, 16).astype("float32") for _ in range(3)]
    kvm = np.ones((2, 32), "float32")
    kvm[:, -3:] = 0.0
    return q, k, v, kvm


def _save_state(path, main, startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    np.savez(path, **{v.name: np.asarray(scope.find_var(v.name))
                      for v in main.list_vars()
                      if v.persistable and scope.find_var(v.name)
                      is not None})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from paddle_tpu.models.transformer import transformer_base as jtb

    out = tmp_path_factory.mktemp("ring_ranks")
    with j_unique_name.guard():
        main, startup, _ = R.build_ring_tb(jfluid, jtb, "ring")
    _save_state(str(out / "ring_tb.npz"), main, startup)
    return out, R.launch(4, ["ring"], str(out), timeout=300)["ring"]


def _jax_plain(causal):
    """The JAX package's ``_plain_attention`` and its gradients of
    ``sum(o ** 2)`` (the oracle tests/test_ring_attention.py holds its
    ring to)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel.ring_attention import _plain_attention

    q, k, v, kvm = [jnp.asarray(a) for a in _qkv()]
    mask = None if causal else kvm

    def loss(q, k, v):
        o = _plain_attention(q, k, v, causal, None, mask)
        return (o.astype(jnp.float32) ** 2).sum(), o

    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                   has_aux=True)(q, k, v)
    return np.asarray(o), [np.asarray(t) for t in g]


def _jax_ring(axes, causal, zigzag):
    """The JAX package's ring on a mesh of ``axes`` (forward)."""
    import jax.numpy as jnp

    from paddle_tpu.parallel import make_mesh, ring_attention

    q, k, v, kvm = [jnp.asarray(a) for a in _qkv()]
    mesh = make_mesh(axes, devices=_devices(4))
    return np.asarray(ring_attention(q, k, v, mesh, causal=causal,
                                     zigzag=zigzag,
                                     kv_mask=None if causal else kvm))


CASES = [("sp4", {"sp": 4}, False, None), ("sp4", {"sp": 4}, True, None),
         ("sp4", {"sp": 4}, True, False),
         ("dp2,sp2", {"dp": 2, "sp": 2}, False, None),
         ("dp2,sp2", {"dp": 2, "sp": 2}, True, None),
         ("dp2,sp2", {"dp": 2, "sp": 2}, True, False)]


@pytest.mark.parametrize("key,axes,causal,zigzag", CASES)
def test_ring_matches_the_jax_packages_output_and_gradients(
        ranks, key, axes, causal, zigzag):
    """Every case against the JAX package's plain attention and its
    gradients; the JAX package's own ring (compiled over a mesh of the
    same shape) for the zigzag sp=4 and the masked dp=2 x sp=2 cases."""
    _out, res = ranks
    o, grads = _jax_plain(causal)
    ring = None
    if (key, causal, zigzag) in (("sp4", True, None),
                                 ("dp2,sp2", False, None)):
        ring = _jax_ring(axes, causal, zigzag)
    for rank in res:
        got = rank["%s_%s_%s" % (key, causal, zigzag)]
        np.testing.assert_allclose(got["o"], o, rtol=OUT_TOL, atol=OUT_TOL)
        if ring is not None:
            np.testing.assert_allclose(got["o"], ring, rtol=OUT_TOL,
                                       atol=OUT_TOL)
        for name, want in zip(("gq", "gk", "gv"), grads):
            np.testing.assert_allclose(got[name], want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)


def test_zigzag_matches_contiguous_and_bf16_resolution(ranks):
    """tests/test_ring_attention.py:133,183: the zigzag layout is the
    contiguous one's function; bf16 inputs land within bf16 resolution
    of the f32 ring; an odd local block cannot zigzag."""
    _out, res = ranks
    for rank in res:
        for key in ("sp4", "dp2,sp2"):
            np.testing.assert_allclose(rank[key + "_True_None"]["o"],
                                       rank[key + "_True_False"]["o"],
                                       rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(rank[key + "_bf16"],
                                       rank[key + "_True_None"]["o"],
                                       atol=0.05, rtol=0.05)
        assert rank["zigzag_refused"] and "even" in rank["zigzag_refused"]


def test_ring_transformer_matches_the_jax_mesh_run_and_fused(ranks):
    """tests/test_transformer_ring.py:38 at dp=2 x sp=2 (four ranks),
    three Adam steps from the JAX package's start state."""
    import jax.numpy as jnp

    from paddle_tpu.models.transformer import transformer_base as jtb
    from paddle_tpu_torch.models.transformer import transformer_base as ttb

    out, res = ranks
    state = str(out / "ring_tb.npz")
    with j_unique_name.guard():
        main, startup, loss = R.build_ring_tb(jfluid, jtb, "ring")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        with np.load(state) as z:
            for n in z.files:
                scope.set_var(n, jnp.asarray(z[n]))
        pe = jfluid.ParallelExecutor(
            main_program=main, loss_name=loss.name,
            mesh=jfluid.parallel.make_mesh({"dp": 2, "sp": 2},
                                           devices=_devices(4)))
        want = [float(np.asarray(pe.run(fetch_list=[loss.name],
                                        feed=R.ring_feed())[0]))
                for _ in range(3)]
    main, startup, loss = R.build_ring_tb(tfluid, ttb, "fused")
    exe, tscope = R._start(tfluid, main, startup, state)
    fused = R._losses(exe, main, loss, [R.ring_feed()] * 3, tscope)
    for rank in res:
        np.testing.assert_allclose(rank["tb"], want, rtol=TB_RTOL)
        np.testing.assert_allclose(rank["tb"], fused, rtol=TB_RTOL)


def test_fallback_without_an_sp_axis():
    """tests/test_ring_attention.py:50: no ``sp`` axis (or one rank of
    it) is the plain attention, the JAX package's ``_plain_attention``."""
    from paddle_tpu.parallel.ring_attention import _plain_attention as jp
    from paddle_tpu_torch.parallel import ring_attention

    q, k, v, kvm = _qkv()
    for axes, causal in (({"dp": 4}, False), ({"dp": 4, "sp": 1}, True)):
        mesh = tfluid.parallel.make_mesh(axes, devices=range(4))
        got = ring_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), mesh, causal=causal,
                             kv_mask=torch.tensor(kvm))
        want = np.asarray(jp(q, k, v, causal, None, kvm))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6)


def test_zigzag_permutations_are_the_jax_packages():
    """The half-blocks each rank takes in the zigzag layout are where the
    JAX package's exchange (its two permutations of the contiguous
    half-blocks) puts them, for rings of 2 to 8 ranks."""
    from paddle_tpu_torch.parallel.ring_attention import _zigzag_halves

    for n in range(2, 9):
        perm0 = [(d, 2 * d if 2 * d < n else 2 * n - 1 - 2 * d)
                 for d in range(n)]
        perm1 = [(d, 2 * d + 1 if 2 * d + 1 < n else 2 * n - 2 - 2 * d)
                 for d in range(n)]
        # rank d holds contiguous halves 2d (slot 0) and 2d + 1 (slot 1)
        held = {j: [] for j in range(n)}
        for d, j in perm0:
            held[j].append(2 * d)
        for d, j in perm1:
            held[j].append(2 * d + 1)
        for j in range(n):
            assert tuple(sorted(held[j])) == _zigzag_halves(n, j)
