"""Rematerialization in paddle_tpu_torch — ``memory_optimize(level>=1)``,
the ``remat_policy`` pass and the executor's checkpointed forward —
held to itself without remat and to paddle_tpu.

* ``backward.remat_segment_plan`` over the small Transformer-base's
  forward slice, segmented by ``passes.schedule._annotate_segments``,
  equals the JAX package's plan (ids, op types, boundary names);
  ``apply_remat_policy`` picks the JAX package's ``_remat_policy`` and
  stamp for the same program, budget and batches, and the
  ``remat_policy`` pass has the JAX package's fingerprint.
* ``memory_optimize(level=1)`` sets the all-or-nothing flag the JAX
  package sets; ``append_backward`` takes a program whose forward ops
  carry ``_remat_segment``; ``comm_overlap`` raises naming ROADMAP Queue
  A 9 (``host_offload`` is ported: tests/test_torch_host_offload.py).
* The counter trap: Adam steps with dropout 0.1 and donation on
  (``memory_optimize``) at level 0, at level 1 and with segments give
  bit-equal losses, gradients and final state — on the tiny
  Transformer-base, and on bench.py's recipe (sparse embeddings, flat
  optimizer state, bf16) whose lookup outputs and unpacked parameters
  are autograd leaves. The backward pass really recomputes: every
  dropout site runs three times a step at level 1 (forward,
  recompute, backward), twice at level 0, and in between with
  segments.
* A level-1 step leaves no tensor in a reference cycle.
* Against the JAX package's ``memory_optimize(level=1)`` step: losses,
  gradients and updates within tests/test_torch_dropout.py's
  tolerances.

The ``cuda`` test runs BERT at a small width under ``run_steps`` at
level 0 and level 1 on a card: losses and state bit-equal, the flash
forward and dropout kernels relaunched for the recompute, the flash
backward pair and the fused update not. (The peak is compared at
BERT-base's shape by chip_smoke.py's ``remat`` phase: at this width
the activations are a small part of it.) It skips here; on the card
(JAX is imported inside the tests that use it)::

    python -m pytest tests/test_torch_remat.py -m cuda --noconftest -q
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.passes import schedule as t_schedule

torch.set_num_threads(1)

TINY = dict(src_vocab_size=50, trg_vocab_size=50, max_length=16,
            n_layer=2, n_head=2, d_model=32, d_inner_hid=64,
            dropout_rate=0.1)
RECIPE_FLAGS = {"use_bfloat16": True, "bf16_activations": True,
                "bf16_moments": True, "fuse_optimizer_state": True}
COUNTER = "_dropout_rng_counter"
LR = 1e-3


def _feed(seed=0, B=3, T_SRC=9, T_TRG=7):
    rng = np.random.RandomState(seed)
    ids = lambda t: rng.randint(1, 50, (B, t)).astype(np.int64)  # noqa
    src_len = rng.randint(1, T_SRC + 1, B)
    trg_len = rng.randint(1, T_TRG + 1, B)
    return {"src_word": ids(T_SRC), "trg_word": ids(T_TRG),
            "lbl_word": ids(T_TRG),
            "src_mask": (np.arange(T_SRC)[None] < src_len[:, None]
                         ).astype(np.float32),
            "trg_mask": (np.arange(T_TRG)[None] < trg_len[:, None]
                         ).astype(np.float32)}


def _program(pkg, flags=None, **model):
    """(main, startup, avg_cost, params_grads) of the tiny
    Transformer-base + Adam in one package, built under ``flags``."""
    if pkg == "jax":
        import paddle_tpu as fluid
        from paddle_tpu.core import flags as reg
        from paddle_tpu.core import unique_name
        from paddle_tpu.models.transformer import transformer_base
    else:
        fluid = reg = tfluid
        unique_name = tfluid.unique_name
        from paddle_tpu_torch.models.transformer import transformer_base
    flags = flags or {}
    saved = {n: reg.get_flag(n) for n in flags}
    reg.set_flags(flags)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with warnings.catch_warnings(), unique_name.guard(), \
                fluid.program_guard(main, startup):
            warnings.filterwarnings("ignore", message="flash_attention")
            _, cost, _ = transformer_base(**dict(TINY, **model),
                                          attn_impl="pallas")
            _, pg = fluid.optimizer.Adam(learning_rate=LR).minimize(cost)
    finally:
        reg.set_flags(saved)
    return main, startup, cost, pg


def _fwd_slice(program):
    import importlib

    bw = next(op for op in program.global_block().ops
              if op.type == "backward")
    pkg = type(program).__module__.split(".")[0]
    backward = importlib.import_module(pkg + ".backward")
    return backward._forward_slice(program, bw.attrs["loss"])[0], \
        bw.attrs["loss"], backward


def _segment(program, policy):
    """Annotate the forward slice in segments and choose ``policy``."""
    fwd, _, _ = _fwd_slice(program)
    t_schedule._annotate_segments(fwd)
    program._remat_policy = tuple(policy)
    program._bump()


# ---------------------------------------------------------------- planning


def test_segment_plan_equals_the_jax_package():
    from paddle_tpu.passes import schedule as j_schedule

    plans = {}
    for pkg, sched in (("jax", j_schedule), ("torch", t_schedule)):
        main = _program(pkg)[0]
        fwd, loss, backward = _fwd_slice(main)
        assert sched._annotate_segments(fwd, max_segments=3) == 3
        plans[pkg] = [(sid, [op.type for op in ops], needed, keep)
                      for sid, ops, needed, keep
                      in backward.remat_segment_plan(fwd, loss)]
    assert plans["torch"] == plans["jax"]
    assert [p[0] for p in plans["torch"]] == [0, 1, 2]


@pytest.mark.parametrize("assume,target,segments", [
    (3, 6, 4), (3, 12, 4), (3, 6, 2), (4, 4, 4)])
def test_remat_policy_picks_the_jax_segments(assume, target, segments):
    from paddle_tpu.passes import schedule as j_schedule

    out = {}
    for pkg, sched in (("jax", j_schedule), ("torch", t_schedule)):
        main = _program(pkg)[0]
        changed = sched.apply_remat_policy(
            main, target_batch=target, assume_batch=assume,
            max_segments=segments)
        out[pkg] = (changed, getattr(main, "_remat_policy", None),
                    getattr(main, "_schedule_stamp", None),
                    [op.attrs.get("_remat_segment")
                     for op in main.global_block().ops])
    assert out["torch"] == out["jax"]
    if target > assume:
        assert out["torch"][0] and out["torch"][1]


def test_remat_policy_pass_and_its_refused_siblings():
    from paddle_tpu.passes import schedule as j_schedule

    kw = dict(target_batch=32, assume_batch=16, max_segments=4)
    assert t_schedule.RematPolicyPass(**kw).fingerprint() == \
        j_schedule.RematPolicyPass(**kw).fingerprint()
    p = tfluid.passes.get_pass("remat_policy")
    assert isinstance(p, t_schedule.RematPolicyPass)
    main = _program("torch")[0]
    out = tfluid.passes.PassManager(
        [t_schedule.RematPolicyPass(assume_batch=3, target_batch=6)]
    ).apply(main)
    assert out._remat_policy and "remat_policy=" in out._schedule_stamp
    # comm_overlap, once refused naming Queue A 9, is ported: the JAX
    # package's fingerprint, and a planless program comes back untouched
    # (tests/test_torch_comm.py runs it on sharded programs)
    p = tfluid.passes.get_pass("comm_overlap")
    assert isinstance(p, t_schedule.CommOverlapPass)
    assert p.fingerprint() == j_schedule.CommOverlapPass().fingerprint()
    v0 = main._version
    assert p.apply(main) is main and main._version == v0
    # host_offload, once refused naming Queue A 8, is ported
    assert isinstance(tfluid.passes.get_pass("host_offload"),
                      t_schedule.HostOffloadPass)


def test_level1_sets_the_flag_and_segmented_programs_take_a_backward():
    main = _program("torch")[0]
    v = main._version
    tfluid.memory_optimize(main, level=1)
    assert main._memory_optimize is True
    assert main._memory_optimize_remat is True and main._version > v
    tfluid.memory_optimize(main, level=0)
    assert main._memory_optimize_remat is False

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        h = tfluid.layers.fc(input=x, size=8, act="relu")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=h, size=1))
        for i, op in enumerate(main.global_block().ops):
            op.attrs["_remat_segment"] = i // 3
        _, pg = tfluid.SGD(learning_rate=0.1).minimize(loss)
    assert len(pg) == 4


# ---------------------------------------------------------- bit equality


def _steps(mode, flags=None, steps=2, sparse=False, count=None):
    """``steps`` Adam steps of the tiny Transformer-base with dropout
    under ``memory_optimize`` and ``mode`` (``"level0"``, ``"level1"``
    or a segment policy): (per-step fetches [loss, grads...], final
    state)."""
    main, startup, cost, pg = _program("torch", flags,
                                       sparse_embedding=sparse)
    tfluid.memory_optimize(main, level=1 if mode == "level1" else 0)
    if mode not in ("level0", "level1"):
        _segment(main, mode)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    fetch = [cost.name] + [g.name for _, g in pg]
    outs = []
    for _ in range(steps):
        if count is not None:
            count.clear()
        outs.append(exe.run(main, feed=_feed(), fetch_list=fetch,
                            scope=scope))
    state = {n: tfluid.fetch_var(n, scope) for n in scope.local_var_names()}
    return outs, state, main


@pytest.fixture
def dropout_calls(monkeypatch):
    """The dropout sites' plain-version calls of the last step."""
    from paddle_tpu_torch.ops import dropout as dr

    calls = []
    plain = dr.plain_dropout

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(dr, "plain_dropout", counted)
    return calls


@pytest.mark.parametrize("config", ["f32", "recipe"])
@pytest.mark.parametrize("mode", ["level1", (1, 3), (0, 2)],
                         ids=["level1", "seg13", "seg02"])
def test_remat_steps_are_bit_equal_to_no_remat(config, mode,
                                               dropout_calls):
    kw = dict(flags=RECIPE_FLAGS, sparse=True) if config == "recipe" \
        else {}
    ref_out, ref_state, main = _steps("level0", count=dropout_calls, **kw)
    sites = sum(op.type == "dropout" for op in main.global_block().ops)
    assert len(dropout_calls) == 2 * sites  # forward and backward
    out, state, main = _steps(mode, count=dropout_calls, **kw)
    for r, o in zip(ref_out, out):
        for a, b in zip(r, o):
            assert np.array_equal(a, b, equal_nan=True)
    assert sorted(state) == sorted(ref_state)
    for n in ref_state:
        assert np.array_equal(state[n], ref_state[n], equal_nan=True), n
    assert int(state[COUNTER]) == 2 * sites
    recomputed = len(dropout_calls) - 2 * sites
    if mode == "level1":
        assert recomputed == sites
    else:
        fwd, _, _ = _fwd_slice(main)
        chosen = sum(op.type == "dropout"
                     and op.attrs["_remat_segment"] in mode for op in fwd)
        assert 0 < chosen < sites and recomputed == chosen


def _live_bytes():
    import gc

    from torch._subclasses.fake_tensor import FakeTensor

    seen = {}
    for o in gc.get_objects():
        # a fake tensor (the metadata of an exported graph another test
        # left for the collector) holds no host bytes
        if torch.is_tensor(o) and o.device.type == "cpu" \
                and not isinstance(o, FakeTensor):
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


@pytest.mark.parametrize("mode", ["level1", (0, 1, 2, 3, 4)],
                         ids=["level1", "all_segments"])
def test_remat_forward_holds_less_than_no_remat(mode):
    """The host bytes of live tensors when the loss is computed: under
    remat a checkpointed region keeps only what it returns (its saved
    tensors are recomputed later), so the forward holds far less than
    without remat, whose environment keeps every activation."""
    held = {}
    for m in ("level0", mode):
        main, startup, cost, _ = _program("torch", d_model=64,
                                          d_inner_hid=256)
        tfluid.memory_optimize(main, level=1 if m == "level1" else 0)
        if m not in ("level0", "level1"):
            _segment(main, m)
        op = next(o for o in main.global_block().ops
                  if cost.name in o.output_arg_names)
        fn, seen = op.fn, []

        def probe(*args, _fn=fn, _seen=seen, **kw):
            if args and args[0].device.type == "cpu" and not _seen:
                _seen.append(_live_bytes())
            return _fn(*args, **kw)

        op.fn = probe
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feed(B=8, T_SRC=16, T_TRG=16),
                fetch_list=[cost], scope=scope)
        held[m] = seen[0]
    assert held[mode] < 0.6 * held["level0"], held


def test_a_remat_step_leaves_no_reference_cycle():
    """A recomputed region's tensors go when the step ends, not when the
    cyclic collector runs (a stopped recompute's traceback would hold
    them: the executor turns checkpoint's early stop off)."""
    import gc

    main, startup, cost, _ = _program("torch")
    tfluid.memory_optimize(main, level=1)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)

    def tensors():
        return sum(torch.is_tensor(o) for o in gc.get_objects())

    gc.collect()
    gc.disable()
    try:
        before = tensors()
        for _ in range(2):
            exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
        assert tensors() == before
    finally:
        gc.enable()


def test_remat_step_matches_the_jax_remat_step():
    """One JAX ``memory_optimize(level=1)`` program and the port's, from
    the JAX start state: 3 steps' losses, the gradients and the
    updates within tests/test_torch_dropout.py's tolerances."""
    import paddle_tpu as jfluid

    from _torch_port import GRAD_TOL, UPDATE_TOL

    j_main, j_startup, j_cost, j_pg = _program("jax")
    t_main, t_startup, t_cost, t_pg = _program("torch")
    jfluid.memory_optimize(j_main, level=1)
    tfluid.memory_optimize(t_main, level=1)
    feed, steps = _feed(), 3
    j_scope = jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(j_startup)
        p0 = {p.name: np.asarray(j_scope.find_var(p.name))
              for p in j_main.all_parameters()}
        fetch = [j_cost.name] + [g.name for _, g in j_pg]
        j_out = [exe.run(j_main, feed=feed, fetch_list=fetch)
                 for _ in range(steps)]
    t_scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t_startup, scope=t_scope)
    tfluid.params_from_numpy(p0, t_scope, tfluid.CPUPlace(),
                             program=t_main)
    fetch = [t_cost.name] + [g.name for _, g in t_pg]
    t_out = [exe.run(t_main, feed=feed, fetch_list=fetch, scope=t_scope)
             for _ in range(steps)]
    for j_o, t_o in zip(j_out, t_out):
        np.testing.assert_allclose(t_o[0], j_o[0], **GRAD_TOL)
    for name, t_g, j_g in zip(fetch[1:], t_out[0][1:], j_out[0][1:]):
        np.testing.assert_allclose(t_g, j_g, err_msg=name, **GRAD_TOL)
    for name, v0 in p0.items():
        j_up = (np.asarray(j_scope.find_var(name)) - v0) / LR
        t_up = (tfluid.fetch_var(name, t_scope) - v0) / LR
        np.testing.assert_allclose(t_up, j_up, rtol=0, atol=UPDATE_TOL,
                                   err_msg=name)
    assert int(tfluid.fetch_var(COUNTER, t_scope)) == \
        int(np.asarray(j_scope.find_var(COUNTER)))


# ---------------------------------------------------------------- card

BERT = dict(vocab_size=128, n_layer=2, n_head=2, d_model=128, d_inner=256,
            max_pos=64, max_predictions=8)


@pytest.mark.cuda
def test_cuda_remat_run_steps_bit_equal_and_relaunched():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.models.bert import bert_pretrain
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import dropout as dr
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    from paddle_tpu_torch.ops import fused_optimizer as fo

    B, T, P, steps = 8, 64, BERT["max_predictions"], 4
    rng = np.random.RandomState(0)
    feed = {"src_ids": rng.randint(1, 128, (B, T)).astype(np.int64),
            "sent_ids": np.zeros((B, T), np.int64),
            "pos_ids": np.tile(np.arange(T, dtype=np.int64), (B, 1)),
            "input_mask": np.ones((B, T), np.float32),
            "mask_pos": rng.randint(0, T, (B, P)).astype(np.int64),
            "mask_label": rng.randint(1, 128, (B, P)).astype(np.int64),
            "mask_weight": np.ones((B, P), np.float32),
            "ns_label": rng.randint(0, 2, (B, 1)).astype(np.int64)}
    runs = {}
    for level in (0, 1):
        saved = {n: tfluid.get_flag(n) for n in RECIPE_FLAGS}
        tfluid.set_flags(RECIPE_FLAGS)
        try:
            main, startup = tfluid.Program(), tfluid.Program()
            with tfluid.unique_name.guard(), \
                    tfluid.program_guard(main, startup):
                _, total, _ = bert_pretrain(**BERT, dropout=0.1,
                                            attn_impl="pallas")
                tfluid.optimizer.Adam(learning_rate=LR).minimize(total)
        finally:
            tfluid.set_flags(saved)
        tfluid.memory_optimize(main, level=level)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        for fn in _cuda.LAUNCHERS:
            for name in getattr(fn, "counts", ("launches",)):
                setattr(fn, name, 0)
        # the eager first step, the capture, steps - 1 replays
        losses, = exe.run_steps(main, feed=feed, steps=steps,
                                fetch_list=[total], scope=scope)
        torch.cuda.synchronize()
        runs[level] = dict(
            losses=losses,
            state={n: tfluid.fetch_var(n, scope)
                   for n in scope.local_var_names()},
            launches=(fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
                      fa.flash_bwd_dkv.launches, dr.dropout_apply.launches,
                      fo.fused_flat_update.launches))
        sites = sum(op.type == "dropout" for op in main.global_block().ops)
        exe.close()
        del exe, scope
    assert np.array_equal(runs[1]["losses"], runs[0]["losses"])
    for n, v in runs[0]["state"].items():
        assert np.array_equal(runs[1]["state"][n], v, equal_nan=True), n
    L = BERT["n_layer"]
    assert runs[0]["launches"] == (L * steps, L * steps, L * steps,
                                   2 * sites * steps, steps)
    assert runs[1]["launches"] == (2 * L * steps, L * steps, L * steps,
                                   3 * sites * steps, steps)
