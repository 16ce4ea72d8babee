"""paddle_tpu_torch's ``memory_optimize`` and state donation, ported from
tests/test_memory_optimize.py (level 0 and the donation opt-out).

* Level 0 marks the program for in-place state updates and bumps its
  version; training with it gives the losses of training without it,
  bit for bit (the port runs the same ops either way).
* Level >= 1 (remat of the backward's forward slice) trains to level
  0's losses bit for bit, and ``print_log`` prints the liveness report;
  ``release_memory`` is the JAX package's no-op.
* ``donate_state_buffers=False``: a state tensor obtained before a step
  keeps its values after it — the JAX package's copy-out contract — on
  a sparse table, which the port updates in place (so the check has
  teeth: with donation on, the same tensor is the updated one), and
  ``memory_optimize`` turns donation back on for its program. The
  ``cuda`` test checks the same through ``run_steps``' captured graph:

    python -m pytest tests/test_torch_memory_optimize.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.executor import _resolve_donation
from paddle_tpu_torch.memory_optimization_transpiler import \
    memory_optimize as shim_memory_optimize
from paddle_tpu_torch.passes import transforms

torch.set_num_threads(1)

CPU = fluid.CPUPlace()


def _mlp():
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(input=x, size=16, act="relu")
        d = L.elementwise_add(L.fc(input=h, size=1), L.scale(y, scale=-1.0))
        loss = L.scale(L.reduce_sum(L.elementwise_mul(d, d)),
                       scale=1.0 / 16)
        fluid.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _train(mem_opt, steps=10, level=0):
    main, startup, loss = _mlp()
    if mem_opt:
        fluid.memory_optimize(main, level=level)
        assert fluid.release_memory(main) is None
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        xb = rng.rand(16, 8).astype("float32")
        yb = xb.sum(1, keepdims=True).astype("float32")
        (l,) = exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                       scope=scope)
        losses.append(float(l))
    return losses


def test_memory_optimize_level0_preserves_numerics():
    base = _train(mem_opt=False)
    opt = _train(mem_opt=True)
    assert opt == base
    assert opt[-1] < opt[0]


def test_level0_marks_the_program_and_bumps_its_version():
    main, _, _ = _mlp()
    v = main._version
    assert getattr(main, "_memory_optimize", None) is None
    fluid.memory_optimize(main)
    assert main._memory_optimize is True and main._version == v + 1
    assert fluid.memory_optimize is transforms.memory_optimize
    assert shim_memory_optimize is transforms.memory_optimize


@pytest.mark.parametrize("kwargs,what", [
    ({"level": 1}, "remat"), ({"level": 2}, "remat"),
    ({"print_log": True}, "liveness")])
def test_level1_and_print_log_are_not_ported(kwargs, what, capsys):
    """Once refused (ROADMAP Queue A 8), both are ported: level >= 1 is
    donation plus the all-or-nothing remat flag, and trains to the
    losses of level 0 bit for bit; ``print_log`` prints the liveness
    report of ``analysis.analyze_liveness``."""
    main, _, _ = _mlp()
    v = main._version
    fluid.memory_optimize(main, **kwargs)
    assert main._memory_optimize is True and main._version > v
    remat = kwargs.get("level", 0) >= 1
    assert main._memory_optimize_remat is remat
    out = capsys.readouterr().out
    if what == "liveness":
        report = fluid.analysis.analyze_liveness(main)
        assert out == ("memory_optimize: buffer donation on; remat off\n"
                       + report.render() + "\n")
        assert "peak-HBM report" in out and "span=" in out
    else:
        assert out == ""
        assert _train(mem_opt=False) == _train(mem_opt=True,
                                               level=kwargs["level"])


def _sparse_program():
    """A sparse table feeding an fc head, Adam: the table and its
    moments update in place on the CPU too."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("ids", [4, 3], dtype="int64", append_batch_size=False)
        e = L.embedding(ids, [20, 6], is_sparse=True,
                        param_attr=fluid.ParamAttr(name="emb"))
        h = L.fc(e, 2, num_flatten_dims=2)
        loss = L.reduce_sum(L.elementwise_mul(h, h))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _ids(seed=0):
    return {"ids": np.random.RandomState(seed).randint(0, 20, (4, 3))}


def _flagged(value):
    saved = fluid.get_flag("donate_state_buffers")
    fluid.set_flags({"donate_state_buffers": value})
    return saved


def test_donation_flag_opt_out_keeps_the_old_tensor():
    """donate_state_buffers=False: the table (and a moment) obtained
    before a step keep their values; the scope holds the new ones."""
    saved = _flagged(False)
    try:
        main, startup, loss = _sparse_program()
        assert _resolve_donation(main) is False
        scope = fluid.Scope()
        exe = fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        moment = next(n for n in scope.local_var_names()
                      if n.startswith("emb_moment1"))
        w_before = fluid.fetch_var("emb", scope, return_numpy=False)
        m_before = fluid.fetch_var(moment, scope, return_numpy=False)
        w0, m0 = w_before.clone(), m_before.clone()
        exe.run(main, feed=_ids(), fetch_list=[loss], scope=scope)
        np.testing.assert_array_equal(w_before.numpy(), w0.numpy())
        np.testing.assert_array_equal(m_before.numpy(), m0.numpy())
        w_after = fluid.fetch_var("emb", scope, return_numpy=False)
        assert w_after is not w_before
        assert not torch.equal(w_after, w0)
    finally:
        fluid.set_flags({"donate_state_buffers": saved})


def test_donation_on_updates_in_place_and_memory_optimize_forces_it():
    """The default (and memory_optimize, whatever the flag says): the
    step updates the scope's table in place, so the tensor obtained
    before it is the updated one; the losses are those of the opt-out
    run."""
    results = {}
    for label, flag, mem_opt in (("default", True, False),
                                 ("forced", False, True),
                                 ("off", False, False)):
        saved = _flagged(flag)
        try:
            main, startup, loss = _sparse_program()
            if mem_opt:
                fluid.memory_optimize(main)
            scope = fluid.Scope()
            exe = fluid.Executor(CPU)
            exe.run(startup, scope=scope)
            fluid.params_from_numpy(
                {p.name: np.random.RandomState(3).randn(*p.shape)
                 .astype(np.float32) for p in main.all_parameters()},
                scope, CPU, program=main)
            w_before = fluid.fetch_var("emb", scope, return_numpy=False)
            w0 = w_before.clone()
            losses = [float(exe.run(main, feed=_ids(s), fetch_list=[loss],
                                    scope=scope)[0]) for s in range(3)]
            results[label] = (losses, fluid.fetch_var("emb", scope))
            in_place = fluid.fetch_var("emb", scope, return_numpy=False) \
                is w_before
            assert in_place == (label != "off"), label
            assert torch.equal(w_before, w0) == (label == "off"), label
        finally:
            fluid.set_flags({"donate_state_buffers": saved})
    for label in ("forced", "off"):
        assert results[label][0] == results["default"][0], label
        np.testing.assert_array_equal(results[label][1],
                                      results["default"][1])


def test_run_steps_honors_the_opt_out():
    saved = _flagged(False)
    try:
        main, startup, loss = _sparse_program()
        scope = fluid.Scope()
        exe = fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        w_before = fluid.fetch_var("emb", scope, return_numpy=False)
        w0 = w_before.clone()
        exe.run_steps(main, feed_list=[_ids(s) for s in range(3)],
                      fetch_list=[loss], scope=scope)
        assert torch.equal(w_before, w0)
        assert not torch.equal(fluid.fetch_var("emb", scope,
                                               return_numpy=False), w0)
    finally:
        fluid.set_flags({"donate_state_buffers": saved})


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [True, False])
def test_cuda_graph_donation(donate):
    """Through run_steps' graph: donation on, the scope keeps the same
    table tensor across calls, updated in place; off, a table tensor
    obtained before a call keeps its values and the scope gets a new
    one. Both give the same losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run_steps captures a CUDA graph")
    place = fluid.CUDAPlace(0)
    saved = _flagged(donate)
    try:
        main, startup, loss = _sparse_program()
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(
            {p.name: np.random.RandomState(3).randn(*p.shape)
             .astype(np.float32) for p in main.all_parameters()},
            scope, place, program=main)
        feeds = [_ids(s) for s in range(3)]
        exe.run_steps(main, feed_list=feeds, fetch_list=[loss], scope=scope)
        w_before = fluid.fetch_var("emb", scope, return_numpy=False)
        w0 = w_before.clone()
        got, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                             scope=scope)
        torch.cuda.synchronize()
        w_after = fluid.fetch_var("emb", scope, return_numpy=False)
        assert exe.num_compiled == 1
        assert (w_after.data_ptr() == w_before.data_ptr()) == donate
        assert torch.equal(w_before, w0) == (not donate)
        assert not torch.equal(w_after, w0)
        assert np.isfinite(got).all()
    finally:
        fluid.set_flags({"donate_state_buffers": saved})
