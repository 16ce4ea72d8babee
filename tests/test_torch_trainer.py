"""paddle_tpu_torch's Trainer: checkpoints and resume, held to the JAX
package's and to an uninterrupted run of its own.

* **Cross-package state.** The JAX package's Trainer trains
  ``fit_a_line`` (SGD) and a two-layer ``transformer_base`` (the tiny
  ``TB`` widths of tests/_torch_port.py, ``dropout_rate=0.1``, Adam,
  ``bf16_moments`` and ``fuse_optimizer_state``: one flat group with
  bfloat16 moments) over 6 seeded batches. After step 3 its scope is
  saved twice: by the Trainer's ``AsyncCheckpointSaver`` (the elastic
  format, dtypes recorded) and by ``ckpt.save_checkpoint`` from an event
  handler (the dense format: its bfloat16 moments are raw ``'<V2'``
  members). A port Trainer over the same ``train_func`` auto-resumes
  from each and trains steps 3-5, with ``steps_per_loop`` 1 and 3; the
  JAX run's own steps 3-5 are the reference. Held: the losses within
  rtol 1e-5 / atol 1e-6 (fit_a_line: rtol 1e-5), every parameter's
  update since step 3 within 0.02 of the learning rate element by
  element (fit_a_line: rtol 1e-5), the dropout counter equal, and every
  dropout site's mask at the restored counter bit-equal to the JAX
  op's.
* **The other direction, f32.** A port Trainer's dense and elastic
  checkpoints of fit_a_line load in the JAX package
  (``ckpt.load_checkpoint``, and ``ckpt.restore`` into a JAX Trainer's
  program): every member equal, bit for bit.
* **Inside the port.** A Trainer that resumes from a checkpoint taken
  at step 5 trains steps 5-9 bit-equal to an uninterrupted 10-step run
  (losses and every persistable: parameters, the flat group, bfloat16
  moments, beta powers, the dropout counter), with ``steps_per_loop`` 1
  and 5, sync and async saves.
* The ``DataLoader`` pipeline (``chunk`` 1 and 5) trains and resumes
  bit-equal to the classic loop.
* Events, ``test``, ``save_params``/``param_path``, and the refused
  options (``parallel``, ``steplog``).

The ``cuda`` test needs a card and skips here: a checkpoint restored
into a Trainer whose ``run_steps`` graph is already captured is honoured
by the next replay (the executor copies a replaced scope tensor into the
graph's buffer). JAX is imported inside the tests that use it:

    python -m pytest tests/test_torch_trainer.py -m cuda --noconftest -q
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ckpt

torch.set_num_threads(1)

COUNTER = "_dropout_rng_counter"
FEEDS = ["src_word", "src_mask", "trg_word", "trg_mask", "lbl_word"]
TB_FLAGS = {"bf16_moments": True, "fuse_optimizer_state": True}
N_BATCHES, RESUME_AT = 6, 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
UPDATE_TOL = 0.02  # |update_port - update_jax| / lr, element by element


# ------------------------------------------------------------- the models


def _fit_func(pkg):
    def train_func():
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1, act=None)
        return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    return train_func


def _fit_reader(n=N_BATCHES):
    w = np.random.RandomState(0).randn(13, 1).astype(np.float32)

    def reader():
        r = np.random.RandomState(1)
        for _ in range(n):
            xb = r.randn(8, 13).astype(np.float32)
            yb = xb @ w + 0.5
            yield [(xb[i], yb[i]) for i in range(8)]
    return reader


def _tb_func(pkg):
    if pkg is fluid:
        from paddle_tpu_torch.models.transformer import transformer_base
    else:
        from paddle_tpu.models.transformer import transformer_base
    from _torch_port import TB

    def train_func():
        _, avg_cost, _ = transformer_base(**{**TB, "dropout_rate": 0.1},
                                          attn_impl="fused")
        return avg_cost
    return train_func


def _tb_reader(n=N_BATCHES):
    from _torch_port import _feed

    def reader():
        for s in range(n):
            f = _feed(s)
            yield [tuple(f[name][i] for name in FEEDS)
                   for i in range(f["src_word"].shape[0])]
    return reader


MODELS = {
    "fit_a_line": dict(func=_fit_func, reader=_fit_reader,
                       feed_order=["x", "y"], flags={}, lr=0.05,
                       opt=lambda pkg, lr: pkg.optimizer.SGD(
                           learning_rate=lr)),
    "transformer": dict(func=_tb_func, reader=_tb_reader, feed_order=FEEDS,
                        flags=TB_FLAGS, lr=1e-3,
                        opt=lambda pkg, lr: pkg.optimizer.Adam(
                            learning_rate=lr)),
}


def _losses_into(out):
    def handler(e):
        if type(e).__name__ == "EndStepEvent" and e.metrics:
            out[e.step] = float(np.asarray(e.metrics[0]).mean())
    return handler


def _fetch(pkg, name, scope):
    """A host copy of a scope value of either package, bfloat16 as
    float32."""
    v = scope.find_var(name)
    if pkg is fluid:
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()
    a = np.array(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ----------------------------------------------- the JAX package's run


class _JaxRun:
    """One JAX Trainer run of ``model`` over N_BATCHES batches: the async
    elastic checkpoints of its CheckpointConfig (step_interval 3) and a
    dense ``ckpt.save_checkpoint`` of its scope after step 3; its losses
    and, at steps 3 and 6, every persistable."""

    def __init__(self, model, tmp):
        import paddle_tpu as jfluid
        from paddle_tpu import ckpt as jckpt

        from _torch_port import _flags

        m = MODELS[model]
        self.elastic = os.path.join(tmp, model + "_elastic")
        self.dense = os.path.join(tmp, model + "_dense")
        self.losses = {}
        handler = _losses_into(self.losses)

        def on_event(e):
            handler(e)
            if type(e).__name__ == "EndStepEvent" and \
                    e.step == RESUME_AT - 1:
                scope = self.trainer.scope
                state = {n: scope.get(n) for n in scope.local_var_names()}
                jckpt.save_checkpoint(self.dense, state, trainer_args={
                    "epoch_id": 0, "step_id": RESUME_AT})
                self.at_resume = self._persistables()

        with warnings.catch_warnings(), _flags("jax", m["flags"]):
            warnings.filterwarnings("ignore")
            self.trainer = jfluid.Trainer(
                m["func"](jfluid), lambda: m["opt"](jfluid, m["lr"]),
                place=jfluid.CPUPlace(),
                checkpoint_config=jfluid.CheckpointConfig(
                    self.elastic, step_interval=RESUME_AT, async_save=True,
                    max_num_checkpoints=10))
            self.trainer.train(1, event_handler=on_event,
                               reader=m["reader"](),
                               feed_order=m["feed_order"])
        self.final = self._persistables()
        # the elastic serial of step 3 alone, for a resume at step 3
        only = os.path.join(tmp, model + "_elastic_at3")
        shutil.copytree(ckpt.serial_dir(self.elastic, 0),
                        ckpt.serial_dir(only, 0))
        self.elastic_at3 = only

    def _persistables(self):
        import paddle_tpu as jfluid

        prog = self.trainer.train_program
        scope = self.trainer.scope
        return {v.name: _fetch(jfluid, v.name, scope)
                for v in prog.list_vars()
                if v.persistable and scope.has_var(v.name)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("jax_trainer"))
    return {name: _JaxRun(name, tmp) for name in MODELS}


def _port_trainer(model, ckpt_dir, async_save=False, step_interval=None):
    m = MODELS[model]
    from _torch_port import _flags

    with _flags("torch", m["flags"]):
        return fluid.Trainer(
            m["func"](fluid), lambda: m["opt"](fluid, m["lr"]),
            place=fluid.CPUPlace(),
            checkpoint_config=fluid.CheckpointConfig(
                ckpt_dir, step_interval=step_interval or RESUME_AT,
                async_save=async_save, max_num_checkpoints=10))


@pytest.mark.parametrize("steps_per_loop", [1, 3])
@pytest.mark.parametrize("fmt", ["dense", "elastic"])
@pytest.mark.parametrize("model", list(MODELS))
def test_port_resumes_a_jax_checkpoint_and_trains_on_as_jax(
        jax_runs, tmp_path, model, fmt, steps_per_loop):
    run = jax_runs[model]
    m = MODELS[model]
    src = run.dense if fmt == "dense" else run.elastic_at3
    work = str(tmp_path / "ckpt")
    shutil.copytree(src, work)
    trainer = _port_trainer(model, work)
    cfg = trainer.checkpoint_cfg
    assert (cfg.epoch_id, cfg.step_id) == (0, RESUME_AT)
    # the restored state is the JAX package's at step 3, bit for bit
    for name, want in run.at_resume.items():
        np.testing.assert_array_equal(_fetch(fluid, name, trainer.scope),
                                      want, err_msg=name)
    losses = {}
    trainer.train(1, event_handler=_losses_into(losses),
                  reader=m["reader"](), feed_order=m["feed_order"],
                  steps_per_loop=steps_per_loop)
    assert sorted(losses) == list(range(RESUME_AT, N_BATCHES))
    for s in losses:
        np.testing.assert_allclose(losses[s], run.losses[s], **LOSS_TOL,
                                   err_msg="step %d" % s)
    for name, want in run.final.items():
        got = _fetch(fluid, name, trainer.scope)
        if model == "fit_a_line" or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
            continue
        base = run.at_resume[name]
        np.testing.assert_allclose((got - base) / m["lr"],
                                   (want - base) / m["lr"], rtol=0,
                                   atol=UPDATE_TOL, err_msg=name)
    if model == "transformer":
        assert int(trainer.scope.find_var(COUNTER)) == \
            int(run.final[COUNTER])


def test_restored_dropout_masks_are_the_jax_masks(jax_runs, tmp_path):
    """Each dropout site's op, at the counter the port restored from the
    JAX checkpoint, draws the JAX op's mask (on ones), bit for bit."""
    import jax.numpy as jnp

    run = jax_runs["transformer"]
    work = str(tmp_path / "ckpt")
    shutil.copytree(run.dense, work)
    trainer = _port_trainer("transformer", work)
    counter = trainer.scope.find_var(COUNTER)
    assert int(counter) == int(run.at_resume[COUNTER])
    jprog = run.trainer.train_program
    jops = [op for op in jprog.global_block().ops if op.type == "dropout"]
    tops = [op for op in trainer.train_program.global_block().ops
            if op.type == "dropout"]
    assert len(tops) == len(jops) > 0
    ones = np.ones((3, 5, 32), np.float32)
    for jop, top in zip(jops, tops):
        jout, _ = jop.fn(jnp.asarray(ones),
                         jnp.int32(int(run.at_resume[COUNTER])))
        tout, _ = top.fn(torch.tensor(ones), counter)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


# ------------------------------------------- the other direction, f32


@pytest.mark.parametrize("async_save", [False, True])
def test_jax_package_reads_the_ports_f32_checkpoint(tmp_path, async_save):
    import paddle_tpu as jfluid
    from paddle_tpu import ckpt as jckpt

    d = str(tmp_path / "ckpt")
    trainer = _port_trainer("fit_a_line", d, async_save=async_save)
    trainer.train(1, reader=_fit_reader(), feed_order=["x", "y"])
    trainer.stop()
    serial = ckpt.latest_valid_serial(d)
    assert serial is not None and jckpt.is_valid(d, serial)
    state, args = jckpt.load_checkpoint(d)
    assert args == {"epoch_id": 1, "step_id": 0}
    want = {n: _fetch(fluid, n, trainer.scope)
            for n in trainer.scope.local_var_names()}
    assert sorted(state) == sorted(want)
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(state[n]), v, err_msg=n)
    # and through a JAX Trainer's auto-resume (ckpt.restore)
    jt = jfluid.Trainer(_fit_func(jfluid),
                        lambda: jfluid.optimizer.SGD(learning_rate=0.05),
                        place=jfluid.CPUPlace(),
                        checkpoint_config=jfluid.CheckpointConfig(d))
    assert jt.checkpoint_cfg.epoch_id == 1
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(jt.scope.get(n)), v,
                                      err_msg=n)


# ------------------------------------------------ inside the port


def _uninterrupted(model, tmp, steps, async_save):
    m = MODELS[model]
    trainer = _port_trainer(model, os.path.join(tmp, "c"),
                            async_save=async_save, step_interval=5)
    losses = {}
    trainer.train(1, event_handler=_losses_into(losses),
                  reader=m["reader"](steps), feed_order=m["feed_order"],
                  steps_per_loop=5)
    return trainer, losses


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("steps_per_loop", [1, 5])
@pytest.mark.parametrize("model", list(MODELS))
def test_resume_is_bit_equal_to_an_uninterrupted_run(
        tmp_path, model, steps_per_loop, async_save):
    m = MODELS[model]
    tmp = str(tmp_path)
    c, c_losses = _uninterrupted(model, tmp, 10, async_save)
    # A trains steps 0-4 (checkpoint at step 5), B resumes and trains 5-9
    a_dir = os.path.join(tmp, "a")
    a = _port_trainer(model, a_dir, async_save=async_save, step_interval=5)
    a.train(1, reader=m["reader"](5), feed_order=m["feed_order"],
            steps_per_loop=steps_per_loop)
    a.stop()
    # keep the step-5 serial only (the epoch's end saved another)
    for s in ckpt.list_checkpoints(a_dir)[1:]:
        shutil.rmtree(ckpt.serial_dir(a_dir, s))
    b = _port_trainer(model, a_dir, async_save=async_save, step_interval=5)
    assert b.checkpoint_cfg.step_id == 5
    b_losses = {}
    b.train(1, event_handler=_losses_into(b_losses),
            reader=m["reader"](10), feed_order=m["feed_order"],
            steps_per_loop=steps_per_loop)
    b.stop()
    assert sorted(b_losses) == list(range(5, 10))
    assert [b_losses[s] for s in range(5, 10)] == \
        [c_losses[s] for s in range(5, 10)]
    names = sorted(c.scope.local_var_names())
    assert sorted(b.scope.local_var_names()) == names
    for n in names:
        bv, cv = b.scope.find_var(n), c.scope.find_var(n)
        assert bv.dtype == cv.dtype, n
        assert torch.equal(bv, cv), n


@pytest.mark.parametrize("chunk", [1, 5])
def test_dataloader_pipeline_trains_and_resumes_as_the_classic_loop(
        tmp_path, chunk):
    """``train(reader=DataLoader)`` (one ``run`` a batch, or ``chunk``
    batches a ``run_steps`` call) gives the classic loop's losses and
    state bit for bit, and resumes a checkpoint at step 5 by skipping
    the trained batches."""
    from paddle_tpu_torch.reader import DataLoader

    tmp = str(tmp_path)
    c, c_losses = _uninterrupted("fit_a_line", tmp, 10, False)

    def loader(trainer):
        return DataLoader(_fit_reader(10), feed_list=["x", "y"], place=fluid.CPUPlace(),
                          program=trainer.train_program, chunk=chunk)

    p = _port_trainer("fit_a_line", os.path.join(tmp, "p"), step_interval=5)
    p_losses = {}
    p.train(1, event_handler=_losses_into(p_losses), reader=loader(p))
    assert p_losses == c_losses
    for n in c.scope.local_var_names():
        assert torch.equal(p.scope.find_var(n), c.scope.find_var(n)), n
    # resume from the pipeline's own step-5 checkpoint
    d = os.path.join(tmp, "p")
    for s in ckpt.list_checkpoints(d)[1:]:
        shutil.rmtree(ckpt.serial_dir(d, s))
    r = _port_trainer("fit_a_line", d, step_interval=5)
    r_losses = {}
    r.train(1, event_handler=_losses_into(r_losses), reader=loader(r))
    assert r_losses == {s: c_losses[s] for s in range(5, 10)}
    for n in c.scope.local_var_names():
        assert torch.equal(r.scope.find_var(n), c.scope.find_var(n)), n


def test_events_match_the_jax_trainer():
    import paddle_tpu as jfluid

    def record(pkg):
        events = []
        t = pkg.Trainer(_fit_func(pkg),
                        lambda: pkg.optimizer.SGD(learning_rate=0.05),
                        place=pkg.CPUPlace())
        t.train(2, event_handler=lambda e: events.append(
            (type(e).__name__, e.epoch, getattr(e, "step", None))),
            reader=_fit_reader(4), feed_order=["x", "y"])
        return events, t
    jev, _ = record(jfluid)
    tev, t = record(fluid)
    assert tev == jev
    metrics = t.test(reader=_fit_reader(2), feed_order=["x", "y"])
    assert len(metrics) == 1 and np.isfinite(metrics[0])


def test_save_params_and_param_path(tmp_path):
    t = _port_trainer("fit_a_line", str(tmp_path / "ck"))
    t.train(1, reader=_fit_reader(), feed_order=["x", "y"])
    t.save_params(str(tmp_path / "params"))
    t2 = fluid.Trainer(_fit_func(fluid),
                       lambda: fluid.optimizer.SGD(learning_rate=0.05),
                       param_path=str(tmp_path / "params"),
                       place=fluid.CPUPlace())
    for p in t.train_program.all_parameters():
        assert torch.equal(t2.scope.find_var(p.name),
                           t.scope.find_var(p.name)), p.name


@pytest.mark.parametrize("kw,item", [({"parallel": True}, "Queue A 9")])
def test_refused_options_name_their_queue_item(kw, item, tmp_path):
    """``parallel=True``, once refused naming ``item``, is ported: in a
    world of one process the Trainer steps through the
    ParallelExecutor to the plain Trainer's parameters, and the
    Inferencer serves through it. (Ranks: tests/test_torch_parallel.py.)"""
    del item
    trained = []
    for extra in ({}, kw):
        t = fluid.Trainer(_fit_func(fluid),
                          lambda: fluid.optimizer.SGD(learning_rate=0.05),
                          place=fluid.CPUPlace(), **extra)
        assert (t._pe is not None) == bool(extra)
        t.train(num_epochs=1, reader=_fit_reader(3), feed_order=["x", "y"],
                event_handler=lambda e: None)
        trained.append({p.name: fluid.fetch_var(p.name, t.scope)
                        for p in t.train_program.all_parameters()})
    for n in trained[0]:
        np.testing.assert_array_equal(trained[0][n], trained[1][n])
    t.save_params(str(tmp_path))

    def infer_func():
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        return fluid.layers.fc(input=x, size=1, act=None)

    xs = np.random.RandomState(2).randn(4, 13).astype(np.float32)
    got = [fluid.Inferencer(infer_func, str(tmp_path),
                            place=fluid.CPUPlace(), parallel=par)
           .infer({"x": xs})[0] for par in (False, True)]
    np.testing.assert_array_equal(got[0], got[1])


def test_steplog_writes_one_record_per_step(tmp_path):
    """``steplog=`` (once refused) appends one StepStats line a step,
    with the loss the step fetched."""
    from paddle_tpu_torch.obs.steplog import read_steplog

    path = str(tmp_path / "run.jsonl")
    t = fluid.Trainer(_fit_func(fluid),
                      lambda: fluid.optimizer.SGD(learning_rate=0.05),
                      place=fluid.CPUPlace(), steplog=path)
    losses = []

    def handler(e):
        if isinstance(e, fluid.EndStepEvent):
            losses.append(float(np.asarray(e.metrics[0]).reshape(-1)[0]))

    t.train(num_epochs=1, event_handler=handler, reader=_fit_reader(4),
            feed_order=["x", "y"])
    t.stop()
    recs = list(read_steplog(path))
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert [r["loss"] for r in recs] == [round(v, 6) for v in losses]
    assert all(r["fresh_compiles"] == 0 for r in recs)


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_restore_into_a_captured_trainer_is_replayed(tmp_path):
    """A Trainer on the card with its ``run_steps`` graph captured; a
    checkpoint of an earlier step restored into its scope; the next
    group replays from the restored state: its losses and final state
    equal those of the first time those steps ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def train_func():
        L = fluid.layers
        x = L.data(name="x", shape=[13], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(input=x, size=32, act="relu")
        pred = L.fc(input=h, size=1)
        return L.mean(L.square_error_cost(pred, y))

    d = str(tmp_path / "ck")
    place = fluid.CUDAPlace(0)
    t = fluid.Trainer(train_func,
                      lambda: fluid.optimizer.Adam(learning_rate=1e-2),
                      place=place,
                      checkpoint_config=fluid.CheckpointConfig(
                          d, step_interval=5, max_num_checkpoints=10))
    fluid.memory_optimize(t.train_program)
    first = {}
    t.train(1, event_handler=_losses_into(first), reader=_fit_reader(10),
            feed_order=["x", "y"], steps_per_loop=5)
    assert t.exe.num_compiled == 1
    after = {n: t.scope.find_var(n).clone()
             for n in t.scope.local_var_names()}
    # restore the step-5 serial and run steps 5-9 again on the graph
    ckpt.restore(d, program=t.train_program, scope=t.scope, serial=0)
    feeder = t._make_feeder(["x", "y"])
    batches = [feeder.feed(b) for b in list(_fit_reader(10)())[5:]]
    again, = t.exe.run_steps(t.train_program, feed_list=batches,
                             fetch_list=[t.loss], scope=t.scope)
    assert t.exe.num_compiled == 1  # replayed, not captured again
    np.testing.assert_array_equal(again, [first[s] for s in range(5, 10)])
    for n, v in after.items():
        assert torch.equal(t.scope.find_var(n), v), n
