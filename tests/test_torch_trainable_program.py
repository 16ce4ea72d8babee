"""paddle_tpu_torch's durable training-program artifact
(``io.save_trainable_program`` / ``load_trainable_program``), held to
its own continuous training and to paddle_tpu's artifact on the CPU
(mirrors tests/test_trainable_program.py).

The JAX package initializes the MLP of that test and its parameters are
carried into the port. Three steps run through ``Executor.run``, the
whole step is exported with the state, and the reloaded
``TrainableProgram`` continues:

* in process, and in a fresh interpreter (``subprocess``: it imports
  the port alone, no program code): the losses equal the port's
  continuous ``Executor`` losses bit for bit;
* the JAX package's own artifact, continued from the same state, gives
  losses within PR 12's rtol 1e-5 / atol 1e-6 of the port's;
* ``run_steps(feed, steps)`` equals ``steps`` calls of ``run``, losses
  and state bit for bit; ``save_state`` round-trips; a program that
  recomputes its forward (``memory_optimize(level=1)``) is refused;
* a two-layer Transformer with dropout 0.1, sparse embeddings, the
  flash kernels' plain versions and flat bf16 Adam carries its dropout
  counter as state: continued from its artifact it equals the
  continuous run bit for bit, losses and every state tensor.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name

from _torch_port import TB, _feed, _flags

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"x": (16, 8), "y": (16, 1)}
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(pkg, seed=11):
    guard = (j_unique_name.guard if pkg is jfluid
             else tfluid.unique_name.guard)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = seed
    with guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _batches(n):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        x = rng.rand(16, 8).astype("f")
        out.append({"x": x, "y": (x.sum(1, keepdims=True) * 0.3)
                    .astype("f")})
    return out


@pytest.fixture(scope="module")
def start():
    """The JAX package's initialized state (name -> array)."""
    main, startup, _ = _build(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _port(start):
    main, startup, loss = _build(tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    tfluid.state_from_numpy(start, scope, CPU, program=main)
    return main, scope, exe, loss


def _losses(exe, main, scope, loss, batches):
    return [float(exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0])
            for b in batches]


def _saved(start, tmp_path, name="art"):
    """(artifact dir, the 6 continuous losses): three steps through the
    Executor, the artifact written after them."""
    batches = _batches(6)
    main, scope, exe, loss = _port(start)
    continuous = _losses(exe, main, scope, loss, batches)
    main, scope, exe, loss = _port(start)
    pre = _losses(exe, main, scope, loss, batches[:3])
    assert pre == continuous[:3]
    d = str(tmp_path / name)
    assert tfluid.io.save_trainable_program(
        d, SHAPES, [loss], exe, main_program=main, scope=scope) == \
        [loss.name]
    return d, continuous


def test_save_load_continue_in_process(start, tmp_path):
    d, continuous = _saved(start, tmp_path)
    manifest = json.load(open(os.path.join(d, "__train__.json")))
    assert manifest["feed_names"] == ["x", "y"]
    assert manifest["train_feed_shapes"] == {"x": [16, 8], "y": [16, 1]}
    assert manifest["torch_export"] == "__train_step__.pt2"
    loaded = tfluid.io.load_trainable_program(d, place=CPU)
    post = [float(loaded.run(b)[0]) for b in _batches(6)[3:]]
    assert post == continuous[3:]

    # state round-trips through save_state
    loaded.save_state(d)
    again = tfluid.io.load_trainable_program(d, place=CPU)
    for n, t in loaded.state_dict().items():
        assert torch.equal(again.state_dict()[n], t), n

    # a step that recomputes its forward is refused, naming its item
    main, scope, exe, loss = _port(start)
    tfluid.memory_optimize(main, level=1)
    with pytest.raises(NotImplementedError, match="Queue A 6"):
        tfluid.io.save_trainable_program(str(tmp_path / "remat"), SHAPES,
                                         [loss], exe, main_program=main,
                                         scope=scope)


def test_port_artifact_matches_the_jax_artifact(start, tmp_path):
    """The JAX package's trainable artifact, written from the same state
    after the same three steps, continues to the port's losses."""
    d, continuous = _saved(start, tmp_path)
    main, startup, loss = _build(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for n, a in start.items():
            scope.set_var(n, a)
        for b in _batches(3):
            exe.run(main, feed=b, fetch_list=[loss.name])
        jfluid.io.save_trainable_program(
            str(tmp_path / "jax"), feed_shapes=SHAPES, fetch_list=[loss],
            executor=exe, main_program=main, scope=scope)
    jloaded = jfluid.io.load_trainable_program(str(tmp_path / "jax"))
    jpost = [float(jloaded.run(b)[0]) for b in _batches(6)[3:]]
    np.testing.assert_allclose(jpost, continuous[3:], **TOL)
    # a JAX-written directory is no port artifact
    with pytest.raises(tfluid.EnforceError, match="torch_export"):
        tfluid.io.load_trainable_program(str(tmp_path / "jax"), place=CPU)


_WORKER = """
import json, sys
import numpy as np
import paddle_tpu_torch as fluid

d, out_path = sys.argv[1], sys.argv[2]
assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
loaded = fluid.io.load_trainable_program(d, place=fluid.CPUPlace())
rng = np.random.RandomState(1)
batches = []
for _ in range(6):
    x = rng.rand(16, 8).astype("f")
    batches.append({"x": x, "y": (x.sum(1, keepdims=True) * 0.3).astype("f")})
with open(out_path, "w") as fh:
    json.dump([float(loaded.run(b)[0]) for b in batches[3:]], fh)
"""


def test_save_load_continue_in_a_new_process(start, tmp_path):
    d, continuous = _saved(start, tmp_path)
    script = str(tmp_path / "loader.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    out_path = str(tmp_path / "losses.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    r = subprocess.run([sys.executable, script, d, out_path], env=env,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-3000:]
    with open(out_path) as f:
        assert json.load(f) == continuous[3:]


def test_run_steps_equals_run_times_steps(start, tmp_path):
    d, continuous = _saved(start, tmp_path)
    a = tfluid.io.load_trainable_program(d, place=CPU)
    b = tfluid.io.load_trainable_program(d, place=CPU)
    batches = _batches(6)[3:]
    by_run = [float(a.run(x)[0]) for x in batches]
    stacked = {n: np.stack([x[n] for x in batches]) for n in SHAPES}
    losses, = b.run_steps(stacked, steps=3)
    assert losses.shape == (3,)
    assert [float(v) for v in losses] == by_run == continuous[3:]
    for n, t in a.state_dict().items():
        assert torch.equal(b.state_dict()[n], t), n
    with pytest.raises(tfluid.EnforceError, match="shape"):
        b.run_steps(stacked, steps=2)


def test_dropout_transformer_carries_its_counter(tmp_path):
    """Dropout 0.1, sparse embeddings, ``attn_impl="pallas"`` (the flash
    ops' plain versions on the CPU) and one flat Adam group with bf16
    moments: the artifact written after one step continues bit for bit,
    the dropout counter among its state."""
    from paddle_tpu_torch.models.transformer import transformer_base

    flags = {"use_bfloat16": True, "bf16_activations": True,
             "bf16_moments": True, "fuse_optimizer_state": True}
    with _flags("torch", flags):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            _, cost, _ = transformer_base(**{**TB, "dropout_rate": 0.1},
                                          attn_impl="pallas",
                                          sparse_embedding=True)
            tfluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    feeds = [_feed(i) for i in range(4)]
    runs = {}
    for mode in ("continuous", "artifact"):
        scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
        exe.run(startup, scope=scope)
        losses = _losses(exe, main, scope, cost, feeds[:1])
        if mode == "artifact":
            d = str(tmp_path / "tb")
            tfluid.io.save_trainable_program(
                d, {n: v.shape for n, v in feeds[0].items()}, [cost], exe,
                main_program=main, scope=scope)
            prog = tfluid.io.load_trainable_program(d, place=CPU)
            losses += [float(prog.run(f)[0]) for f in feeds[1:]]
            state = prog.state_dict()
        else:
            losses += _losses(exe, main, scope, cost, feeds[1:])
            state = {n: scope.get(n) for n in scope.local_var_names()}
        runs[mode] = losses, state
    (want, ref), (got, state) = runs["continuous"], runs["artifact"]
    assert got == want
    counter = next(n for n in state if "dropout" in n and "counter" in n)
    assert int(state[counter]) == int(ref[counter]) > 0
    for n, t in state.items():
        assert torch.equal(t, ref[n]), n
