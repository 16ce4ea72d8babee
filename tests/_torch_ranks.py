"""Ranks for the port's multi-process tests: the model functions both
packages share (each takes the package, ``paddle_tpu`` or
``paddle_tpu_torch``), the scenarios a world of gloo ranks on the CPU
runs, and :func:`launch`, which starts the world.

A scenario runs on every rank of the world and returns a JSON-able
dict; each rank writes ``<out>/<scenario>.<rank>.json``. Inputs (start
states, feeds) come from the test as ``.npz`` files under the same
directory. Run as ``python tests/_torch_ranks.py <rank> <world>
<store file> <out dir> <scenario>[,<scenario>...]``. This module imports
no JAX: the ranks load only the port.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# ---------------------------------------------------------------- models

def _guard(fluid):
    return fluid.unique_name.guard()


def build_mlp(fluid, mesh=None, rules=None, use_amp=False, seed=5,
              shard=None):
    """tests/test_sharding.py's MLP: (main, startup, loss). ``shard``
    (a callable taking the program) replaces ``shard_program`` — the
    ranks pass the mesh of their world."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with _guard(fluid), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, 16], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.data(name="y", shape=[-1, 1], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.fc(x, size=32, act="relu")
        h = fluid.layers.fc(h, size=32, act="relu")
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if shard is not None:
            shard(main)
        elif mesh is not None:
            fluid.sharding.shard_program(main, mesh, rules=rules)
        opt = fluid.optimizer.Adam(learning_rate=0.01)
        if use_amp:
            opt = fluid.amp.decorate(opt, init_loss_scaling=256.0)
        opt.minimize(loss)
    return main, startup, loss


def mlp_feeds(steps, batch=8, seed=3):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(batch, 16).astype("float32"),
             "y": rng.rand(batch, 1).astype("float32")}
            for _ in range(steps)]


def build_pe_mlp(fluid, opt="sgd", seed=7, dropout=0.0):
    """tests/test_parallel_executor.py's MLP (SGD 0.1, or Momentum)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with _guard(fluid), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if opt == "sgd":
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        else:
            fluid.optimizer.Momentum(learning_rate=0.1,
                                     momentum=0.9).minimize(loss)
    return main, startup, loss


def pe_data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 16).astype("float32")
    return {"x": x, "y": (x.sum(1, keepdims=True) * 0.5).astype("float32")}


SPARSE_IDS = np.array([[1, 3, 3, 7], [7, 2, 1, 1], [5, 5, 0, 9],
                       [9, 8, 7, 6], [0, 1, 2, 3], [4, 5, 6, 7],
                       [8, 9, 10, 11], [3, 3, 3, 3]], dtype="int64")


def build_sparse(fluid):
    """tests/test_sparse_grad_parallel.py's lookup model (lazy Adam)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 13
    with _guard(fluid), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[-1, 4], dtype="int64",
                                append_batch_size=False)
        emb = fluid.layers.embedding(
            ids, size=[40, 8], is_sparse=True,
            param_attr=fluid.ParamAttr(name="ptable"))
        red = fluid.layers.reduce_mean(emb, dim=1)
        out = fluid.layers.fc(input=red, size=3,
                              param_attr=fluid.ParamAttr(name="pw"),
                              bias_attr=False)
        loss = fluid.layers.reduce_mean(out)
        fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def build_fused(fluid, fuse, out=1):
    """tests/test_fused_state.py's MLP under ``fuse_optimizer_state``
    (Adam 1e-2), its flags read while it is built. Its flat group holds
    433 elements (four ranks do not divide it: it stays whole); with
    ``out=4`` 484, 121 a rank (a slice 484 bytes into the group)."""
    set_flags = fluid.set_flags
    set_flags({"fuse_optimizer_state": fuse})
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 3
        with _guard(fluid), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = fluid.layers.data(name="y", shape=[out], dtype="float32")
            h = fluid.layers.fc(x, size=16, act="relu")
            h2 = fluid.layers.fc(h, size=16, act="tanh")
            pred = fluid.layers.fc(h2, size=out)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
            fluid.optimizer.Adam(1e-2).minimize(loss)
    finally:
        set_flags({"fuse_optimizer_state": False})
    return main, startup, loss


def fused_feed(out=1):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 8).astype("float32"),
            "y": rng.randn(8, out).astype("float32")}


TB = dict(src_vocab_size=64, trg_vocab_size=64, max_length=8, n_layer=1,
          n_head=2, d_model=32, d_inner_hid=64, dropout_rate=0.0)


# TB with an FFN width and a vocabulary whose weights' shapes, whole and
# halved, no other tensor shares (the mp-mesh scenario tells a
# tensor-parallel weight's whole shape apart); its ids stay below 64
TB_MP = dict(d_inner_hid=48, src_vocab_size=80, trg_vocab_size=80)


def build_tb(fluid, transformer_base, shard=None, opt="adam", **kw):
    """A tiny Transformer-base with Adam 1e-3 (or SGD 0.1); ``shard(main)``
    runs between the forward and ``minimize``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 7
    with _guard(fluid), fluid.program_guard(main, startup):
        _, avg_cost, _ = transformer_base(**dict(TB, **kw))
        if shard is not None:
            shard(main)
        if opt == "sgd":
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
        else:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return main, startup, avg_cost


def build_penalty(fluid, mesh=None, seed=5):
    """An MLP whose loss adds a penalty on a weight alone to the batch's
    mean error (a term that does not depend on the batch), SGD 0.1."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with _guard(fluid), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, 16], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.data(name="y", shape=[-1, 1], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.fc(x, size=32, act="relu")
        pred = fluid.layers.fc(h, size=1)
        err = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        w = main.global_block().var("fc.w_0")
        pen = fluid.layers.scale(
            fluid.layers.reduce_sum(fluid.layers.square(w)), scale=0.05)
        loss = fluid.layers.elementwise_add(err, pen)
        if mesh is not None:
            fluid.sharding.shard_program(main, mesh)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def tb_feeds(steps, B=4, T=8, V=64, seed=0, ragged=False):
    """TB batches; ``ragged`` gives each row its own length (at least
    one token), so the token-weighted loss weighs the rows unevenly."""
    rng = np.random.RandomState(seed)

    def mask():
        if not ragged:
            return np.ones((B, T), "float32")
        lens = rng.randint(1, T + 1, size=B)
        return (np.arange(T)[None] < lens[:, None]).astype("float32")

    return [{"src_word": rng.randint(1, V, (B, T)).astype("int64"),
             "trg_word": rng.randint(1, V, (B, T)).astype("int64"),
             "lbl_word": rng.randint(1, V, (B, T)).astype("int64"),
             "src_mask": mask(), "trg_mask": mask()}
            for _ in range(steps)]


# ---------------------------------------------------------------- scenarios

def _port():
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid

    return fluid


def _start(fluid, main, startup, state_path, place=None):
    """A scope on ``place`` (default the CPU) holding the test's start
    state (the JAX package's startup values) for ``main``."""
    place = place or fluid.CPUPlace()
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    with np.load(state_path) as z:
        state = {k: z[k] for k in z.files}
    fluid.state_from_numpy(state, scope, place, program=main)
    return exe, scope


def _losses(exe, main, loss, feeds, scope):
    return [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0]) for f in feeds]


def _shapes(scope, names):
    return {n: list(scope.find_var(n).shape) for n in names}


def sc_mlp(out, mesh_kw, steps=20):
    fluid = _port()
    mesh = fluid.sharding.training_mesh(**mesh_kw)
    main, startup, loss = build_mlp(fluid, mesh=mesh)
    exe, scope = _start(fluid, main, startup, os.path.join(out, "mlp.npz"))
    feeds = mlp_feeds(steps)
    losses = _losses(exe, main, loss, feeds, scope)
    names = [n for n in sorted(scope.local_var_names())
             if n.startswith("fc.w_0") and scope.find_var(n).dim()]
    odd = {"x": np.random.RandomState(1).rand(3, 16).astype("float32"),
           "y": np.random.RandomState(2).rand(3, 1).astype("float32")}
    odd_loss = float(exe.run(main, feed=odd, fetch_list=[loss],
                             scope=scope)[0])
    return {"losses": losses, "shapes": _shapes(scope, names),
            "odd_loss": odd_loss}


def sc_mlp_data_fsdp(out):
    return sc_mlp(out, dict(data=2, fsdp=2, tp=1))


def sc_mlp_fsdp_tp(out):
    return sc_mlp(out, dict(data=1, fsdp=2, tp=2))


def sc_run_steps(out):
    fluid = _port()
    mesh = fluid.sharding.training_mesh(data=2, fsdp=2, tp=1)
    feeds = mlp_feeds(6, seed=11)
    got = {}
    for how in ("run", "run_steps"):
        main, startup, loss = build_mlp(fluid, mesh=mesh, seed=9)
        exe, scope = _start(fluid, main, startup,
                            os.path.join(out, "mlp9.npz"))
        if how == "run":
            got[how] = _losses(exe, main, loss, feeds, scope)
        else:
            got[how] = np.asarray(exe.run_steps(
                main, feed_list=feeds, fetch_list=[loss],
                scope=scope)[0]).ravel().tolist()
    return got


def sc_amp(out):
    fluid = _port()
    mesh = fluid.sharding.training_mesh(data=2, fsdp=2, tp=1)
    main, startup, loss = build_mlp(fluid, mesh=mesh, use_amp=True)
    exe, scope = _start(fluid, main, startup,
                        os.path.join(out, "mlp_amp.npz"))
    losses = _losses(exe, main, loss, mlp_feeds(8), scope)
    m1 = [n for n in scope.local_var_names()
          if n.startswith("fc.w_0_moment1")][0]
    return {"losses": losses,
            "stamps": [bool(getattr(main, "_amp_stamp", None)),
                       bool(main._sharding_stamp)],
            "master": [str(scope.find_var("fc.w_0").dtype),
                       list(scope.find_var("fc.w_0").shape)],
            "moment": [str(scope.find_var(m1).dtype),
                       list(scope.find_var(m1).shape)]}


def sc_ckpt(out):
    import torch.distributed as dist

    fluid = _port()
    from paddle_tpu_torch import ckpt
    from paddle_tpu_torch.sharding.spmd import whole_state

    mesh = fluid.sharding.training_mesh(data=2, fsdp=2, tp=1)
    feeds = mlp_feeds(6)
    root = os.path.join(out, "ckpt")
    state_path = os.path.join(out, "mlp.npz")
    main, startup, loss = build_mlp(fluid, mesh=mesh)
    exe, scope = _start(fluid, main, startup, state_path)
    ref = _losses(exe, main, loss, feeds, scope)

    main, startup, loss = build_mlp(fluid, mesh=mesh)
    exe, scope = _start(fluid, main, startup, state_path)
    _losses(exe, main, loss, feeds[:3], scope)
    whole = whole_state(main, scope)
    if dist.get_rank() == 0:
        ckpt.save_checkpoint(root, whole)
    dist.barrier()

    main, startup, loss = build_mlp(fluid, mesh=mesh)
    exe, scope = _start(fluid, main, startup, state_path)
    state, _ = ckpt.restore(root, program=main, scope=scope)
    m1 = [n for n in scope.local_var_names()
          if n.startswith("fc.w_0_moment1")][0]
    placed = list(scope.find_var(m1).shape)
    resumed = _losses(exe, main, loss, feeds[3:], scope)
    return {"ref": ref, "resumed": resumed, "placed": placed,
            "whole": list(whole[m1].shape), "restored": state is not None}


def sc_tb_tp(out):
    fluid = _port()
    from paddle_tpu_torch.models.transformer import transformer_base
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    mesh = fluid.sharding.training_mesh(data=2, fsdp=1, tp=2)
    main, startup, cost = build_tb(
        fluid, transformer_base, tp=True, attn_impl="pallas",
        shard=lambda m: fluid.sharding.shard_program(m, mesh))
    exe, scope = _start(fluid, main, startup, os.path.join(out, "tb.npz"))
    heads = []
    orig = fa.plain_flash_forward

    def spy(q, *a, **k):
        heads.append(int(q.shape[2]))
        return orig(q, *a, **k)

    fa.plain_flash_forward = spy
    try:
        losses = _losses(exe, main, cost, tb_feeds(10), scope)
    finally:
        fa.plain_flash_forward = orig
    return {"losses": losses, "heads": sorted(set(heads))}


def sc_tb_mp(out):
    """TB with ``tp=True`` and SGD on a dp=2 x mp=2 mesh, where the
    ``mp`` specs hold each weight as its rank's block: the losses, the
    held shapes, and the shape of every tensor an all-gather or an
    all-reduce handled (a weight is never gathered or reduced whole)."""
    fluid = _port()
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.sharding import comm

    mesh = fluid.parallel.make_mesh({"dp": 2, "mp": 2})
    main, startup, cost = build_tb(
        fluid, transformer_base, tp=True, opt="sgd",
        shard=lambda m: fluid.sharding.shard_program(m, mesh), **TB_MP)
    exe, scope = _start(fluid, main, startup, os.path.join(out,
                                                           "tb_mp.npz"))
    seen = []
    all_gather, all_reduce = comm.all_gather, comm.all_reduce

    def spy_gather(t, group, dim=0):
        got = all_gather(t, group, dim)
        seen.append(["all_gather", list(got.shape)])
        return got

    def spy_reduce(t, group, mean=False):
        seen.append(["all_reduce", list(t.shape)])
        return all_reduce(t, group, mean)

    comm.all_gather, comm.all_reduce = spy_gather, spy_reduce
    try:
        losses = _losses(exe, main, cost, tb_feeds(4), scope)
    finally:
        comm.all_gather, comm.all_reduce = all_gather, all_reduce
    weights = {p.name: [list(p.shape), list(scope.find_var(p.name).shape)]
               for p in main.all_parameters()
               if getattr(p, "sharding_spec", None)}
    return {"losses": losses, "seen": seen, "weights": weights}


def sc_penalty(out):
    """The penalty MLP at data=4: the batch's mean error summed over the
    ranks' blocks, the penalty computed alike on every rank."""
    fluid = _port()
    mesh = fluid.sharding.training_mesh(data=4, fsdp=1, tp=1)
    main, startup, loss = build_penalty(fluid, mesh=mesh)
    exe, scope = _start(fluid, main, startup,
                        os.path.join(out, "penalty.npz"))
    return {"losses": _losses(exe, main, loss, mlp_feeds(10), scope)}


def sc_tb_ragged(out):
    """TB (no tp) at data=2 x fsdp=2 on batches of ragged rows: the
    token-weighted loss of the whole batch, on every rank."""
    fluid = _port()
    from paddle_tpu_torch.models.transformer import transformer_base

    mesh = fluid.sharding.training_mesh(data=2, fsdp=2, tp=1)
    main, startup, cost = build_tb(
        fluid, transformer_base,
        shard=lambda m: fluid.sharding.shard_program(m, mesh))
    exe, scope = _start(fluid, main, startup,
                        os.path.join(out, "tb_plain.npz"))
    return {"losses": _losses(exe, main, cost,
                              tb_feeds(5, ragged=True), scope)}


def _pe(fluid, main, loss, scope, strategy="AllReduce", remat=False):
    bs = fluid.BuildStrategy()
    bs.reduce_strategy = getattr(fluid.parallel.ReduceStrategy, strategy)
    bs.use_remat = remat
    return fluid.ParallelExecutor(main_program=main, loss_name=loss.name,
                                  build_strategy=bs, scope=scope,
                                  use_cuda=False)


def sc_pe(out):
    fluid = _port()
    data = pe_data()
    res = {}
    for strat, steps in (("AllReduce", 5), ("Reduce", 4)):
        main, startup, loss = build_pe_mlp(fluid)
        _exe, scope = _start(fluid, main, startup,
                             os.path.join(out, "pe.npz"))
        pe = _pe(fluid, main, loss, scope, strat)
        res[strat] = [float(pe.run(fetch_list=[loss.name], feed=data)[0])
                      for _ in range(steps)]
        res["device_count"] = pe.device_count
    # momentum accumulators held as dp slices under Reduce
    main, startup, loss = build_pe_mlp(fluid, opt="momentum")
    _exe, scope = _start(fluid, main, startup,
                         os.path.join(out, "pe_momentum.npz"))
    pe = _pe(fluid, main, loss, scope, "Reduce")
    res["momentum"] = [float(pe.run(fetch_list=[loss.name],
                                    feed=data)[0]) for _ in range(3)]
    gb = main.global_block()
    accs = [n for n, v in gb.vars.items()
            if getattr(v, "is_accumulator", False)]
    res["accs"] = {n: [list(gb.var(n).shape), list(scope.find_var(n).shape)]
                   for n in accs}
    res["layouts"] = {n: list(pe.state_shardings([n])[n].spec)
                      for n in accs}
    # a list of per-device feed dicts
    main, startup, loss = build_pe_mlp(fluid)
    _exe, scope = _start(fluid, main, startup, os.path.join(out, "pe.npz"))
    pe = _pe(fluid, main, loss, scope)
    parts = [{"x": data["x"][i * 16:(i + 1) * 16],
              "y": data["y"][i * 16:(i + 1) * 16]} for i in range(4)]
    res["feed_list"] = float(pe.run(fetch_list=[loss.name],
                                    feed=parts)[0])
    res["remat"] = {}
    for remat in (False, True):
        main, startup, loss = build_pe_mlp(fluid)
        _exe, scope = _start(fluid, main, startup,
                             os.path.join(out, "pe.npz"))
        pe = _pe(fluid, main, loss, scope, remat=remat)
        res["remat"][str(remat)] = [
            float(pe.run(fetch_list=[loss.name], feed=data)[0])
            for _ in range(3)]
    # bcast_params: every rank takes rank 0's parameters
    import torch
    import torch.distributed as dist

    main, startup, loss = build_pe_mlp(fluid)
    _exe, scope = _start(fluid, main, startup, os.path.join(out, "pe.npz"))
    scope.set_var("fc.w_0", scope.find_var("fc.w_0") + dist.get_rank())
    pe = _pe(fluid, main, loss, scope)
    pe.bcast_params()
    res["bcast"] = float(fluid.fetch_var("fc.w_0", scope).sum())
    # a rank's run_steps on the CPU: a loop of runs
    main, startup, loss = build_pe_mlp(fluid)
    _exe, scope = _start(fluid, main, startup, os.path.join(out, "pe.npz"))
    pe = _pe(fluid, main, loss, scope)
    res["run_steps"] = np.asarray(pe.run_steps(
        feed_list=[data] * 3, fetch_list=[loss.name])[0]).ravel().tolist()
    return res


def sc_sparse(out):
    fluid = _port()
    res = {}
    for strat in ("AllReduce", "Reduce"):
        main, startup, loss = build_sparse(fluid)
        _exe, scope = _start(fluid, main, startup,
                             os.path.join(out, "sparse.npz"))
        pe = _pe(fluid, main, loss, scope, strat)
        res[strat] = [float(pe.run(feed={"ids": SPARSE_IDS},
                                   fetch_list=[loss.name])[0])
                      for _ in range(3)]
        res[strat + "_table"] = fluid.fetch_var("ptable", scope).tolist()
    return res


def sc_fused(out):
    fluid = _port()
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    res = {}
    for size in (1, 4):
        feed = fused_feed(size)
        for strat in ("AllReduce", "Reduce"):
            for fuse in (False, True):
                main, startup, loss = build_fused(fluid, fuse, size)
                _exe, scope = _start(fluid, main, startup, os.path.join(
                    out, "fused_%d_%d.npz" % (size, fuse)))
                pe = _pe(fluid, main, loss, scope, strat)
                res["%s_%d_%d" % (strat, size, fuse)] = [
                    float(pe.run(fetch_list=[loss.name], feed=feed)[0])
                    for _ in range(3)]
                if fuse and strat == "Reduce":
                    gb = main.global_block()
                    res["flat_%d" % size] = {
                        n: [list(gb.var(n).shape),
                            list(scope.find_var(n).shape)]
                        for n in scope.local_var_names()
                        if n.startswith("fused_moment")}
    res["launches"] = int(fused_flat_update.launches)  # CPU: none
    return res


def sc_dropout(out):
    fluid = _port()
    mesh = fluid.sharding.training_mesh(data=4, fsdp=1, tp=1)
    res = {}
    data = pe_data(16)
    for how in ("pe", "plan"):
        main, startup, loss = build_pe_mlp(fluid, dropout=0.5)
        if how == "plan":
            main, startup = fluid.Program(), fluid.Program()
            main.random_seed = 7
            with _guard(fluid), fluid.program_guard(main, startup):
                x = fluid.layers.data(name="x", shape=[16],
                                      dtype="float32")
                y = fluid.layers.data(name="y", shape=[1], dtype="float32")
                h = fluid.layers.fc(x, size=32, act="relu")
                h = fluid.layers.dropout(h, dropout_prob=0.5)
                pred = fluid.layers.fc(h, size=1)
                loss = fluid.layers.mean(
                    fluid.layers.square_error_cost(pred, y))
                fluid.sharding.shard_program(main, mesh)
                fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe, scope = _start(fluid, main, startup,
                            os.path.join(out, "dropout.npz"))
        if how == "pe":
            pe = _pe(fluid, main, loss, scope)
            run = lambda: pe.run(fetch_list=[loss.name],  # noqa: E731
                                 feed=data)[0]
        else:
            run = lambda: exe.run(main, feed=data,  # noqa: E731
                                  fetch_list=[loss], scope=scope)[0]
        res[how] = [float(run()) for _ in range(3)]
        res[how + "_w"] = fluid.fetch_var("fc.w_0", scope).tolist()
    return res


def sc_trainer(out):
    fluid = _port()
    rng = np.random.RandomState(4)
    batches = [[(rng.rand(16).astype("float32"),
                 rng.rand(1).astype("float32")) for _ in range(8)]
               for _ in range(4)]

    def train_func():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1, act=None)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    t = fluid.Trainer(train_func,
                      lambda: fluid.optimizer.SGD(learning_rate=0.1),
                      place=fluid.CPUPlace(), parallel=True)
    losses = []
    t.train(num_epochs=1, reader=lambda: iter(batches),
            feed_order=["x", "y"],
            event_handler=lambda e: losses.append(float(e.metrics[0]))
            if isinstance(e, fluid.EndStepEvent) else None)
    w = fluid.fetch_var(t.train_program.all_parameters()[0].name, t.scope)
    import torch.distributed as dist

    if dist.get_rank() == 0:  # one writer; the others read after it
        t.save_params(os.path.join(out, "trainer_params"))
    dist.barrier()

    def infer_func():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        return fluid.layers.fc(input=x, size=1, act=None)

    xs = np.random.RandomState(5).rand(8, 16).astype("float32")
    pred = fluid.Inferencer(infer_func, os.path.join(out, "trainer_params"),
                            place=fluid.CPUPlace(), parallel=True
                            ).infer({"x": xs})[0]
    return {"losses": losses, "w": w.tolist(), "infer": pred.tolist()}


def sc_embedding(out):
    """The row-sharded lookup table over an ``ep`` axis of four ranks:
    the lookup and each rank's rows' gradient."""
    import torch

    fluid = _port()
    from paddle_tpu_torch.sharding import ShardedEmbedding, sharded_lookup

    mesh = fluid.sharding.make_mesh({"ep": 4})
    emb = ShardedEmbedding(10, 3, mesh, seed=1)  # 12 rows, 3 a rank
    whole = torch.randn((12, 3), generator=torch.Generator().manual_seed(
        1)) * 0.02  # the constructor's draw of the padded table
    ids = torch.tensor([[0, 4, 9], [7, 7, 3]])
    table = emb.table.clone().requires_grad_(True)
    got = sharded_lookup(table, ids, mesh)
    got.sum().backward()
    return {"rows": emb.padded_rows, "held": list(emb.table.shape),
            "lookup": got.tolist(), "want": whole[ids].tolist(),
            "grad": table.grad.sum(1).tolist()}


def sc_card(out):
    """Two ranks sharing card 0 over gloo: the ParallelExecutor at dp=2
    (AllReduce, and Reduce on the fused flat state, whose update
    launches the kernel on each rank's slice), and a sharded program's
    ``run_steps``, refused before any capture."""
    import torch

    fluid = _port()
    from paddle_tpu_torch.core.enforce import GraphCaptureError
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    place = fluid.CUDAPlace(0)
    feed = fused_feed(4)
    res = {}
    for strat in ("AllReduce", "Reduce"):
        main, startup, loss = build_fused(fluid, True, 4)
        _exe, scope = _start(fluid, main, startup,
                             os.path.join(out, "card.npz"), place)
        fused_flat_update.launches = 0
        bs = fluid.BuildStrategy()
        bs.reduce_strategy = getattr(fluid.parallel.ReduceStrategy, strat)
        pe = fluid.ParallelExecutor(main_program=main, loss_name=loss.name,
                                    build_strategy=bs, scope=scope,
                                    place=place)
        res[strat] = [float(pe.run(fetch_list=[loss.name], feed=feed)[0])
                      for _ in range(3)]
        res[strat + "_launches"] = int(fused_flat_update.launches)
        res[strat + "_moments"] = {
            n: [list(main.global_block().var(n).shape),
                list(scope.find_var(n).shape),
                scope.find_var(n).data_ptr() % 16,
                scope.find_var(n).device.type]
            for n in scope.local_var_names() if n.startswith("fused_moment")}
        try:
            pe.run_steps(feed_list=[feed] * 2, fetch_list=[loss.name])
            res[strat + "_capture"] = None
        except GraphCaptureError as e:
            res[strat + "_capture"] = str(e)
    mesh = fluid.sharding.training_mesh(data=2, fsdp=1, tp=1)
    main, startup, loss = build_mlp(fluid, mesh=mesh)
    exe, scope = _start(fluid, main, startup, os.path.join(out, "mlp.npz"),
                        place)
    res["plan_loss"] = float(exe.run(main, feed=mlp_feeds(1)[0],
                                     fetch_list=[loss], scope=scope)[0])
    try:
        exe.run_steps(main, feed_list=mlp_feeds(2), fetch_list=[loss],
                      scope=scope)
        res["plan_capture"] = None
    except GraphCaptureError as e:
        res["plan_capture"] = str(e)
    torch.cuda.synchronize()
    return res


# ------------------------------------------------ communication analysis

# an activation rule that pins each fc output to ``fsdp``: on a
# data=2 x fsdp=1 mesh that drops the batch's ``data`` shard, so the
# analysis predicts a gather at each constraint and ``comm_overlap``
# widens the constraints to ``("data",)``
DP_PIN_RULES = [(r"fc\.tmp_\d+$", ("fsdp",))]


def build_megatron_ffn(fluid, mesh, d=16, f=64):
    """A forward-only Megatron FFN pair (a column-parallel fc, relu, a
    row-parallel fc, ``ParamAttr(sharding=...)`` over ``tp``) and its
    mean, sharded over ``mesh``: (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 5
    with _guard(fluid), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, d], dtype="float32",
                              append_batch_size=False)
        col = fluid.ParamAttr(sharding=(None, "tp"))
        row = fluid.ParamAttr(sharding=("tp", None))
        h = fluid.layers.fc(x, size=f, act="relu", param_attr=col)
        out = fluid.layers.fc(h, size=d, param_attr=row)
        loss = fluid.layers.mean(out)
        fluid.sharding.shard_program(main, mesh)
    return main, startup, loss


def _events(rep):
    return [[e.kind, e.reason, e.op_type, e.var, list(e.axes), e.bytes]
            for e in rep.events]


def sc_comm(out):
    """The communication analysis on two ranks, against the port's own
    collectives (``comm.STATS``): one forward of the Megatron FFN pair
    and of the ``tp=True`` Transformer at data=1 x fsdp=1 x tp=2 (no
    batch split), each with its prediction; and the MLP at data=2 with
    ``DP_PIN_RULES``, trained with and without ``comm_overlap`` from the
    same start (its predicted counts before and after the pass)."""
    fluid = _port()
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.passes.schedule import CommOverlapPass
    from paddle_tpu_torch.sharding import comm

    res = {}
    tp_mesh = fluid.sharding.training_mesh(data=1, fsdp=1, tp=2)
    feed = {"x": np.random.RandomState(4).rand(8, 16).astype("float32")}
    tb_feed = tb_feeds(1)[0]
    builds = {
        "ffn": (lambda: build_megatron_ffn(fluid, tp_mesh), feed, 8),
        "tb": (lambda: _tb_forward(fluid, transformer_base, tp_mesh),
               tb_feed, 4)}
    for key, (build, fd, batch) in builds.items():
        main, startup, loss = build()
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        rep = analysis.analyze_comm(main, batch_size=batch,
                                    fetch_list=[loss])
        comm.reset_stats()
        res[key + "_loss"] = float(exe.run(main, feed=fd, fetch_list=[loss],
                                           scope=scope)[0])
        res[key + "_stats"] = {k: list(v) for k, v in comm.STATS.items()}
        res[key + "_pred"] = _events(rep)
        res[key + "_rowparallel"] = sum(
            1 for op in main.global_block().ops
            if op.type == "mul" and op.attrs.get("_tp") == "row")
    dp_mesh = fluid.sharding.training_mesh(data=2, fsdp=1, tp=1)
    for overlap in (False, True):
        counts = {}

        def shard(main, overlap=overlap, counts=counts):
            fluid.sharding.shard_program(
                main, dp_mesh,
                rules=DP_PIN_RULES + fluid.sharding.default_rules())
            counts["before"] = analysis.analyze_comm(
                main, batch_size=8).counts()
            if overlap:
                CommOverlapPass(batch_size=8).apply(main)
            counts["after"] = analysis.analyze_comm(
                main, batch_size=8).counts()
            counts["specs"] = [op.attrs.get("spec")
                               for op in main.global_block().ops
                               if op.type == "sharding_constraint"]
            counts["stamp"] = getattr(main, "_schedule_stamp", None)

        main, startup, loss = build_mlp(fluid, shard=shard)
        exe, scope = _start(fluid, main, startup,
                            os.path.join(out, "mlp.npz"))
        counts["losses"] = _losses(exe, main, loss, mlp_feeds(5), scope)
        res["overlap_%d" % overlap] = counts
    return res


def _tb_forward(fluid, transformer_base, mesh):
    """TB (``tp=True``) sharded over ``mesh``, forward only."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 7
    with _guard(fluid), fluid.program_guard(main, startup):
        _, avg_cost, _ = transformer_base(**dict(TB, tp=True,
                                                 attn_impl="fused"))
        fluid.sharding.shard_program(main, mesh)
    return main, startup, avg_cost


# ------------------------------------------- pipeline, sequence, experts

PP_TB = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16,
             n_layer=2, n_head=2, d_model=16, d_inner_hid=32,
             dropout_rate=0.0, attn_impl="fused", pp_encoder=True,
             pp_microbatches=2)


def build_pp_tb(fluid, transformer_base, seed=13, **kw):
    """tests/test_pipeline.py's pipelined Transformer (SGD 0.1)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with _guard(fluid), fluid.program_guard(main, startup):
        _, avg_cost, _ = transformer_base(**dict(PP_TB, **kw))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


def pp_feed(B=8, T=8, V=64):
    rng = np.random.RandomState(0)

    def ids():
        return rng.randint(1, V, size=(B, T)).astype("int64")

    ones = np.ones((B, T), "float32")
    return {"src_word": ids(), "trg_word": ids(), "lbl_word": ids(),
            "src_mask": ones, "trg_mask": ones}


RING_TB = dict(src_vocab_size=64, trg_vocab_size=64, max_length=32,
               n_layer=1, n_head=2, d_model=16, d_inner_hid=32,
               dropout_rate=0.0)


def build_ring_tb(fluid, transformer_base, attn_impl, seed=11):
    """tests/test_transformer_ring.py's Transformer, with Adam 1e-3 so a
    few steps train it."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with _guard(fluid), fluid.program_guard(main, startup):
        _, avg_cost, _ = transformer_base(attn_impl=attn_impl, **RING_TB)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return main, startup, avg_cost


def ring_feed(B=4, T=8, V=64):
    rng = np.random.RandomState(3)

    def ids():
        return rng.randint(1, V, size=(B, T)).astype("int64")

    mask = np.ones((B, T), "float32")
    mask[:, -2:] = 0.0  # a padded tail: the key mask's path
    return {"src_word": ids(), "trg_word": ids(), "lbl_word": ids(),
            "src_mask": mask, "trg_mask": mask}


def build_moe(fluid, D=8, E=4, F=16, cap=1.25):
    """tests/test_moe.py's expert-parallel program (Adam 0.01); ``cap``
    the capacity factor (0.5 drops tokens)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 31
    with _guard(fluid), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, -1, D], dtype="float32",
                              append_batch_size=False)
        out, aux = fluid.layers.switch_moe(x, E, F, capacity_factor=cap)
        loss = fluid.layers.elementwise_add(
            x=fluid.layers.reduce_mean(out), y=aux)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss, out, aux


def moe_feed(D=8):
    return np.random.RandomState(1).randn(8, 4, D).astype("float32")


def build_dist_emb(fluid, is_distributed):
    """tests/test_distributed_embedding.py's lookup model (SGD 0.1)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 5
    with _guard(fluid), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[-1, 4], dtype="int64",
                                append_batch_size=False)
        label = fluid.layers.data(name="label", shape=[-1, 1],
                                  dtype="float32", append_batch_size=False)
        emb = fluid.layers.embedding(ids, size=[32, 8],
                                     is_distributed=is_distributed)
        pooled = fluid.layers.reduce_mean(emb, dim=1)
        pred = fluid.layers.fc(input=pooled, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred,
                                                                label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def dist_emb_feed(B=8):
    rng = np.random.RandomState(0)
    return {"ids": rng.randint(0, 32, size=(B, 4)).astype("int64"),
            "label": rng.rand(B, 1).astype("float32")}


def _pe_mesh(fluid, main, loss, scope, axes):
    return fluid.ParallelExecutor(
        main_program=main, loss_name=loss.name, scope=scope,
        use_cuda=False, mesh=fluid.parallel.make_mesh(axes))


def _pe_losses(pe, loss, feed, steps):
    return [float(pe.run(fetch_list=[loss.name], feed=feed)[0])
            for _ in range(steps)]


GPIPE_D = 8


def gpipe_inputs():
    """tests/test_pipeline.py's gpipe operands: [S=4, d, d] weights, a
    [16, 5, d] input and its [16, 5] mask."""
    rng = np.random.RandomState(0)
    S, d = 4, GPIPE_D
    W = (rng.randn(S, d, d) * 0.3).astype("float32")
    b = (rng.randn(S, d) * 0.1).astype("float32")
    x = rng.randn(16, 5, d).astype("float32")
    mask = (rng.rand(16, 5) > 0.2).astype("float32")
    return W, b, x, mask


def sc_gpipe(out):
    """``gpipe`` against the sequential fold: pp=4 (a layer a stage) and
    pp=2 x dp=2 (two layers a stage), forward and gradient."""
    import torch

    fluid = _port()
    from paddle_tpu_torch.parallel.pipeline import (gpipe, microbatch,
                                                    unmicrobatch)

    W, b, x, mask = [torch.tensor(a) for a in gpipe_inputs()]

    def stage(p, xb, mb):
        w, bb = p
        for i in range(w.shape[0]):
            xb = torch.tanh(xb @ w[i] + bb[i]) * mb[..., None] + xb
        return xb

    res = {}
    for name, axes in (("pp4", {"pp": 4}), ("pp2dp2", {"pp": 2, "dp": 2})):
        mesh = fluid.parallel.make_mesh(axes)
        Wg = W.clone().requires_grad_(True)
        bg = b.clone().requires_grad_(True)
        y = unmicrobatch(gpipe(stage, (Wg, bg), microbatch(x, 4), mesh,
                               side_mb=(microbatch(mask, 4),)))
        (y ** 2).sum().backward()
        res[name] = {"y": y.tolist(), "gW": Wg.grad.tolist(),
                     "gb": bg.grad.tolist()}
    return res


def _pp_run(fluid, out, axes, steps=4, state="pp_tb.npz", **kw):
    from paddle_tpu_torch.models.transformer import transformer_base

    main, startup, loss = build_pp_tb(fluid, transformer_base, **kw)
    _exe, scope = _start(fluid, main, startup, os.path.join(out, state))
    pe = _pe_mesh(fluid, main, loss, scope, axes)
    return _pe_losses(pe, loss, pp_feed(), steps), main, scope


def sc_pp(out):
    """The pipelined Transformer on pp=2 x dp=2, pp=2 x mp=2 (tp),
    pp=2 x mp=2 and dp=2 x mp=2 (no pp: the sequential fold on each
    rank's blocks) with dropout; each rank's held stage block."""
    import torch.distributed as dist

    fluid = _port()
    res = {}
    res["pp_dp"], main, scope = _pp_run(fluid, out, {"pp": 2, "dp": 2})
    res["held"] = {p.name: [list(p.shape),
                            list(scope.find_var(p.name).shape)]
                   for p in main.all_parameters()
                   if p.name.startswith("pp_enc.")}
    res["pp_tp"], _m, _s = _pp_run(fluid, out, {"pp": 2, "mp": 2},
                                   state="pp_tb_tp.npz", tp=True)
    res["pp_tp_drop"], _m, _s = _pp_run(
        fluid, out, {"pp": 2, "mp": 2}, steps=3, state="pp_tb_drop.npz",
        tp=True, dropout_rate=0.2)
    res["dp_mp_drop"], _m, _s = _pp_run(
        fluid, out, {"dp": 2, "mp": 2}, steps=3, state="pp_tb_drop.npz",
        tp=True, dropout_rate=0.2)
    a, _m, _s = _pp_run(fluid, out, {"pp": 2, "dp": 2}, steps=3,
                        state="pp_tb_drop1.npz", dropout_rate=0.3)
    b, _m, _s = _pp_run(fluid, out, {"pp": 2, "dp": 2}, steps=3,
                        state="pp_tb_drop1.npz", dropout_rate=0.3)
    res["pp_dp_drop"] = [a, b]
    try:
        _pp_run(fluid, out, {"mp": 4}, steps=1, state="pp_tb_tp.npz",
                tp=True)
        res["indivisible"] = None
    except fluid.EnforceError as e:
        res["indivisible"] = str(e)
    res["rank"] = dist.get_rank()
    return res


def sc_ring(out):
    """Ring attention on sp=4 (causal, not, zigzag against contiguous,
    gradients) and dp=2 x sp=2, and the ring Transformer at dp=2 x sp=2
    against its one-process fused run."""
    import torch

    fluid = _port()
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.parallel import ring_attention

    rng = np.random.RandomState(0)
    q, k, v = [torch.tensor(rng.randn(2, 32, 4, 16).astype("float32"))
               for _ in range(3)]
    kvm = torch.ones(2, 32)
    kvm[:, -3:] = 0.0
    res = {}
    for axes in ({"sp": 4}, {"dp": 2, "sp": 2}):
        mesh = fluid.parallel.make_mesh(axes)
        key = ",".join("%s%d" % kv for kv in axes.items())
        for causal in (False, True):
            for zz in ((None, False) if causal else (None,)):
                qs, ks, vs = [t.clone().requires_grad_(True)
                              for t in (q, k, v)]
                o = ring_attention(qs, ks, vs, mesh, causal=causal,
                                   zigzag=zz,
                                   kv_mask=None if causal else kvm)
                (o.float() ** 2).sum().backward()
                res["%s_%s_%s" % (key, causal, zz)] = {
                    "o": o.tolist(), "gq": qs.grad.tolist(),
                    "gk": ks.grad.tolist(), "gv": vs.grad.tolist()}
        mesh16 = fluid.parallel.make_mesh(axes)
        o16 = ring_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             mesh16, causal=True)
        res[key + "_bf16"] = o16.float().tolist()
    try:
        ring_attention(q[:, :12], k[:, :12], v[:, :12],
                       fluid.parallel.make_mesh({"sp": 4}), causal=True,
                       zigzag=True)
        res["zigzag_refused"] = None
    except ValueError as e:
        res["zigzag_refused"] = str(e)
    main, startup, loss = build_ring_tb(fluid, transformer_base, "ring")
    _exe, scope = _start(fluid, main, startup,
                         os.path.join(out, "ring_tb.npz"))
    pe = _pe_mesh(fluid, main, loss, scope, {"dp": 2, "sp": 2})
    res["tb"] = _pe_losses(pe, loss, ring_feed(), 3)
    return res


def sc_ep(out):
    """switch_moe at ep=2 x dp=2 (losses, the rank's experts, the drops)
    and the distributed lookup table at dp=2 x ep=2, alone and in the
    Transformer."""
    fluid = _port()
    from paddle_tpu_torch.models.transformer import transformer_base

    res = {}
    for cap in (1.25, 0.5):
        main, startup, loss, outv, aux = build_moe(fluid, cap=cap)
        _exe, scope = _start(fluid, main, startup,
                             os.path.join(out, "moe.npz"))
        pe = _pe_mesh(fluid, main, loss, scope, {"ep": 2, "dp": 2})
        xv = moe_feed()
        row = {"losses": _pe_losses(pe, loss, {"x": xv}, 3)}
        got = pe.run(feed={"x": xv}, fetch_list=[outv.name, aux.name])
        row["out"] = np.asarray(got[0]).tolist()
        row["aux"] = float(np.asarray(got[1]))
        row["held"] = {p.name: [list(p.shape),
                                list(scope.find_var(p.name).shape)]
                       for p in main.all_parameters()}
        res["moe_%s" % cap] = row
    main, startup, loss = build_dist_emb(fluid, True)
    _exe, scope = _start(fluid, main, startup,
                         os.path.join(out, "dist_emb.npz"))
    pe = _pe_mesh(fluid, main, loss, scope, {"dp": 2, "ep": 2})
    res["emb"] = _pe_losses(pe, loss, dist_emb_feed(), 4)
    table = [p.name for p in main.all_parameters()
             if p.name.startswith("embedding")][0]
    res["emb_held"] = list(scope.find_var(table).shape)
    main, startup, loss = build_tb(fluid, transformer_base,
                                   distributed_embedding=True)
    _exe, scope = _start(fluid, main, startup,
                         os.path.join(out, "tb_emb.npz"))
    pe = _pe_mesh(fluid, main, loss, scope, {"dp": 2, "ep": 2})
    res["tb"] = _pe_losses(pe, loss, tb_feeds(1)[0], 3)
    return res


# ------------------------------------------------ checkpoints across ranks

def build_zero_mlp(fluid):
    """tests/test_sharded_checkpoint.py's MLP (Momentum 0.05, 0.9)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 3
    with _guard(fluid), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="relu")
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def zero_feed(step):
    rng = np.random.RandomState(100 + step)
    x = rng.rand(64, 16).astype("float32")
    return {"x": x, "y": (x.sum(1, keepdims=True) * 0.5).astype("float32")}


def _zero_pe(fluid, out, state="zero.npz"):
    main, startup, loss = build_zero_mlp(fluid)
    _exe, scope = _start(fluid, main, startup, os.path.join(out, state))
    return main, loss, scope, _pe(fluid, main, loss, scope, "Reduce")


def _steps(pe, loss, steps):
    return [float(pe.run(feed=zero_feed(s), fetch_list=[loss.name])[0])
            for s in steps]


def _gathered(pe, scope, names):
    """Each of ``names`` whole on every rank (collective)."""
    from paddle_tpu_torch.sharding import comm

    out = {}
    gb = pe._program.global_block()
    for n in names:
        v = scope.find_var(n)
        shape = tuple(int(x) for x in gb.var(n).shape)
        if tuple(v.shape) != shape:
            v = comm.gather_full(v, pe.state_shardings([n])[n].spec,
                                 pe.mesh)
        out[n] = v.detach().float().numpy() if v.dtype == \
            __import__("torch").bfloat16 else v.detach().numpy()
    return out


def _set_state(scope, state):
    import torch

    for n, v in state.items():
        scope.set_var(n, v if isinstance(v, torch.Tensor)
                      else torch.as_tensor(np.asarray(v)))


def trainer_batches():
    rng = np.random.RandomState(4)
    return [[(rng.rand(16).astype("float32"),
              rng.rand(1).astype("float32")) for _ in range(8)]
            for _ in range(6)]


def trainer_func(fluid):
    def train_func():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1, act=None)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    return train_func


def sc_ckpt_save(out):
    """ZeRO (Reduce) at dp=4: an uninterrupted 5-step run; 3 steps then
    a sharded (legacy) and an elastic save from every rank, the whole
    state beside them; each restored onto the same mesh (blocks
    re-sliced from the shards / whole values placed by the run) for
    steps 3-4. The pipelined Transformer at pp=2 x dp=2 saves its stage
    blocks. ``Trainer(parallel=True)`` checkpoints across the ranks and
    a new Trainer resumes."""
    import torch
    import torch.distributed as dist

    fluid = _port()
    from paddle_tpu_torch import ckpt
    from paddle_tpu_torch.models.transformer import transformer_base

    rank = dist.get_rank()
    res = {}
    main, loss, scope, pe = _zero_pe(fluid, out)
    res["oracle"] = _steps(pe, loss, range(5))
    main, loss, scope, pe = _zero_pe(fluid, out)
    res["first3"] = _steps(pe, loss, range(3))
    names = sorted(scope.local_var_names())
    state = pe.sharded_state(names)
    res["shards"] = sorted(n for n, v in state.items()
                           if isinstance(v, ckpt.manifest.Shard))
    for fmt, save in (("sharded", ckpt.save_checkpoint_sharded),
                      ("elastic", ckpt.save_checkpoint_elastic)):
        save(os.path.join(out, fmt), state, serial=0,
             trainer_args={"step": 3})
    whole = _gathered(pe, scope, names)
    if rank == 0:
        np.savez(os.path.join(out, "zero_saved.npz"), **whole)
    dist.barrier()
    for fmt in ("sharded", "elastic"):
        main, loss, scope, pe = _zero_pe(fluid, out)
        if fmt == "sharded":
            st, targs = ckpt.load_checkpoint_sharded(
                os.path.join(out, fmt),
                shardings=pe.state_shardings(names))
            res["block_shapes"] = {n: list(np.shape(v))
                                   for n, v in st.items()}
            _set_state(scope, st)
        else:
            st, targs = ckpt.restore(os.path.join(out, fmt), program=main,
                                     scope=scope)
        res["targs_" + fmt] = targs
        res["resumed_" + fmt] = _steps(pe, loss, range(3, 5))
    # a shard_program mesh (data=2 x fsdp=2): saved after 3 steps,
    # restored onto the same mesh (each rank's blocks exact) and onto
    # fsdp=4 under the default rules (tests/test_ckpt.py:150,226)
    from paddle_tpu_torch.sharding.spmd import held_state

    feeds = mlp_feeds(6)
    runs = {}
    for key, kw in (("saved", dict(data=2, fsdp=2)),
                    ("same", dict(data=2, fsdp=2)),
                    ("other", dict(data=1, fsdp=4))):
        mesh = fluid.sharding.training_mesh(tp=1, **kw)
        main, startup, loss = build_mlp(fluid, mesh=mesh)
        exe, scope = _start(fluid, main, startup,
                            os.path.join(out, "mlp.npz"))
        plan, gb = main._sharding_plan, main.global_block()
        if key == "saved":
            _losses(exe, main, loss, feeds[:3], scope)
            st = held_state(main, scope, mesh, lambda n: plan.spec_for(
                gb._find_var_recursive(n), n))
            ckpt.save_checkpoint_elastic(os.path.join(out, "plan"), st,
                                         serial=0)
            blocks = {n: (v.data if isinstance(v, ckpt.manifest.Shard)
                          else v).clone() for n, v in st.items()}
            res["plan_blocks"] = sum(isinstance(v, ckpt.manifest.Shard)
                                     for v in st.values())
        else:
            ckpt.restore(os.path.join(out, "plan"), program=main,
                         scope=scope)
            if key == "same":
                res["plan_exact"] = all(
                    torch.equal(scope.find_var(n), v)
                    for n, v in blocks.items())
        runs[key] = _losses(exe, main, loss, feeds[3:], scope)
    res["plan"] = runs
    # the pipelined Transformer's stage blocks
    main, startup, loss = build_pp_tb(fluid, transformer_base)
    _exe, scope = _start(fluid, main, startup,
                         os.path.join(out, "pp_tb.npz"))
    pe = _pe_mesh(fluid, main, loss, scope, {"pp": 2, "dp": 2})
    _pe_losses(pe, loss, pp_feed(), 2)
    pnames = sorted(scope.local_var_names())
    ckpt.save_checkpoint_elastic(os.path.join(out, "pp"),
                                 pe.sharded_state(pnames), serial=0)
    pwhole = _gathered(pe, scope, pnames)
    if rank == 0:
        np.savez(os.path.join(out, "pp_saved.npz"), **pwhole)
    res["pp_losses"] = _pe_losses(pe, loss, pp_feed(), 2)
    # Trainer(parallel=True) with a checkpoint_config across the ranks
    batches = trainer_batches()
    train_func = trainer_func(fluid)

    def reader(crash):
        for i, b in enumerate(batches):
            if crash and i == 3:
                raise RuntimeError("preempted")
            yield b

    def trainer(crash):
        cfg = fluid.CheckpointConfig(os.path.join(out, "trainer"),
                                     step_interval=3)
        t = fluid.Trainer(train_func,
                          lambda: fluid.optimizer.Adam(learning_rate=0.01),
                          place=fluid.CPUPlace(), parallel=True,
                          checkpoint_config=cfg)
        losses = []
        try:
            t.train(num_epochs=1, reader=lambda: reader(crash),
                    feed_order=["x", "y"],
                    event_handler=lambda e: losses.append(
                        float(e.metrics[0]))
                    if isinstance(e, fluid.EndStepEvent) else None)
        except RuntimeError as e:
            assert "preempted" in str(e)
        return t, losses

    # three steps and a checkpoint, then the run dies; a new Trainer
    # resumes at step 3
    _t, res["trainer_first"] = trainer(True)
    dist.barrier()
    t, res["trainer_resumed"] = trainer(False)
    res["trainer_w"] = fluid.fetch_var(
        t.train_program.all_parameters()[0].name, t.scope).tolist()
    res["rank"] = rank
    return res


def sc_ckpt_restore2(out):
    """A world of two ranks restores checkpoints written by four (the
    port's elastic save, and the JAX package's sharded and elastic
    saves on its 4-device mesh): each rank's ZeRO blocks against the
    saved whole state, then steps 3-4."""
    fluid = _port()
    from paddle_tpu_torch import ckpt

    res = {}
    with np.load(os.path.join(out, "zero_saved.npz")) as z:
        saved = {k: z[k] for k in z.files}
    for root in ("elastic", "jax_sharded", "jax_elastic"):
        main, loss, scope, pe = _zero_pe(fluid, out)
        names = [n for n in sorted(scope.local_var_names())]
        layouts = pe.state_shardings(names)
        st, targs = ckpt.load_checkpoint_sharded(os.path.join(out, root),
                                                 shardings=layouts)
        from paddle_tpu_torch.sharding import comm

        gaps = {}
        want = saved if root == "elastic" else dict(np.load(
            os.path.join(out, "jax_saved.npz")))
        for n, v in st.items():
            spec = layouts[n].spec
            w = want[n]
            if any(spec):
                w = w[comm.local_slices(w.shape, spec, pe.mesh)]
            gaps[n] = [list(np.shape(v)), bool(np.array_equal(
                np.asarray(v), w))]
        res[root] = {"gaps": gaps, "targs": targs}
        _set_state(scope, st)
        res[root]["resumed"] = _steps(pe, loss, range(3, 5))
    return res


# the training recipe's flags: bf16 activations and moments, fused
# optimizer state ("bf16"), and the same with f32 activations and
# moments ("f32")
UPDATE_FLAGS = {
    "bf16": {"use_bfloat16": True, "bf16_activations": True,
             "bf16_moments": True, "fuse_optimizer_state": True},
    "f32": {"use_bfloat16": False, "bf16_activations": False,
            "bf16_moments": False, "fuse_optimizer_state": True}}


def build_update_tb(fluid, transformer_base, key):
    """TB (two layers) with row-sparse word tables, the flash route and
    Adam 1e-3, built under ``UPDATE_FLAGS[key]``."""
    flags = UPDATE_FLAGS[key]
    saved = {n: fluid.get_flag(n) for n in flags}
    fluid.set_flags(flags)
    try:
        return build_tb(fluid, transformer_base, n_layer=2,
                        sparse_embedding=True, attn_impl="pallas")
    finally:
        fluid.set_flags(saved)


def update_feed():
    """A batch of 8 x 8 tokens: as many as the tables have rows."""
    return tb_feeds(1, B=8)[0]


def sc_ckpt_update(out):
    """ZeRO (Reduce) at dp=2 on the recipe-flagged Transformer (each of
    ``UPDATE_FLAGS``): 3 steps, an elastic save from both ranks with
    each rank's held blocks beside it (``chip_smoke.saved_blocks``), then
    steps 4-5."""
    import torch
    import torch.distributed as dist

    fluid = _port()
    from chip_smoke import saved_blocks
    from paddle_tpu_torch import ckpt
    from paddle_tpu_torch.models.transformer import transformer_base

    res = {}
    for key in UPDATE_FLAGS:
        main, startup, loss = build_update_tb(fluid, transformer_base, key)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        with np.load(os.path.join(out, "update_%s.npz" % key)) as z:
            fluid.params_from_numpy({k: z[k] for k in z.files}, scope,
                                    fluid.CPUPlace(), program=main)
        pe = _pe(fluid, main, loss, scope, "Reduce")
        losses = []
        for i in range(5):
            losses.append(float(pe.run(feed=update_feed(),
                                       fetch_list=[loss.name])[0]))
            if i == 2:
                ckpt.save_checkpoint_elastic(
                    os.path.join(out, "update_" + key), pe.sharded_state(),
                    serial=0, trainer_args={"step": 3})
                torch.save(saved_blocks(pe.sharded_state()), os.path.join(
                    out, "update_%s.%d.pt" % (key, dist.get_rank())))
        res[key] = losses
    return res


def sc_ckpt_kill(out):
    """Two ranks save serial 0, then start serial 1: rank 0 writes its
    part and leaves, rank 1 is SIGKILLed before writing — serial 1 never
    becomes valid."""
    import signal

    import torch.distributed as dist

    fluid = _port()
    from paddle_tpu_torch import ckpt

    main, loss, scope, pe = _zero_pe(fluid, out)
    losses = _steps(pe, loss, range(3))
    root = os.path.join(out, "killed")
    state = pe.sharded_state(sorted(scope.local_var_names()))
    ckpt.save_checkpoint_elastic(root, state, serial=0,
                                 trainer_args={"step": 3})
    dist.barrier()
    _steps(pe, loss, range(3, 4))
    state = pe.sharded_state(sorted(scope.local_var_names()))
    if dist.get_rank() == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    ckpt.save_checkpoint_elastic(root, state, serial=1,
                                 trainer_args={"step": 4})
    with open(os.path.join(out, "ckpt_kill.0.json"), "w") as f:
        import json as _json

        _json.dump({"first3": losses}, f)
    os._exit(0)


def sc_ckpt_resume(out):
    """A fresh world of two resumes the killed run from its newest
    valid serial and runs steps 3-4."""
    fluid = _port()
    from paddle_tpu_torch import ckpt

    main, loss, scope, pe = _zero_pe(fluid, out)
    root = os.path.join(out, "killed")
    st, targs = ckpt.restore(root, program=main, scope=scope)
    return {"serial": ckpt.latest_valid_serial(root), "targs": targs,
            "resumed": _steps(pe, loss, range(3, 5))}


# the card's legs: PP_TB at a head size the flash kernels take
CARD_PP = dict(d_model=128, d_inner_hid=256, attn_impl="pallas")


def sc_card_legs(out):
    """Two ranks sharing card 0 over gloo: the pipelined Transformer at
    pp=2 (flash at each stage's microbatches), the ring Transformer at
    sp=2, the MoE layer at ep=2 (each rank's experts, a packed fused
    launch a step), and an elastic save of the MoE state from both."""
    fluid = _port()
    from paddle_tpu_torch import ckpt
    from paddle_tpu_torch.models.transformer import transformer_base
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    place = fluid.CUDAPlace(0)
    res = {}

    def pe_on(main, loss, scope, axes):
        return fluid.ParallelExecutor(
            main_program=main, loss_name=loss.name, scope=scope,
            place=place, mesh=fluid.parallel.make_mesh(axes))

    main, startup, loss = build_pp_tb(fluid, transformer_base, **CARD_PP)
    _e, scope = _start(fluid, main, startup,
                       os.path.join(out, "card_pp.npz"), place)
    pe = pe_on(main, loss, scope, {"pp": 2})
    fa.flash_fwd.launches = 0
    res["pp"] = _pe_losses(pe, loss, pp_feed(), 3)
    res["pp_flash"] = int(fa.flash_fwd.launches)
    main, startup, loss = build_ring_tb(fluid, transformer_base, "ring")
    _e, scope = _start(fluid, main, startup,
                       os.path.join(out, "card_ring.npz"), place)
    pe = pe_on(main, loss, scope, {"sp": 2})
    res["sp"] = _pe_losses(pe, loss, ring_feed(), 3)
    main, startup, loss, outv, _aux = build_moe(fluid, cap=0.5)
    _e, scope = _start(fluid, main, startup,
                       os.path.join(out, "card_moe.npz"), place)
    pe = pe_on(main, loss, scope, {"ep": 2})
    fused_flat_update.launches = 0
    res["moe"] = _pe_losses(pe, loss, {"x": moe_feed()}, 3)
    res["moe_fused"] = int(fused_flat_update.launches)
    ckpt.save_checkpoint_elastic(os.path.join(out, "card_ckpt"),
                                 pe.sharded_state(), serial=0)
    import torch

    torch.cuda.synchronize()
    return res


SCENARIOS = {
    "card_legs": sc_card_legs, "comm": sc_comm,
    "ckpt_save": sc_ckpt_save, "ckpt_restore2": sc_ckpt_restore2,
    "ckpt_kill": sc_ckpt_kill, "ckpt_resume": sc_ckpt_resume,
    "ckpt_update": sc_ckpt_update,
    "gpipe": sc_gpipe, "pp": sc_pp, "ring": sc_ring, "ep": sc_ep,
    "card": sc_card, "embedding": sc_embedding,
    "mlp_data_fsdp": sc_mlp_data_fsdp, "mlp_fsdp_tp": sc_mlp_fsdp_tp,
    "run_steps": sc_run_steps, "amp": sc_amp, "ckpt": sc_ckpt,
    "tb_tp": sc_tb_tp, "tb_mp": sc_tb_mp, "penalty": sc_penalty,
    "tb_ragged": sc_tb_ragged, "pe": sc_pe, "sparse": sc_sparse,
    "fused": sc_fused, "dropout": sc_dropout, "trainer": sc_trainer,
}


def _main(argv):
    rank, world, init_file, out, names = argv
    rank, world = int(rank), int(world)
    _port()
    from paddle_tpu_torch import parallel

    parallel.init_distributed("file://" + init_file, world, rank,
                              backend="gloo", timeout_s=60)
    for name in names.split(","):
        res = SCENARIOS[name](out)
        with open(os.path.join(out, "%s.%d.json" % (name, rank)), "w") as f:
            json.dump(res, f)
    parallel.env.shutdown()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world, scenarios, out, timeout=240, codes=None):
    """Run ``scenarios`` on a world of ``world`` gloo ranks on the CPU
    (their store a file under ``out``); returns {scenario: [each rank's
    result]}. The ranks are killed when one fails or the time is up, and
    the failure raises with their output's tail. ``codes``: each rank's
    expected exit code (default 0; a rank expected to die writes no
    result)."""
    codes = list(codes) if codes is not None else [0] * world
    # a store of its own: a later world in the same directory must not
    # meet an earlier world's keys
    init = os.path.join(out, "store.%d" % time.time_ns())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(out, "rank%d.log" % r), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             init, out, ",".join(scenarios)], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p, c in zip(procs, codes)
                   if p.poll() not in (None, c)]
            if bad or time.time() > deadline:
                failed = "a rank failed" if bad else "timed out"
                break
            time.sleep(0.1)
        if failed is None and [p.returncode for p in procs] != codes:
            failed = "a rank failed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append("rank %d:\n%s" % (r, log.read()[-3000:]))
        raise RuntimeError("%s:\n%s" % (failed, "\n".join(tails)))
    for log in logs:
        log.close()
    out_res = {}
    for name in scenarios:
        out_res[name] = []
        for r in range(world):
            if codes[r] != 0:
                continue
            with open(os.path.join(out, "%s.%d.json" % (name, r))) as f:
                out_res[name].append(json.load(f))
    return out_res


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _main(sys.argv[1:])
