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
        if mesh is not None:
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
    from paddle_tpu_torch.ops import flash_attention as fa

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


SCENARIOS = {
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


def launch(world, scenarios, out, timeout=240):
    """Run ``scenarios`` on a world of ``world`` gloo ranks on the CPU
    (their store a file under ``out``); returns {scenario: [each rank's
    result]}. The ranks are killed when one fails or the time is up, and
    the failure raises with their output's tail."""
    init = os.path.join(out, "store")
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
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                failed = "a rank failed" if bad else "timed out"
                break
            time.sleep(0.1)
        if failed is None and any(p.returncode for p in procs):
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
            with open(os.path.join(out, "%s.%d.json" % (name, r))) as f:
                out_res[name].append(json.load(f))
    return out_res


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _main(sys.argv[1:])
