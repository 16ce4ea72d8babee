"""The card's leg of the passes and static tools (JAX-free, so it runs on
a machine without JAX): the int8 ops on the card against their CPU
runs, an int8 program's captured graph against its eager run, host
offload's pinned staging, and ``set_memory_fraction``'s cap. Every test
is marked ``cuda`` and skips on a host without a card; the CPU side of
each is held to the JAX package in tests/test_torch_quantize.py,
tests/test_torch_host_offload.py and tests/test_torch_static_tools.py.

Run on a card: ``python -m pytest tests/test_torch_static_card.py -m
cuda --noconftest -q``.
"""

import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import passes
from paddle_tpu_torch.passes import quantize as tq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# (x shape, K, N): the padded cases of torch._int_mm on CUDA (M <= 16,
# K or N not a multiple of 8) and a plain one
MUL_CASES = [((1, 768), 768, 2), ((3, 147), 147, 64), ((40, 64), 64, 24),
             ((2, 5, 24), 24, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MUL_CASES, ids=str)
def test_cuda_int8_mul_equals_the_cpu(case):
    dev = _card()
    xshape, K, N = case
    rng = np.random.RandomState(K + N)
    xq = torch.from_numpy(rng.randint(-127, 128, xshape).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(np.int8))
    fn = tq._int8_mul_fn(rng.rand(N).astype(np.float32) * 1e-4)
    assert torch.equal(fn(xq.to(dev), wq.to(dev)).cpu(), fn(xq, wq))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((2, 3, 20, 20), (16, 7, 7), (2, 2), (3, 3), (1, 1)),
    ((1, 512, 7, 7), (8, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((1, 4, 11, 10), (6, 3, 3), (1, 2), (2, 1), (2, 2))], ids=str)
def test_cuda_int8_conv_equals_the_cpu(case):
    dev = _card()
    xshape, (O, kh, kw), st, pd, dl = case
    rng = np.random.RandomState(O * kh)
    xq = torch.from_numpy(rng.randint(-127, 128, xshape).astype(np.int8))
    wq = torch.from_numpy(
        rng.randint(-127, 128, (O, xshape[1], kh, kw)).astype(np.int8))
    fn = tq._int8_conv_fn(rng.rand(O).astype(np.float32) * 1e-4, st, pd,
                          dl, 1)
    assert torch.equal(fn(xq.to(dev), wq.to(dev)).cpu(), fn(xq, wq))


@pytest.mark.cuda
def test_cuda_quantize_act_equals_the_cpu():
    dev = _card()
    rng = np.random.RandomState(3)
    s = np.float32(0.37)
    ties = ((rng.randint(-126, 126, 4000).astype(np.float32) + 0.5)
            * s / np.float32(127.0)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([rng.randn(4000).astype(
        np.float32), ties, np.nextafter(ties, np.float32(np.inf))]))
    fn = tq._quant_act_fn(float(s), 127.0)
    assert torch.equal(fn(x.to(dev)).cpu(), fn(x))


def _fit_a_line(place, scope):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
    fluid.Executor(place).run(startup, scope=scope)
    return main, pred.name


@pytest.mark.cuda
def test_cuda_int8_program_graph_equals_eager():
    _card()
    place = fluid.CUDAPlace(0)
    scope = fluid.Scope()
    main, pred = _fit_a_line(place, scope)
    rng = np.random.RandomState(0)
    xb = rng.rand(64, 13).astype("float32")
    q = passes.quantize_for_serving(main, scope, [{"x": xb}], place=place)
    assert all(scope.find_var(n).is_cuda for n in scope.local_var_names()
               if n.endswith("@INT8"))
    exe = fluid.Executor(place)
    for rows in (1, 16, 64):
        want, = exe.run(q, feed={"x": xb[:rows]}, fetch_list=[pred],
                        scope=scope)
        got, = exe.run_graph(q, feed={"x": xb[:rows]}, fetch_list=[pred],
                             scope=scope)
        assert np.array_equal(got, want), rows
    cpu = fluid.Scope()
    for n in scope.local_var_names():
        cpu.set_var(n, scope.find_var(n).cpu())
    on_cpu, = fluid.Executor(fluid.CPUPlace()).run(
        q, feed={"x": xb}, fetch_list=[pred], scope=cpu)
    on_card, = exe.run(q, feed={"x": xb}, fetch_list=[pred], scope=scope)
    assert np.array_equal(on_card, on_cpu)


@pytest.mark.cuda
def test_cuda_int8_artifact_serves_through_the_predictor(tmp_path):
    """An int8 program exported on the card (its rescale vectors are
    constants of the graph) serves through NativePredictor bit-equal to
    ``Executor.run`` at its bucket."""
    from paddle_tpu_torch.inference import (NativeConfig,
                                            create_paddle_predictor)

    _card()
    place = fluid.CUDAPlace(0)
    scope = fluid.Scope()
    main, pred = _fit_a_line(place, scope)
    xb = np.random.RandomState(1).rand(8, 13).astype("float32")
    q = passes.quantize_for_serving(main, scope, [{"x": xb}], place=place)
    exe = fluid.Executor(place)
    d = str(tmp_path / "int8")
    fluid.io.save_inference_model(d, ["x"], [pred], exe, main_program=q,
                                  scope=scope, export_batch_sizes=[8])
    want, = exe.run(q, feed={"x": xb}, fetch_list=[pred], scope=scope)
    p = create_paddle_predictor(NativeConfig(model_dir=d, use_gpu=True))
    got = np.asarray(p.run({"x": xb})[0].data)
    assert np.array_equal(got, want)


def _adam_mlp(offload):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, 256], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.data(name="y", shape=[-1, 1], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.fc(x, size=1024, act="relu")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(h, size=1), y))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    if offload:
        passes.apply_passes([passes.HostOffloadPass()], main)
    return main, startup, loss.name


@pytest.mark.cuda
def test_cuda_offloaded_state_lives_in_pinned_host_memory():
    """Between steps the moments are pinned host tensors and the card's
    allocated bytes drop by their size; losses and state bit-equal."""
    _card()
    place = fluid.CUDAPlace(0)
    rng = np.random.RandomState(11)
    feeds = []
    for _ in range(5):
        xb = rng.rand(32, 256).astype("float32")
        feeds.append({"x": xb, "y": xb.sum(1, keepdims=True)})
    runs = {}
    for offload in (False, True):
        main, startup, loss = _adam_mlp(offload)
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        losses, between = [], []
        for feed in feeds:
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(out.tolist())
            torch.cuda.synchronize()
            between.append(torch.cuda.memory_allocated())
            for n in getattr(main, "_host_offload_state", ()):
                t = scope.find_var(n)
                assert t.device.type == "cpu" and t.is_pinned(), n
        names = getattr(main, "_host_offload_state", ())
        host = sum(scope.find_var(n).numel()
                   * scope.find_var(n).element_size() for n in names)
        state = {v.name: fluid.fetch_var(v.name, scope)
                 for v in main.list_vars() if v.persistable}
        exe.close()
        del exe, scope
        gc.collect()
        runs[offload] = (losses, between, state, host, names)
    (bl, bmem, bstate, _, _), (ol, omem, ostate, host, names) = \
        runs[False], runs[True]
    assert ol == bl
    assert all(np.array_equal(ostate[n], v) for n, v in bstate.items())
    assert host > 0
    # the caching allocator hands out whole blocks (512-byte multiples,
    # a large block unsplit when under 1 MiB would remain): each tensor
    # may free up to that much more than its bytes
    slack = len(names) * ((1 << 20) + 512)
    for b, o in zip(bmem, omem):
        assert 0 <= (b - o) - host <= slack, (b - o, host)


@pytest.mark.cuda
def test_cuda_memory_fraction_caps_a_process():
    _card()
    child = r'''
import torch
from paddle_tpu_torch.core import memory
total = torch.cuda.get_device_properties(0).total_memory
memory.set_memory_fraction(0.1)
assert memory.memory_usage().bytes_limit == int(total * 0.1)
ok = torch.empty(int(total * 0.05), dtype=torch.uint8, device="cuda")
try:
    torch.empty(int(total * 0.2), dtype=torch.uint8, device="cuda")
    raise SystemExit("an allocation past the fraction went through")
except torch.OutOfMemoryError:
    pass
assert memory.memory_usage().bytes_in_use >= ok.numel()
memory.preallocate(True)
assert torch.cuda.memory_reserved() >= int(total * 0.1) * 0.95
print("capped")
'''
    proc = subprocess.run([sys.executable, "-c", child], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "capped" in proc.stdout, proc.stderr
