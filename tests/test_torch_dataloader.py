"""paddle_tpu_torch's input pipeline (``reader.DataLoader``,
``prefetch_to_device``, the reader combinators) and its executor
integration, ported from the loader cases of tests/test_pipeline.py
(the trainer and GPipe cases wait for ``trainer.py`` and the parallel
tier).

The pipeline's contract is the JAX package's: ordering, an exact
in-flight bound, exceptions that keep the reader's traceback, worker
threads that retire when the consumer walks away, ``Executor.run(feed=
loader)`` with ``chunk`` batches a ``run_steps`` call, ragged tails
that keep the return contract and still deliver the end of the pass,
async fetches, profiler spans, and a lint of feed shapes that would
capture a graph per batch. On the CPU the chunked dispatch is a loop of
``run``, so it is held bit-equal to the per-step loop (the JAX package
compares its scan at rtol 1e-5). The ``cuda`` test holds the copies on
the loader's own CUDA stream to the host batches:

    python -m pytest tests/test_torch_dataloader.py -m cuda --noconftest -q
"""

import gc
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import profiler
from paddle_tpu_torch.reader import (DataLoader, buffered,
                                     prefetch_to_device, xmap_readers)

torch.set_num_threads(1)

CPU = fluid.CPUPlace()


def _assert_threads_retire(prefix: str, timeout: float = 5.0):
    """Pipeline worker threads carry a pdtpu- name prefix; after a
    consumer walks away they must exit within their 0.25 s stop-poll."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name.startswith(prefix)]
        if not alive:
            return
        time.sleep(0.05)
    raise AssertionError(f"threads still alive: {alive}")


def _fit_a_line_program():
    """x[13] -> fc 1, summed squared error / 8, SGD(0.05)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[13], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        d = L.elementwise_add(L.fc(input=x, size=1, act=None),
                              L.scale(y, scale=-1.0))
        cost = L.scale(L.reduce_sum(L.elementwise_mul(d, d)), scale=0.125)
        fluid.SGD(learning_rate=0.05).minimize(cost)
    return main, startup, cost


def _line_batches(n_batches, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(13).astype("f"), rng.randn(1).astype("f"))
             for _ in range(batch)] for _ in range(n_batches)]


def _fresh(main, startup):
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    return exe, scope


def test_dataloader_ordering_preserved():
    batches = [[(np.full(13, i, "f"), np.full(1, i, "f"))
                for _ in range(4)] for i in range(50)]
    main, startup, cost = _fit_a_line_program()
    loader = DataLoader(lambda: iter(batches), feed_list=["x", "y"],
                        program=main, buffer_size=3, place=CPU)
    seen = [float(feed["x"][0, 0]) for feed in loader]
    assert seen == [float(i) for i in range(50)]


def test_dataloader_at_most_buffer_size_in_flight():
    produced = []
    consumed = []
    bound = 3

    def reader():
        for i in range(30):
            # the worker takes an in-flight slot BEFORE pulling the next
            # item, so production can lead consumption by at most the
            # buffer size (undelivered) + the one batch in the consumer's
            # hands
            assert len(produced) - len(consumed) <= bound + 1, \
                (len(produced), len(consumed))
            produced.append(i)
            yield {"x": np.full((2, 4), i, "f")}

    loader = DataLoader(reader, buffer_size=bound, place=CPU)
    for feed in loader:
        consumed.append(feed)
        time.sleep(0.005)  # slow consumer: the buffer actually fills
    assert len(produced) == len(consumed) == 30


def test_prefetch_to_device_ordering_and_bound():
    produced = []
    seen = [0]

    def reader():
        for i in range(20):
            # buffer_size=2 undelivered + the one in the consumer's hands
            assert len(produced) - seen[0] <= 3
            produced.append(i)
            yield np.full((3,), i, "f")

    out = []
    for arr in prefetch_to_device(reader, buffer_size=2, place=CPU):
        assert isinstance(arr, torch.Tensor)
        out.append(float(arr[0]))
        seen[0] += 1
        time.sleep(0.002)
    assert out == [float(i) for i in range(20)]


def test_dataloader_exception_propagates_with_traceback():
    def exploding_reader():
        yield {"x": np.ones((2, 2), "f")}
        raise ValueError("boom in reader")

    loader = DataLoader(exploding_reader, buffer_size=2, place=CPU)
    it = iter(loader)
    next(it)
    with pytest.raises(ValueError, match="boom in reader") as ei:
        next(it)
    # the worker-side traceback survives the thread hop
    frames = []
    tb = ei.value.__traceback__
    while tb is not None:
        frames.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    assert "exploding_reader" in frames, frames


def test_dataloader_drives_executor():
    """A fixed-batch DataLoader driving ``Executor.run`` gives the losses
    of the same batches fed as dicts; nothing is captured on the CPU;
    exhaustion raises the reader EOF."""
    batches = _line_batches(4)
    main, startup, cost = _fit_a_line_program()
    exe, ref = _fresh(main, startup)
    feeder = fluid.DataFeeder(feed_list=["x", "y"], program=main)
    want = [exe.run(main, feed=feeder.feed(b), fetch_list=[cost],
                    scope=ref)[0] for b in batches]
    exe, scope = _fresh(main, startup)
    loader = DataLoader(lambda: iter(batches), feed_list=["x", "y"],
                        program=main, place=CPU)
    got = [exe.run(main, feed=loader, fetch_list=[cost.name],
                   scope=scope)[0] for _ in range(4)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert exe.num_compiled == 0
    with pytest.raises(fluid.EOFException):
        exe.run(main, feed=loader, fetch_list=[cost.name], scope=scope)


def test_dataloader_chunked_run_steps_matches_per_step():
    """chunk=3 runs three batches as one ``run_steps`` call; the losses,
    stacked on a leading chunk axis, equal the per-step loop's bit for
    bit (on the CPU run_steps is the loop of run)."""
    batches = _line_batches(6)
    main, startup, cost = _fit_a_line_program()
    exe, scope = _fresh(main, startup)
    loader = DataLoader(lambda: iter(batches), feed_list=["x", "y"],
                        program=main, place=CPU)
    per_step = [float(exe.run(main, feed=loader, fetch_list=[cost.name],
                              scope=scope)[0]) for _ in range(6)]
    exe, scope = _fresh(main, startup)
    loader = DataLoader(lambda: iter(batches), feed_list=["x", "y"],
                        program=main, chunk=3, place=CPU)
    chunked = []
    for _ in range(2):
        out, = exe.run(main, feed=loader, fetch_list=[cost.name],
                       scope=scope)
        assert out.shape[0] == 3  # leading chunk axis
        chunked.extend(float(v) for v in out)
    assert chunked == per_step


def test_async_fetch_handles():
    main, startup, cost = _fit_a_line_program()
    feeder = fluid.DataFeeder(feed_list=["x", "y"], program=main)
    feed = feeder.feed(_line_batches(1)[0])
    exe, s1 = _fresh(main, startup)
    sync, = exe.run(main, feed=feed, fetch_list=[cost.name], scope=s1)
    exe, s2 = _fresh(main, startup)
    handle, = exe.run(main, feed=feed, fetch_list=[cost.name], scope=s2,
                      return_numpy="async")
    assert handle.name == cost.name
    handle.block_until_ready()
    assert handle.is_ready()
    assert float(handle) == float(sync)
    np.testing.assert_array_equal(np.asarray(handle), sync)
    assert "ready" in repr(handle)


def test_pipeline_profiler_spans_recorded():
    """The overlap instrumentation fires: feed_wait (consumer waits),
    h2d (worker conversions), dispatch and fetch_sync."""
    main, startup, cost = _fit_a_line_program()
    exe, scope = _fresh(main, startup)
    profiler.reset_profiler()
    profiler.start_profiler("CPU")
    try:
        loader = DataLoader(lambda: iter(_line_batches(3)),
                            feed_list=["x", "y"], program=main, place=CPU)
        for _ in range(3):
            exe.run(main, feed=loader, fetch_list=[cost.name], scope=scope)
        counts = profiler.event_counts()
        totals = profiler.event_totals()
    finally:
        profiler.stop_profiler(print_report=False)
    assert counts.get("feed_wait", 0) >= 3
    assert counts.get("h2d", 0) >= 3
    assert counts.get("dispatch", 0) >= 3
    assert counts.get("fetch_sync", 0) >= 3
    assert set(counts) == set(totals) and all(t >= 0 for t in
                                              totals.values())
    assert {n for n, _, _ in profiler.get_spans()} >= {"feed_wait", "h2d"}
    assert loader.metrics.batches_total == 3
    assert 0.0 <= loader.metrics.stall_fraction() <= 1.0
    rep = loader.metrics.report()
    assert rep["batches_total"] == 3 and rep["h2d"]["count"] == 3
    profiler.reset_profiler()
    assert profiler.event_counts() == {}


def test_profiler_spans_show_in_a_torch_trace():
    """A RecordEvent opens a ``record_function`` while a torch profiler
    records, so the executor's spans appear in its trace."""
    main, startup, cost = _fit_a_line_program()
    exe, scope = _fresh(main, startup)
    feed = fluid.DataFeeder(["x", "y"], program=main).feed(
        _line_batches(1)[0])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    names = {e.name for e in prof.events()}
    assert {"dispatch", "fetch_sync"} <= names


def test_buffered_abandoned_iteration_no_thread_leak():
    def thousand():
        for i in range(1000):
            yield i

    for i, _ in enumerate(buffered(lambda: thousand(), 4)()):
        if i == 1:
            break
    gc.collect()
    _assert_threads_retire("pdtpu-buffered")


def test_xmap_abandoned_iteration_no_thread_leak():
    def thousand():
        for i in range(1000):
            yield i

    r = xmap_readers(lambda x: x * 2, lambda: thousand(), 3, 4)
    for i, _ in enumerate(r()):
        if i == 1:
            break
    gc.collect()
    _assert_threads_retire("pdtpu-xmap")


def test_dataloader_abandoned_iteration_no_thread_leak():
    def reader():
        for i in range(1000):
            yield {"x": np.full((2, 2), i, "f")}

    loader = DataLoader(reader, buffer_size=2, name="leaktest", place=CPU)
    it = iter(loader)
    next(it)
    next(it)
    loader.close()
    gc.collect()
    _assert_threads_retire("pdtpu-dataloader-leaktest")


def test_xmap_exception_propagates():
    def bad():
        yield 1
        raise RuntimeError("mapper source died")

    with pytest.raises(RuntimeError, match="mapper source died"):
        list(xmap_readers(lambda x: x, lambda: bad(), 2, 4)())


def test_dataloader_recompile_lint_warns_on_pinned_batch():
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[32, 13], dtype="float32",
                   append_batch_size=False)
        L.data(name="y", shape=[1], dtype="float32")
        L.fc(input=x, size=1, act=None)
    loader = DataLoader(lambda: iter(_line_batches(2, batch=16)),
                        feed_list=["x", "y"], program=main, place=CPU)
    with pytest.warns(UserWarning, match="pinned to 32"):
        for _ in loader:
            break
    loader.close()

    # a clean dynamic-batch program stays silent
    main2, _, _ = _fit_a_line_program()
    loader2 = DataLoader(lambda: iter(_line_batches(2, batch=16)),
                         feed_list=["x", "y"], program=main2, place=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in loader2:
            break
    loader2.close()


def test_dataloader_oneshot_iterator_rejected_on_second_pass():
    """A generator object can only supply one pass; epoch 2 must fail
    loudly instead of silently yielding zero batches."""
    def gen():
        for i in range(3):
            yield {"x": np.full((2, 2), i, "f")}

    loader = DataLoader(gen(), buffer_size=2, place=CPU)
    assert len(list(loader)) == 3
    with pytest.raises(fluid.EnforceError, match="one-shot"):
        iter(loader)
    # a list (re-iterable) and a creator both support multiple passes
    items = [{"x": np.zeros((2, 2), "f")}]
    loader2 = DataLoader(items, buffer_size=2, place=CPU)
    assert len(list(loader2)) == len(list(loader2)) == 1


def test_dataloader_dict_reader_recompile_lint():
    """The lint also fires for dict-style readers (no feed_list): the
    feed surface comes from the first batch's keys."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[32, 13], dtype="float32",
                   append_batch_size=False)
        L.data(name="y", shape=[1], dtype="float32")
        L.fc(input=x, size=1)

    def dict_reader():
        yield {"x": np.zeros((16, 13), "f"), "y": np.zeros((16, 1), "f")}

    loader = DataLoader(dict_reader, program=main, place=CPU)
    with pytest.warns(UserWarning, match="pinned to 32"):
        next(iter(loader))
    loader.close()


def test_dataloader_ragged_tail_honors_return_contract():
    """A tail shorter than chunk does not materialize behind the
    caller's back: "async" stays a handle, False stays a tensor."""
    batches = _line_batches(4)
    main, startup, cost = _fit_a_line_program()
    exe, scope = _fresh(main, startup)
    with pytest.warns(UserWarning, match="drop_last=False"):
        loader = DataLoader(lambda: iter(batches), feed_list=["x", "y"],
                            program=main, chunk=3, drop_last=False,
                            place=CPU)
        exe.run(main, feed=loader, fetch_list=[cost.name],
                scope=scope)  # full chunk
    h, = exe.run(main, feed=loader, fetch_list=[cost.name], scope=scope,
                 return_numpy="async")  # 1-batch ragged tail
    assert isinstance(h, fluid.FetchHandle)
    assert isinstance(h.value, torch.Tensor)
    assert np.asarray(h).shape == (1,)

    loader2 = DataLoader(lambda: iter(batches), feed_list=["x", "y"],
                         program=main, chunk=3, drop_last=False,
                         place=CPU, check_recompile=False)
    exe.run(main, feed=loader2, fetch_list=[cost.name], scope=scope)
    dev, = exe.run(main, feed=loader2, fetch_list=[cost.name], scope=scope,
                   return_numpy=False)
    assert isinstance(dev, torch.Tensor) and dev.shape == (1,)


def test_dataloader_ragged_tail_still_delivers_eof():
    """The tail pull swallows the pass's StopIteration; the next run
    still sees EOF instead of silently starting a fresh pass (a chunked
    train loop would otherwise never end)."""
    batches = _line_batches(7)
    main, startup, cost = _fit_a_line_program()
    exe, scope = _fresh(main, startup)
    loader = DataLoader(lambda: iter(batches), feed_list=["x", "y"],
                        program=main, chunk=3, drop_last=False, place=CPU,
                        check_recompile=False)
    for want in (3, 3, 1):  # the last is the ragged tail
        out, = exe.run(main, feed=loader, fetch_list=[cost.name],
                       scope=scope)
        assert out.shape == (want,)
    with pytest.raises(fluid.EOFException):
        exe.run(main, feed=loader, fetch_list=[cost.name], scope=scope)
    # and the pass after the delivered EOF starts fresh
    out, = exe.run(main, feed=loader, fetch_list=[cost.name], scope=scope)
    assert out.shape == (3,)


def test_xmap_passes_none_samples_through():
    """None is a valid sample, not the worker stop sentinel."""
    out = list(xmap_readers(lambda x: x, lambda: iter([None, 1, None]),
                            2, 4)())
    assert len(out) == 3 and out.count(None) == 2 and 1 in out


def test_data_feeder_rows_to_feed():
    main, _, _ = _fit_a_line_program()
    rows = _line_batches(1, batch=5)[0]
    feed = fluid.DataFeeder(["x", "y"], program=main).feed(rows)
    assert feed["x"].shape == (5, 13) and feed["x"].dtype == np.float32
    assert feed["y"].shape == (5, 1)
    np.testing.assert_array_equal(feed["x"][2], rows[2][0])
    with pytest.raises(fluid.EnforceError, match="empty minibatch"):
        fluid.DataFeeder(["x", "y"], program=main).feed([])


@pytest.mark.cuda
def test_cuda_loader_copies_on_its_stream():
    """On the card the loader's batches arrive on the device, equal to
    the host batches, usable on the consumer's stream while the next
    batches are copied; a chunked run over the loader gives the losses
    of ``run_steps`` on the same batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the loader's copy stream")
    place = fluid.CUDAPlace(0)
    rng = np.random.RandomState(0)
    host = [{"x": rng.randn(64, 13).astype("f"),
             "y": rng.randn(64, 1).astype("f")} for _ in range(9)]
    main, startup, cost = _fit_a_line_program()
    loader = DataLoader(lambda: iter(host), program=main, place=place,
                        buffer_size=3)
    for want, got in zip(host, loader):
        assert got["x"].is_cuda
        # work on the consumer's stream reads the copied values
        np.testing.assert_array_equal((got["x"] * 1).cpu().numpy(),
                                      want["x"])
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    p0 = {p.name: fluid.fetch_var(p.name, scope)
          for p in main.all_parameters()}
    loader = DataLoader(lambda: iter(host), program=main, place=place,
                        chunk=3, buffer_size=3)
    got = np.concatenate([exe.run(main, feed=loader, fetch_list=[cost],
                                  scope=scope)[0] for _ in range(3)])
    ref = fluid.Scope()
    exe2 = fluid.Executor(place)
    exe2.run(startup, scope=ref)
    fluid.params_from_numpy(p0, ref, place, program=main)
    want = np.concatenate([exe2.run_steps(main, feed_list=host[i:i + 3],
                                          fetch_list=[cost], scope=ref)[0]
                           for i in (0, 3, 6)])
    np.testing.assert_array_equal(got, want)
