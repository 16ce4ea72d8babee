"""The sweep engine: measure candidate configs, elect one, persist it
(counterpart of paddle_tpu/tuning/sweep.py).

Methodology:

* **dependency-chained calls**: a candidate's measured closure queues
  ``iters`` calls, each fed the previous call's outputs (the paged
  kernel's output is the next query, the fused update works in place on
  the same buffers, a gradient is the next input), so no call can start
  before its predecessor ends (:func:`chained_grad_scan`).
* **device time on the card**: each sample is one pair of CUDA events
  around the ``iters`` queued calls, queued behind a spin kernel
  (``torch.cuda._sleep``) that holds the stream while the host enqueues
  them, so the host's launch cost (145 µs a paged call through its
  custom op) does not pace the card. A sample counts only if every
  call was queued before the spin ended; otherwise the spin grows
  fourfold and the sample is taken again. A candidate whose launches
  overflow the card's queue of pending launches (about 1,024) cannot
  get ahead of any spin; then every candidate of the sweep is timed
  again without the spin (events around the calls, paced by the host
  where the host is slower), so one election compares one yardstick.
  Each measurement records its ``timing``: ``device``, ``host_paced``
  or, on the CPU, ``host`` (the host clock over the plain versions the
  wrappers run there).
* every sample is also a ``tuning/sample`` span and every sweep a
  ``tuning/sweep`` span of the port's profiler, as in the JAX package.
* one unmeasured warm call first (it also builds the kernel library),
  **min-of-samples** per candidate (noise is one-sided), and **early
  pruning**: a candidate whose first sample already exceeds
  ``prune_factor x`` the best time seen skips its remaining samples.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import profiler
from ..core.enforce import enforce
from .registry import TunableKernel, get_tunable
from .store import TunedRecord, TuningStore

SAMPLE_SPAN = "tuning/sample"
SWEEP_SPAN = "tuning/sweep"

SPIN_CYCLES = 10 ** 7  # a few ms of the card's clock
SPIN_TRIES = 4


class _spans_enabled:
    """Make RecordEvent spans record for the enclosed block even when
    no outer profiler session is active (without clobbering one that
    is)."""

    def __enter__(self):
        self._was = profiler._STATE["enabled"]
        profiler._STATE["enabled"] = True
        return self

    def __exit__(self, *exc):
        profiler._STATE["enabled"] = self._was
        return False


def default_device() -> torch.device:
    """The device a sweep measures on when the caller names none: the
    current card. A host without one raises — measuring the CPU's plain
    versions is asked for explicitly (``device="cpu"``)."""
    enforce(torch.cuda.is_available(),
            "tuning: no CUDA device is visible; pass device='cpu' to "
            "time the plain versions on the host")
    return torch.device("cuda", torch.cuda.current_device())


def chained_grad_scan(fn_or_grad: Callable, args,
                      iters: int) -> Callable[[], tuple]:
    """Build the measured closure: ``run()`` queues ``iters`` calls of
    ``fn_or_grad``, each fed the previous call's outputs, and returns
    the last outputs without waiting for the device.

    ``fn_or_grad(*args)`` returns one output per arg, of the arg's
    shape: gradients (``torch.autograd.grad``), an in-place update
    returning its buffers, or the paged kernel's output as the next
    query. Eager torch folds nothing away, so the outputs feed the next
    call as they are (cast to the arg's dtype)."""
    carry = tuple(args)

    def run() -> tuple:
        nonlocal carry
        for _ in range(iters):
            outs = fn_or_grad(*carry)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            carry = tuple(o if o.dtype == a.dtype else o.to(a.dtype)
                          for a, o in zip(carry, outs))
        return carry

    return run


class HostPaced(Exception):
    """A card sample could not be queued ahead of the card: its
    launches overflow the queue of pending launches."""


def _device_sample(run: Callable, iters: int, spin: bool = True) -> float:
    """Device ms per call of one sample on the current card (see the
    module docstring). The card holds about 1,024 pending launches: a
    sample that launches more (a fused_ce call at a small chunk cap
    launches a few hundred kernels per chunk pass) blocks the host
    behind the spin and never gets ahead of it, however long the spin;
    after ``SPIN_TRIES`` spins it raises :class:`HostPaced`. With
    ``spin=False``: events around the calls, paced by the host where
    the host is slower."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = SPIN_CYCLES
    for _ in range(SPIN_TRIES if spin else 1):
        if spin:
            torch.cuda._sleep(cycles)
        start.record()
        run()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead or not spin:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise HostPaced()


def measure_min_ms(run: Callable, iters: int, samples: int = 3,
                   prune_above_ms: Optional[float] = None,
                   device=None, host_paced: bool = False
                   ) -> Optional[float]:
    """min-of-samples per-call milliseconds for one candidate: device
    time on a card, host time on the CPU (``device``: where ``run``
    launches; default the current card). The first ``run()`` is the
    unmeasured warm pass (and builds the kernel). Returns None when the
    candidate was pruned after its first sample (``prune_above_ms``).
    On a card a sample that cannot be queued ahead of the card raises
    :class:`HostPaced`; ``host_paced=True`` takes every sample without
    the spin instead (see ``_device_sample``)."""
    device = torch.device(device) if device is not None \
        else default_device()
    cuda = device.type == "cuda"
    with _spans_enabled():
        if cuda:
            with torch.cuda.device(device):
                run()
                torch.cuda.synchronize()
        else:
            run()
        best: Optional[float] = None
        for s in range(samples):
            with profiler.RecordEvent(SAMPLE_SPAN):
                if cuda:
                    with torch.cuda.device(device):
                        ms = _device_sample(run, iters,
                                            spin=not host_paced)
                else:
                    t0 = time.perf_counter()
                    run()
                    ms = (time.perf_counter() - t0) / iters * 1e3
            best = ms if best is None else min(best, ms)
            if (s == 0 and prune_above_ms is not None
                    and ms > prune_above_ms):
                return None  # early-pruned: not worth more samples
        return best


def sweep(kernel: str, problem: Optional[dict] = None, *,
          dtype: str = "float32", device_kind: Optional[str] = None,
          device=None, iters: int = 8, samples: int = 3,
          prune_factor: float = 4.0,
          subset: Optional[Dict[str, Sequence]] = None,
          store: Optional[TuningStore] = None, force: bool = False,
          publish: bool = True,
          progress: Optional[Callable[[str], None]] = None
          ) -> TunedRecord:
    """Measure every valid candidate for ``(kernel, problem, dtype)``
    on ``device`` (default: the current card) and persist the winner.

    With a store attached and an entry already published for the key,
    returns it WITHOUT re-measuring unless ``force`` — the zero
    re-sweep warm-start contract. A candidate that fails to build or
    launch is recorded with its error (``measurements[i]["error"]``)
    and never elected; the wrappers never give way to a plain version
    on the card, so such an error is the kernel's."""
    from . import api

    k: TunableKernel = get_tunable(kernel)
    device = torch.device(device) if device is not None \
        else default_device()
    device_kind = device_kind or api.current_device_kind(device)
    if problem is None:
        problem = k.default_problem(device_kind)
    bucket = k.bucket_key(problem)
    if store is None:
        store = api.active_store()
    if store is not None and not force:
        existing = store.get(TunedRecord(
            k.name, k.version, device_kind, dtype, bucket,
            k.defaults).key)
        if existing is not None:
            api._count("sweep_reused")
            return existing

    cands = k.candidates(problem, subset=subset)
    enforce(cands, f"{kernel}: no valid candidates for {problem}")
    say = progress or (lambda _m: None)
    api._count("sweeps")
    with _spans_enabled(), profiler.RecordEvent(SWEEP_SPAN):
        timed = _measure_all(k, cands, problem, dtype, iters, samples,
                             prune_factor, device, say, False)
        if timed is None:
            say("  a candidate overflows the card's launch queue: every "
                "candidate timed again host-paced")
            timed = _measure_all(k, cands, problem, dtype, iters, samples,
                                 prune_factor, device, say, True)
    best_cfg, best_ms, measurements = timed
    enforce(best_cfg is not None,
            f"{kernel}: every candidate failed for {problem}")
    rec = TunedRecord(k.name, k.version, device_kind, dtype, bucket,
                      best_cfg, best_ms=best_ms,
                      measurements=measurements, source="sweep")
    if publish and store is not None:
        if not store.put(rec):
            # first publisher won while we swept — serve THEIR entry so
            # every process agrees on one config
            theirs = store.get(rec.key)
            if theirs is not None:
                rec = theirs
    api.seed_memo(rec)
    return rec


def _measure_all(k: TunableKernel, cands, problem, dtype, iters, samples,
                 prune_factor, device, say, host_paced: bool):
    """(best config, its ms, measurements) of every candidate timed one
    way; None when a candidate cannot be timed behind the spin (the
    caller retimes every candidate with ``host_paced``)."""
    from . import api

    timing = ("host" if device.type != "cuda"
              else "host_paced" if host_paced else "device")
    best_cfg, best_ms = None, None
    measurements: List[dict] = []
    for cfg in cands:
        try:
            run = k.build_measure(problem, cfg, dtype, iters, device)
            prune = None if best_ms is None else best_ms * prune_factor
            ms = measure_min_ms(run, iters, samples=samples,
                                prune_above_ms=prune, device=device,
                                host_paced=host_paced)
        except HostPaced:
            return None
        except Exception as e:  # noqa: BLE001 - report per-config
            say(f"  {cfg} FAILED: {e}")
            measurements.append({"config": cfg, "ms": None,
                                 "error": str(e)})
            continue
        api._count("candidates_measured")
        if ms is None:
            say(f"  {cfg} pruned (first sample > {prune_factor:g}x best)")
            measurements.append({"config": cfg, "ms": None,
                                 "pruned": True, "timing": timing})
            continue
        say(f"  {cfg} {ms:8.4f} ms/call ({timing})")
        measurements.append({"config": cfg, "ms": ms, "timing": timing})
        if best_ms is None or ms < best_ms:
            best_cfg, best_ms = cfg, ms
    return best_cfg, best_ms, measurements


def sweep_program(program, *, dtype: str = "float32",
                  store: Optional[TuningStore] = None,
                  force: bool = False, **kw) -> List[TunedRecord]:
    """Sweep every tunable kernel a program's op set reaches, at each
    kernel's default problem — the coarse 'tune this model' entry the
    CLI exposes; per-shape tuning goes through :func:`sweep`."""
    from .registry import tunables_for_ops

    op_types = {op.type for op in program.global_block().ops}
    out = []
    for k in tunables_for_ops(op_types):
        out.append(sweep(k.name, dtype=dtype, store=store, force=force,
                         **kw))
    return out
