"""High-level event-driven Trainer (counterpart of paddle_tpu/trainer.py;
reference: python/paddle/fluid/trainer.py:167).

``train_func`` builds the loss graph, ``optimizer_func`` supplies the
optimizer, and training runs an epoch/step event loop with
BeginEpoch/EndEpoch/BeginStep/EndStep callbacks on one device (the card
unless ``place=CPUPlace()``). :class:`~paddle_tpu_torch.ckpt.
CheckpointConfig` gives periodic, atomic, auto-resumed checkpoints
(reference: trainer.py:98,637,737): a new Trainer over the same
``train_func`` restores the newest valid checkpoint of its directory —
every persistable: parameters, flat groups, optimizer moments, the
learning rate, the dropout counter — and resumes at the step after it.

``steps_per_loop > 1`` runs each group of that many batches as one
``Executor.run_steps`` call (on a card a captured CUDA graph), capped to
the checkpoint interval. A checkpoint restored into a Trainer whose
graph is already captured is honoured by the next replay: the executor
copies a scope tensor that was replaced into the graph's buffer first.

Each step fires the ``trainer.step`` fault point (``resilience``).
``steplog=`` (a path or an ``obs.StepLogger``) appends one StepStats
JSON line per step, on the eager, ``steps_per_loop`` and DataLoader
paths alike; a train loop dying on an unhandled exception hands it to
the flight recorder (``obs.record``) before it propagates.

``parallel=True`` runs the steps through the ParallelExecutor over the
ranks of the ``torch.distributed`` world (``parallel.init_distributed``
first in each rank): each rank trains on its slice of every batch.

Not ported: the supervisor heartbeat of each step (Queue A 10).
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import ckpt
from .ckpt import CheckpointConfig
from .core import unique_name
from .core.enforce import EnforceError, EOFException, enforce, not_ported
from .core.place import default_place
from .core.program import Program, program_guard
from .core.scope import Scope, scope_guard
from .data_feeder import DataFeeder
from .executor import Executor
from .io import save_inference_model, save_persistables

__all__ = ["BeginEpochEvent", "BeginStepEvent", "CheckpointConfig",
           "EndEpochEvent", "EndStepEvent", "Trainer"]


class BeginEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id: int, step_id: int):
        self.epoch = epoch_id
        self.step = step_id
        # parity with reference: handler may request metrics this step
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id: int, step_id: int, metrics: List):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class Trainer:
    """reference: python/paddle/fluid/trainer.py:167.

    Args:
        train_func: returns ``loss`` or ``[loss, *metrics]``; called under
            ``program_guard`` (and a fresh ``unique_name`` space) to
            populate the train program.
        optimizer_func: returns an Optimizer instance.
        param_path: a ``save_persistables`` directory loaded after the
            startup program.
        place: device place (default: ``CUDAPlace(0)``).
        parallel: not ported (raises).
        checkpoint_config: enables periodic checkpoints + auto-resume.
        steplog: per-step run telemetry (``obs.steplog``): a path or a
            ``StepLogger``; every step appends one StepStats JSON line
            (live-tail with ``python -m paddle_tpu_torch.tools.top``).
            None (default) = off.
    """

    def __init__(self,
                 train_func: Callable,
                 optimizer_func: Callable,
                 param_path: Optional[str] = None,
                 place=None,
                 parallel: bool = False,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 steplog=None):
        if isinstance(steplog, str):
            from .obs.steplog import StepLogger

            steplog = StepLogger(steplog)
        self._steplog = steplog
        self.place = place if place is not None else default_place()
        self.parallel = parallel
        self.checkpoint_cfg = checkpoint_config
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()

        # fresh name space per Trainer so two Trainers over the same
        # train_func produce identical parameter names (save/load parity)
        with unique_name.guard(), \
                program_guard(self.train_program, self.startup_program):
            ret = train_func()
            if isinstance(ret, (list, tuple)):
                self.train_func_outputs = list(ret)
            else:
                self.train_func_outputs = [ret]
            loss = self.train_func_outputs[0]
            self.loss = loss
            optimizer = optimizer_func()
            optimizer.minimize(loss)
        self.test_program = self.train_program.clone(for_test=True)

        self.exe = Executor(self.place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program, scope=self.scope)
            if param_path:
                from .io import load_persistables

                load_persistables(self.exe, param_path,
                                  main_program=self.train_program,
                                  scope=self.scope)

        self._pe = None
        if self.parallel:
            from .parallel import ParallelExecutor, num_trainers

            if checkpoint_config and num_trainers() > 1:
                raise not_ported(
                    "Trainer(parallel=True) checkpoints across ranks "
                    "(multi-process elastic saves)",
                    "Queue A 9, multi-GPU (g2)")

            self._pe = ParallelExecutor(loss_name=loss.name,
                                        main_program=self.train_program,
                                        scope=self.scope, place=self.place)

        if self.checkpoint_cfg:
            # lint the checkpoint against the train program's symbol
            # table, then write it into the scope (one write per flat
            # buffer)
            state, args = ckpt.restore(
                self.checkpoint_cfg.checkpoint_dir,
                program=self.train_program, scope=self.scope,
                place=self.place)
            if state is not None and args:
                self.checkpoint_cfg.epoch_id = int(args.get("epoch_id", 0))
                self.checkpoint_cfg.step_id = int(args.get("step_id", 0))
                # data-position state for a checkpointable reader
                self._resume_reader_state = args.get("reader_state")

    # ------------------------------------------------------------------
    def _tick(self):
        """Per-step hook: the ``trainer.step`` fault point. (The JAX
        package also beats the supervisor's heartbeat here; the
        supervisor waits for ROADMAP Queue A 10.)"""
        from .resilience import faults

        faults.fire("trainer.step")
        self._steps_done = getattr(self, "_steps_done", 0) + 1

    def _run_step(self, feed: Dict[str, np.ndarray], fetch_names):
        self._tick()
        if self._pe is not None:
            return self._pe.run(feed=feed, fetch_list=fetch_names)
        return self.exe.run(self.train_program, feed=feed,
                            fetch_list=fetch_names, scope=self.scope)

    def _drain_saves(self) -> None:
        """Wait for pending async checkpoint writes, even when the loop
        raised — a background failure must surface, but never mask the
        loop's own error."""
        if not hasattr(self, "_async_saver"):
            return
        if sys.exc_info()[0] is None:
            self._async_saver.wait()
        else:
            try:
                self._async_saver.wait()
            except Exception:
                pass

    def train(self,
              num_epochs: int,
              event_handler: Optional[Callable] = None,
              reader: Optional[Callable] = None,
              feed_order: Optional[Sequence[str]] = None,
              steps_per_loop: int = 1,
              log_every: int = 1):
        """Epoch/step loop with events (reference: trainer.py:376).

        ``reader`` may be a :class:`paddle_tpu_torch.reader.DataLoader` —
        then training runs the OVERLAPPED pipeline: the loader's worker
        stages the next batch while a step runs, steps dispatch with
        non-blocking fetches, and the host waits for metrics only every
        ``log_every`` steps (off-boundary EndStepEvents carry
        :class:`~paddle_tpu_torch.executor.FetchHandle` metrics). Feed
        order and chunking are the loader's job there.

        ``steps_per_loop > 1`` groups that many reader batches into ONE
        ``Executor.run_steps`` call. Step events still fire once per step
        with that step's metrics, and the trained state is bit-identical
        to steps_per_loop=1, BUT all steps of a group run before the
        BeginStepEvents of steps 2..n fire, and the first BeginStepEvent
        decides ``fetch_metrics`` for the whole group. Checkpoints land on
        group boundaries, and a group is capped to the checkpoint's
        ``step_interval``. Partial groups (an epoch's ragged tail, a
        shape boundary) run per step."""
        event_handler = event_handler or (lambda e: None)
        if self._steplog is not None:
            event_handler = self._steplog.wrap_events(
                event_handler, executor=self.exe, scope=self.scope)
        if reader is None:
            raise EnforceError("train() needs a reader")
        if getattr(reader, "_pdtpu_dataloader", False):
            return self._train_pipeline(num_epochs, event_handler, reader,
                                        log_every)
        feeder = self._make_feeder(feed_order)
        fetch_names = [v.name for v in self.train_func_outputs]
        # resume point: a checkpoint stores the NEXT (epoch, step) to run,
        # so completed work is never replayed on restart
        start_epoch = (self.checkpoint_cfg.epoch_id
                       if self.checkpoint_cfg else 0)
        resume_step = (self.checkpoint_cfg.step_id
                       if self.checkpoint_cfg else 0)
        self._active_reader = reader
        # a checkpointable reader restores its own data position and
        # fast-forwards internally
        step_base = 0
        rstate = getattr(self, "_resume_reader_state", None)
        if rstate is not None and hasattr(reader, "load_state_dict"):
            reader.load_state_dict(rstate)
            step_base = resume_step
            resume_step = 0
            self._resume_reader_state = None

        try:
            with scope_guard(self.scope):
                for epoch_id in range(start_epoch, num_epochs):
                    event_handler(BeginEpochEvent(epoch_id))
                    skip_until = (resume_step
                                  if epoch_id == start_epoch else 0)
                    group = max(1, int(steps_per_loop))
                    if (self.checkpoint_cfg is not None
                            and self.checkpoint_cfg.step_interval
                            is not None):
                        # checkpoints land on group boundaries: a group
                        # longer than step_interval would coarsen them
                        group = min(group,
                                    self.checkpoint_cfg.step_interval)

                    def flush(pending):
                        if not pending:
                            return
                        first = BeginStepEvent(epoch_id, pending[0][0])
                        event_handler(first)
                        want = fetch_names if first.fetch_metrics else []
                        if len(pending) < max(group, 2):
                            # a partial group or steps_per_loop=1: per
                            # step (a graph per ragged length would
                            # capture the whole step again)
                            for i, (sid, feed) in enumerate(pending):
                                if i:
                                    event_handler(
                                        BeginStepEvent(epoch_id, sid))
                                metrics = self._run_step(feed, want)
                                event_handler(EndStepEvent(
                                    epoch_id, sid, metrics))
                        else:
                            self._tick()  # one call per group
                            if self._pe is not None:
                                stacked = self._pe.run_steps(
                                    feed_list=[f for _, f in pending],
                                    fetch_list=want)
                            else:
                                stacked = self.exe.run_steps(
                                    self.train_program,
                                    feed_list=[f for _, f in pending],
                                    fetch_list=want, scope=self.scope)
                            for i, (sid, _) in enumerate(pending):
                                if i:  # first BeginStep already fired
                                    event_handler(
                                        BeginStepEvent(epoch_id, sid))
                                event_handler(EndStepEvent(
                                    epoch_id, sid,
                                    [m[i] for m in stacked]))
                        last_sid = pending[-1][0]
                        cfg = self.checkpoint_cfg
                        if (cfg and cfg.step_interval is not None and
                                (last_sid + 1) // cfg.step_interval >
                                pending[0][0] // cfg.step_interval):
                            self._save_checkpoint(epoch_id, last_sid + 1)
                        pending.clear()

                    pending: list = []  # [(step_id, feed)]
                    head_shapes = None  # shape signature of pending[0]
                    for step_id, data in enumerate(reader(),
                                                   start=step_base):
                        if step_id < skip_until:
                            continue
                        feed = feeder.feed(data)
                        # a group must be shape-uniform to stack: flush
                        # early at every shape boundary
                        if group > 1:
                            shapes = {n: np.shape(v)
                                      for n, v in feed.items()}
                            if pending and shapes != head_shapes:
                                flush(pending)
                            if not pending:
                                head_shapes = shapes
                        pending.append((step_id, feed))
                        if len(pending) >= group:
                            flush(pending)
                    flush(pending)
                    step_base = 0
                    event_handler(EndEpochEvent(epoch_id))
                    if (self.checkpoint_cfg and
                            (epoch_id + 1) %
                            self.checkpoint_cfg.epoch_interval == 0):
                        self._save_checkpoint(epoch_id + 1, 0)
        except Exception as e:
            # flight-recorder hook: a train loop dying on an unhandled
            # exception dumps a post-mortem bundle before the error
            # propagates (one None check while the recorder is off)
            from .obs import record as obs_record

            obs_record.record_exception(e, context="trainer.train")
            raise
        finally:
            self._drain_saves()

    def _train_pipeline(self, num_epochs: int, event_handler: Callable,
                        loader, log_every: int) -> None:
        """Overlapped training over a reader.DataLoader: with
        ``loader.chunk == 1`` one ``Executor.run`` a batch with async
        fetches, metrics materialized every ``log_every`` steps; with
        ``loader.chunk > 1`` one ``run_steps`` call a chunk
        (``Executor.run(feed=loader)``), step events fired from the
        chunk's stacked metrics. Checkpoints follow the classic contract:
        step_interval crossings save mid-epoch and a resumed Trainer skips
        the first epoch's trained batches."""
        enforce(self._pe is None,
                "the DataLoader pipeline drives the single-program "
                "Executor; with parallel=True feed batches through "
                "ParallelExecutor.run instead")
        fetch_names = [v.name for v in self.train_func_outputs]
        log_every = max(1, int(log_every))
        chunk = max(1, int(getattr(loader, "chunk", 1)))
        cfg = self.checkpoint_cfg
        start_epoch = cfg.epoch_id if cfg else 0
        resume_step = cfg.step_id if cfg else 0

        def maybe_step_ckpt(epoch_id, first_sid, last_sid):
            if (cfg and cfg.step_interval is not None and
                    (last_sid + 1) // cfg.step_interval >
                    first_sid // cfg.step_interval):
                self._save_checkpoint(epoch_id, last_sid + 1)

        try:
            with scope_guard(self.scope):
                for epoch_id in range(start_epoch, num_epochs):
                    event_handler(BeginEpochEvent(epoch_id))
                    it = iter(loader)
                    step_id = 0
                    # resume point: skip the first epoch's completed
                    # batches without running them
                    skip = resume_step if epoch_id == start_epoch else 0
                    while step_id < skip:
                        try:
                            next(it)
                        except StopIteration:
                            break
                        step_id += 1
                    if chunk == 1:
                        for feed in it:
                            begin = BeginStepEvent(epoch_id, step_id)
                            event_handler(begin)
                            want = (fetch_names if begin.fetch_metrics
                                    else [])
                            self._tick()
                            handles = self.exe.run(
                                self.train_program, feed=feed,
                                fetch_list=want, scope=self.scope,
                                return_numpy="async")
                            if (step_id + 1) % log_every == 0:
                                metrics = [h.numpy() for h in handles]
                            else:
                                metrics = list(handles)
                            event_handler(EndStepEvent(epoch_id, step_id,
                                                       metrics))
                            maybe_step_ckpt(epoch_id, step_id, step_id)
                            step_id += 1
                    else:
                        while True:
                            # dispatch BEFORE any step event: a
                            # BeginStepEvent never fires for a step that
                            # will not run
                            self._tick()
                            try:
                                handles = self.exe.run(
                                    self.train_program, feed=loader,
                                    fetch_list=fetch_names,
                                    scope=self.scope, return_numpy="async")
                            except EOFException:
                                break
                            arrs = [h.numpy() for h in handles]
                            n = arrs[0].shape[0] if arrs else chunk
                            first_sid = step_id
                            for i in range(n):
                                begin = BeginStepEvent(epoch_id, step_id)
                                event_handler(begin)
                                metrics = ([a[i] for a in arrs]
                                           if begin.fetch_metrics else [])
                                event_handler(EndStepEvent(
                                    epoch_id, step_id, metrics))
                                step_id += 1
                            maybe_step_ckpt(epoch_id, first_sid,
                                            step_id - 1)
                    event_handler(EndEpochEvent(epoch_id))
                    if cfg and (epoch_id + 1) % cfg.epoch_interval == 0:
                        self._save_checkpoint(epoch_id + 1, 0)
        except Exception as e:
            # the classic loop's flight-recorder hook
            from .obs import record as obs_record

            obs_record.record_exception(e, context="trainer.train")
            raise
        finally:
            loader.close()
            self._drain_saves()

    def test(self, reader: Callable,
             feed_order: Optional[Sequence[str]] = None) -> List[float]:
        """Average the train_func outputs over a test reader
        (reference: trainer.py:404)."""
        feeder = self._make_feeder(feed_order)
        fetch_names = [v.name for v in self.train_func_outputs]
        totals = None
        count = 0
        with scope_guard(self.scope):
            for data in reader():
                feed = feeder.feed(data)
                vals = self.exe.run(self.test_program, feed=feed,
                                    fetch_list=fetch_names, scope=self.scope)
                vals = [float(np.mean(v)) for v in vals]
                totals = (vals if totals is None
                          else [a + b for a, b in zip(totals, vals)])
                count += 1
        if not count:
            return []
        return [t / count for t in totals]

    def save_params(self, param_path: str) -> None:
        save_persistables(self.exe, param_path,
                          main_program=self.train_program, scope=self.scope)

    def save_inference_model(self, param_path: str,
                             feeded_var_names: Sequence[str],
                             target_var_indexes: Sequence[int]) -> None:
        targets = [self.train_func_outputs[i] for i in target_var_indexes]
        save_inference_model(param_path, list(feeded_var_names), targets,
                             self.exe, main_program=self.test_program,
                             scope=self.scope)

    def stop(self):
        # executors hold no daemon resources; only pending async
        # checkpoint writes need draining (reference parity: Trainer.stop)
        if hasattr(self, "_async_saver"):
            self._async_saver.close()
            del self._async_saver
        if self._steplog is not None:
            self._steplog.close()

    # ------------------------------------------------------------------
    def _make_feeder(self, feed_order) -> DataFeeder:
        gb = self.train_program.global_block()
        if feed_order is None:
            feed_vars = [v for v in gb.vars.values()
                         if getattr(v, "is_data", False)]
        else:
            feed_vars = [gb.var(name) for name in feed_order]
        return DataFeeder(feed_list=feed_vars, place=self.place,
                          program=self.train_program)

    def _save_checkpoint(self, epoch_id: int, step_id: int) -> None:
        # hand the savers the scope's values: each save copies them to
        # the host before it returns (ckpt.manifest.snapshot_state), so
        # the next step may update them in place at once
        state = {n: self.scope.find_var(n)
                 for n in self.scope.local_var_names()}
        trainer_args = {"epoch_id": epoch_id, "step_id": step_id}
        rd = getattr(self, "_active_reader", None)
        if rd is not None and hasattr(rd, "state_dict"):
            trainer_args["reader_state"] = rd.state_dict()
        cfg = self.checkpoint_cfg
        enforce(cfg is not None, "no checkpoint_config")
        if cfg.async_save:
            if not hasattr(self, "_async_saver"):
                self._async_saver = ckpt.AsyncCheckpointSaver(
                    cfg.checkpoint_dir,
                    max_num_checkpoints=cfg.max_num_checkpoints)
            self._async_saver.save(state, trainer_args=trainer_args)
            return
        ckpt.save_checkpoint(
            cfg.checkpoint_dir, state,
            trainer_args=trainer_args,
            max_num_checkpoints=cfg.max_num_checkpoints)
