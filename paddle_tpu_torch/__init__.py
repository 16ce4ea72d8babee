"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, beside it.

The same Fluid-style program-as-data IR with named scopes and layers;
op fns are torch callables, the Executor runs them eagerly on one
device, and every TPU kernel of paddle_tpu on a ported path is a kernel
written by hand for NVIDIA Hopper (``csrc/``). Entry points run on
``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``.

The slices ported so far serve a causal LM through paged-KV decode::

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import serve_decoding

and train Transformer-base (``append_backward`` + ``Adam`` +
``Executor``), with the mixed-precision recipe of ``bench.py`` — a bf16
activation stream, bf16 moments, flat optimizer state and sparse
embeddings with lazy Adam::

    from paddle_tpu_torch.models.transformer import transformer_base
    fluid.set_flags({"use_bfloat16": True, "bf16_activations": True,
                     "bf16_moments": True, "fuse_optimizer_state": True})
    with fluid.program_guard(main, startup):
        feeds, avg_cost, _ = transformer_base(
            ..., sparse_embedding=True, attn_impl="pallas")
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(avg_cost)

Mixed precision is a program rewrite: ``amp.decorate(opt)`` wraps an
optimizer so ``minimize`` casts the forward to bf16 (f32 master weights
and moments), scales the loss, and skips an overflowed step on the card;
``amp.rewrite_program`` serves a program in bf16. ``GradientAccumulation``
and ``ModelAverage`` wrap an optimizer as in the JAX package::

    fluid.amp.decorate(fluid.optimizer.Adam(1e-4)).minimize(avg_cost)

Its training loop is ``bench.py``'s: ``memory_optimize`` keeps the
state updated in place, ``Executor.run_steps`` runs N steps as one
captured CUDA graph, and ``Executor.run(feed=loader)`` drives it from a
``reader.DataLoader`` that copies batches to the card on its own stream::

    fluid.memory_optimize(main)
    losses, = exe.run_steps(main, feed_list=batches, fetch_list=[avg_cost])
    loader = fluid.reader.DataLoader(reader, place=fluid.CUDAPlace(0),
                                     program=main, chunk=10)
    losses, = exe.run(main, feed=loader, fetch_list=[avg_cost])

Persistence and the training loop: ``io`` saves and loads
variables and the inference and decode models in the JAX package's
files, ``ckpt`` writes atomic checkpoints (dense, elastic, async) and
restores them, and ``Trainer`` runs the epoch/step loop over
``run_steps`` with auto-resumed checkpoints; ``Inferencer`` serves what
a Trainer saved::

    trainer = fluid.Trainer(train_func, optimizer_func,
                            checkpoint_config=fluid.CheckpointConfig(dir))
    trainer.train(num_epochs=1, reader=reader, feed_order=names,
                  steps_per_loop=10)

Exported artifacts: ``io.save_inference_model`` writes the pruned
forward as a ``torch.export`` program per batch bucket, which
``inference.NativePredictor`` (and ``serving.serve_program(<dir>)``)
runs without the Program; ``io.save_trainable_program`` writes the whole
training step, which ``io.load_trainable_program`` continues in another
process. Every kernel is a ``torch.library`` custom op
(``paddle_tpu_torch::*``), so an exported graph runs the hand-written
kernels on a card and their plain versions on the CPU.

The request server (``serving.serve_program``) pads coalesced requests
to bucket shapes, each a captured CUDA graph on the card; the decode
and request servers share ``resilience``' fault plane, circuit breaker
and degradation ladder, and ``obs``' metrics registry and traces.

The sequence tier (``layers/{sequence,rnn,control_flow,beam_search,crf,
ctc}``, ``nets``, ``lod_tensor``, ``metrics``, ``evaluator``) takes
padded sequences with length companions: ``layers.data(...,
lod_level=1)`` declares ``<name>@LEN``, which ``DataFeeder`` fills
while it pads ragged rows; the recurrences are eager loops over the
padded time axis, so a training step of the seq2seq NMT, the stacked
LSTM or the SRL db-lstm replays as a captured CUDA graph::

    words = fluid.layers.data(name="words", shape=[-1, -1, 1],
                              dtype="int64", lod_level=1,
                              append_batch_size=False)
    feed = fluid.DataFeeder([words, label]).feed(rows)  # + "words@LEN"

Several cards (or CPU processes): ``tools.launch`` starts N ranks,
each calls ``parallel.init_distributed()``; then either
``ParallelExecutor`` (AllReduce, or the ZeRO Reduce strategy) or
``sharding.shard_program(main, sharding.training_mesh(data=, fsdp=,
tp=))`` before ``minimize`` and the ordinary ``Executor``: each rank
runs its block of the batch and of the sharded state::

    python -m paddle_tpu_torch.tools.launch --nproc 4 train.py

Fluid's top-level names are here as in the JAX package: the ``io``
save/load functions, the gradient clips, ``get_var``, ``calc_gradient``,
``WeightNormParamAttr``, the places (``TPUPlace`` is ``CUDAPlace``;
``CUDAPinnedPlace`` is pinned host memory), ``default_place`` and
``force_cpu`` (the CPU as the process's default place). ``fleet`` serves
a causal LM from several replicas behind a prefix-affinity router::

    from paddle_tpu_torch import fleet

This package imports neither jax nor paddle_tpu.
"""

from . import (amp, analysis, average, checkpoint, ckpt, clip,
               compile_cache, debugger, evaluator, inference, io, layers,
               lod_tensor, metrics, nets, obs, optimizer, parallel, passes,
               profiler, reader, regularizer, resilience, sharding,
               timeline, tuning)
from .parallel import (BuildStrategy, DistributeTranspiler,
                       DistributeTranspilerConfig, ExecutionStrategy,
                       ParallelExecutor, make_mesh)
from . import initializer_api as initializer  # noqa: F401
from .backward import append_backward, calc_gradient
from .ckpt import CheckpointConfig
from .clip import (ErrorClipByValue, GradientClipByGlobalNorm,
                   GradientClipByNorm, GradientClipByValue,
                   set_gradient_clip)
from .convert import params_from_numpy, state_from_numpy
from .core import (CPUPlace, CUDAPinnedPlace, CUDAPlace, EnforceError,
                   EOFException, GraphCaptureError, Operator, Parameter,
                   Program, Scope, TPUPlace, Variable, default_main_program,
                   default_startup_program, get_var, global_scope,
                   program_guard, scope_guard, switch_main_program,
                   switch_startup_program)
from .core import flags as _flags
from .core import unique_name
from .core.flags import get_flag
from .core.place import default_place, force_cpu, is_compiled_with_tpu
# legacy top-level pass API (core.passes shim semantics: unchecked,
# unstamped); the checked manager is paddle_tpu_torch.passes
from .core.passes import (PassManager, ProgramPass, apply_passes, get_pass,
                          list_passes, register_pass)
from .data_feeder import DataFeeder
from .executor import Executor, FetchHandle, fetch_var
from .inference_transpiler import InferenceTranspiler, transpile_to_bfloat16
from .inferencer import Inferencer
from .io import (load_inference_model, load_params, load_persistables,
                 load_vars, save_inference_model, save_params,
                 save_persistables, save_vars)
from .lod_tensor import (LoDTensor, LoDTensorArray, create_lod_tensor,
                         create_random_int_lodtensor)
from .memory_optimization_transpiler import memory_optimize, release_memory
from .optimizer import (SGD, Adadelta, AdadeltaOptimizer, Adagrad,
                        AdagradOptimizer, Adam, Adamax, AdamaxOptimizer,
                        AdamOptimizer, DecayedAdagrad,
                        DecayedAdagradOptimizer, Ftrl, FtrlOptimizer,
                        GradientAccumulation, ModelAverage,
                        Momentum, MomentumOptimizer, ProximalAdagrad,
                        ProximalAdagradOptimizer, ProximalGD,
                        ProximalGDOptimizer, RMSProp, RMSPropOptimizer,
                        SGDOptimizer)
from .param_attr import ParamAttr, WeightNormParamAttr
from .quantize_transpiler import QuantizeTranspiler
from .reader.prefetch import batch
from .trainer import (BeginEpochEvent, BeginStepEvent, EndEpochEvent,
                      EndStepEvent, Trainer)

import numpy as _np

# Fluid's ``fluid.Tensor`` (the pybind LoDTensor base), as the JAX
# package has it: host arrays are numpy
Tensor = _np.ndarray


def set_flags(d):
    """Set global flags from a dict (``core.flags.set_flags``)."""
    _flags.set_flags(d)

# flight-recorder auto-enable (obs.record): the obs_record flag
# (PDTPU_OBS_RECORD) names a bundle dir, and an inherited
# PDTPU_RECORD_DIR means a supervising parent wants this worker's black
# box collected there. PDTPU_RECORD_DIR wins: it is the parent's
# explicit per-worker dir, while the flag may be ambient env inherited
# from that same parent. Absent both (the default), nothing runs.
import os as _os

_record_dir = (_os.environ.get(obs.record.ENV_VAR)
               or get_flag("obs_record"))
if _record_dir:
    obs.record.enable(dir=_record_dir,
                      interval_s=float(get_flag("obs_record_interval_s")
                                       or 1.0))
