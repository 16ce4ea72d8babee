#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path on one NVIDIA card and hold every
kernel of that path to its plain torch version.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc.
Phases, one JSON line each (or one per shape):

1. device  — the card's name and power limit (nvidia-smi); builds the
             kernels from csrc/ (paged_attention.cu, flash_attention.cu,
             fused_optimizer.cu, dropout.cu; one nvcc each, started
             together) and
             reports the build seconds, ptxas' register/spill report, and
             each flash kernel's shared bytes and blocks an SM.
2. kernel  — ``ops.paged_window_attention`` (the CUDA kernels) against
             ``ops.plain_window_attention`` on the card at the decode
             shapes (B in {1, 16}, T in {1, 4}, H=8, D=64, block 16,
             32 pages per sequence; random cached lengths, -1 padding
             pages, one inactive row), f32 and bf16 pools, also at
             the suffix windows T in {64, 512}; and int8 pools (the same
             K/V quantized per slot, f32 scales) with f32 and bf16
             queries at T in {1, 4, 64, 512}; and the speculative verify
             window T=9 (B=16, f32). Each row checks the route
             the planner gives (split at T <= 8, query tile past it,
             never generic) and runs the generic route's kernel (called
             directly) beside it. Max abs error over rows with a
             valid key for both, finiteness everywhere, and two clocks
             for the kernel, the generic kernel, the plain version and
             ``F.scaled_dot_product_attention`` over the pre-gathered
             (for int8: and dequantized) window (gather excluded): wall
             ms per call from CUDA events around back-to-back calls
             (the host's launch rate at small shapes) and device ms per
             call (``device_ms``: the same calls queued behind a spin
             kernel, so the card runs them back to back), the four in
             turns on the same inputs; beside the byte/flop bound.
3. serving — ``serve_decoding`` of a Transformer-base-width causal LM
             (vocab 32000, 6 layers, 8 heads, d_model 512, FFN 2048;
             random weights from a numpy seed) on ``CUDAPlace(0)``
             answering 16 concurrent requests (prompts of 16-200 tokens,
             32 new tokens each; all queued, then the session started,
             so every run batches them alike), every bucket a captured
             CUDA graph (the warm-up captures them, timed alone), and
             the same burst on the eager engine
             (``DecodeEngine(_capture=False)``). Checks every request
             completes, graphs = ``warm_bucket_count()`` after warm-up
             and after the burst (0 eager), the kernel launched at least
             6 times per decode step (replays counted), all on the split
             route (none on the generic one), the captured streams equal
             the eager ones, and two streams equal greedy decoding by
             the full unpaged forward. Reports both runs' tokens/s,
             decode-step ms, TTFT, warm-up s and memory, the memory the
             warm-up reserves with one graph pool shared by the buckets
             against a pool per graph, and one decode step of 16 rows of
             each engine profiled (host wall, device busy, launches,
             idle share).
4. flash   — the three flash-attention kernels (``flash_fwd``,
             ``flash_bwd_dq``, ``flash_bwd_dkv``) against
             ``plain_flash_forward`` / ``plain_flash_backward`` on the
             card: the training path's shape (B=32, T=256, H=8, D=64)
             unmasked, causal and key-masked (ragged tails), a ragged
             cross shape (Tq=200, Tk=333), the long-context shape (B=4,
             T=2048) plain and causal, D=128 (B=4, T=512, H=4, causal,
             key-masked) and BERT-base's phase-1 shape (B=64, T=128,
             H=12, D=64, key-masked), each in f32 and bf16.
             o within 1e-4 (f32) / 3e-2 (bf16), lse within 1e-4,
             dq/dk/dv within 1e-3 / 3e-2 of their max magnitude (sums
             run in another order), all finite; the bf16 o also within
             one bf16 ulp per element (plus 1e-3 of max |o|) of both
             ``plain_flash_forward`` and ``plain_flash_forward_bf16``
             (the model of its rounding: p as two bf16 parts), and bf16
             dq/dk/dv within one bf16 ulp (plus 1e-3 of max |grad|) of
             ``plain_flash_backward_bf16``, the model of the bf16
             backward kernels' rounding of p and ds. CUDA-event times of each
             kernel, its bound, the plain versions and
             ``F.scaled_dot_product_attention`` (forward, and its
             backward alone); at the key-masked training shape, the
             long-context shapes, D=128 and BERT's shape also device
             times
             (``device_ms``, ``plain_device_ms``, ``sdpa_device_ms``).
5. routes  — ``attn_impl="fused"`` (plain torch attention) against
             ``"pallas"`` (the kernels), forward and forward+backward, at
             T=256 and T=2048, key-masked and causal: the measurements a
             card rule for ``attn_impl=None`` needs.
6. training — ``transformer_base`` (vocab 32000, 6 layers, 8 heads,
             d_model 512, FFN 2048, f32, dropout 0) + ``Adam`` +
             ``Executor`` on ``CUDAPlace(0)``, B=32, T=256 with ragged
             masks, from numpy-seeded weights, built twice: with
             ``attn_impl="pallas"`` and ``"fused"``. Step 0's loss
             (rel 1e-5) and the gradients of the source embedding, the
             first encoder Q weight and the last decoder FFN weight
             agree between the two, within 1e-3 of their max or twice
             the distance between the fused step on the card and on the
             host CPU (the f32 noise floor of that gradient); each flash
             kernel launches exactly 18 times a step (one forward
             pass); 10 Adam steps give finite losses ending below step
             0's. Step
             ms, tokens/s, peak memory, and one profiled step split by
             kernel family with the device's idle share.
7. fused_update — ``fused_flat_update`` (the CUDA kernel) against
             ``plain_flat_update`` on the card, every kind and branch:
             SGD, Adagrad and Adam (Adam with and without the
             beta-power advance) at N = the recipe's flat group size;
             Momentum (plain, Nesterov), Adamax (with and without its
             beta-power advance), DecayedAdagrad, Adadelta, RMSProp
             (plain, centered with momentum), Ftrl (lr_power -0.5 and
             -0.25), ProximalGD and ProximalAdagrad at N = ResNet-50's
             flat group (25,557,032); each with f32 and bf16 moments,
             and each also at a ragged N = 128*4099+37; and Adam at
             BERT-base's flat group (bf16 moments), DeepFM's and the
             seq2seq NMT's (f32 moments). Every output
             bit-equal (max abs error 0) and finite. CUDA-event ms of
             the kernel and the plain version, the bound (bytes read and
             written once over 3.35 TB/s), and a torch fused optimizer
             over the same flat tensors with f32 state where one
             computes the same update — ``torch._fused_adam_`` for
             Adam, ``torch._fused_sgd_`` with a momentum buffer for
             Momentum (``nesterov=True`` for Nesterov) and with
             ``momentum=0`` for SGD, ``torch._fused_adagrad_`` for
             Adagrad (its error recorded where this torch lacks it on
             the card) — a time yardstick only.
7b. amp   — (run after phase 7) mixed precision. (a) ``amp_gate``: the
             fused update gated on a device flag (``apply``) against the
             gated ``plain_flat_update``, every kind and branch, f32 and
             bf16 moments, with and without the beta-power advance,
             each flag value (Adam at the recipe's group size, the rest
             at ResNet-50's): bit-equal, and a false flag leaves every
             buffer as it was and hands out the step-start powers; the
             recipe's group timed ungated, gated true and gated false
             beside ``torch._fused_adam_(found_inf=)`` with each value,
             the bound (a skipped step reads the flag and the powers).
             (b) ``amp_recipe``: ``bench_amp.py``'s build at its
             accelerator config under ``amp.decorate(Adam(1e-4))``,
             with ``attn_impl="pallas"`` and ``fuse_optimizer_state``,
             ``memory_optimize``, the training phases' batch: 10 eager
             steps and one ``run_steps`` call of 10 from the same start
             bit-equal, 18 launches of each flash kernel and one gated
             update a group a step, losses within rtol 0.15 of the same
             program without AMP (mean relative gap under 5 %); step
             ms, tokens/s, peak memory, MFU over the bf16 peak, the
             ratio over f32. (c) ``amp_overflow``: the loss scale set on
             the card, then one ``run_steps`` call of 8 whose steps 3
             and 4 carry an inf token weight: the parameters, both
             moments and both beta powers held bit for bit across them,
             ``found_inf`` set at them, the scale halved at the second,
             training after. (d) ``amp_accumulation``:
             ``GradientAccumulation(Adam, 4)`` in f32, four micro-steps
             of B=8 against one B=32 step on the same tokens (full
             masks): bit-unchanged after micro-steps 1-3; the fourth's
             mean gradient and update bit-equal to their recomputation
             from the four micro-batches' gradients (the sum from zeros,
             over 4, one ``fused_flat_update``); the micro-batches' mean
             loss within 1e-5 of the B=32 loss; the parameters' distance
             from the B=32 step's reported (the elements beyond 1e-5 of
             their max counted). (e) ``amp_serving``
             (run after phase 3): ``amp.rewrite_program`` of phase 3's
             causal LM served with phase 3's burst: bf16 pools, every
             paged launch on them (split route at decode), the kernel
             on bf16 pools within 3e-2 of its plain version; tokens/s,
             decode-step ms, TTFT, and the share of tokens equal to the
             f32 greedy streams (reported, not enforced).
8. recipe  — ``bench.py``'s recipe: ``transformer_base`` at the widths
             above with ``sparse_embedding=True``, ``attn_impl="pallas"``,
             ``Adam(1e-4)`` and the flags ``use_bfloat16``,
             ``bf16_activations``, ``bf16_moments`` and
             ``fuse_optimizer_state``, B=32, T=256, ragged masks, 10
             steps. The fused kernel launches once per group per step and
             each flash kernel 18 times a step; the loss is finite and
             falls; step 0's loss is within rel 1e-5 of the same program
             built without ``fuse_optimizer_state`` (the same forward),
             and after two steps every dense parameter is within 1e-6 of
             its max of that route's. Step ms (mean, p50), tokens/s, peak
             memory, launches per step, the device idle share and device
             ms by family (``fused_update`` one of them).
9. run_steps — ``bench.py``'s training loop on the recipe:
             ``memory_optimize(main)``, then ``Executor.run_steps`` (a
             captured CUDA graph) and ``Executor.run(feed=DataLoader)``,
             from the recipe phase's start state and batch. Checks: 10
             steps in one call give losses of shape (10,), each within
             rel 1e-5 of the recipe phase's eager step, every dense
             parameter within 1e-6 of its max of the eager run's after
             them (the bit-equal count is printed), and the flash kernels
             18 and the fused update ``groups`` launches a step by their
             counters; a second call replays (one graph) and its losses
             keep falling; one replayed step under ``torch.profiler``
             shows 18 launches of each flash kernel and ``groups`` of
             the fused update by kernel name, as the counters do;
             ``unroll=True`` gives the losses of ``unroll=False`` (rel
             1e-5). Reports, in ``bench.py``'s protocol (chunks of 10
             steps, a warm chunk, 20 timed steps): step ms and tokens/s
             with the feed on the card, the same with ``unroll=True``,
             the host-fed leg through ``DataLoader(chunk=10,
             buffer_size=4)`` (tokens/s, ``host_fed_ratio``, the
             loader's ``stall_fraction``), each graph's capture
             seconds, the profiled step's device idle share, peak
             memory.
10. prefix_int8 — shared-prompt serving: ``serve_decoding`` of the
             causal LM of phase 3 with ``CacheConfig(num_blocks=512,
             block_size=16, max_blocks_per_seq=32, kv_dtype="int8",
             prefix_cache=True)``, decode buckets 1-16 and the default
             suffix buckets 1-512, answering 16 concurrent requests that
             share a 128-token system prompt plus a private suffix of
             8-64 tokens, 32 new tokens each. Checks every request
             completes, 15 prefix hits, 1 miss and 15*128 prompt tokens
             avoided, and the int8 kernel launched at least 6 times per
             decode step and per suffix prefill, decode on the split
             route and suffix prefills on the split (buckets up to 8)
             or query-tile route, none generic; the same traffic with
             f32 pools and prefix caching gives the streams of f32 pools
             without it (a difference only where the full forward's
             top-2 logit gap is below 1e-3). Reports tokens/s, TTFT,
             step, prefill and extend ms, the pools' bytes, and the int8
             streams' token agreement with the f32 ones. All captured;
             the int8 and f32 prefix-cached bursts run again on the
             eager engine and must stream the same tokens.
11. sampling — the serving burst with ``DecodingConfig(sampling=True)``:
             even requests greedy, odd ones temperature 0.8 / top-k 40 /
             top-p 0.95 with a seed each, one at top-k 1. Greedy and
             top-k 1 requests equal the serving phase's streams; the
             burst submitted in reverse order gives every stream again
             (keys are positional in the stream). Reports tokens/s,
             decode-step ms, and the sampling head's device ms at
             [16, 32000] beside the greedy argmax's.
12. speculative — the serving burst with a draft: a one-layer
             causal LM of the same vocab and widths (own scope, own
             seed) at ``speculate_k`` 3 (verify windows of 4 on the
             split route) and 8 (windows of 9 on the query-tile route),
             and a parameter-copied self-draft at 3. Checks graphs for
             target and draft, the route launches (the draft's decode
             steps and the verify windows, by counter), streams equal
             the serving phase's greedy streams except at a near tie
             (top-2 gap < 1e-3), and the self-draft's acceptance rate
             1.0. Reports acceptance, tokens per verified row, tokens/s and
             verify-step ms.

13. resnet — ``bench_resnet.py``'s training path: ``resnet_imagenet``
             depth 50, B=64, 3x224x224, 1000 classes, ``Momentum(0.1,
             0.9)``, the flags ``use_bfloat16``, ``bf16_activations``
             and ``bf16_moments``, ``memory_optimize``; a pool of 4
             seeded batches on the card, one warm ``run_steps`` chunk,
             then 16 timed steps in chunks of 4; in the per-parameter
             layout and under ``fuse_optimizer_state``, where the
             ``momentum`` kind of the fused update launches once per
             group per step (by its counter, graph replays counted).
             Checks, with ``cudnn.deterministic``: step 0's loss equal
             between the layouts (rel 1e-5), every parameter after two
             eager steps within 1e-6 of its max between them,
             ``run_steps`` of the same two batches equal to the eager
             steps (losses rel 1e-5, parameters 1e-6); the timed runs
             (cuDNN's defaults) give finite losses; the space-to-depth
             stem equals the plain stem at f32 (the same shape, within
             1e-4 of its max). Reports images/s, step ms, capture s,
             peak memory, and one replayed step profiled (idle share,
             device ms by family: conv, batch_norm, elementwise, matmul,
             fused_update, ...), per layout.

14. dropout — the dropout kernel (``ops.dropout.dropout_apply``) against
             ``plain_dropout`` on the card: the recipe's mask shapes
             [32, 256, 512] and [32, 256, 2048] in f32 and bf16 at p =
             0.1 and 0.5, a ragged N = 128*4099+37 at p = 0.1, and
             BERT-base's masks [64, 128, 768] and [64, 128, 3072] in
             bf16 at p = 0.1, each with -0.0, +-inf and NaN at its
             head. The forward, the op's
             output and its backward (the kernel on a seeded gradient)
             bit-equal to the plain version, the counter's advance, the
             kept fraction within 0.002 of 1-p. Wall and device ms, the
             plain version's ms, the bound (bytes over 3.35 TB/s, or 75
             integer operations an element over SMs x 128 x the SM
             clock, the larger), and ``F.dropout``'s ms at the same
             shape as a yardstick only (another stream, another scale).
15. dropout_recipe — the recipe (phase 8) at ``transformer_base``'s
             own ``dropout_rate=0.1`` after ``memory_optimize``: 62
             dropout sites; 10 eager steps and one ``run_steps`` call of
             the same 10 steps from the same state bit-equal (losses,
             every dense parameter, the counter), the kernel launched 62
             times forward and 62 backward a step (by its counters,
             replays counted, and by the profiler in a replayed step).
             Step ms and tokens/s in bench.py's protocol beside phase
             9's dropout-0 figures, peak memory, one replayed step
             profiled.
16. fused_ce — the recipe with ``fused_ce=True`` against the same recipe
             unfused, from the same weights: step 0's loss within rel
             1e-3 and the head weight's gradient within 3e-2 of its max
             (the unfused head rounds its logits to bf16, the fused op
             keeps them f32); the predict head's ``mul`` neither live
             nor run with only the loss fetched, eagerly or under
             ``run_steps``. Peak memory, step ms and tokens/s of each
             under ``memory_optimize`` and ``run_steps`` (bench.py's
             protocol).
17. vgg    — VGG-16 (batch norm) with phase 13's recipe (B=64,
             3x224x224, 1000 classes, ``Momentum(0.1, 0.9)``, the three
             bf16 flags, ``memory_optimize``, a pool of 4 batches on the
             card, ``run_steps`` chunks of 4, the per-parameter layout):
             two eager steps and ``run_steps`` of the same two batches
             bit-equal under ``cudnn.deterministic`` (losses, every
             parameter); a warm chunk and 16 timed steps with finite
             losses, the dropout kernel its only kernel of this repo,
             launched 2 + 2 times a step. Images/s, step ms, capture s,
             peak memory, one replayed step profiled (idle share,
             device ms by family).
18. persist — persistence and the training loop through the port's
             entry points (``Trainer``, ``ckpt``, ``io``, ``Inferencer``),
             checkpoints under ``build/chip_smoke_persist`` (removed at
             the end). (a) Phase 15's dropout recipe (the recipe flags,
             sparse embeddings, one flat Adam group with bf16 moments,
             ``dropout_rate=0.1``, ``attn_impl="pallas"``,
             ``memory_optimize``) built by ``Trainer(train_func,
             optimizer_func, checkpoint_config=CheckpointConfig(dir,
             step_interval=10))`` and fed 20 seeded batches with
             ``steps_per_loop=10``: C trains 20 steps uninterrupted with
             async saves; A trains 10 and saves synchronously; B (a new
             Trainer and Scope) auto-resumes A's checkpoint and B2 C's
             async-written step-10 checkpoint, each training steps
             10-19. B's and B2's losses and every tensor of their scopes
             (parameters, the flat group, the bf16 moments, the tables
             and their moments, the beta powers, the dropout counter)
             bit-equal to C's; B launched each flash kernel 18 times, the
             fused ``adam`` update once and the dropout kernel 62 + 62
             times a step (by their counters); C's step-10 checkpoint
             restored into C after its graph was captured, and the next
             ``run_steps`` call replays (no capture) steps 10-19 bit-equal
             again. (b) The serving phase's causal LM saved with
             ``io.save_decode_model``, reloaded into a new Scope with
             ``io.load_decode_model(program=)`` and served with
             ``serve_decoding``: the 16-request burst streams the serving
             phase's greedy tokens, decode on the split route. (c)
             ``fit_a_line`` trained by ``Trainer`` on the card (20 steps,
             SGD, the last loss under 5 % of the first);
             ``save_inference_model`` → ``load_inference_model`` and
             ``save_params`` → ``Inferencer.infer`` both equal
             ``Executor.run`` on the trained scope. Reports the
             checkpoint's bytes, save ms (sync; async on the caller's
             thread), restore ms, the Trainer's step ms (a group of 10
             replayed steps between its step events, feed conversion
             included) beside the run_steps and dropout_recipe phases'
             step ms, the decode artifact's save and load seconds.
19. bert   — BERT-base pretraining at its published widths (12 layers,
             hidden 768, 12 heads, FFN 3072, vocab 30522, 512
             positions; random weights from a numpy seed): first step
             0 at f32, dropout 0, B=64, T=128 under
             ``attn_impl="pallas"`` and ``"fused"`` (the loss within
             rel 1e-5, the gradients of ``word_embedding`` and the
             first layer's Q weight within 1e-3 of their max or twice
             the card-vs-host distance); then the recipe's flags,
             ``attn_impl="pallas"``, dropout 0.1 (49 sites),
             ``Adam(1e-4)``, ``memory_optimize``, at the phase-1 shape
             (B=64, T=128, 20 predictions, lengths 64-128, about 15 %
             of each sequence masked): 10 eager steps and one
             ``run_steps`` call of the same 10 steps from the same
             state bit-equal (losses and every scope tensor), exact
             launches (12 of each flash kernel, one fused update and
             2 x 49 dropout a step), then a warm chunk and 20 timed
             steps in chunks of 10 with finite, falling losses (step
             ms, tokens/s, sequences/s, peak memory, one replayed step
             profiled: device ms by family, idle share); and at the
             phase-2 shape (B=16, T=512, 80 predictions): 10 steps
             under ``run_steps`` with exact launches, a warm and a
             timed chunk, finite, falling losses.
20. deepfm — DeepFM at the JAX package's defaults (100000 features, 39
             fields, embed 16, MLP 400-400-400, ``is_distributed=True``:
             a plain lookup on one card), B=4096, f32, ``Adam(1e-3)``,
             ``fuse_optimizer_state``, ``memory_optimize``: 10 eager
             steps and one ``run_steps`` call of the same steps
             bit-equal, one fused ``adam`` update a step, ``auc``
             within 1e-6 of the same binning in numpy at each eager
             step, a warm chunk and 20 timed steps with finite, falling
             losses; examples/s, step ms, peak memory, one replayed
             step profiled.
21. static — the static tier over the training programs phases 9
             (the recipe under ``run_steps``), 13 (ResNet-50, fused
             layout), 17 (VGG-16), 19 (BERT phases 1 and 2) and 20
             (DeepFM) built and timed, at their feed shapes:
             ``obs.cost.report``'s FLOPs and bytes a step, by family,
             unknown op types; achieved TFLOP/s from the phase's
             measured step ms and MFU against the H100 SXM's published
             dense peak for the step's matmul dtype (bf16 989.4, f32
             without TF32 66.9 TFLOP/s); ``analyze_liveness``' predicted
             peak beside the phase's ``max_memory_allocated``. Fails on
             an unknown op in the matmul, conv or attention family, on
             any ``check_program`` error, and unless one recipe step
             with the ``check_program`` flag on is checked once, before
             any kernel launched, and passes.
22. remat  — BERT-base at the phase-2 shape (B=16, T=512, 80
             predictions), phase 19's flags, dropout 0.1,
             ``attn_impl="pallas"``, two ``run_steps`` chunks of 10 at
             ``memory_optimize(level=0)`` and at ``level=1``: losses
             and every scope tensor bit-equal, exact launches a step at
             level 1 (flash forward 2 x 12, dQ 12, dK/dV 12, dropout
             3 x 49, one fused update) and level 0 (12, 12, 12, 2 x 49,
             1), and a lower peak at level 1; then
             ``RematPolicyPass(assume_batch=16, target_batch=32)`` (the
             sequence axis pinned at 512 first: the pass's static model
             counts every -1 as the batch) picks segments, and B=32
             runs with them and without remat, bit-equal. Reports step
             ms, peaks and the liveness predictions of each run.
23. resilience — (run after phase 12) the decode tier's fault and
             overload paths over phase 3's model, every bucket captured:
             (a) default off: the serving burst with no plan, breaker or
             ladder gives phase 3's streams, paged launches by route and
             graphs; (b) a seeded ``FaultPlan`` (``serving.admission``,
             ``decoding.prefill`` and ``decoding.step`` raises, one
             ``decoding.prefix_commit`` corruption) with a
             ``CircuitBreaker`` over phase 10's int8 shared-prompt burst:
             exactly the two prefill-injected requests fail, every other
             stream equals phase 10's (but at a near tie), a decode step
             re-steps its sequences alone (one retry), the injections
             equal the plan's ``schedule()``, the breaker opens and a
             probe closes it, no capture after warm-up; (c) the
             degradation ladder on a 104-block pool: the lowest class
             streams first, the ladder is forced to stage 2 and the two
             higher classes preempt it (5 preemptions, 3 resumed through
             their published prefixes), every stream equals phase 3's
             (but at a near tie), stage 4 sheds the lowest class with a
             retriable ``OverloadedError`` and its Retry-After hint,
             then the ladder walks back to 0; (d) phase 12's one-layer
             draft at k=3: a ``decoding.draft_step`` raise falls back
             to plain decoding for good (``DraftEngineError``), a
             ``decoding.verify_step`` raise costs one plain round, both
             with phase 3's streams. Reports injections, transitions,
             re-steps and paged launches by route per leg.
24. server — (run after phase 23) the bucketed request server: a
             BERT-base sentence-pair classifier (BERT_MODEL's widths,
             ``is_test``, ``attn_impl="pallas"``, the bert phase's bf16
             flags, feeds [-1, 128], the next-sentence head's
             ``fc(tanh)``, ``fc(2)`` and a softmax over [CLS]; seeded
             weights) saved with ``save_inference_model``, loaded with
             ``load_inference_model`` and served with ``serve_program``
             (buckets 1-64, ``batch_timeout_ms=2``): 8 client threads
             send 256 seeded requests of 1-8 rows, then one of 100 rows.
             Every reply within 3e-2 of an eager ``Executor.run`` of its
             own rows, 7 graphs after warm-up and after the traffic, a
             ``serving.step``-injected poison request fails alone, and
             the flash forward launched 12 times an executed batch.
             Reports rows/s, the padded-row share, request latency p50
             and p99 (an ``obs.metrics.Histogram``), queue wait and
             batch execute, and ``render_prometheus()``'s line count.
25. artifact — (run after phase 24) exported artifacts, every kernel
             reached through its ``paddle_tpu_torch::*`` custom op from
             a ``torch.export`` graph. (a) Phase 24's classifier,
             its scope copied to the CPU, saved there with
             ``save_inference_model(export_batch_sizes=SERVER_BUCKETS)``
             (a program per bucket, traced on the CPU) and served on the
             card by ``serve_program(<dir>)`` alone (no program, no
             scope): 7 graphs after warm-up and after phase 24's
             traffic, the flash forward launched 12 times an executed
             batch, every bucket bit-equal to ``Executor.run`` of the
             same pruned, optimized program on the card, every reply
             within 3e-2 of an eager run of its own rows. (b) Phase 15's
             dropout recipe, saved with ``save_trainable_program`` from
             the card scope after step 0 and loaded with
             ``load_trainable_program``: 10 ``run`` steps and one
             ``run_steps(steps=10)`` call (a captured graph of the step)
             bit-equal to 10 ``Executor.run`` steps from the same state,
             losses and every state tensor, with exact launches (flash
             forward, dQ and dK/dV 18 a step, the fused Adam update once,
             dropout 2 x 62); ``run_steps``' step ms beside PR 11's.
             (c) ResNet-50 in test mode (seeded weights and running
             statistics), folded by ``InferenceTranspiler`` and cast by
             ``transpile_to_bfloat16``, exported at B=64 and run by
             ``NativePredictor``: bit-equal to ``Executor.run`` of the
             folded program, within 3e-2 of the unfolded one
             (probabilities, and logits as a share of their max).
             Reports export, load and warm-up seconds, rows/s and the
             padded share beside phase 24's, step ms, images/s and the
             captured forward's device ms; and the host microseconds of
             one flash forward call through its custom op, through the
             op under autograd, and as the CUDA kernel function called
             directly (the binding's cost to an eager path).

26. seq2seq, sentiment, srl — (run after phase 20) the sequence tier's
             models at the JAX package's default widths, f32, random
             weights from a numpy seed, ``Adam(1e-3)`` on one flat
             fused group, synthetic rows from the seed padded by the
             port's DataFeeder: ``machine_translation.build_train()``
             (dicts 30000, word 256, hidden 512; B=64 pairs, lengths
             3-19, the target +1), ``sentiment.build_train(5147,
             "stacked_lstm")`` (B=64, 8-100 tokens) and
             ``label_semantic_roles.db_lstm()`` (B=32, 5-29 tokens in
             its 128 slots, the CRF loss). 10 eager steps (srl: 5) and
             the same steps as one ``run_steps`` call, bit-equal in
             losses and every scope tensor, the fused update once a
             step, falling losses; eager and replayed step ms, tokens/s,
             capture s, peak memory, and one eager and one replayed step
             profiled (device busy, idle share, launches by family).
             srl decodes its trained emissions with ``crf_decoding`` on
             the card and holds every path to ``numpy_viterbi``. Phase
             7 times the seq2seq group (Adam, f32 moments) too.
27. ssd    — (run after phase 26) MobileNet-SSD on PASCAL VOC at
             300x300 (PaddlePaddle/models, fluid/object_detection/
             mobilenet_ssd.py and train.py; ``build_ssd``): 21 classes,
             1917 priors (asserted), B=64, synthetic images and 1-8
             boxes an image padded to 16 rows from a numpy seed, random
             weights from a seed, ``ssd_loss`` summed,
             ``RMSProp(piecewise_decay([40000, 60000], [1e-3, 5e-4,
             2.5e-4]), L2Decay(5e-5))`` on fused flat groups (the convs
             at lr scale 0.1, the rest at 1.0). Under
             ``cudnn.deterministic``: 2 eager steps, the same 2 as one
             ``run_steps`` call (losses and every scope tensor
             bit-equal), then 10 steps over a pool of four batches
             replayed (the first two losses the eager ones, every loss
             finite, the last pass's mean below the first's, the fused
             update ``groups`` times a step by its counter); the test
             clone (``detection_output`` at nms 0.45) on two test
             batches through ``run_graph`` bit-equal to ``Executor.run``,
             the eval clone's ``evaluator.DetectionMAP`` (11-point,
             difficult boxes out) equal to ``metrics.DetectionMAP`` over
             the fetched rows (plumbing) and within 1e-6 of the VOC
             11-point definition written in the script, and refused (``GraphCaptureError``) by
             ``run_steps`` and ``run_graph``; ``detection_output`` alone
             on the fetched heads, captured and eager, profiled (device
             ms, launches). Then, with cuDNN's defaults, the replayed
             step timed (ms, images/s, peak memory) and one replayed
             step profiled (device busy, idle share, kernels by family).
             Phase 7 times RMSProp at the conv group (f32, lr scale
             0.1).
28. op_tier — (run after phase 27) every other new layer once on the
             card at a realistic shape, forward and input gradient
             against the port's CPU result on the same inputs within
             1e-4 of the max (a leading slice of the batch where the
             CPU would be slow): channels-last batch norm at ResNet-50's
             first ([64, 112, 112, 64], also against the NCHW batch norm
             on the card), a DCGAN ``conv2d_transpose`` ([64, 512, 4, 4]
             to [64, 256, 8, 8]), ``conv3d_transpose``, ``conv3d`` and
             ``pool3d`` at a C3D block ([8, 64, 16, 56, 56]), AlexNet's
             ``lrn``, a CRNN ``im2sequence``, ``image_resize`` 300 to
             600 (bilinear) and 600 to 300 (nearest), Fast R-CNN's
             ``roi_pool`` (128 rois at 7x7 on [8, 512, 38, 50]),
             ``hsigmoid``, ``nce`` and ``sampled_softmax`` at imikolov's
             dict (2074) with 512 hidden, the fake-quantize ops, and
             ``switch_moe`` at google/switch-base-8's widths over 64 x
             128 tokens (parity at 4 x 128); forward and forward+backward
             ms on the card.
29. tuning — (run after phase 12's ``amp_serving``) kernel autotuning
             in a temporary tuning store: the serving burst with default
             launch configs, then with ``DecodingConfig(autotune=True)``
             (its warm-up sweeps the paged kernel's ``split_waves`` at
             every ``decode_tuning_problems()`` point; tokens identical
             to the default burst's); sweeps of the paged kernel on bf16
             pools at those points and on int8 pools at B=16, of the
             fused update's grid cap at the recipe's Adam group and of
             ``fused_ce``'s chunk cap at the recipe's head. Every
             launched paged candidate against
             ``plain_split_window_attention`` at its planned splits,
             every grid cap bit-equal to the plain update, every chunk
             cap's loss within 1e-3 of the default's; no candidate
             error. A second process on the store (zero sweeps, store
             hits, the same configs) and a fresh one seeding the
             ``save_decode_model`` manifest's ``tuned_configs``. Each
             candidate's device ms, the winner against the default and
             its bound, rows 4, 5a and 5b at the default and the tuned
             config (a tuned 5a or 5b more than 5 % slower than the
             default fails), decode-step ms, the warm-up with the sweeps
             it ran, and the host µs of a memo-hit lookup.

30. obs    — (run after phase 24) the observability tooling: (a) the
             recipe (phase 15's program) through ``Trainer(steplog=)``,
             12 steps as three ``run_steps`` chunks of 4: one StepStats
             line a step with the JAX package's keys (epoch, step, dt_s,
             loss, fresh_compiles, t), one fresh capture, exact flash
             and fused-update launches, ``tools.top --once`` reading the
             file; (b) the flight recorder on phase 24's BERT engine,
             whose 7 bucket captures ran with ``compile_cache_dir`` set
             (fingerprinted, nothing persisted): a server whose worker
             loop dies writes an ``-exception`` bundle that
             ``tools.postmortem validate`` accepts, its env pins torch,
             CUDA and the card, its program stamps the 7 capture
             fingerprints; (c) a decode burst (4 prompts, 8 tokens,
             captured buckets) with ``obs.trace`` and
             ``start_profiler(trace_dir=)``: the host timeline
             (``timeline.export_chrome_trace``, a trace per request) and
             the torch.profiler device trace (the paged kernel's rows)
             pass ``tools.trace validate``.
31. compile_cache — (run after phase 25, whose BERT-base export goes
             through a fresh ``compile_cache_dir``: 7 misses, 7
             publishes) a second process builds the same program and
             exports it through the same store: 7 hits, 0 misses, every
             ``.pt2`` sha256-equal to the cold export's, the smallest and
             largest buckets of both directories bit-equal through
             ``NativePredictor`` on the same rows; meanwhile, in a copy
             of the store with one byte of the batch-1 payload flipped,
             the batch-1 program exported again: 1 bad entry, 1 miss, 1
             publish, the file the republished payload (a warm export
             writes it again), its output the cold one's. Cold and warm
             export seconds.

Then the whole call's seconds (``call_s``), the card's name and power
limit, the kernels JSON line (wall and
device ms of each kernel and its library call; ``amp_launches``,
``persist_launches``,
``bert_launches``, ``deepfm_launches``, ``remat_launches``,
``resilience_launches``, ``server_launches``, ``artifact_launches``,
``seq2seq_launches``, ``sentiment_launches``, ``srl_launches`` and
``obs_launches``:
those phases' launches
of the kernels their paths run; ``fused_flat_update_amp``, the gated
Adam of the AMP path with its gated and skipped launches; the rows at
BERT-base's, DeepFM's and the seq2seq NMT's shapes carry the bert,
remat, deepfm and seq2seq phases' launches; ``fused_flat_update_rmsprop``,
RMSProp at MobileNet-SSD's conv group, the ssd phase's), and as the
last line ``{"ok": true, "device": {...}}``. Every phase row carries the
card's name and power limit. Any failed phase exits
non-zero. Without a visible CUDA device — or outside a checkout that
holds ``paddle_tpu_torch`` — it exits non-zero and prints no result.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

T_START = time.perf_counter()  # the call's seconds count from here

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12,  # f32 outside the tensor cores
            torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # sums run in another order
LSE_TOL = 1e-4  # the flash forward's lse, f32 in both types
L2_BYTES = 50 * 2 ** 20

# paged-attention decode shapes
H, D, BS, MB, NB = 8, 64, 16, 32, 512
# kernel-phase rows: (pool kind, query dtype, B, T)
KERNEL_ROWS = (
    [(None, dt, B, T) for dt in (torch.float32, torch.bfloat16)
     for B in (1, 16) for T in (1, 4)]
    + [(None, dt, B, T) for dt in (torch.float32, torch.bfloat16)
       for B in (1, 16) for T in (64, 512)]
    + [("int8", dt, B, T) for dt in (torch.float32, torch.bfloat16)
       for B in (1, 16) for T in (1, 4, 64, 512)]
    # the speculative verify window of speculate_k = 8 (query-tile route)
    + [(None, torch.float32, 16, 9)])

# Transformer-base widths (the repo's flagship config, bench.py)
MODEL = dict(vocab_size=32000, n_layer=6, n_head=8, d_model=512,
             d_inner_hid=2048)
N_REQUESTS = 16
MAX_NEW = 32
SEED = 0
# shared-prompt serving: a system prompt every request carries, then a
# private suffix of 8-64 tokens
SYSTEM_PROMPT = 128
SUFFIX_TOKENS = (8, 64)

# Transformer-base training (bench.py's flagship step, f32, dense
# embeddings, dropout 0): B=32 sentences of T=256 target tokens
TRAIN_MODEL = dict(src_vocab_size=32000, trg_vocab_size=32000,
                   max_length=256, n_layer=6, n_head=8, d_model=512,
                   d_inner_hid=2048, dropout_rate=0.0)
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 32, 256, 10, 1e-4
# 6 encoder self-attentions, 6 decoder self- and 6 cross-attentions
ATTN_PER_STEP = 3 * TRAIN_MODEL["n_layer"]

# flash-attention cases: (label, B, Tq, Tk, H, D, causal, key mask,
# dtypes); the training path's shape, a ragged cross shape, the
# long-context shape (bench.py BENCH_SEQ=2048, B=4), and D=128
BOTH = (torch.float32, torch.bfloat16)
FLASH_CASES = [
    ("path", 32, 256, 256, 8, 64, False, False, BOTH),
    ("path_causal", 32, 256, 256, 8, 64, True, False, BOTH),
    ("path_masked", 32, 256, 256, 8, 64, False, True, BOTH),
    ("cross", 32, 200, 333, 8, 64, False, True, BOTH),
    ("long", 4, 2048, 2048, 8, 64, False, False, BOTH),
    ("long_causal", 4, 2048, 2048, 8, 64, True, False, BOTH),
    ("d128", 4, 512, 512, 4, 128, True, True, BOTH),
    # BERT-base's phase-1 shape: 12 heads, ragged key mask
    ("bert", 64, 128, 128, 12, 64, False, True, BOTH),
    # the training path at one rank's heads under tensor parallelism
    # (tp=2: 4 of the 8 heads; the parallel phase)
    ("path_masked_tp", 32, 256, 256, 4, 64, False, True, (torch.bfloat16,)),
]
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}  # of max |grad|
# flash cases whose rows also carry device times (device_ms): the
# training shape with its key mask, the long-context shapes, D=128,
# BERT-base's, and the training shape at a rank's heads under tp=2
DEVICE_CASES = ("path_masked", "long", "long_causal", "d128", "bert",
                "path_masked_tp")


# the card's name and power limit (nvidia-smi), printed beside every
# phase's numbers once the device phase has read it
CARD = None


def emit(obj) -> None:
    if "phase" in obj and "card" not in obj and CARD is not None:
        obj = {"phase": obj["phase"], "card": CARD, **obj}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls
    (CUDA events around the whole run, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_TRIES = 4
SPIN_CYCLES = 10 ** 7  # a few ms of the card's clock


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around
    ``iters`` calls that the card runs back to back (after ``warmup``).
    A spin kernel (``torch.cuda._sleep``) holds the stream while the host
    queues the calls, so the card never waits for the host between them;
    a run counts only if every call was queued before the spin ended
    (the event after it had not completed when the host was done).
    Otherwise the spin is made 4 times longer and the run made again, at
    most ``DEVICE_TRIES`` runs, then the smoke fails. Unlike ``cuda_ms``
    it leaves out the host's time between launches, which is what
    ``cuda_ms`` measures for a small kernel; it keeps the card's own gaps
    between back-to-back kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = SPIN_CYCLES
    for _ in range(DEVICE_TRIES):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail("device_ms: the host did not queue %d calls within a spin of "
         "%d cycles" % (iters, cycles // 4))


def reset_counts(fn) -> None:
    """Set every launch count a launcher keeps to 0."""
    for name in getattr(fn, "counts", ("launches",)):
        setattr(fn, name, 0)


def route_counts(fn) -> dict:
    return {name: getattr(fn, name) for name in getattr(
        fn, "counts", ("launches",))}


# ---------------------------------------------------------------- phase 1


KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_optimizer",
                  "dropout")


def phase_device():
    from paddle_tpu_torch.ops import (_cuda, dropout, flash_attention,
                                      fused_optimizer, paged_attention)

    global CARD
    card = CARD = card_line()
    t0 = time.perf_counter()
    _cuda.build_all(KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    paged_attention.build()
    flash_attention.build()
    fused_optimizer.build()
    dropout.build()
    ptxas = {name: [ln.strip() for ln in
                    _cuda.build_logs.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name in KERNEL_SOURCES}
    # dynamic shared memory of one block of each flash kernel, and the
    # blocks one SM holds (the card's occupancy calculator)
    lib = flash_attention._library()
    names = [("%s_d%d_%s" % (kind, d, dt), i, d, bf)
             for i, kind in enumerate(("fwd", "dq", "dkv"))
             for d in (64, 128) for bf, dt in ((0, "f32"), (1, "bf16"))]
    smem = {n: lib.flash_smem_bytes(i, d, bf) for n, i, d, bf in names}
    per_sm = {n: lib.flash_blocks_per_sm(i, d, bf) for n, i, d, bf in names}
    if min(per_sm.values()) < 1:
        fail("a flash kernel fits no block on an SM: %s" % per_sm)
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "ptxas": ptxas,
          "flash_smem_bytes": smem, "flash_blocks_per_sm": per_sm})
    return card


# ---------------------------------------------------------------- phase 2


def quantize_pool(x):
    """An f32 ``[nb, bs, H, D]`` pool as the int8 rewrite stores it:
    codes and ``[nb, bs]`` f32 scales, absmax/127 per slot."""
    scale = x.abs().amax(dim=(2, 3)) * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(x / safe[..., None, None]), -127, 127)
    return codes.to(torch.int8), scale


def make_problem(B, T, dtype, seed, inactive_row, kv=None):
    """A paged-window problem at the decode shapes: each sequence owns
    its own random pages (as the allocator hands them out), a random
    number of them valid (at least enough for T) and the rest -1, and a
    cached length inside its valid span. The inactive row has an all -1
    table and position -1, as the engine pads a decode batch. With
    ``kv="int8"`` the same K/V are quantized per slot. Returns (the five
    positional arguments, the scale keywords)."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda", 0)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    pages = rng.permutation(NB)
    tables = np.full((B, MB), -1, np.int32)
    cached = np.zeros(B, np.int32)
    for b in range(B):
        n_valid = rng.randint(-(-T // BS), MB + 1)
        tables[b, :n_valid] = pages[b * MB:b * MB + n_valid]
        cached[b] = rng.randint(0, n_valid * BS - T + 1)
    if inactive_row:
        tables[-1] = -1
        cached[-1] = -1
    as_t = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    if kv == "int8":
        kc, ks = quantize_pool(as_t(kp, torch.float32))
        vc, vs = quantize_pool(as_t(vp, torch.float32))
        pools, scales = (kc, vc), {"k_scale": ks, "v_scale": vs}
    else:
        pools, scales = (as_t(kp, dtype), as_t(vp, dtype)), {}
    return ((as_t(q, dtype),) + pools + (as_t(tables, torch.int32),
                                         as_t(cached, torch.int32)), scales)


def window_masks(tables, cached, T):
    """(per-(b, t) key mask [B, T, S], rows with a valid key [B, T])."""
    B = tables.shape[0]
    S = MB * BS
    pos = cached.long()[:, None] + torch.arange(T, device=tables.device)
    page_ok = (tables.long() >= 0).repeat_interleave(BS, dim=1)   # [B, S]
    m = ((torch.arange(S, device=tables.device)[None, None, :]
          <= pos[:, :, None]) & page_ok[:, None, :])
    return m, m.any(-1)


def work(tables, cached, T, dtype, kv=None):
    """Bytes the function must move and operations it must do for these
    inputs: each valid K/V row read once (all heads; one byte an element
    and 8 bytes of scales a row for int8 pools), q and out once, the
    tables and lengths; two flops per multiply-add of QK and PV."""
    m, _ = window_masks(tables, cached, T)
    B = tables.shape[0]
    item = torch.finfo(dtype).bits // 8
    last = (cached.long() + T - 1)[:, None]
    page_ok = (tables.long() >= 0).repeat_interleave(BS, dim=1)
    rows_read = int(((torch.arange(MB * BS, device=tables.device)[None, :]
                      <= last) & page_ok).sum())
    row_bytes = H * 2 * D + 8 if kv == "int8" else H * 2 * D * item
    nbytes = (rows_read * row_bytes + 2 * B * T * H * D * item
              + tables.numel() * 4 + cached.numel() * 4)
    ops = int(m.sum()) * H * 2 * (2 * D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def phase_kernel():
    from paddle_tpu_torch.ops import (paged_window_attention,
                                      plain_window_attention, plan_route)

    rows = []
    for kv, dtype, B, T in KERNEL_ROWS:
        args, scales = make_problem(B, T, dtype, seed=B * 10 + T,
                                    inactive_row=B > 1, kv=kv)
        label = "B=%d T=%d %s %s pools" % (B, T, dtype, kv or "float")
        route = plan_route(B, T, H, D, D, MB, BS, dtype, kv == "int8").route
        if route == "generic":
            fail("the serving shapes took the generic route (%s)" % label)
        before = route_counts(paged_window_attention)
        out = paged_window_attention(*args, **scales)
        after = route_counts(paged_window_attention)
        counter = "split_launches" if route == "split" else "tile_launches"
        if after[counter] != before[counter] + 1 or \
                after["generic_launches"] != before["generic_launches"]:
            fail("the launch did not take the %s route (%s)"
                 % (route, label))
        # the generic route's kernel, the A/B yardstick, on the same inputs
        generic = paged_window_attention(*args, **scales, route="generic")
        ref = plain_window_attention(*args, **scales)
        torch.cuda.synchronize()
        _, valid = window_masks(args[3], args[4], T)
        err = float((out.float() - ref.float()).abs()[valid].max())
        generic_err = float((generic.float() - ref.float()).abs()[
            valid].max())
        if not bool(torch.isfinite(out).all()):
            fail("kernel output not finite (%s)" % label)
        if not err <= TOL[dtype]:
            fail("kernel disagrees with the plain version: max abs err "
                 "%g > %g (%s, %s route)" % (err, TOL[dtype], label, route))
        if not generic_err <= TOL[dtype]:
            fail("the generic route disagrees with the plain version: max "
                 "abs err %g > %g (%s)" % (generic_err, TOL[dtype], label))
        rows.append(dict(B=B, T=T, dtype=str(dtype)[6:],
                         pools=kv or str(dtype)[6:], route=route,
                         max_abs_err=err, generic_max_abs_err=generic_err,
                         prob=(args, scales)))
    for r in rows:
        r.update(time_problem(*r.pop("prob")))
        emit({"phase": "kernel", **r})
    return rows


def time_problem(args, scales):
    """Times of the kernel (the planner's route), the generic route's
    kernel (called directly), the plain version and SDPA, on
    rotating copies of the problem whose pools together exceed the L2
    cache, so each launch reads its K/V from device memory as a decode
    step over many layers would. SDPA runs over the window gathered
    (and, for int8 pools, dequantized to q's type) beforehand, outside
    the timed calls. Two clocks: wall ms per call (CUDA events around
    back-to-back calls: at small shapes that is the host's launch
    rate), and device ms per call (``device_ms``: the calls queued
    behind a spin kernel, run back to back), taken in turns — kernel,
    generic, SDPA, plain — on the same copies."""
    from paddle_tpu_torch.ops import (paged_window_attention,
                                      plain_window_attention)

    q, kp, vp, tables, cached = args
    B, T = q.shape[:2]
    kv = "int8" if scales else None
    pool_bytes = 2 * kp.numel() * kp.element_size()
    n_copies = max(1, math.ceil(4 * L2_BYTES / pool_bytes))
    copies = [(args, scales)] + [
        ((q, kp.clone(), vp.clone(), tables, cached),
         {n: t.clone() for n, t in scales.items()})
        for _ in range(n_copies - 1)]
    state = {"i": 0}

    def rotating(fn, items):
        def call():
            state["i"] = (state["i"] + 1) % len(items)
            a, kw = items[state["i"]]
            return fn(*a, **kw)
        return call

    mask, _ = window_masks(tables, cached, T)
    sdpa_items = []
    for (cq, ck, cv, ct, _), kw in copies:
        gidx = (ct.long()[:, :, None] * BS
                + torch.arange(BS, device=ct.device)).reshape(B, -1)
        gidx = gidx.clamp(min=0)
        keys = ck.reshape(NB * BS, H, D)[gidx]
        vals = cv.reshape(NB * BS, H, D)[gidx]
        if kw:
            keys = (keys.float() * kw["k_scale"].reshape(-1)[gidx][
                ..., None, None]).to(q.dtype)
            vals = (vals.float() * kw["v_scale"].reshape(-1)[gidx][
                ..., None, None]).to(q.dtype)
        sdpa_items.append(((cq.permute(0, 2, 1, 3).contiguous(),
                            keys.permute(0, 2, 1, 3).contiguous(),
                            vals.permute(0, 2, 1, 3).contiguous(),
                            mask[:, None, :, :]), {}))
    iters = 200 if T <= 64 else 50
    kernel = rotating(paged_window_attention, copies)
    generic = rotating(lambda *a, **kw: paged_window_attention(
        *a, **kw, route="generic"), copies)
    plain = rotating(plain_window_attention, copies)
    sdpa = rotating(lambda a, b, c, m: F.scaled_dot_product_attention(
        a, b, c, attn_mask=m), sdpa_items)
    kernel_ms = cuda_ms(kernel, iters)
    generic_ms = cuda_ms(generic, iters if T <= 64 else 10)
    plain_ms = cuda_ms(plain, 20)
    library_ms = cuda_ms(sdpa, iters)
    # device time, the four in turns on the same rotating copies
    dev_iters = 50 if T <= 64 else 20
    dev = {"device_ms": device_ms(kernel, dev_iters),
           "generic_device_ms": device_ms(generic,
                                          dev_iters if T <= 64 else 5),
           "library_device_ms": device_ms(sdpa, dev_iters),
           "plain_device_ms": device_ms(plain, 5, warmup=1)}
    bound_ms, bound_by, nbytes, ops = work(tables, cached, T, q.dtype, kv)
    del copies, sdpa_items
    torch.cuda.empty_cache()
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "generic_ms": generic_ms, "library_ms": library_ms, **dev,
            "library": "F.scaled_dot_product_attention over the "
                       "pre-gathered window (gather excluded)"
                       + (", dequantized beforehand" if kv else ""),
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by, "bytes": nbytes, "ops": ops,
            "copies": n_copies}


# ---------------------------------------------------------------- phase 3


def build_model(n_layer=MODEL["n_layer"], seed=SEED):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.causal_lm import causal_lm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, logits = causal_lm(**dict(MODEL, n_layer=n_layer))
    scope = fluid.Scope()
    fluid.params_from_numpy(seeded_weights(main, seed), scope,
                            fluid.CUDAPlace(0), program=main)
    return main, logits, scope


def seeded_weights(program, seed=SEED):
    """Random weights for every parameter of ``program`` from a numpy
    seed: layer-norm scales near 1, matrices N(0, 1/fan_in), embedding
    tables and biases N(0, 0.02^2)."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for p in program.all_parameters():
        if p.name.startswith("layer_norm") and ".w_" in p.name:
            a = 1.0 + 0.02 * rng.standard_normal(p.shape)
        elif len(p.shape) == 2 and "emb_table" not in p.name:
            a = rng.standard_normal(p.shape) / math.sqrt(p.shape[0])
        else:
            a = 0.02 * rng.standard_normal(p.shape)
        arrays[p.name] = a.astype(np.float32)
    return arrays


def serving_prompts():
    rng = np.random.RandomState(SEED + 1)
    return [rng.randint(0, MODEL["vocab_size"],
                        size=rng.randint(16, 201)).tolist()
            for _ in range(N_REQUESTS)]


SERVING_CACHE = dict(num_blocks=512, block_size=16, max_blocks_per_seq=32)


def decoding_config(cache, **config_kw):
    """The serving phases' DecodingConfig: decode buckets 1-16, MAX_NEW
    new tokens, warm-up run by the caller."""
    from paddle_tpu_torch.decoding import DecodingConfig

    return DecodingConfig(cache=cache, decode_buckets=(1, 2, 4, 8, 16),
                          max_new_tokens=MAX_NEW, warm_up=False, **config_kw)


def open_session(model, cache, draft=None, warm=True, **config_kw):
    """A DecodeSession over ``model`` on the card (``draft`` = (program,
    logits, scope) makes it speculative), not started; with ``warm``
    every bucket is captured first. Returns (session, engines)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import serve_decoding

    main, logits, scope = model
    kw = {}
    if draft is not None:
        kw = dict(draft_program=draft[0], draft_logits_name=draft[1].name,
                  draft_scope=draft[2])
    session = serve_decoding(main, "tokens", logits.name, scope=scope,
                             config=decoding_config(cache, **config_kw),
                             place=fluid.CUDAPlace(0), auto_start=False,
                             **kw)
    engines = [e for e in (session.engine, session.draft_engine)
               if e is not None]
    if warm:
        for e in reversed(engines):  # the draft first, as a session starts
            e.warm_up()
    return session, engines


def serve_burst(model, cache, prompts, counters=(), capture=True,
                share_pool=True, params=None, draft=None, **config_kw):
    """Serve ``prompts`` as one burst (32 new tokens each) on the card
    with ``cache``: through ``serve_decoding`` (every bucket a captured
    CUDA graph), or with ``capture=False`` through the eager engine
    (``DecodeEngine(_capture=False)``), or with ``share_pool=False``
    with a graph memory pool per graph. ``params`` gives each request
    its SamplingParams, ``config_kw`` go to ``DecodingConfig``, and
    ``draft`` = (program, logits, scope) makes the session
    speculative. The warm-up (on the card: the captures) runs
    first and is timed alone; then every request is queued and the
    session started, so the batcher admits them in one order and batches
    them the same way in every run. Each launcher in ``counters`` has its
    counts set to 0 just before the burst. Returns a dict: streams, wall
    seconds and TTFTs from the start, the metrics reports, pool bytes,
    warm-up seconds, graphs against the warm bucket count before and
    after the burst, the memory the warm-up reserved, peak memory, and
    the session's engines (for a profile)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import DecodeEngine, DecodeSession

    if capture and share_pool:
        session, engines = open_session(model, cache, draft=draft,
                                        warm=False, **config_kw)
    else:
        main, logits, scope = model
        engine = DecodeEngine(main, "tokens", logits.name, scope=scope,
                              config=decoding_config(cache, **config_kw),
                              place=fluid.CUDAPlace(0), _capture=capture,
                              _share_pool=share_pool)
        session = DecodeSession(engine, auto_start=False)
        engines = [engine]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    for e in reversed(engines):  # the draft first, as a session starts
        e.warm_up()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # what the warm-up keeps: the graphs' pools (the eager runs' cached
    # blocks are released first)
    torch.cuda.empty_cache()
    warm_reserved = torch.cuda.memory_reserved() - reserved0
    graphs = [e.num_compiled for e in engines]
    first_t = {}

    def on_token(i):
        def cb(tok):
            first_t.setdefault(i, time.perf_counter())
        return cb

    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        reset_counts(fn)
    try:
        futs = [session.submit(p, max_new_tokens=MAX_NEW,
                               on_token=on_token(i),
                               sampling=params[i] if params else None)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        session.start()
        streams = [f.result(timeout=600) for f in futs]
        wall_s = time.perf_counter() - t0
    finally:
        session.shutdown(drain=True, timeout=120)
    if len(streams) != len(prompts) or any(len(s) != MAX_NEW
                                           for s in streams):
        fail("not every request completed with %d tokens (%s)"
             % (MAX_NEW, cache))
    ttft = np.asarray([(first_t[i] - t0) * 1e3
                       for i in range(len(prompts))])
    return {"streams": streams, "wall_s": wall_s, "ttft": ttft,
            "report": session.metrics.report(),
            "draft_report": (session.draft_engine.metrics.report()
                             if session.draft_engine is not None else None),
            "warm_up_s": warm_s, "graph_reserved_bytes": warm_reserved,
            "graphs": graphs,
            "graphs_after": [e.num_compiled for e in engines],
            "warm_bucket_count": [e.warm_bucket_count() for e in engines],
            "captured": session.engine.captured,
            "pool_bytes": session.engine.pair.pool_bytes,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "engines": engines}


def check_graphs(run, label):
    """A captured run's engines captured every warm bucket at warm-up and
    the burst added no graph; an eager run's captured nothing."""
    want = run["warm_bucket_count"] if run["captured"] else \
        [0] * len(run["graphs"])
    if run["graphs"] != want or run["graphs_after"] != run["graphs"]:
        fail("%s: graphs %s at warm-up and %s after the burst, expected %s"
             % (label, run["graphs"], run["graphs_after"], want))


def burst_row(run):
    """The end-to-end numbers of one burst."""
    rep, ttft = run["report"], run["ttft"]
    n_tokens = sum(len(s) for s in run["streams"])
    row = {"captured": run["captured"], "requests": len(run["streams"]),
           "tokens": n_tokens,
           "wall_s": run["wall_s"], "tokens_per_s": n_tokens / run["wall_s"],
           "ttft_ms_mean": float(ttft.mean()),
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_max": float(ttft.max()),
           "warm_up_s": run["warm_up_s"],
           "graph_reserved_bytes": run["graph_reserved_bytes"],
           "graphs": run["graphs"],
           "warm_bucket_count": run["warm_bucket_count"],
           "pool_bytes": run["pool_bytes"],
           "max_memory_allocated": run["max_memory_allocated"]}
    for name, label in (("decode_step", "decode_step"),
                        ("prefill_latency", "prefill"),
                        ("extend", "extend"), ("verify", "verify")):
        h = rep[name]
        if h["count"]:
            row["mean_%s_ms" % label] = h["mean_ms"]
            row["p50_%s_ms" % label] = h["p50_ms"]
            row[label + "s"] = h["count"]
    return row


def decode_profile(engine, prompts, steps=5):
    """One decode step of ``engine`` over ``len(prompts)`` live rows
    (prompts prefilled into fresh reservations): host wall ms per step
    unprofiled (mean of ``steps``), and one step under torch.profiler
    with its device busy ms, kernel launches and idle share."""
    from paddle_tpu_torch.decoding import KVCacheManager

    kv = KVCacheManager(engine.cache_config)
    sids = [kv.admit(len(p), 2 * steps + 4) for p in prompts]
    tables = np.stack([kv.table_row(sid) for sid in sids])
    state = {"tok": np.concatenate([
        engine.prefill([np.asarray(p)], tables[i:i + 1],
                       np.asarray([len(p)], np.int32))
        for i, p in enumerate(prompts)]),
        "pos": np.asarray([len(p) for p in prompts], np.int32)}

    def step():
        state["tok"] = engine.decode(state["tok"], state["pos"], tables)
        state["pos"] = state["pos"] + 1

    step()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof_ms, by_family, launches, top = profile_step(step, top=6)
    for sid in sids:
        kv.release(sid)
    busy = sum(by_family.values())
    return {"rows": len(prompts), "host_wall_ms": wall_ms,
            "profiled_wall_ms": prof_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / prof_ms,
            "device_idle_share_unprofiled": 1.0 - busy / wall_ms,
            "kernel_launches": launches,
            "device_ms_by_family": by_family, "top_kernels": top}


def phase_serving(card):
    """The greedy burst on captured buckets, the same burst on the eager
    engine, the graphs' memory with one shared pool against a pool per
    graph, and one decode step of each engine profiled."""
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import paged_window_attention

    model = build_model()
    prompts = serving_prompts()
    cache = CacheConfig(**SERVING_CACHE)
    run = serve_burst(model, cache, prompts,
                      counters=(paged_window_attention,))
    counts = route_counts(paged_window_attention)
    check_graphs(run, "serving")
    launches = counts["launches"]
    steps = run["report"]["decode_step"]["count"]
    if launches < MODEL["n_layer"] * steps or launches == 0:
        fail("kernel launched %d times over %d decode steps of %d layers"
             % (launches, steps, MODEL["n_layer"]))
    # every decode launch (T=1) takes the split route
    if counts["generic_launches"] or counts["split_launches"] < \
            MODEL["n_layer"] * steps or counts["split_launches"] + \
            counts["tile_launches"] != launches:
        fail("serving: the paged launches did not take the split route "
             "(decode) and the query-tile route only: %s" % counts)
    eager = serve_burst(model, cache, prompts, capture=False)
    check_graphs(eager, "serving eager")
    if run["streams"] != eager["streams"]:
        bad = [i for i, (a, b) in enumerate(zip(run["streams"],
                                                 eager["streams"])) if a != b]
        fail("serving: the captured streams differ from the eager ones "
             "(requests %s)" % bad)
    # the graphs' memory: one pool shared by an engine's graphs (the
    # default) against a pool per graph
    private = serve_burst(model, cache, prompts[:2], share_pool=False)
    check_graphs(private, "serving, a pool per graph")
    profiles = {"captured": decode_profile(run["engines"][0], prompts),
                "eager": decode_profile(eager["engines"][0], prompts)}
    emit({"phase": "serving", "card": card, **burst_row(run),
          "kernel_launches": launches, "route_launches": counts,
          "eager": burst_row(eager),
          "streams_equal_eager": True,
          "tokens_per_s_over_eager": (burst_row(run)["tokens_per_s"]
                                      / burst_row(eager)["tokens_per_s"]),
          "graph_memory": {
              "shared_pool_reserved_bytes": run["graph_reserved_bytes"],
              "pool_per_graph_reserved_bytes":
                  private["graph_reserved_bytes"]},
          "decode_step_profile": profiles})
    streams = run["streams"]
    del run, eager, private
    torch.cuda.empty_cache()
    check_oracle(*model, prompts, streams)
    return counts, model, streams


def first_divergence(a, b):
    """Index of the first token where two streams differ, or None."""
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def near_ties(model, prompts, got, want, label):
    """Streams ``got`` must equal ``want`` except where, at the first
    token they part, the full forward's top-2 logit gap after the shared
    history is below 1e-3 (a near tie, which another summation order may
    break the other way). Returns the near ties found."""
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, logits, scope = model
    ties = []
    for i, (a, b) in enumerate(zip(got, want)):
        j = first_divergence(a, b)
        if j is None:
            continue
        out, = exe.run(main, feed={"tokens": np.asarray(
            [prompts[i] + b[:j]], np.int64)}, fetch_list=[logits],
            scope=scope)
        top2 = np.sort(out[0, -1])[-2:]
        gap = float(top2[1] - top2[0])
        if gap >= 1e-3:
            fail("%s: request %d token %d: %d against %d (top-2 gap %g)"
                 % (label, i, j, a[j], b[j], gap))
        ties.append({"request": i, "token": j, "top2_gap": gap})
    return ties


def shared_prompts():
    """16 prompts sharing a SYSTEM_PROMPT-token system prompt, each with
    a private suffix of SUFFIX_TOKENS tokens."""
    rng = np.random.RandomState(SEED + 3)
    system = rng.randint(0, MODEL["vocab_size"], size=SYSTEM_PROMPT).tolist()
    return [system + rng.randint(0, MODEL["vocab_size"], size=rng.randint(
        SUFFIX_TOKENS[0], SUFFIX_TOKENS[1] + 1)).tolist()
        for _ in range(N_REQUESTS)]


def phase_prefix_int8(card, model):
    """Shared-prompt serving with prefix caching on int8 pools, and the
    same traffic on f32 pools with and without prefix caching, captured;
    the int8 and f32 prefix-cached bursts again on the eager engine.
    Returns the int8 burst's paged launches and streams."""
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import paged_window_attention

    prompts = shared_prompts()
    kinds = {"int8": dict(kv_dtype="int8", prefix_cache=True),
             "f32": dict(prefix_cache=True), "f32_nocache": {}}
    runs = {}
    for name, kw in kinds.items():
        runs[name] = serve_burst(model, CacheConfig(**SERVING_CACHE, **kw),
                                 prompts, counters=(paged_window_attention,))
        check_graphs(runs[name], "prefix_int8 " + name)
        if name == "int8":
            counts = route_counts(paged_window_attention)
            launches = counts["launches"]
            int8_launches = counts["int8_launches"]
    for name in ("int8", "f32"):
        run = serve_burst(model, CacheConfig(**SERVING_CACHE, **kinds[name]),
                          prompts, capture=False)
        check_graphs(run, "prefix_int8 %s eager" % name)
        if run["streams"] != runs[name]["streams"]:
            fail("prefix_int8: the captured %s streams differ from the "
                 "eager ones" % name)
        runs[name + "_eager"] = run
    rep = runs["int8"]["report"]
    calls = (rep["decode_step"]["count"] + rep["extend"]["count"])
    want = (N_REQUESTS - 1, 1, (N_REQUESTS - 1) * SYSTEM_PROMPT)
    for name in ("int8", "f32", "int8_eager", "f32_eager"):
        r = runs[name]["report"]
        got = (r["prefix_cache_hits_total"], r["prefix_cache_misses_total"],
               r["prefill_tokens_avoided_total"])
        if got != want:
            fail("%s prefix caching: (hits, misses, tokens avoided) = %s, "
                 "expected %s" % (name, got, want))
    if int8_launches < MODEL["n_layer"] * calls or \
            int8_launches != launches:
        fail("the int8 kernel launched %d times (of %d launches) over %d "
             "decode steps and suffix prefills of %d layers"
             % (int8_launches, launches, calls, MODEL["n_layer"]))
    # decode steps take the split route, suffix prefills the query-tile
    # route (or the split route at buckets up to its threshold)
    if counts["generic_launches"] or counts["split_launches"] < \
            MODEL["n_layer"] * rep["decode_step"]["count"] or \
            counts["tile_launches"] < MODEL["n_layer"] or \
            counts["split_launches"] + counts["tile_launches"] != launches:
        fail("prefix_int8: the paged launches did not take the split and "
             "query-tile routes: %s" % counts)
    # f32 pools: prefix caching must not change the streams, except
    # where the full forward's top-2 logit gap says the two are a tie
    ties = near_ties(model, prompts, runs["f32"]["streams"],
                     runs["f32_nocache"]["streams"], "prefix_int8 f32")
    # report only: how far the int8 streams follow the f32 ones
    agree = [first_divergence(a, b) for a, b in zip(
        runs["int8"]["streams"], runs["f32"]["streams"])]
    same = sum(x == y for a, b in zip(runs["int8"]["streams"],
                                      runs["f32"]["streams"])
               for x, y in zip(a, b))
    row = {"phase": "prefix_int8", "card": card,
           "system_prompt": SYSTEM_PROMPT, "suffix_tokens": SUFFIX_TOKENS,
           "prefix_cache_hits": rep["prefix_cache_hits_total"],
           "prefix_cache_misses": rep["prefix_cache_misses_total"],
           "prefill_tokens_avoided": rep["prefill_tokens_avoided_total"],
           "prefill_tokens_computed": rep["prefill_tokens_computed_total"],
           "kernel_launches": launches, "int8_launches": int8_launches,
           "route_launches": counts,
           "f32_near_ties": ties,
           "captured_streams_equal_eager": {"int8": True, "f32": True},
           "int8_vs_f32_streams_identical": sum(a is None for a in agree),
           "int8_vs_f32_tokens_equal": same,
           "int8_vs_f32_first_divergence": agree}
    for name, run in runs.items():
        row[name] = burst_row(run)
    int8_streams = runs["int8"]["streams"]
    del runs
    torch.cuda.empty_cache()
    emit(row)
    return counts, int8_streams


SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)


def phase_sampling(card, model, greedy_streams):
    """Mixed greedy and seeded sampled requests in one captured burst
    (``DecodingConfig(sampling=True)``), the same burst submitted in
    reverse order, and the sampling head's device time."""
    from paddle_tpu_torch.decoding import (GREEDY, CacheConfig,
                                           SamplingParams)

    prompts = serving_prompts()
    params = [GREEDY if i % 2 == 0 else
              SamplingParams(**SAMPLED, seed=1000 + i)
              for i in range(N_REQUESTS)]
    params[1] = SamplingParams(temperature=0.8, top_k=1, seed=7)
    cache = CacheConfig(**SERVING_CACHE)
    fwd = serve_burst(model, cache, prompts, params=params, sampling=True)
    order = list(range(N_REQUESTS))[::-1]
    rev = serve_burst(model, cache, [prompts[i] for i in order],
                      params=[params[i] for i in order], sampling=True)
    rev_streams = [None] * N_REQUESTS
    for k, i in enumerate(order):
        rev_streams[i] = rev["streams"][k]
    check_graphs(fwd, "sampling")
    check_graphs(rev, "sampling reversed")
    greedy_rows = [i for i, p in enumerate(params) if p.greedy]
    for i in greedy_rows:
        if fwd["streams"][i] != greedy_streams[i]:
            fail("sampling: greedy request %d differs from the greedy "
                 "burst's stream" % i)
    if fwd["streams"][1] != greedy_streams[1]:
        fail("sampling: the top_k=1 request differs from greedy")
    if rev_streams != fwd["streams"]:
        bad = [i for i in range(N_REQUESTS)
               if rev_streams[i] != fwd["streams"][i]]
        fail("sampling: seeded streams changed with the submission order "
             "(requests %s)" % bad)
    sampled_rows = [i for i, p in enumerate(params)
                    if not p.greedy and p.top_k != 1]
    moved = sum(fwd["streams"][i] != greedy_streams[i]
                for i in sampled_rows)
    head_ms, argmax_ms = sampling_head_ms(params)
    emit({"phase": "sampling", "card": card, **burst_row(fwd),
          "reversed": burst_row(rev),
          "greedy_rows": len(greedy_rows),
          "sampled_rows_off_greedy": moved,
          "sampled_rows": len(sampled_rows),
          "greedy_rows_equal_greedy_burst": True,
          "top_k_1_equals_greedy": True,
          "reversed_order_streams_equal": True,
          "sampling_head_device_ms": head_ms,
          "greedy_head_device_ms": argmax_ms})
    del fwd, rev
    torch.cuda.empty_cache()


def sampling_head_ms(params):
    """Device ms of the sampling head alone at the decode shape (two
    sorts over V and a threefry of [B, V]) and of the greedy argmax, on
    random logits with the burst's per-row parameters. The head is
    timed as a captured graph's replay, as it runs in a decode step (its
    ~400 launches would fill the launch queue behind ``device_ms``'s
    spin)."""
    from paddle_tpu_torch.decoding.sampling import _sample_token

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    logits = 3 * torch.randn(len(params), MODEL["vocab_size"], device=dev,
                             generator=gen)
    feeds = [torch.tensor([p.temperature for p in params], device=dev),
             torch.tensor([p.top_k for p in params], device=dev,
                          dtype=torch.int32),
             torch.tensor([p.top_p for p in params], device=dev),
             torch.tensor([p.seed for p in params], device=dev,
                          dtype=torch.int32),
             torch.arange(len(params), device=dev, dtype=torch.int32)]
    _sample_token(logits, *feeds)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _sample_token(logits, *feeds)
    return (device_ms(graph.replay, 20),
            device_ms(lambda: torch.argmax(logits, -1), 50))


def phase_speculative(card, model, greedy_streams):
    """Speculative decoding of the greedy burst: a one-layer draft of the
    same vocab and widths (its own scope, its own seed) at
    ``speculate_k`` 3 (verify windows of 4: the split route) and 8
    (windows of 9: the query-tile route), and a parameter-copied
    self-draft at 3."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import paged_window_attention
    from paddle_tpu_torch.ops.paged_attention import SPLIT_MAX_T

    prompts = serving_prompts()
    cache = CacheConfig(**SERVING_CACHE)
    main, logits, scope = model
    draft = build_model(n_layer=1, seed=SEED + 5)
    self_scope = fluid.Scope()
    for n in scope.local_var_names():
        if not n.startswith("kv_cache@"):
            self_scope.set_var(n, scope.find_var(n).clone())
    runs = (("k3", 3, draft, 1), ("k8", 8, draft, 1),
            ("self_k3", 3, (main, logits, self_scope), MODEL["n_layer"]))
    rows, counts_by = {}, {}
    for label, k, d, d_layers in runs:
        run = serve_burst(model, cache, prompts,
                          counters=(paged_window_attention,), draft=d,
                          speculate_k=k)
        counts = route_counts(paged_window_attention)
        check_graphs(run, "speculative " + label)
        rep, drep = run["report"], run["draft_report"]
        verify = rep["verify_steps_total"]
        draft_steps = drep["decode_step"]["count"]
        # the target never decodes: its paged launches are the verify
        # windows', the draft's are its decode steps'
        target, drafted = MODEL["n_layer"] * verify, d_layers * draft_steps
        want = ({"split_launches": target + drafted, "tile_launches": 0}
                if k + 1 <= SPLIT_MAX_T else
                {"split_launches": drafted, "tile_launches": target})
        got = {n: counts[n] for n in want}
        if got != want or counts["generic_launches"] or \
                counts["launches"] != target + drafted:
            fail("speculative %s: route launches %s, expected %s over %d "
                 "verify steps and %d draft steps" % (label, counts, want,
                                                      verify, draft_steps))
        ties = near_ties(model, prompts, run["streams"], greedy_streams,
                         "speculative " + label)
        if label.startswith("self") and rep["spec_acceptance_rate"] != 1.0:
            fail("speculative %s: a parameter-copied self-draft accepted "
                 "%.4f of its proposals, not all"
                 % (label, rep["spec_acceptance_rate"]))
        decoded = sum(len(x) for x in run["streams"]) - len(prompts)
        rows[label] = {**burst_row(run), "speculate_k": k,
                       "draft_layers": d_layers,
                       "acceptance_rate": rep["spec_acceptance_rate"],
                       "spec_proposed": rep["spec_proposed_total"],
                       "spec_accepted": rep["spec_accepted_total"],
                       "verify_steps": verify,
                       # tokens a sequence gains from one verify
                       "tokens_per_verify_row":
                           decoded / rep["verify_rows_total"],
                       "draft_decode_steps": draft_steps,
                       "mean_draft_decode_step_ms":
                           drep["decode_step"]["mean_ms"],
                       "route_launches": counts, "near_ties": ties}
        counts_by[label] = counts
        del run
        torch.cuda.empty_cache()
    emit({"phase": "speculative", "card": card, **rows})
    return counts_by


# ------------------------------------------------------- resilience, server

# the ladder leg's pool: 104 blocks of 16 (the burst's worst case is 154)
# hold the lowest class's requests and some more, so the higher classes
# preempt (5 preemptions) and some preempted requests find their
# published prefix still cached when they resume (3 suffix prefills);
# the admission order, and so these counts, do not depend on the card
LADDER_CACHE = dict(num_blocks=104, block_size=16, max_blocks_per_seq=32)
LADDER_CLASSES = (0, 1, 2)  # PRIORITY_HIGH, _NORMAL, _LOW by i % 3


def outcomes(futs, timeout=600):
    """Each future's stream, or the exception it resolved with."""
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=timeout))
        except Exception as e:  # the caller checks the class
            out.append(e)
    return out


def accepted_equal(model, prompts, got, want, label):
    """Every completed stream (not an exception) equals ``want`` but at
    a near tie (``near_ties``); returns (accepted count, near ties)."""
    keep = [i for i, g in enumerate(got) if not isinstance(g, Exception)]
    for i in keep:
        if len(got[i]) != MAX_NEW:
            fail("%s: request %d completed with %d tokens" % (
                label, i, len(got[i])))
    ties = near_ties(model, [prompts[i] for i in keep],
                     [got[i] for i in keep], [want[i] for i in keep],
                     label)
    return len(keep), ties


def check_warm_graphs(engines, label):
    """No capture after warm-up: each engine holds exactly its warm
    buckets' graphs."""
    got = [e.num_compiled for e in engines]
    want = [e.warm_bucket_count() for e in engines]
    if got != want:
        fail("%s: %s graphs after the traffic, expected the warm buckets' "
             "%s" % (label, got, want))
    return got


def schedule_matches(plan, log, hits):
    """The live injections equal the plan's simulation of the observed
    hit counts, site by site (the live log interleaves sites)."""
    sim = plan.schedule(hits)
    return all([r for r in log if r["site"] == site]
               == [r for r in sim if r["site"] == site] for site in hits)


class Hold:
    """A streaming callback that holds the session's worker at the first
    token of its request until ``release()``: what follows (a ladder
    stage, more submits) lands at a fixed point of the stream."""

    def __init__(self):
        import threading

        self.tokens = []
        self.reached = threading.Event()
        self.go = threading.Event()

    def __call__(self, tok):
        self.tokens.append(tok)
        if len(self.tokens) == 1:
            self.reached.set()
            self.go.wait(timeout=300)

    def release(self):
        self.go.set()


def phase_resilience(card, model, greedy, serving_counts, prefix_streams):
    """The decode tier's fault and overload paths over the serving
    phase's model, every bucket captured: (a) default off — the serving
    burst again, no plan, breaker or ladder; (b) a seeded FaultPlan with
    a circuit breaker over the prefix_int8 phase's shared-prompt burst
    (int8 pools, prefix caching); (c) the degradation ladder: priority classes, preemption
    and resumption, stage-4 shedding, the walk back; (d) speculation's
    draft-step and verify-step faults. Returns the paged launches by
    route of each leg."""
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import paged_window_attention as pwa
    from paddle_tpu_torch.resilience import (CircuitBreaker,
                                             DegradationConfig,
                                             DegradationManager, FaultPlan,
                                             InjectedFault, faults)
    from paddle_tpu_torch.serving import (DraftEngineError,
                                          GenerationInterruptedError,
                                          OverloadedError, is_retriable)

    t_phase = time.perf_counter()
    prompts = serving_prompts()
    cache = CacheConfig(**SERVING_CACHE)
    counts, row = {}, {"phase": "resilience", "card": card}

    # (a) default off: the serving phase's streams, launches and graphs
    if faults.active_plan() is not None:
        fail("resilience: a fault plan is active before the default-off leg")
    run = serve_burst(model, cache, prompts, counters=(pwa,))
    counts["default_off"] = route_counts(pwa)
    check_graphs(run, "resilience default-off")
    if run["streams"] != greedy:
        fail("resilience default-off: the streams differ from the serving "
             "phase's")
    if counts["default_off"] != serving_counts:
        fail("resilience default-off: paged launches %s, the serving "
             "phase's %s" % (counts["default_off"], serving_counts))
    row["default_off"] = {**burst_row(run), "streams_equal_serving": True,
                          "route_launches": counts["default_off"]}
    del run

    # (b) a seeded plan over the shared-prompt int8 burst, with a
    # breaker: two admission raises (the request stays queued), two
    # prefill raises (those two requests fail alone, and the breaker
    # opens), three decode-step raises (a batch step, then a solo
    # re-step: its retry), and the second prefix publish corrupted (a
    # request's private suffix blocks stay private; nothing shares
    # them, so no stream depends on it — under int8 a hit's stream may
    # differ from a miss's, so the system prompt's publish is spared)
    sp = shared_prompts()
    plan = (FaultPlan(seed=SEED + 11)
            .rule("serving.admission", "raise", hits=[0, 5])
            .rule("decoding.prefill", "raise", hits=[3, 4])
            .rule("decoding.step", "raise", hits=[6, 7, 30])
            .rule("decoding.prefix_commit", "corrupt", hits=[1]))
    br = CircuitBreaker(window=4, min_samples=2, failure_rate=0.5,
                        reset_timeout_s=0.05)
    session, engines = open_session(
        model, CacheConfig(**SERVING_CACHE, kv_dtype="int8",
                           prefix_cache=True), breaker=br)
    reset_counts(pwa)
    faults.install_plan(plan)
    try:
        futs = [session.submit(p, max_new_tokens=MAX_NEW) for p in sp]
        session.start()
        got = outcomes(futs)
        log, hits = faults.injection_log(), faults.hit_counts()
        injected = faults.injections()
    finally:
        faults.clear_plan()
    opened = [t for t in br.transitions if t["to"] == "open"]
    # the breaker opened on the prefill failures; a probe after its reset
    # timeout is admitted half-open and closes it
    time.sleep(2 * br.reset_timeout_s)
    probe = session.submit(sp[0], max_new_tokens=MAX_NEW).result(timeout=600)
    state = br.state
    rep = session.metrics.report()
    counts["faults"] = route_counts(pwa)
    graphs = check_warm_graphs(engines, "resilience faults")
    session.shutdown(drain=True, timeout=120)
    failed = {i: type(g).__name__ for i, g in enumerate(got)
              if isinstance(g, Exception)}
    if sorted(failed.values()).count("InjectedFault") != 2 or any(
            not isinstance(got[i], (InjectedFault,
                                    GenerationInterruptedError))
            for i in failed):
        fail("resilience faults: failed requests %s, expected two prefill "
             "injections (and at most interrupted re-steps)" % failed)
    n_ok, ties = accepted_equal(model, sp, got, prefix_streams,
                                "resilience faults")
    if not schedule_matches(plan, log, hits):
        fail("resilience faults: injections %s differ from the plan's "
             "schedule of %s" % (log, hits))
    if not opened or state != "closed":
        fail("resilience faults: the breaker's transitions %s (state %s): "
             "it should open on the failures and close after a probe"
             % (br.transitions, state))
    if rep["retries_total"] < 1 or rep["prefix_commits_dropped_total"] != 1:
        fail("resilience faults: %d retries, %d dropped prefix publishes"
             % (rep["retries_total"], rep["prefix_commits_dropped_total"]))
    accepted_equal(model, [sp[0]], [probe], [prefix_streams[0]],
                   "resilience probe")
    row["faults"] = {
        "plan": plan.to_dict(), "injections": injected, "hits": hits,
        "schedule_equals_plan": True, "failed": failed,
        "accepted": n_ok, "near_ties": ties,
        "restep_retries": rep["retries_total"],
        "decode_steps": rep["decode_steps_total"],
        "prefix_commits_dropped": rep["prefix_commits_dropped_total"],
        "prefix_cache_hits": rep["prefix_cache_hits_total"],
        "breaker_transitions": [(t["from"], t["to"], t["reason"])
                                for t in br.transitions],
        "graphs": graphs, "route_launches": counts["faults"]}

    # (c) the ladder: the lowest class streams first on a pool that
    # holds four of them; at stage 2 the higher classes arrive and
    # preempt them; every stream then completes, the preempted ones
    # resumed through their published prefixes (suffix prefills)
    mgr = DegradationManager(DegradationConfig(down_after=10 ** 6))
    session, engines = open_session(
        model, CacheConfig(**LADDER_CACHE, prefix_cache=True), degrade=mgr)
    prio = [LADDER_CLASSES[i % 3] for i in range(N_REQUESTS)]
    low = [i for i in range(N_REQUESTS) if prio[i] == 2]
    hold = Hold()
    reset_counts(pwa)
    futs = {low[0]: session.submit(prompts[low[0]], max_new_tokens=MAX_NEW,
                                   priority=2, on_token=hold)}
    for i in low[1:]:
        futs[i] = session.submit(prompts[i], max_new_tokens=MAX_NEW,
                                 priority=2)
    session.start()
    try:
        if not hold.reached.wait(timeout=300):
            fail("resilience ladder: the first request never streamed")
        mgr.force_stage(2, "chip_smoke")
        for i in range(N_REQUESTS):
            if i not in futs:
                futs[i] = session.submit(prompts[i], max_new_tokens=MAX_NEW,
                                         priority=prio[i])
    finally:
        hold.release()
    got = outcomes([futs[i] for i in range(N_REQUESTS)])
    if any(isinstance(g, Exception) for g in got):
        fail("resilience ladder: %s" % [repr(g) for g in got
                                        if isinstance(g, Exception)])
    n_ok, ladder_ties = accepted_equal(model, prompts, got, greedy,
                                       "resilience ladder")
    if hold.tokens != got[low[0]]:
        fail("resilience ladder: the held request streamed %s, resolved "
             "%s" % (hold.tokens, got[low[0]]))
    lrep = session.metrics.report()
    counts["ladder"] = route_counts(pwa)
    if lrep["preemptions_total"] < 1 or lrep["prefix_cache_hits_total"] < 1 \
            or counts["ladder"]["tile_launches"] \
            + counts["ladder"]["split_launches"] != \
            counts["ladder"]["launches"] or \
            counts["ladder"]["generic_launches"]:
        fail("resilience ladder: %d preemptions, %d resumed through a "
             "cached prefix, launches %s"
             % (lrep["preemptions_total"], lrep["prefix_cache_hits_total"],
                counts["ladder"]))
    # stage 4 sheds the lowest class with a Retry-After hint; a higher
    # class is still served
    mgr.force_stage(4, "chip_smoke")
    try:
        session.submit(prompts[low[0]], max_new_tokens=MAX_NEW, priority=2)
        fail("resilience ladder: stage 4 admitted the lowest class")
    except OverloadedError as e:
        if not is_retriable(e) or not e.retry_after_s > 0:
            fail("resilience ladder: shed without a retriable hint (%r)"
                 % (e,))
        hint = e.retry_after_s
    served = session.submit(prompts[1], max_new_tokens=MAX_NEW,
                            priority=1).result(timeout=600)
    accepted_equal(model, [prompts[1]], [served], [greedy[1]],
                   "resilience stage 4")
    # pressure cleared: with a short hysteresis the idle worker's
    # evaluations walk the ladder back, one stage at a time
    mgr.config.down_after = 2
    deadline = time.monotonic() + 60
    while mgr.stage > 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    if mgr.stage != 0:
        fail("resilience ladder: stuck at stage %d" % mgr.stage)
    graphs = check_warm_graphs(engines, "resilience ladder")
    session.shutdown(drain=True, timeout=120)
    row["ladder"] = {
        "cache": LADDER_CACHE, "accepted": n_ok, "near_ties": ladder_ties,
        "preemptions": lrep["preemptions_total"],
        "resumed_from_prefix": lrep["prefix_cache_hits_total"],
        "suffix_prefills": lrep["extend"]["count"],
        "admission_blocked": lrep["admission_blocked_total"],
        "shed": lrep["admissions_rejected_total"], "retry_after_s": hint,
        "transitions": [(t["from"], t["to"], t["reason"])
                        for t in mgr.transitions],
        "graphs": graphs, "route_launches": counts["ladder"],
        "decode_step_ms_mean": lrep["decode_step"]["mean_ms"]}

    # (d) speculation (the speculative phase's one-layer draft, k=3): a
    # draft-step raise mid-burst falls back to plain decoding for good;
    # a verify-step raise costs one plain round
    draft = build_model(n_layer=1, seed=SEED + 5)
    for label, site, hit in (("draft_fault", "decoding.draft_step", 20),
                             ("verify_fault", "decoding.verify_step", 2)):
        plan = FaultPlan(seed=SEED + 12).rule(site, "raise", hits=[hit])
        session, engines = open_session(model, cache, draft=draft,
                                        speculate_k=3)
        reset_counts(pwa)
        faults.install_plan(plan)
        try:
            futs = [session.submit(p, max_new_tokens=MAX_NEW)
                    for p in prompts]
            session.start()
            got = outcomes(futs)
            injected = faults.injections()
        finally:
            faults.clear_plan()
        health = session.health()
        drep = session.metrics.report()
        counts[label] = route_counts(pwa)
        graphs = check_warm_graphs(engines, "resilience " + label)
        err = session.batcher.draft_error
        session.shutdown(drain=True, timeout=120)
        n_ok, ties = accepted_equal(model, prompts, got, greedy,
                                    "resilience " + label)
        if n_ok != N_REQUESTS or injected != {site + ":raise": 1}:
            fail("resilience %s: %d of %d completed, injections %s"
                 % (label, n_ok, N_REQUESTS, injected))
        fallback = isinstance(err, DraftEngineError)
        if fallback != (label == "draft_fault"):
            fail("resilience %s: draft error %r, speculation %s"
                 % (label, err, health.get("speculation")))
        row[label] = {"injections": injected, "near_ties": ties,
                      "speculation": health["speculation"],
                      "spec_disabled": drep["spec_disabled_total"],
                      "verify_steps": drep["verify_steps_total"],
                      "acceptance_rate": drep["spec_acceptance_rate"],
                      "graphs": graphs, "route_launches": counts[label]}
    del draft
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return counts


SERVER_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
SERVER_T = 128           # BERT-base's phase-1 sequence length
SERVER_REQUESTS, SERVER_CLIENTS, SERVER_ROWS = 256, 8, (1, 8)
SERVER_OVERSIZE = 100    # one request past the largest bucket
SERVER_ROOT = "build/chip_smoke_server"  # under the checkout, ignored
SERVER_FLAGS = {"use_bfloat16": True, "bf16_activations": True}


def build_server_model(flags=SERVER_FLAGS):
    """A BERT-base sentence-pair classifier for inference: the encoder
    of ``bert_encoder`` at BERT_MODEL's widths (``is_test``,
    ``attn_impl="pallas"``, built under ``flags``: by default the bert
    phase's bf16 flags; the ptq phase's f32 program turns them off),
    feeds ``[-1, SERVER_T]``, then ``bert_pretrain``'s next-sentence
    head over [CLS] — ``fc(tanh)``, ``fc(2)`` — and a softmax. Returns
    (main, feed names, probabilities var, scope) with numpy-seeded
    weights on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import bert_encoder

    saved = {n: fluid.get_flag(n) for n in flags}
    fluid.set_flags(flags)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            feeds = [fluid.layers.data(name=n, shape=[-1, SERVER_T],
                                       dtype=dt, append_batch_size=False)
                     for n, dt in (("src_ids", "int64"),
                                   ("sent_ids", "int64"),
                                   ("pos_ids", "int64"),
                                   ("input_mask", "float32"))]
            enc = bert_encoder(*feeds, **BERT_MODEL, dropout=BERT_DROPOUT,
                               is_test=True, attn_impl="pallas")
            cls = fluid.layers.squeeze(fluid.layers.slice(
                enc, axes=[1], starts=[0], ends=[1]), axes=[1])
            pooled = fluid.layers.fc(input=cls, size=BERT_MODEL["d_model"],
                                     act="tanh")
            prob = fluid.layers.softmax(fluid.layers.fc(input=pooled,
                                                        size=2))
    finally:
        fluid.set_flags(saved)
    scope = fluid.Scope()
    fluid.params_from_numpy(seeded_weights(main, SEED + 13), scope,
                            fluid.CUDAPlace(0), program=main)
    return main, [v.name for v in feeds], prob, scope


def server_requests(seed=SEED + 14):
    """SERVER_REQUESTS sentence pairs of 1-8 rows each, then one of
    SERVER_OVERSIZE rows: lengths 8-128, two segments, ids from the
    vocab."""
    rng = np.random.RandomState(seed)
    sizes = list(rng.randint(SERVER_ROWS[0], SERVER_ROWS[1] + 1,
                             size=SERVER_REQUESTS)) + [SERVER_OVERSIZE]
    out = []
    for n in sizes:
        lens = rng.randint(8, SERVER_T + 1, size=n)
        first = rng.randint(1, SERVER_T, size=n) % lens
        cols = np.arange(SERVER_T)[None, :]
        mask = cols < lens[:, None]
        out.append({
            "src_ids": np.where(mask, rng.randint(
                1, BERT_MODEL["vocab_size"], size=(n, SERVER_T)),
                0).astype(np.int64),
            "sent_ids": (mask & (cols > first[:, None])).astype(np.int64),
            "pos_ids": np.broadcast_to(cols, (n, SERVER_T)).astype(np.int64),
            "input_mask": mask.astype(np.float32)})
    return out


def phase_server(card, held):
    """The bucketed request server over an inference program: BERT-base
    sentence-pair classification saved with ``save_inference_model``,
    loaded with ``load_inference_model`` and served with
    ``serve_program`` (buckets 1-64, every bucket a captured graph) to
    8 client threads; then a poison request. The warm-up runs with the
    ``compile_cache_dir`` flag set, so each capture is fingerprinted
    into ``compile_cache.recent_fingerprints()``. Returns the flash
    forward's launches and the batches executed; ``held`` receives the
    engine and the 7 capture fingerprints (the obs phase's)."""
    import shutil
    import threading

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import metrics as obs_metrics
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.resilience import FaultPlan, InjectedFault, faults
    from paddle_tpu_torch.serving import (InferenceServer, ServingConfig,
                                          serve_program)

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SERVER_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    main, feed_names, prob, scope = build_server_model()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    fluid.io.save_inference_model(root, feed_names, [prob], exe,
                                  main_program=main, scope=scope,
                                  export_stablehlo=False)
    save_s = time.perf_counter() - t0
    del scope
    served_scope = fluid.Scope()
    t0 = time.perf_counter()
    program, feeds, fetches = fluid.io.load_inference_model(
        root, exe, scope=served_scope, program=main)
    load_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    config = ServingConfig(buckets=SERVER_BUCKETS, batch_timeout_ms=2.0,
                           queue_capacity=4 * SERVER_REQUESTS)
    server = serve_program(program, feeds, fetches, scope=served_scope,
                           config=config, place=fluid.CUDAPlace(0),
                           auto_start=False)
    from paddle_tpu_torch.compile_cache import recent_fingerprints

    # the flag on for the captures alone: they are fingerprinted (and
    # persist nothing)
    fluid.set_flags({"compile_cache_dir": root + "_cache"})
    try:
        t0 = time.perf_counter()
        server.start()  # warm_up: one capture per bucket
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        fluid.set_flags({"compile_cache_dir": ""})
    engine = server.engine
    if engine.compile_count != len(SERVER_BUCKETS):
        fail("server: %d graphs after warm-up, expected one per bucket (%d)"
             % (engine.compile_count, len(SERVER_BUCKETS)))
    fps = [r["fingerprint"] for r in recent_fingerprints()
           if r["kind"] == "graph"][-len(SERVER_BUCKETS):]
    if len(set(fps)) != len(SERVER_BUCKETS):
        fail("server: the warm-up fingerprinted %d distinct captures, "
             "expected %d" % (len(set(fps)), len(SERVER_BUCKETS)))
    reqs = server_requests()
    replies = [None] * len(reqs)
    latency = obs_metrics.Histogram()
    lock = threading.Lock()

    def client(c):
        for i in range(c, SERVER_REQUESTS, SERVER_CLIENTS):
            t = time.perf_counter()
            out, = server.infer(reqs[i], timeout=600)
            ms = (time.perf_counter() - t) * 1e3
            with lock:
                latency.observe(ms)
            replies[i] = out

    reset_counts(fa.flash_fwd)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(
            r is None for r in replies[:SERVER_REQUESTS]):
        fail("server: not every client request was answered")
    t = time.perf_counter()
    replies[-1], = server.infer(reqs[-1], timeout=600)  # oversize: chunks
    oversize_ms = (time.perf_counter() - t) * 1e3
    server.shutdown(drain=True, timeout=120)
    rep = server.metrics.report()
    # a poison request: three requests coalesce into one batch (queued
    # before the worker starts); serving.step raises on that batch and on
    # the second solo re-run, so that request alone fails
    poison = InferenceServer(engine, config=ServingConfig(
        buckets=SERVER_BUCKETS, batch_timeout_ms=200.0, warm_up=False),
        auto_start=False)
    pfeeds = reqs[:3]
    pfuts = [poison.submit(f) for f in pfeeds]
    faults.install_plan(FaultPlan(seed=SEED + 15).rule(
        "serving.step", "raise", hits=[0, 2]))
    try:
        poison.start()
        pgot = outcomes(pfuts)
    finally:
        faults.clear_plan()
        poison.shutdown(drain=True, timeout=120)
    if [isinstance(g, InjectedFault) for g in pgot] != [False, True, False]:
        fail("server: the poison request did not fail alone (%s)"
             % [repr(g) if isinstance(g, Exception) else "ok" for g in pgot])
    executed = server.metrics.report()["batch_execute"]["count"]
    launches = fa.flash_fwd.launches
    if launches != BERT_MODEL["n_layer"] * executed:
        fail("server: the flash forward launched %d times over %d executed "
             "batches of %d layers" % (launches, executed,
                                       BERT_MODEL["n_layer"]))
    if engine.compile_count != len(SERVER_BUCKETS):
        fail("server: %d graphs after the traffic, expected %d"
             % (engine.compile_count, len(SERVER_BUCKETS)))
    # every reply against an eager Executor.run of its own rows
    worst = 0.0
    for i, (feed, got) in enumerate(zip(reqs, replies)):
        want, = exe.run(program, feed=feed, fetch_list=fetches,
                        scope=served_scope)
        if got.shape != want.shape or not np.isfinite(got).all():
            fail("server: request %d replied %s, eager %s" % (
                i, got.shape, want.shape))
        worst = max(worst, float(np.abs(got - want).max()))
    for g, feed in zip(pgot[::2], pfeeds[::2]):
        want, = exe.run(program, feed=feed, fetch_list=fetches,
                        scope=served_scope)
        worst = max(worst, float(np.abs(g[0] - want).max()))
    if worst > TOL[torch.bfloat16]:
        fail("server: a reply differs from its eager run by %g" % worst)
    rows = sum(len(r["src_ids"]) for r in reqs)
    emit({"phase": "server", "card": card, "model": BERT_MODEL,
          "flags": SERVER_FLAGS, "seq_len": SERVER_T,
          "buckets": SERVER_BUCKETS, "batch_timeout_ms": 2.0,
          "requests": len(reqs), "clients": SERVER_CLIENTS, "rows": rows,
          "save_s": save_s, "load_s": load_s, "warm_up_s": warm_s,
          "graphs": engine.compile_count,
          "rows_per_s": (rows - SERVER_OVERSIZE) / wall_s,
          "traffic_wall_s": wall_s, "oversize_ms": oversize_ms,
          "padded_row_share": rep["padding_overhead"],
          "batches": rep["batches_total"], "executed_batches": executed,
          "mean_batch_rows": rep["batch_size"]["mean_rows"],
          "request_latency_ms": latency.snapshot(),
          "queue_wait_ms": rep["queue_wait"],
          "batch_execute_ms": rep["batch_execute"],
          "flash_fwd_launches": launches,
          "max_abs_err_vs_eager": worst, "poison_fails_alone": True,
          "prometheus_lines": len(
              obs_metrics.render_prometheus().splitlines()),
          "phase_s": time.perf_counter() - t_phase})
    held.update(engine=engine, fingerprints=fps)
    del server, poison, engine, served_scope
    return {"flash_fwd": launches, "batches": executed, "save_s": save_s,
            "load_s": load_s, "warm_up_s": warm_s,
            "rows_per_s": (rows - SERVER_OVERSIZE) / wall_s,
            "padded_row_share": rep["padding_overhead"]}


# the ptq phase: BERT-base served in int8 (f32 program, PTQ through
# quantize_for_serving), and one ResNet-50 batch through ptq_int8
PTQ_FLAGS = {"use_bfloat16": False, "bf16_activations": False}
PTQ_DRIFT = 0.05      # prob-space bound of tests/test_quantize_ptq.py:145
PTQ_REQUESTS = 128    # served requests of 1-8 rows
PTQ_CALIB = (8, 2)    # two calibration batches of 8 requests each
PTQ_RESNET_B = 8


def _stack(reqs):
    """One feed of the rows of ``reqs``."""
    return {n: np.concatenate([r[n] for r in reqs]) for n in reqs[0]}


def _graph_device_ms(place, program, feed, fetch, scope):
    """(device ms of one replay, fetches) of ``program`` captured at
    ``feed``'s shapes (``Executor.run_graph``)."""
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(place)
    out = exe.run_graph(program, feed=feed, fetch_list=fetch, scope=scope)
    cap = next(c for c in exe._cache.values() if c.graph is not None)

    def replay():
        cap.idx.zero_()  # the graph's row counter, as launch() resets it
        cap.graph.replay()

    ms = device_ms(replay, 20)
    exe.close()
    return ms, out


def ptq_resnet(place):
    """ResNet-50 (``is_test``, 224x224, f32, seeded weights) through
    ``ptq_int8`` on one batch of PTQ_RESNET_B images: every conv becomes
    an ``int8_conv_dequant``; the stem's (K = 147) and a 3x3 conv over
    512 channels run on CPU tensors and on the card from the same
    codes, bit for bit."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import passes
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    saved = {n: fluid.get_flag(n) for n in PTQ_FLAGS}
    fluid.set_flags(PTQ_FLAGS)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(
                name="img", shape=[-1, 3, RESNET_HW, RESNET_HW],
                dtype="float32", append_batch_size=False)
            predict = resnet_imagenet(img, class_dim=RESNET_CLASSES,
                                      is_test=True)
    finally:
        fluid.set_flags(saved)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.params_from_numpy(resnet_weights(main), scope, place,
                            program=main)
    rng = np.random.RandomState(SEED + 41)
    batch = {"img": rng.rand(PTQ_RESNET_B, 3, RESNET_HW,
                             RESNET_HW).astype(np.float32)}
    t0 = time.perf_counter()
    q = passes.quantize_for_serving(main, scope, [batch], place=place)
    quant_s = time.perf_counter() - t0
    convs = [op for op in q.global_block().ops
             if op.type == "int8_conv_dequant"]
    n_conv = sum(op.type == "conv2d" for op in main.global_block().ops)
    if len(convs) != n_conv or any(op.type == "conv2d"
                                   for op in q.global_block().ops):
        fail("ptq: %d of ResNet-50's %d convs became int8_conv_dequant"
             % (len(convs), n_conv))

    def filt(op):
        return tuple(scope.find_var(op.input("Y")[0]).shape)

    picks = [convs[0], next(op for op in convs
                            if filt(op)[1:] == (512, 3, 3))]
    ref, = exe.run(main, feed=batch, fetch_list=[predict.name], scope=scope)
    vals = exe.run(q, feed=batch, fetch_list=[predict.name] + [
        op.input("X")[0] for op in picks], scope=scope)
    got = vals[0]
    checked = []
    for op, codes in zip(picks, vals[1:]):
        w8 = scope.find_var(op.input("Y")[0])
        x = torch.from_numpy(codes)
        on_cpu = op.fn(x, w8.cpu())
        on_card = op.fn(x.to(place.torch_device()), w8).cpu()
        if not torch.equal(on_cpu, on_card):
            fail("ptq: the int8 conv %s (filter %s) parts from its CPU run "
                 "by %g" % (op.output("Out")[0], filt(op),
                            float((on_cpu - on_card).abs().max())))
        checked.append({"out": op.output("Out")[0], "filter": filt(op),
                        "input": list(codes.shape), "bit_equal": True})
    if not np.isfinite(got).all():
        fail("ptq: the int8 ResNet-50's logits are not finite")
    return {"convs": len(convs), "quantize_s": quant_s,
            "checked_convs": checked,
            "top1_agreement": float((got.argmax(1)
                                     == ref.argmax(1)).mean()),
            "max_abs_logit_drift": float(np.abs(got - ref).max()),
            "max_abs_logit": float(np.abs(ref).max())}


def phase_ptq(card):
    """BERT-base served in int8: ``build_server_model``'s classifier in
    f32 (without the server's bf16 flags), the same seeded weights,
    calibrated on two batches of requests and quantized with
    ``quantize_for_serving`` (every weight-carrying ``mul`` an
    ``int8_mul_dequant`` against an int8 weight on the card, the stamp
    set, zero diagnostics); served through ``serve_program`` over
    SERVER_BUCKETS (a captured graph per bucket) to client threads.
    Every reply equals the int8 program's ``Executor.run`` of its rows,
    bit for bit, and stays within PTQ_DRIFT of the f32 program's; the
    attention stays f32, so the f32 flash forward launches 12 times an
    executed batch. Then ResNet-50's int8 convs (:func:`ptq_resnet`).
    Returns the flash forward's launches."""
    import threading

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import analysis, passes
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import ServingConfig, serve_program

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    main, feed_names, prob, scope = build_server_model(PTQ_FLAGS)
    fetch = [prob.name]
    reqs = server_requests(SEED + 40)[:PTQ_REQUESTS]
    per, n_batches = PTQ_CALIB
    calib = [_stack(reqs[i * per:(i + 1) * per]) for i in range(n_batches)]
    t0 = time.perf_counter()
    q = passes.quantize_for_serving(main, scope, calib, place=place)
    quant_s = time.perf_counter() - t0
    gb, qb = main.global_block(), q.global_block()

    def weighted_muls(block):
        return [op for op in block.ops if op.type == "mul"
                and block._find_var_recursive(op.input("Y")[0]).persistable]

    n_mul = len(weighted_muls(gb))
    n_int8 = sum(op.type == "int8_mul_dequant" for op in qb.ops)
    if n_int8 != n_mul or weighted_muls(qb):
        fail("ptq: %d of BERT-base's %d weight-carrying muls became "
             "int8_mul_dequant" % (n_int8, n_mul))
    w8 = [n for n in scope.local_var_names() if n.endswith("@INT8")]
    bad = [n for n in w8 if scope.find_var(n).dtype != torch.int8
           or scope.find_var(n).device != place.torch_device()]
    if len(w8) != n_mul or bad:
        fail("ptq: %d int8 weights for %d muls; not int8 on the card: %s"
             % (len(w8), n_mul, bad[:5]))
    stamp = getattr(q, "_passes_stamp", None) or ""
    if not stamp.startswith("ptq_int8=int8/b8/per_channel"):
        fail("ptq: the int8 program carries no ptq_int8 stamp (%r)" % stamp)
    report = analysis.check_program(q, feed=feed_names, fetch_list=fetch)
    if report.diagnostics:
        fail("ptq: check_program reports on the int8 program:\n%s"
             % report)

    config = ServingConfig(buckets=SERVER_BUCKETS, batch_timeout_ms=2.0,
                           queue_capacity=4 * PTQ_REQUESTS)
    server = serve_program(q, feed_names, fetch, scope=scope, config=config,
                           place=place, auto_start=False)
    t0 = time.perf_counter()
    server.start()  # warm_up: one capture per bucket
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    engine = server.engine
    if engine.compile_count != len(SERVER_BUCKETS):
        fail("ptq: %d graphs after warm-up, expected one per bucket (%d)"
             % (engine.compile_count, len(SERVER_BUCKETS)))
    replies = [None] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), SERVER_CLIENTS):
            replies[i], = server.infer(reqs[i], timeout=600)

    reset_counts(fa.flash_fwd)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    server.shutdown(drain=True, timeout=120)
    if any(r is None for r in replies):
        fail("ptq: not every request was answered")
    executed = server.metrics.report()["batch_execute"]["count"]
    launches = fa.flash_fwd.launches
    if launches != BERT_MODEL["n_layer"] * executed:
        fail("ptq: the f32 flash forward launched %d times over %d executed "
             "batches of %d layers" % (launches, executed,
                                       BERT_MODEL["n_layer"]))
    if engine.compile_count != len(SERVER_BUCKETS):
        fail("ptq: %d graphs after the traffic, expected %d"
             % (engine.compile_count, len(SERVER_BUCKETS)))
    del server, engine

    # every reply against the int8 program's own eager run of its rows
    # (bit for bit) and the f32 program's (within PTQ_DRIFT)
    exe = fluid.Executor(place)
    unequal, worst, drift, agree, rows = 0, 0.0, 0.0, 0, 0
    for feed, got in zip(reqs, replies):
        want, = exe.run(q, feed=feed, fetch_list=fetch, scope=scope)
        ref, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        if got.shape != want.shape or not np.isfinite(got).all():
            fail("ptq: a reply of shape %s, eager %s" % (got.shape,
                                                        want.shape))
        if not np.array_equal(got, want):
            unequal += 1
            worst = max(worst, float(np.abs(got - want).max()))
        drift = max(drift, float(np.abs(got - ref).max()))
        agree += int((got.argmax(1) == ref.argmax(1)).sum())
        rows += len(got)
    if unequal:
        fail("ptq: %d of %d replies differ from the int8 program's "
             "Executor.run of their rows (max %g)" % (unequal, len(reqs),
                                                      worst))
    if not drift < PTQ_DRIFT:
        fail("ptq: the int8 replies drift %g from the f32 program's "
             "probabilities (bound %g)" % (drift, PTQ_DRIFT))
    rows_all = _stack(reqs)
    feed64 = {n: v[:SERVER_BUCKETS[-1]] for n, v in rows_all.items()}
    int8_ms, out8 = _graph_device_ms(place, q, feed64, fetch, scope)
    f32_ms, out32 = _graph_device_ms(place, main, feed64, fetch, scope)
    want64, = exe.run(q, feed=feed64, fetch_list=fetch, scope=scope)
    if not np.array_equal(out8[0], want64):
        fail("ptq: bucket 64's captured int8 run parts from its eager run "
             "by %g" % float(np.abs(out8[0] - want64).max()))
    resnet = ptq_resnet(place)
    emit({"phase": "ptq", "card": card, "model": BERT_MODEL,
          "flags": PTQ_FLAGS, "seq_len": SERVER_T,
          "buckets": SERVER_BUCKETS, "requests": len(reqs),
          "clients": SERVER_CLIENTS, "rows": rows,
          "calibration_rows": [len(c["src_ids"]) for c in calib],
          "stamp": stamp, "int8_muls": n_int8, "int8_weights": len(w8),
          "quantize_s": quant_s, "warm_up_s": warm_s,
          "graphs": len(SERVER_BUCKETS), "rows_per_s": rows / wall_s,
          "traffic_wall_s": wall_s, "executed_batches": executed,
          "flash_fwd_f32_launches": launches,
          "replies_bit_equal_to_eager": len(reqs),
          "max_prob_drift_vs_f32": drift, "drift_bound": PTQ_DRIFT,
          "top1_agreement": agree / rows,
          "bucket64_device_ms": {"int8": int8_ms, "f32": f32_ms},
          "bucket64_top1_agreement": float((out8[0].argmax(1)
                                            == out32[0].argmax(1)).mean()),
          "resnet50": resnet,
          "phase_s": time.perf_counter() - t_phase})
    return {"flash_fwd": launches}


def check_oracle(main, logits, scope, prompts, streams):
    """Two streams must equal greedy decoding by re-running the full
    unpaged forward on the card; a disagreement is tolerated only where
    the oracle's top-2 logit gap is below 1e-3 (then the streams
    legitimately part, and the check of that stream stops there)."""
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(fluid.CUDAPlace(0))
    for i in (0, N_REQUESTS - 1):
        seq = list(prompts[i])
        for j, got in enumerate(streams[i]):
            out, = exe.run(main, feed={"tokens": np.asarray([seq],
                                                            np.int64)},
                           fetch_list=[logits], scope=scope)
            last = out[0, -1]
            want = int(np.argmax(last))
            if got != want:
                top2 = np.sort(last)[-2:]
                gap = float(top2[1] - top2[0])
                if gap >= 1e-3:
                    fail("request %d token %d: served %d, oracle %d "
                         "(top-2 gap %g)" % (i, j, got, want, gap))
                emit({"phase": "oracle", "request": i, "token": j,
                      "served": got, "oracle": want, "top2_gap": gap,
                      "note": "near tie; stream check stops here"})
                break
            seq.append(got)
        else:
            emit({"phase": "oracle", "request": i,
                  "tokens_checked": len(streams[i]), "agree": True})


# ---------------------------------------------------------------- phase 4


def flash_inputs(B, Tq, Tk, H, D, masked, dtype, seed):
    """q, k, v, dO on the card in ``dtype`` and a ``[B, Tk]`` f32 key
    mask with ragged tails (every row keeps at least half its keys), or
    None."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda", 0)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    q, k, v, do = t(B, Tq, H, D), t(B, Tk, H, D), t(B, Tk, H, D), \
        t(B, Tq, H, D)
    mask = None
    if masked:
        lens = rng.randint(Tk // 2, Tk + 1, size=B)
        mask = torch.from_numpy((np.arange(Tk)[None, :] < lens[:, None])
                                .astype(np.float32)).to(dev)
    return q, k, v, do, mask


def flash_work(B, Tq, Tk, H, D, causal, mask, dtype):
    """{kernel: (bound ms, bound_by)} for this run's inputs. Operations
    count the valid (query, key) pairs — 4, 6 and 8 flops per pair and
    head-dim element for the forward, dQ and dK/dV — at the card's peak
    for the type; bytes count each input read once and each output
    written once, over 3.35 TB/s."""
    ok = (torch.ones(B, Tk, device="cuda") if mask is None
          else (mask > 0).float())
    per_key = (torch.clamp(Tq - torch.arange(Tk, device="cuda"), min=0)
               .float() if causal else torch.full((Tk,), float(Tq),
                                                 device="cuda"))
    pairs = H * float((ok * per_key).sum())
    item = torch.finfo(dtype).bits // 8
    qb, kb = B * Tq * H * D * item, B * Tk * H * D * item
    rows, mb = B * H * Tq * 4, (0 if mask is None else B * Tk * 4)
    work = {"flash_fwd": (4 * D * pairs, qb + 2 * kb + mb + qb + rows),
            "flash_bwd_dq": (6 * D * pairs,
                             3 * qb + 2 * kb + rows + mb + qb + rows),
            "flash_bwd_dkv": (8 * D * pairs,
                              2 * qb + 2 * kb + 2 * rows + mb + 2 * kb)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def sdpa_args(q, k, v, causal, mask):
    """SDPA's [B, H, T, D] copies and its mask arguments (the copies are
    made once, outside the timed calls)."""
    hm = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    kw = {}
    if mask is not None:
        m = (mask > 0)[:, None, None, :]
        if causal:
            Tq, Tk = q.shape[1], k.shape[1]
            m = m & torch.ones(Tq, Tk, dtype=torch.bool,
                               device=q.device).tril()[None, None]
        kw["attn_mask"] = m
    elif causal:
        kw["is_causal"] = True
    return hm, kw


def check_flash(label, dtype, q, k, v, do, causal, mask):
    """Run the three kernels once and hold them to the plain versions;
    returns the errors, or fails."""
    from paddle_tpu_torch.ops.flash_attention import (
        bf16_ulps, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
        plain_flash_backward, plain_flash_backward_bf16, plain_flash_forward,
        plain_flash_forward_bf16)

    o, lse = flash_fwd(q, k, v, causal, None, mask)
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal, None, mask)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal, None, mask)
    torch.cuda.synchronize()
    ro, rlse = plain_flash_forward(q, k, v, causal, None, mask)
    rdq, rdk, rdv = plain_flash_backward(q, k, v, o, lse, do, causal, None,
                                         mask)
    errs = {"o": float((o.float() - ro.float()).abs().max()),
            "lse": float((lse - rlse).abs().max())}
    if dtype == torch.bfloat16:
        # the bf16 forward within one bf16 ulp of the unrounded plain
        # version and of the model of its rounding (p as two bf16 parts)
        mo, _ = plain_flash_forward_bf16(q, k, v, causal, None, mask)
        errs["o_ulps"] = bf16_ulps(o, ro)
        errs["o_model_ulps"] = bf16_ulps(o, mo)
        del mo
        # the bf16 kernels against the model of their rounding; beside
        # them the unrounded plain version's reading of the same check
        # (above 1 for one of the three: the check sees the rounding)
        mdq, mdk, mdv = plain_flash_backward_bf16(q, k, v, o, lse, do,
                                                  causal, None, mask)
        for name, got, want, plain in (("dq", dq, mdq, rdq),
                                       ("dk", dk, mdk, rdk),
                                       ("dv", dv, mdv, rdv)):
            errs[name + "_model_rel"] = float(
                (got.float() - want.float()).abs().max()) / max(
                float(want.float().abs().max()), 1e-30)
            errs[name + "_model_ulps"] = bf16_ulps(got, want)
            errs[name + "_control_ulps"] = bf16_ulps(plain, want)
    for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        err = float((got.float() - want.float()).abs().max())
        errs[name] = err
        errs[name + "_rel"] = err / max(float(want.float().abs().max()),
                                        1e-30)
    for name, t in (("o", o), ("lse", lse), ("delta", delta), ("dq", dq),
                    ("dk", dk), ("dv", dv)):
        if not bool(torch.isfinite(t).all()):
            fail("flash %s %s: %s is not finite" % (label, dtype, name))
    if not (errs["o"] <= TOL[dtype] and errs["lse"] <= LSE_TOL):
        fail("flash %s %s: forward disagrees with the plain version: %s"
             % (label, dtype, errs))
    if dtype == torch.bfloat16 and not (errs["o_ulps"] <= 1.0
                                        and errs["o_model_ulps"] <= 1.0):
        fail("flash %s: the bf16 forward is more than one bf16 ulp from "
             "the plain version or its rounding model: %s" % (label, errs))
    if not all(errs[n + "_rel"] <= GRAD_TOL[dtype] for n in ("dq", "dk",
                                                              "dv")):
        fail("flash %s %s: backward disagrees with the plain version: %s"
             % (label, dtype, errs))
    if dtype == torch.bfloat16 and not all(
            errs[n + "_model_ulps"] <= 1.0 for n in ("dq", "dk", "dv")):
        fail("flash %s: the bf16 backward disagrees with its rounding "
             "model: %s" % (label, errs))
    return errs, (o, lse, delta)


def phase_flash():
    from paddle_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv, flash_bwd_dq, flash_fwd, plain_flash_backward,
        plain_flash_forward)

    rows = []
    for i, (label, B, Tq, Tk, H, D, causal, masked, dtypes) in \
            enumerate(FLASH_CASES):
        for dtype in dtypes:
            q, k, v, do, mask = flash_inputs(B, Tq, Tk, H, D, masked, dtype,
                                             seed=100 + i)
            errs, (o, lse, delta) = check_flash(label, dtype, q, k, v, do,
                                                causal, mask)
            long = Tq * Tk > 10 ** 6
            iters = 10 if long else 30
            ms = {
                "flash_fwd": cuda_ms(lambda: flash_fwd(
                    q, k, v, causal, None, mask), iters),
                "flash_bwd_dq": cuda_ms(lambda: flash_bwd_dq(
                    q, k, v, o, lse, do, causal, None, mask), iters),
                "flash_bwd_dkv": cuda_ms(lambda: flash_bwd_dkv(
                    q, k, v, lse, delta, do, causal, None, mask), iters),
            }
            plain_fwd_ms = cuda_ms(lambda: plain_flash_forward(
                q, k, v, causal, None, mask), 3, warmup=1)
            plain_bwd_ms = cuda_ms(lambda: plain_flash_backward(
                q, k, v, o, lse, do, causal, None, mask), 3, warmup=1)
            (sq, sk, sv), kw = sdpa_args(q, k, v, causal, mask)
            lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, **kw), iters)
            gq, gk, gv = (x.detach().requires_grad_() for x in (sq, sk, sv))
            out = F.scaled_dot_product_attention(gq, gk, gv, **kw)
            g_out = do.transpose(1, 2).contiguous()
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (gq, gk, gv), g_out, retain_graph=True), iters)
            dev = {}
            if label in DEVICE_CASES:
                dev["device_ms"] = {
                    "flash_fwd": device_ms(lambda: flash_fwd(
                        q, k, v, causal, None, mask), iters),
                    "flash_bwd_dq": device_ms(lambda: flash_bwd_dq(
                        q, k, v, o, lse, do, causal, None, mask), iters),
                    "flash_bwd_dkv": device_ms(lambda: flash_bwd_dkv(
                        q, k, v, lse, delta, do, causal, None, mask),
                        iters)}
                dev["sdpa_device_ms"] = {
                    "fwd": device_ms(lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, **kw), iters),
                    "bwd": device_ms(lambda: torch.autograd.grad(
                        out, (gq, gk, gv), g_out, retain_graph=True),
                        iters)}
                dev["plain_device_ms"] = {
                    "fwd": device_ms(lambda: plain_flash_forward(
                        q, k, v, causal, None, mask), 3, warmup=1),
                    "bwd": device_ms(lambda: plain_flash_backward(
                        q, k, v, o, lse, do, causal, None, mask), 3,
                        warmup=1)}
            del out
            bounds = flash_work(B, Tq, Tk, H, D, causal, mask, dtype)
            row = {"phase": "flash", "case": label,
                   "dtype": str(dtype)[6:], "B": B, "Tq": Tq, "Tk": Tk,
                   "H": H, "D": D, "causal": causal, "masked": masked,
                   "errors": errs, "ms": ms,
                   "bound_ms": {n: b[0] for n, b in bounds.items()},
                   "bound_by": {n: b[1] for n, b in bounds.items()},
                   "plain_fwd_ms": plain_fwd_ms,
                   "plain_bwd_ms": plain_bwd_ms,
                   "sdpa_fwd_ms": lib_fwd_ms, "sdpa_bwd_ms": lib_bwd_ms,
                   **dev}
            emit(row)
            rows.append(row)
            del q, k, v, do, mask, o, lse, delta, gq, gk, gv
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 5


def phase_routes():
    """Both attn_impl routes of the attention op on the same inputs
    (f32): forward, and forward + backward."""
    from paddle_tpu_torch.models.transformer import attention
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    routes = {"fused": lambda q, k, v, m, c: attention(q, k, v, mask=m,
                                                       causal=c),
              "pallas": lambda q, k, v, m, c: flash_attention(
                  q, k, v, causal=c, kv_mask=m)}
    out = []
    for B, T in ((TRAIN_B, TRAIN_T), (4, 2048)):
        for kind in ("key_masked", "causal"):
            causal = kind == "causal"
            q, k, v, do, mask = flash_inputs(B, T, T, 8, 64, not causal,
                                             torch.float32, seed=T)
            gq, gk, gv = (x.detach().requires_grad_() for x in (q, k, v))
            row = {"phase": "routes", "B": B, "T": T, "kind": kind}
            for name, fn in routes.items():
                def fwd():
                    with torch.no_grad():
                        fn(q, k, v, mask, causal)

                row[name + "_fwd_ms"] = cuda_ms(fwd, 10)
                row[name + "_fwd_bwd_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(
                        fn(gq, gk, gv, mask, causal), (gq, gk, gv), do), 10)
            emit(row)
            out.append(row)
            del q, k, v, do, mask, gq, gk, gv
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 6


def build_trainer(attn_impl):
    """(main, startup, avg_cost) of Transformer-base + Adam."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import transformer_base

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, avg_cost, _ = transformer_base(**TRAIN_MODEL,
                                          attn_impl=attn_impl)
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_cost)
    return main, startup, avg_cost


def train_batch(seed=SEED + 2):
    """One batch of B sentences of T tokens, ragged source and target
    tails (each keeps at least half its tokens)."""
    rng = np.random.RandomState(seed)
    V = TRAIN_MODEL["src_vocab_size"]
    ids = lambda: rng.randint(1, V, size=(TRAIN_B, TRAIN_T))  # noqa: E731
    mask = lambda: (np.arange(TRAIN_T)[None, :] < rng.randint(  # noqa: E731
        TRAIN_T // 2, TRAIN_T + 1, size=TRAIN_B)[:, None]).astype(np.float32)
    return {"src_word": ids(), "trg_word": ids(), "lbl_word": ids(),
            "src_mask": mask(), "trg_mask": mask()}


def _train_family(name: str) -> str:
    low = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if kernel + "_" in low:  # flash_fwd_kernel, flash_bwd_dq_mma_kernel
            return kernel
    if "fused_update_kernel" in low:
        return "fused_update"
    if "dropout_kernel" in low:
        return "dropout"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "matmul", "nvjet")):
        return "matmul"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def profile_step(run_step, top=15, family_launches=None,
                 family=_train_family):
    """One training step under torch.profiler: (host wall ms, device ms
    by kernel family (``family`` of a kernel's name), kernel launches,
    the ``top`` kernels by device ms as [name, ms, launches] rows). A
    dict passed as ``family_launches`` receives the kernels launched by
    family."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_family, by_name, launches = {}, {}, 0
    for e in prof.events():
        # a host span (paddle_tpu_torch.profiler's record_function
        # ranges) also shows on the device's timeline: not a kernel
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        fam = family(e.name)
        ms = float(e.time_range.elapsed_us()) / 1e3
        by_family[fam] = by_family.get(fam, 0.0) + ms
        name = by_name.setdefault(e.name[:90], [0.0, 0])
        name[0] += ms
        name[1] += 1
        launches += fam != "copies"
        if family_launches is not None:
            family_launches[fam] = family_launches.get(fam, 0) + 1
    if not by_family:
        fail("the profiler recorded no device activity")
    rows = sorted(([n, ms, k] for n, (ms, k) in by_name.items()),
                  key=lambda r: -r[1])[:top]
    return wall_ms, by_family, launches, rows


def grad_noise_floor(feed, fetch, checked, ref):
    """{gradient: max |fused on the card - fused on the host| / its max}:
    how far two correct f32 runs of the same step part when only the
    order of their sums differs. Far from the loss this floor can
    exceed 1e-3 of a gradient's max at this width (PERF.md has the
    card's numbers), so the kernel route is held to the plain route
    within twice the floor, and never looser than 1e-3."""
    import paddle_tpu_torch as fluid

    main, startup, _ = build_trainer("fused")
    scope, place = fluid.Scope(), fluid.CPUPlace()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.params_from_numpy(seeded_weights(main), scope, place,
                            program=main)
    host = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return {name: float(np.abs(dev - cpu).max()
                        / max(np.abs(cpu).max(), 1e-30))
            for name, dev, cpu in zip(checked, ref[1:], host[1:])}


def phase_training(card):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa

    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    place = fluid.CUDAPlace(0)
    feed = train_batch()
    nets = {}
    for impl in ("fused", "pallas"):
        main, startup, cost = build_trainer(impl)
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(seeded_weights(main), scope, place,
                                program=main)
        nets[impl] = (main, cost, scope, exe)
    fc_w = [p.name for p in nets["pallas"][0].all_parameters()
            if p.name.startswith("fc.w_")]
    # the source embedding, the first encoder Q weight and the last
    # decoder FFN weight (the last fc weight is the vocab projection)
    checked = ["src_word_emb_table", fc_w[0], fc_w[-2]]
    fetch = [nets["pallas"][1].name] + [n + "@GRAD" for n in checked]

    main, cost, scope, exe = nets["fused"]
    ref = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    del nets["fused"], main, scope, exe
    torch.cuda.empty_cache()
    floor = grad_noise_floor(feed, fetch, checked, ref)

    main, cost, scope, exe = nets["pallas"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in launchers:
        fn.launches = 0
    losses, step_s = [], []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, scope=scope,
                      fetch_list=fetch if step == 0 else [cost])
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
        if step == 0:
            first = {fn.__name__: fn.launches for fn in launchers}
            if any(n != ATTN_PER_STEP for n in first.values()):
                fail("step 0 launched %s flash kernels, expected %d of "
                     "each (one forward pass)" % (first, ATTN_PER_STEP))
            loss_rel = abs(losses[0] - float(ref[0])) / abs(float(ref[0]))
            grad_rel = {}
            for name, got, want in zip(checked, out[1:], ref[1:]):
                grad_rel[name] = float(np.abs(got - want).max()
                                       / max(np.abs(want).max(), 1e-30))
            if not loss_rel <= 1e-5:
                fail("step-0 loss: pallas %r, fused %r (rel %g > 1e-5)"
                     % (losses[0], float(ref[0]), loss_rel))
            grad_tol = {n: max(GRAD_TOL[torch.float32], 2.0 * floor[n])
                        for n in checked}
            if not all(grad_rel[n] <= grad_tol[n] for n in checked):
                fail("step-0 gradients disagree between the routes: %s "
                     "(limits %s)" % (grad_rel, grad_tol))
    launches = {fn.__name__: fn.launches for fn in launchers}
    peak = torch.cuda.max_memory_allocated()
    if any(n != ATTN_PER_STEP * TRAIN_STEPS for n in launches.values()):
        fail("%d steps launched %s flash kernels, expected %d of each"
             % (TRAIN_STEPS, launches, ATTN_PER_STEP * TRAIN_STEPS))
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite training loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("the loss did not fall over %d Adam steps: %s"
             % (TRAIN_STEPS, losses))
    steady = step_s[1:]
    step_ms = float(np.mean(steady)) * 1e3
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run(main, feed=feed, fetch_list=[cost], scope=scope))
    busy = sum(by_family.values())
    emit({"phase": "training", "card": card, "batch": TRAIN_B,
          "seq": TRAIN_T, "steps": TRAIN_STEPS, "losses": losses,
          "step0_loss_rel_err": loss_rel, "step0_grad_rel_err": grad_rel,
          "step0_grad_noise_floor": floor, "step0_grad_limit": grad_tol,
          "step_ms_mean": step_ms,
          "step_ms_p50": float(np.median(steady)) * 1e3,
          "first_step_ms": step_s[0] * 1e3,
          "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
          "max_memory_allocated": peak, "flash_launches": launches,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall_ms,
          "device_idle_share_unprofiled": 1.0 - busy / step_ms,
          "kernel_launches_per_step": kernels,
          "device_ms_by_family": dict(sorted(by_family.items(),
                                             key=lambda kv: -kv[1])),
          "top_kernels": top})
    return launches, step_ms


# ---------------------------------------------------------------- phase 7


# bench.py's mixed-precision recipe (bench.py:80-86, :120)
RECIPE_FLAGS = {"use_bfloat16": True, "bf16_activations": True,
                "bf16_moments": True, "fuse_optimizer_state": True}
# the fused update's cases: label -> (kind, consts, flops per element in
# the plain version's order). The recipe's kinds (sgd, adagrad, adam)
# run at the recipe's flat group size, the others at ResNet-50's.
FUSED_CONFIGS = {
    "sgd": ("sgd", (1.0,), 2),
    "adagrad": ("adagrad", (1.0, 1e-6), 7),
    "adam": ("adam", (1.0, 0.9, 0.999, 1e-8), 12),
    "momentum": ("momentum", (1.0, 0.9, False), 4),
    "momentum_nesterov": ("momentum", (1.0, 0.9, True), 6),
    "adamax": ("adamax", (1.0, 0.9, 0.999, 1e-8), 10),
    "decayed_adagrad": ("decayed_adagrad", (1.0, 0.95, 1e-6), 9),
    "adadelta": ("adadelta", (1.0, 0.95, 1e-6), 16),
    "rmsprop": ("rmsprop", (1.0, 0.95, 1e-6, 0.9, False), 11),
    "rmsprop_centered": ("rmsprop", (1.0, 0.95, 1e-6, 0.9, True), 16),
    "ftrl": ("ftrl", (1.0, 0.01, 0.01, -0.5), 17),
    "ftrl_power": ("ftrl", (1.0, 0.01, 0.01, -0.25), 17),
    "proximal_gd": ("proximal_gd", (1.0, 0.01, 0.01), 8),
    "proximal_adagrad": ("proximal_adagrad", (1.0, 0.01, 0.01), 16),
    # MobileNet-SSD's convs: RMSProp's defaults at their lr scale 0.1
    "rmsprop_ssd": ("rmsprop", (0.1, 0.95, 1e-6, 0.0, False), 11),
}
RECIPE_KINDS = ("sgd", "adagrad", "adam")
# (label, bf16 moments, owns the shared scalars' advance); the recipe's
# group is Adam's last case
FUSED_CASES = (
    [("sgd", False, False), ("adagrad", False, False),
     ("adagrad", True, False), ("adam", False, False),
     ("adam", False, True), ("adam", True, False), ("adam", True, True),
     ("proximal_gd", False, False)]
    + [(label, bf16, owns) for label in FUSED_CONFIGS
       if label not in RECIPE_KINDS + ("proximal_gd", "rmsprop_ssd")
       for bf16 in (False, True)
       for owns in ((False, True) if label == "adamax" else (False,))])
RAGGED_N = 128 * 4099 + 37


def build_recipe(fuse, shard=None, **model):
    """(main, startup, avg_cost) of the recipe, with
    ``fuse_optimizer_state`` as ``fuse`` and ``model`` overriding
    ``transformer_base``'s arguments (``dropout_rate``, ``fused_ce``,
    ``tp``); the flags are read while the program is built. ``shard``
    (a callable taking the program) runs before ``minimize``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import transformer_base

    values = dict(RECIPE_FLAGS, fuse_optimizer_state=fuse)
    saved = {n: fluid.get_flag(n) for n in values}
    fluid.set_flags(values)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, avg_cost, _ = transformer_base(
                **dict(TRAIN_MODEL, **model), sparse_embedding=True,
                attn_impl="pallas")
            if shard is not None:
                shard(main)
            fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_cost)
    finally:
        fluid.set_flags(saved)
    return main, startup, avg_cost


def fused_inputs(kind, bf16, n, seed):
    """(p, g, lr, moments, shared scalars) on the card, from a seeded
    generator: normals; first moments, velocities and Ftrl's linear
    term 0.1 N(0, 1), RMSProp's momentum 0.01 N and mean gradient 0.1 N
    (its mean square twice the mean gradient's square and more, so the
    centered variance stays positive after rounding to bf16), the other moments squares of normals;
    beta powers of step 3."""
    from paddle_tpu_torch.ops.fused_optimizer import KINDS

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda: torch.randn(n, generator=gen, device=dev)  # noqa: E731
    signed = {("adam", 0): 0.1, ("adamax", 0): 0.1, ("momentum", 0): 0.1,
              ("rmsprop", 0): 0.01, ("rmsprop", 2): 0.1, ("ftrl", 1): 0.1}
    accs = []
    for i in range(KINDS[kind][0]):
        a = rand()
        accs.append(signed[kind, i] * a if (kind, i) in signed else a * a)
    if kind == "rmsprop":
        accs[1] = accs[1] + 2.0 * accs[2] * accs[2]
    accs = [a.to(torch.bfloat16 if bf16 else torch.float32) for a in accs]
    shared = (torch.tensor(0.9 ** 3, device=dev),
              torch.tensor(0.999 ** 3, device=dev))[:KINDS[kind][1]]
    return rand(), rand(), torch.tensor(TRAIN_LR, device=dev), accs, shared


def fused_work(label, bf16, owns, n):
    """(bound ms, bound_by, bytes, ops): p and g read and p written, each
    moment the update changes read and written (not RMSProp's mean
    gradient unless centered), lr and the shared scalars read and the
    advanced ones written, once; the update's flops over the f32 peak."""
    from paddle_tpu_torch.ops.fused_optimizer import KINDS

    kind, consts, flops = FUSED_CONFIGS[label]
    n_acc, n_sh = KINDS[kind][:2]
    if kind == "rmsprop" and not consts[4]:
        n_acc -= 1
    nbytes = (n * (12 + 2 * n_acc * (2 if bf16 else 4))
              + 4 * (1 + n_sh + (n_sh if owns else 0)))
    ops = flops * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[torch.float32] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def phase_fused_update(card, n_recipe, n_resnet, n_bert, n_deepfm,
                       n_seq2seq, n_ssd):
    """Every case bit-equal to the plain version at its main path's
    group size (the recipe's kinds at the recipe's, the others at
    ResNet-50's) and at a ragged size; times at the main size. Adam's
    groups of BERT-base (bf16 moments), DeepFM and the seq2seq NMT (f32)
    at their sizes too, and RMSProp at MobileNet-SSD's conv group (f32,
    lr scale 0.1)."""
    from paddle_tpu_torch.ops.fused_optimizer import (fused_flat_update,
                                                      plain_flat_update)

    rows = []
    # the recipe's group at one rank's ZeRO slice (the parallel
    # phase's Reduce strategy over two ranks)
    cases = ([(c, None) for c in FUSED_CASES]
             + [(("adam", True, True), n_recipe // 2),
                (("adam", True, True), n_bert),
                (("adam", False, True), n_deepfm),
                (("adam", False, True), n_seq2seq),
                (("rmsprop_ssd", False, False), n_ssd)])
    for i, ((label, bf16, owns), n_model) in enumerate(cases):
        kind, consts, _flops = FUSED_CONFIGS[label]
        n_main = n_model or (n_recipe if label in RECIPE_KINDS
                             else n_resnet)
        for n in (n_main,) if n_model else (n_main, RAGGED_N):
            p, g, lr, accs, shared = fused_inputs(kind, bf16, n, 200 + i)
            want = plain_flat_update(kind, p, g, lr, accs, shared, owns,
                                     consts)
            # the kernel updates p and the moments in place: copies
            got = fused_flat_update(kind, p.clone(), g, lr,
                                    [a.clone() for a in accs], shared, owns,
                                    consts)
            torch.cuda.synchronize()
            case = (label, bf16, owns, n)
            if len(got) != len(want) or not all(
                    a.dtype == b.dtype and a.shape == b.shape
                    for a, b in zip(got, want)):
                fail("fused_update %s: kernel outputs %s, plain %s"
                     % (case, [(a.dtype, tuple(a.shape)) for a in got],
                        [(b.dtype, tuple(b.shape)) for b in want]))
            if not all(bool(torch.isfinite(b).all()) for b in want):
                fail("fused_update %s: the plain version is not finite on "
                     "these inputs" % (case,))
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
            if err != 0.0 or not all(torch.equal(a, b)
                                     for a, b in zip(got, want)):
                n_diff = [int((a != b).sum()) for a, b in zip(got, want)]
                fail("fused_update %s: the kernel is not bit-equal to the "
                     "plain version (max abs err %g, elements differing "
                     "per output %s)" % (case, err, n_diff))
            row = {"phase": "fused_update", "card": card, "label": label,
                   "kind": kind, "moments": "bf16" if bf16 else "f32",
                   "owns": owns, "n": n, "max_abs_err": err,
                   "bit_equal": True}
            if n == n_main:
                pk, ak = p.clone(), [a.clone() for a in accs]
                row["ms"] = cuda_ms(lambda: fused_flat_update(
                    kind, pk, g, lr, ak, shared, owns, consts), 20)
                row["plain_ms"] = cuda_ms(lambda: plain_flat_update(
                    kind, p, g, lr, accs, shared, owns, consts), 5, warmup=1)
                (row["bound_ms"], row["bound_by"], row["bytes"],
                 row["ops"]) = fused_work(label, bf16, owns, n)
                row["device_ms"] = device_ms(lambda: fused_flat_update(
                    kind, pk, g, lr, ak, shared, owns, consts), 10)
                row["library_ms"] = row["library_device_ms"] = None
                library = {"adam": fused_adam_ms, "adagrad": fused_adagrad_ms,
                           "momentum": fused_sgd_ms,
                           "momentum_nesterov": fused_sgd_nesterov_ms,
                           "sgd": fused_sgd_plain_ms}.get(label)
                if library is not None:
                    (row["library_ms"], row["library_device_ms"],
                     row["library_error"]) = library(p, g, accs)
                del pk, ak
            emit(row)
            rows.append(row)
            del p, g, lr, accs, shared, want, got
            torch.cuda.empty_cache()
    return rows


def _library_ms(call):
    """(wall ms, device ms, error) of a torch fused-optimizer call; (None,
    None, the error) where this torch lacks it for these tensors."""
    try:
        return cuda_ms(call, 20), device_ms(call, 10), None
    except (AttributeError, NotImplementedError, RuntimeError,
            TypeError) as e:
        return None, None, repr(e)


def fused_adam_ms(p, g, accs, found_inf=None):
    """``torch._fused_adam_`` — what ``torch.optim.Adam(fused=True)``
    calls — over the same flat tensors with f32 moments (a time
    yardstick only: it places eps differently); with ``found_inf`` (0.0
    or 1.0) the gated call a GradScaler makes, which skips the update
    on 1.0."""
    pl = p.clone()
    m1, m2 = (a.float().clone() for a in accs)
    step = torch.tensor(3.0, device=p.device)
    fi = None if found_inf is None else torch.tensor(float(found_inf),
                                                     device=p.device)
    return _library_ms(lambda: torch._fused_adam_(
        [pl], [g], [m1], [m2], [], [step], lr=TRAIN_LR, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
        maximize=False, found_inf=fi))


def fused_adagrad_ms(p, g, accs):
    """``torch._fused_adagrad_`` (``torch.optim.Adagrad(fused=True)``)
    over the same flat tensors with an f32 sum."""
    pl, m = p.clone(), accs[0].float().clone()
    step = torch.tensor(3.0, device=p.device)
    return _library_ms(lambda: torch._fused_adagrad_(
        [pl], [g], [m], [step], lr=TRAIN_LR, lr_decay=0.0,
        weight_decay=0.0, eps=1e-6, maximize=False))


def fused_sgd_ms(p, g, accs, nesterov=False):
    """``torch._fused_sgd_`` with a momentum buffer
    (``torch.optim.SGD(momentum=0.9, fused=True)``) over the same flat
    tensors with an f32 velocity: v = 0.9 v + g, p -= lr v, the
    Momentum update (``nesterov``: p -= lr (g + 0.9 v))."""
    pl, v = p.clone(), accs[0].float().clone()
    return _library_ms(lambda: torch._fused_sgd_(
        [pl], [g], [v], weight_decay=0.0, momentum=0.9, lr=TRAIN_LR,
        dampening=0.0, nesterov=nesterov, maximize=False,
        is_first_step=False))


def fused_sgd_nesterov_ms(p, g, accs):
    """``torch._fused_sgd_(nesterov=True)``, the Nesterov Momentum
    update, with an f32 velocity."""
    return fused_sgd_ms(p, g, accs, nesterov=True)


def fused_sgd_plain_ms(p, g, accs):
    """``torch._fused_sgd_`` with ``momentum=0`` and no buffer
    (``torch.optim.SGD(fused=True)``): p -= lr g, the SGD update."""
    del accs
    pl = p.clone()
    return _library_ms(lambda: torch._fused_sgd_(
        [pl], [g], [], weight_decay=0.0, momentum=0.0, lr=TRAIN_LR,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False))


# ---------------------------------------------------------------- amp

# the AMP recipe's overflow replay: steps whose batch carries an inf
# token weight (two in a row: the default decr_every_n_nan_or_inf=2
# backs the scale off at the second), in a run_steps call of AMP_REPLAY
AMP_REPLAY, AMP_BAD_STEPS = 8, (3, 4)
AMP_SCALE = 2.0 ** 15  # decorate's init_loss_scaling, set on the card
AMP_LOSS_RTOL, AMP_LOSS_MEAN_REL = 0.15, 0.05  # tests/test_amp.py:298-301
AMP_MICRO = 4  # GradientAccumulation's accumulate_steps
# GradientAccumulation against the combined batch: the losses; the mean
# gradient (relative 2-norm, tensor by tensor) in float64, where only
# rounding parts them; the same in float32, where the forward rows of
# B=8 and B=32 differ by ~1e-6 (the GEMM library picks its kernel by
# the row count) and the first step's gradients, sums over 8192 tokens
# at random weights that largely cancel, widen that to ~1e-3
AMP_ACCUM_TOL, AMP_ACCUM_F64_TOL, AMP_ACCUM_F32_TOL = 1e-5, 1e-10, 2e-3


def build_amp_recipe(use_amp, accumulate=None):
    """``bench_amp.py:37-56``'s build at its accelerator config
    (``:102-107``: TRAIN_MODEL's widths, dropout 0), ``Adam(1e-4)``,
    under ``amp.decorate`` when ``use_amp``, or inside
    ``GradientAccumulation(Adam, accumulate)``; ``memory_optimize``.
    Two changes from bench_amp.py: ``attn_impl="pallas"`` (the three
    flash kernels; the port's default is plain torch attention), and
    ``fuse_optimizer_state`` (the update is the fused kernel, gated under
    AMP and accumulation). The build-time bf16 flags stay off, as in
    bench_amp.py: the rewrite makes the bf16 stream. Returns (main,
    startup, avg_cost, the optimizer)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import transformer_base

    saved = fluid.get_flag("fuse_optimizer_state")
    fluid.set_flags({"fuse_optimizer_state": True})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, avg_cost, _ = transformer_base(**TRAIN_MODEL,
                                              attn_impl="pallas")
            opt = fluid.optimizer.Adam(learning_rate=TRAIN_LR)
            if use_amp:
                opt = fluid.amp.decorate(opt)
            elif accumulate:
                opt = fluid.optimizer.GradientAccumulation(opt, accumulate)
            opt.minimize(avg_cost)
    finally:
        fluid.set_flags({"fuse_optimizer_state": saved})
    fluid.memory_optimize(main)
    return main, startup, avg_cost, opt


def amp_group(main):
    """(N, bf16 moments, owns the beta powers) of the AMP recipe's one
    gated Adam group: the shape the main path hands the gated kernel."""
    from paddle_tpu_torch.core import dtype_utils

    gb = main.global_block()
    op, = [op for op in gb.ops if op.type == "adam_fused"]
    n = int(gb.var(op.input("FlatParam")[0]).shape[0])
    moments = dtype_utils.to_torch(
        gb.var(op.input("Moment1")[0]).dtype)
    return n, moments == torch.bfloat16, bool(op.output("Beta1PowOut"))


def amp_gate(card, group, n_resnet):
    """(a) The gated kernel against the gated plain version: every kind
    and branch, f32 and bf16 moments, with and without the shared
    scalars' advance, each flag value; Adam at the AMP recipe's group
    size (``group``, from ``amp_group``), the rest at ResNet-50's.
    Bit-equal; a false flag leaves every buffer as it was and hands out
    the step-start scalars. Then Adam at the AMP group's shape (its N,
    its moment dtype, its ownership of the powers) timed ungated, gated
    true and gated false, beside ``_fused_adam_`` with each
    ``found_inf``."""
    from paddle_tpu_torch.ops.fused_optimizer import (KINDS,
                                                      fused_flat_update,
                                                      plain_flat_update)

    n_amp, amp_bf16, amp_owns = group
    cases, worst = 0, 0.0
    for i, (label, (kind, consts, _flops)) in enumerate(
            FUSED_CONFIGS.items()):
        n_acc, n_sh = KINDS[kind][:2]
        n = n_amp if label == "adam" else n_resnet
        for bf16 in ((False, True) if n_acc else (False,)):
            for owns in ((False, True) if n_sh else (False,)):
                p, g, lr, accs, shared = fused_inputs(kind, bf16, n, 300 + i)
                ins = [p] + list(accs) + (list(shared) if owns else [])
                for flag in (True, False):
                    apply = torch.tensor(flag, device=p.device)
                    want = plain_flat_update(kind, p, g, lr, accs, shared,
                                             owns, consts, apply)
                    got = fused_flat_update(kind, p.clone(), g, lr,
                                            [a.clone() for a in accs],
                                            shared, owns, consts, apply)
                    torch.cuda.synchronize()
                    case = (label, "bf16" if bf16 else "f32", owns, flag, n)
                    if len(got) != len(want) or not all(
                            a.dtype == b.dtype and torch.equal(a, b)
                            for a, b in zip(got, want)):
                        fail("amp gate %s: the gated kernel is not bit-equal "
                             "to the gated plain version" % (case,))
                    if not flag and not all(torch.equal(a, b)
                                            for a, b in zip(got, ins)):
                        fail("amp gate %s: a false flag changed a buffer or "
                             "the scalars handed out" % (case,))
                    worst = max(worst, max(float((a.float() - b.float())
                                                 .abs().max())
                                           for a, b in zip(got, want)))
                    cases += 1
                del p, g, lr, accs, shared, ins, want, got
                torch.cuda.empty_cache()

    kind, consts, _flops = FUSED_CONFIGS["adam"]
    p, g, lr, accs, shared = fused_inputs(kind, amp_bf16, n_amp, 399)
    on = torch.tensor(True, device=p.device)
    off = torch.tensor(False, device=p.device)
    pk, ak = p.clone(), [a.clone() for a in accs]

    def call(apply):
        return lambda: fused_flat_update(kind, pk, g, lr, ak, shared,
                                         amp_owns, consts, apply)

    _bound, bound_by, nbytes, _ops = fused_work("adam", amp_bf16, amp_owns,
                                                n_amp)
    # a skipped step reads the flag (1 byte); an owner also reads the
    # two powers and writes them out: 17 bytes
    skipped_bytes = 1 + (16 if amp_owns else 0)
    row = {"n": n_amp, "moments": "bf16" if amp_bf16 else "f32",
           "owns": amp_owns, "cases": cases, "max_abs_err": worst,
           "ungated_ms": cuda_ms(call(None), 20),
           "ungated_device_ms": device_ms(call(None), 10),
           "ms": cuda_ms(call(on), 20), "device_ms": device_ms(call(on), 10),
           "skipped_ms": cuda_ms(call(off), 20),
           "skipped_device_ms": device_ms(call(off), 10),
           "plain_ms": cuda_ms(lambda: plain_flat_update(
               kind, p, g, lr, accs, shared, amp_owns, consts, on), 5,
               warmup=1),
           "bound_ms": (nbytes + 1) / HBM_BYTES_PER_S * 1e3,
           "bound_by": bound_by, "bytes": nbytes + 1,
           "skipped_bound_ms": skipped_bytes / HBM_BYTES_PER_S * 1e3,
           "skipped_bytes": skipped_bytes}
    del pk, ak
    (row["library_ms"], row["library_device_ms"],
     row["library_error"]) = fused_adam_ms(p, g, accs, 0.0)
    (row["library_skipped_ms"], row["library_skipped_device_ms"],
     _err) = fused_adam_ms(p, g, accs, 1.0)
    del p, g, lr, accs, shared
    torch.cuda.empty_cache()
    return row


def phase_amp(card, n_resnet, f32_step_ms):
    """Mixed precision on the card: (a) the gated kernel (``amp_gate``);
    (b) bench_amp.py's recipe (``build_amp_recipe``) at full width, B=32,
    T=256 with the training phases' ragged masks: 10 eager steps and one
    ``run_steps`` call of 10 from the same start bit-equal, exact
    launches (each flash kernel 18 a step, the gated update once a
    group), losses within rtol 0.15 of the same program without AMP
    (mean relative gap under 5 %), step ms, tokens/s, peak memory, MFU
    over the bf16 peak, the speedup over f32; (c) an overflow inside a
    replay: the loss scale set on the card, then one run_steps call whose
    steps 3 and 4 carry an inf token weight (their losses and gradients
    are not finite): those steps leave the parameters, both moments and
    both beta powers bit-unchanged, ``found_inf`` is set at them, the
    scale backs off by ``decr_ratio`` at the second, and the steps after
    train; (d) ``amp_accumulation``. Returns (the row, the recipe's
    timed program for the static phase)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import cost as obs_cost
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    main, startup, cost, opt = build_amp_recipe(True)
    gate = amp_gate(card, amp_group(main), n_resnet)
    gate["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "amp_gate", "card": card, **gate})

    # (b) the AMP recipe
    feed = train_batch()
    groups = sum(op.type.endswith("_fused")
                 for op in main.global_block().ops)
    gated = [op for op in main.global_block().ops
             if op.type.endswith("_fused") and op.input("ApplyFlag")]
    if groups < 1 or len(gated) != groups:
        fail("amp: %d of %d group ops gated" % (len(gated), groups))
    flash = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    launchers = flash + (fused_flat_update,)

    def launched():
        out = {fn.__name__: fn.launches for fn in launchers}
        out["gated"] = fused_flat_update.gated_launches
        return out

    exe, scope = _fresh(main, startup, place)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in launchers:
        reset_counts(fn)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[cost],
                                    scope=scope)[0]))
        step_s.append(time.perf_counter() - t0)
    eager_state = scope_tensors(scope)
    eager_launches = launched()
    exe2, scope2 = _fresh(main, startup, place)
    replayed, = exe2.run_steps(main, feed=feed, steps=TRAIN_STEPS,
                               fetch_list=[cost], scope=scope2)
    launches = launched()
    diff = state_diff(scope_tensors(scope2), eager_state)
    if [float(x) for x in replayed] != losses or diff:
        fail("amp: run_steps' %d steps are not bit-equal to the eager ones "
             "(losses %s against %s; tensors differing %s)"
             % (TRAIN_STEPS, list(replayed), losses, diff[:8]))
    del eager_state
    per_step = {fn.__name__: ATTN_PER_STEP for fn in flash}
    per_step["fused_flat_update"] = per_step["gated"] = groups
    want = {k: 2 * TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != want:
        fail("amp: 10 eager steps and 10 replayed launched %s, expected %s"
             % (launches, want))
    if not all(math.isfinite(x) for x in losses) or \
            opt.found_overflow(scope):
        fail("amp: the recipe overflowed or lost finiteness: %s" % losses)
    peak = torch.cuda.max_memory_allocated()
    eager_ms = float(np.mean(step_s[1:])) * 1e3
    run_s, timed_losses = _timed_chunks(exe2, main, feed, cost, scope2, 2)
    if not np.isfinite(timed_losses).all():
        fail("amp: non-finite timed losses")
    step_ms = run_s * 1e3 / (2 * CHUNK)
    del exe, scope
    torch.cuda.empty_cache()

    # the same program without AMP: the loss reference, and bench_amp's
    # ratio (f32 over AMP, run_steps against run_steps)
    main32, startup32, cost32, _ = build_amp_recipe(False)
    exe32, scope32 = _fresh(main32, startup32, place)
    f32_losses = [float(exe32.run(main32, feed=feed, fetch_list=[cost32],
                                  scope=scope32)[0])
                  for _ in range(TRAIN_STEPS)]
    run32_s, _ = _timed_chunks(exe32, main32, feed, cost32, scope32, 2)
    f32_run_steps_ms = run32_s * 1e3 / (2 * CHUNK)
    exe32.close()
    del exe32, scope32
    torch.cuda.empty_cache()
    rel = np.abs(np.array(losses) - f32_losses) / np.abs(f32_losses)
    if not (rel <= AMP_LOSS_RTOL).all() or not rel.mean() < \
            AMP_LOSS_MEAN_REL:
        fail("amp: losses %s part from f32's %s (rel %s; limits %g each, "
             "mean %g)" % (losses, f32_losses, rel.tolist(), AMP_LOSS_RTOL,
                           AMP_LOSS_MEAN_REL))
    shapes = {n: tuple(v.shape) for n, v in feed.items()}
    flops = obs_cost.report(main, feed_shapes=shapes).total_flops
    ach = obs_cost.achieved(flops, step_ms / 1e3, MFU_PEAK_FLOPS["bf16"])
    recipe = {"groups": groups, "losses": losses, "f32_losses": f32_losses,
              "loss_rel": rel.tolist(), "loss_rel_mean": float(rel.mean()),
              "eager_step_ms": eager_ms, "step_ms": step_ms,
              "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
              "eager_tokens_per_s": TRAIN_B * TRAIN_T / (eager_ms / 1e3),
              "f32_run_steps_ms": f32_run_steps_ms,
              "speedup_over_f32_run_steps": f32_run_steps_ms / step_ms,
              "training_phase_f32_step_ms": f32_step_ms,
              "speedup_over_training_phase": f32_step_ms / eager_ms,
              "flops_per_step": flops, "mfu_bf16": ach["mfu"],
              "max_memory_allocated": peak,
              "eager_launches": eager_launches, "launches": launches}
    emit({"phase": "amp_recipe", "card": card, **recipe})

    # (c) an overflow inside one replay: the scale set on the card (no
    # host read), two steps whose token weights hold an inf
    scale = opt.scaler.scale_var.name
    found = opt.scaler.found_inf_var.name
    inner = opt.inner
    watch = ["fused_param_storage_0", "fused_moment1_storage_0",
             "fused_moment2_storage_0",
             inner._shared_scalars["beta1_pow_acc"].name,
             inner._shared_scalars["beta2_pow_acc"].name]
    scope2.find_var(scale).fill_(AMP_SCALE)
    batches = []
    for i in range(AMP_REPLAY):
        b = dict(feed)
        if i in AMP_BAD_STEPS:
            b["trg_mask"] = feed["trg_mask"].copy()
            b["trg_mask"][0, 0] = np.inf
        batches.append(b)
    for fn in launchers:
        reset_counts(fn)
    outs = exe2.run_steps(main, feed_list=batches, steps=AMP_REPLAY,
                          fetch_list=[cost, found, scale] + watch,
                          scope=scope2, return_numpy=False)
    torch.cuda.synchronize()
    o_loss, o_found, o_scale = (t.cpu().numpy() for t in outs[:3])
    held = outs[3:]
    o_launches = launched()
    bad = list(AMP_BAD_STEPS)
    first, last = bad[0], bad[-1]
    unchanged = all(torch.equal(t[first - 1], t[i]) for t in held
                    for i in bad)
    trains = not torch.equal(held[0][last], held[0][last + 1])
    want_found = [i in AMP_BAD_STEPS for i in range(AMP_REPLAY)]
    want_scale = [AMP_SCALE if i < last else AMP_SCALE * 0.5
                  for i in range(AMP_REPLAY)]
    if [bool(x) for x in o_found] != want_found or \
            [float(x) for x in o_scale] != want_scale or not unchanged \
            or not trains or not np.isfinite(
                np.delete(o_loss, bad)).all():
        fail("amp overflow replay: found_inf %s (want %s), scale %s (want "
             "%s), state held across the skipped steps %s, trains after "
             "%s, losses %s" % (o_found.tolist(), want_found,
                                o_scale.tolist(), want_scale, unchanged,
                                trains, o_loss.tolist()))
    if o_launches["gated"] != groups * AMP_REPLAY:
        fail("amp overflow replay launched %s" % o_launches)
    overflow = {"steps": AMP_REPLAY, "bad_steps": bad,
                "found_inf": [bool(x) for x in o_found],
                "scale": [float(x) for x in o_scale],
                "losses": o_loss.tolist(), "held_bit_equal": True,
                "held": watch, "gated_launches": o_launches["gated"],
                "skipped_launches": groups * int(o_found.sum())}
    emit({"phase": "amp_overflow", "card": card, **overflow})
    timed = timed_program("amp_recipe", main, feed, cost, step_ms, peak,
                          "bf16")
    exe2.close()
    del exe2, scope2, outs, held
    torch.cuda.empty_cache()
    t_accumulation = time.perf_counter()
    accumulation = amp_accumulation(card, place, launchers, launched,
                                    groups)
    row = {"gate": gate, "recipe": recipe, "overflow": overflow,
           "accumulation": accumulation, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    # where the phase's time goes: the gate; the recipe, its f32 twin
    # and the overflow replay; the accumulation check
    emit({"phase": "amp", "card": card, "phase_s": row["phase_s"],
          "gate_s": gate["phase_s"],
          "recipe_s": t_accumulation - t_phase - gate["phase_s"],
          "accumulation_s": time.perf_counter() - t_accumulation})
    return row, timed


def _adam_group(program, adam):
    """(gradient names, state names — flat parameter, moments, beta
    powers — learning-rate name, update constants) of ``program``'s one
    flat Adam group."""
    op = next(op for op in program.global_block().ops
              if op.type == "adam_fused")
    state = [op.input(slot)[0] for slot in ("FlatParam", "Moment1",
                                            "Moment2", "Beta1Pow",
                                            "Beta2Pow")]
    return (op.input("Grad"), state, op.input("LearningRate")[0],
            adam._update_consts(1.0))


def _adam_recomputed(start, grads, lr, consts):
    """One Adam update of the flat group from ``start`` by the kernel,
    on ``grads`` concatenated: the state it leaves."""
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    return fused_flat_update(
        "adam", start[0].clone(), torch.cat([g.reshape(-1) for g in grads]),
        lr, [start[1].clone(), start[2].clone()], start[3:], True, consts)


def _as_float64(main, scope, feed):
    """Retype ``main``'s float32 variables and ``scope``'s float32
    tensors to float64; the feed too."""
    for blk in main.blocks:
        for v in blk.vars.values():
            if v.dtype == np.float32:
                v.dtype = np.dtype("float64")
    for name in list(scope.local_var_names()):
        t = scope.find_var(name)
        if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
            scope.set_var(name, t.double())
    return {n: v.astype("float64") if v.dtype == np.float32 else v
            for n, v in feed.items()}


def accumulation_float64(place, full, parts):
    """``GradientAccumulation(Adam, 4)`` over ``parts`` against one Adam
    step over ``full``, in float64: plain attention and per-parameter
    Adam (the flash kernels and the flat group update take f32 and
    bf16), the program's float32 variables and the scope's tensors
    retyped after the startup (``layer_norm`` and the loss compute in at
    least f32, so in f64 here). Returns (the mean gradient's widest
    relative 2-norm gap, the parameters' widest relative gap after the
    step, whether both started from the same parameters)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import transformer_base

    def step(accumulate, batches):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, cost, _ = transformer_base(**TRAIN_MODEL)
            opt = fluid.optimizer.Adam(learning_rate=TRAIN_LR)
            if accumulate:
                opt = fluid.optimizer.GradientAccumulation(opt, AMP_MICRO)
            opt.minimize(cost)
        adam = [op for op in main.global_block().ops if op.type == "adam"]
        grads = [op.input("Grad")[0] for op in adam]
        params = [op.input("Param")[0] for op in adam]
        exe, scope = _fresh(main, startup, place)
        start = [scope.find_var(n).clone() for n in params]
        for b in batches:
            out = exe.run(main, feed=_as_float64(main, scope, b),
                          fetch_list=grads, scope=scope, return_numpy=False)
        got = ([g.clone() for g in out],
               [scope.find_var(n).clone() for n in params], start)
        exe.close()
        del exe, scope, out
        torch.cuda.empty_cache()
        return got

    g_acc, p_acc, s_acc = step(True, parts)
    g_one, p_one, s_one = step(False, [full])
    same = len(s_acc) == len(s_one) and all(
        torch.equal(a, b) for a, b in zip(s_acc, s_one))
    grad_gap = max(float((a - b).norm() / b.norm().clamp_min(1e-300))
                   for a, b in zip(g_acc, g_one))
    param_gap = max(float((a - b).abs().max()
                          / b.abs().max().clamp_min(1e-300))
                    for a, b in zip(p_acc, p_one))
    return grad_gap, param_gap, same


def amp_accumulation(card, place, launchers, launched, groups):
    """(d) ``GradientAccumulation(Adam, 4)`` in f32: four micro-steps of
    B=8 against one Adam step of B=32 on the same tokens (full masks, so
    every micro-batch has the same token count). Held: micro-steps 1-3
    leave the state bit-unchanged; the applied step's mean gradient and
    update are bit-equal to their recomputation from the micro-batches'
    gradients, and the B=32 step's update to its recomputation from its
    own gradient, from the same start; the mean micro loss within
    ``AMP_ACCUM_TOL`` of the B=32 loss; the mean gradient within
    ``AMP_ACCUM_F32_TOL`` of the B=32 gradient (``|difference|_2 /
    |B=32|_2``, tensor by tensor); every parameter's gap within the
    gradient's gap times the first Adam step's slope at 0,
    ``lr_t (1 - beta1) / eps``; and the same comparison in float64
    (``accumulation_float64``) within ``AMP_ACCUM_F64_TOL``, so what
    parts the f32 steps is rounding, not the accumulation. Adam's first
    step moves an element by ``lr g / (|g| + eps / sqrt(1 - beta2))``, a
    soft sign of width 3.2e-7 (slope 316 at lr 1e-4), so the gradients'
    gap parts elements near zero by up to 316 times that gap; the
    parameters' gap is reported against ``AMP_ACCUM_TOL``."""
    feed = train_batch()
    full = dict(feed, src_mask=np.ones_like(feed["src_mask"]),
                trg_mask=np.ones_like(feed["trg_mask"]))
    micro = TRAIN_B // AMP_MICRO
    parts = [{n: v[k * micro:(k + 1) * micro] for n, v in full.items()}
             for k in range(AMP_MICRO)]
    gmain, gstartup, gcost, gopt = build_amp_recipe(False, AMP_MICRO)
    avg_names, state, lr_name, consts = _adam_group(gmain, gopt.inner)
    grad_names = [n[:-len("@ACCUM_AVG")] for n in avg_names]
    exe, scope = _fresh(gmain, gstartup, place)
    start = [scope.find_var(n).clone() for n in state]
    for fn in launchers:
        reset_counts(fn)
    held_micro, g_losses, grads = [], [], []
    for k, part in enumerate(parts):
        out = exe.run(gmain, feed=part, scope=scope, return_numpy=False,
                      fetch_list=[gcost] + grad_names + (
                          avg_names if k == AMP_MICRO - 1 else []))
        g_losses.append(float(out[0]))
        grads.append([g.clone() for g in out[1:1 + len(grad_names)]])
        if k < AMP_MICRO - 1:
            held_micro.append(all(torch.equal(scope.find_var(n), t)
                                  for n, t in zip(state, start)))
    avg = [a.clone() for a in out[1 + len(grad_names):]]
    g_launches = launched()
    after = [scope.find_var(n).clone() for n in state]
    lr = scope.find_var(lr_name).clone()
    views = {n: v for n, v in gmain._flat_state_views.items()
             if v[0] == state[0]}
    exe.close()
    del exe, scope, out
    # acc = ((g1 + g2) + g3) from zeros, the mean (acc + g4) / 4
    ref_avg = []
    for i in range(len(grad_names)):
        acc = torch.zeros_like(grads[0][i])
        for k in range(AMP_MICRO):
            acc = acc + grads[k][i]
        ref_avg.append(acc / AMP_MICRO)
    avg_equal = all(torch.equal(a, b) for a, b in zip(avg, ref_avg))
    update_equal = all(torch.equal(a, b) for a, b in zip(
        _adam_recomputed(start, ref_avg, lr, consts), after))
    del grads, ref_avg
    torch.cuda.empty_cache()

    # one Adam step of B=32 on the same tokens, from the same start
    pmain, pstartup, pcost, popt = build_amp_recipe(False)
    g32_names, state32, lr32_name, consts32 = _adam_group(pmain, popt)
    exe, scope = _fresh(pmain, pstartup, place)
    start32 = [scope.find_var(n).clone() for n in state32]
    out = exe.run(pmain, feed=full, fetch_list=[pcost] + g32_names,
                  scope=scope, return_numpy=False)
    whole_loss = float(out[0])
    g32 = [g.clone() for g in out[1:]]
    after32 = [scope.find_var(n).clone() for n in state32]
    update32_equal = all(torch.equal(a, b) for a, b in zip(
        _adam_recomputed(start32, g32, scope.find_var(lr32_name), consts32),
        after32))
    exe.close()
    del exe, scope, out
    same_start = grad_names == list(g32_names) and all(
        torch.equal(a, b) for a, b in zip(start, start32))

    # the gradients' gap, tensor by tensor
    grad_gap = [float((a.double() - b.double()).norm()
                      / b.double().norm().clamp_min(1e-300))
                for a, b in zip(avg, g32)]
    grad_gap_max = [float((a - b).abs().max()
                          / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(avg, g32)]
    worst = sorted(zip(grad_gap, grad_gap_max, grad_names),
                   reverse=True)[:5]
    # the parameters' gap within the first step's slope times the
    # gradients' gap, up to a unit in the last place and the update's
    # rounding
    beta1, eps = popt._beta1, popt._epsilon
    b1p, b2p = float(start32[3]), float(start32[4])
    first_step = not (start32[1].any() or start32[2].any())
    slope = float(lr) * math.sqrt(1.0 - b2p) / (1.0 - b1p) * (1.0 - beta1) \
        / eps
    dg = (torch.cat([a.reshape(-1) for a in avg])
          - torch.cat([g.reshape(-1) for g in g32])).abs()
    dp = (after[0] - after32[0]).abs()
    p_abs = torch.maximum(after[0].abs(), after32[0].abs())
    ulp = torch.nextafter(p_abs, torch.full_like(p_abs, math.inf)) - p_abs
    within_slope = first_step and bool(
        (dp <= slope * dg * (1 + 1e-5) + ulp + 1e-6 * float(lr)).all())
    del dg, p_abs, ulp, avg, g32
    rel, beyond, elements = {}, 0, 0
    for name, (_flat, o, n, _shape, _dt) in views.items():
        w = after32[0][o:o + n].abs().max().clamp_min(1e-30)
        d = dp[o:o + n]
        rel[name] = float(d.max() / w)
        beyond += int((d > AMP_ACCUM_TOL * w).sum())
        elements += n
    del dp, after, after32, start, start32
    torch.cuda.empty_cache()
    loss_rel = abs(float(np.mean(g_losses)) - whole_loss) / abs(whole_loss)
    f64_grad_gap, f64_param_gap, f64_same = accumulation_float64(
        place, full, parts)
    if not all(held_micro) or not avg_equal or not update_equal or \
            not update32_equal or not same_start or \
            not loss_rel <= AMP_ACCUM_TOL or \
            not max(grad_gap) <= AMP_ACCUM_F32_TOL or not within_slope or \
            not f64_same or not f64_grad_gap <= AMP_ACCUM_F64_TOL or \
            g_launches["gated"] != AMP_MICRO * groups:
        fail("amp accumulation: micro-steps 1-3 held the state %s; the "
             "mean gradient %s and the applied update %s bit-equal to "
             "their recomputation from the micro-batches; the B=32 update "
             "%s to its own; same start and gradient order %s; mean micro "
             "loss against the B=32 loss rel %g (limit %g); the mean "
             "gradient against the B=32 gradient %g (limit %g; the widest "
             "tensors: 2-norm gap, element gap, name %s); parameters "
             "within the first step's slope %g times the gradients' gap "
             "%s; in float64 from the same start %s, the mean gradient's "
             "gap %g (limit %g); gated launches %s"
             % (held_micro, avg_equal, update_equal, update32_equal,
                same_start, loss_rel, AMP_ACCUM_TOL, max(grad_gap),
                AMP_ACCUM_F32_TOL, worst, slope, within_slope, f64_same,
                f64_grad_gap, AMP_ACCUM_F64_TOL, g_launches))
    accumulation = {
        "micro_batch": micro, "steps": AMP_MICRO,
        "held_micro_steps": held_micro, "mean_gradient_bit_equal": avg_equal,
        "update_bit_equal": update_equal,
        "b32_update_bit_equal": update32_equal,
        "micro_losses": g_losses, "b32_loss": whole_loss,
        "loss_rel_err": loss_rel,
        "b32_grad_gap_norm_max": max(grad_gap),
        "b32_grad_gap_norm_median": float(np.median(grad_gap)),
        "b32_grad_gap_elem_max": max(grad_gap_max),
        "b32_grad_gap_widest": worst,
        "f64_b32_grad_gap_norm_max": f64_grad_gap,
        "f64_b32_param_max_rel_err": f64_param_gap,
        "adam_first_step_slope": slope, "params_within_slope": within_slope,
        "b32_param_max_rel_err": max(rel.values()),
        "b32_params_within_1e-5": sum(r <= AMP_ACCUM_TOL
                                      for r in rel.values()),
        "params": len(rel), "b32_elements_beyond_1e-5": beyond,
        "elements": elements, "gated_launches": g_launches["gated"]}
    emit({"phase": "amp_accumulation", "card": card, **accumulation})
    return accumulation


def phase_amp_serving(card, model, greedy):
    """(e) bf16 serving: ``amp.rewrite_program`` of the serving phase's
    ``causal_lm`` (a clone), served by ``serve_decoding`` with the
    serving phase's cache and burst, every bucket captured. The pools
    are bf16 (the rewrite puts the paged ops on the bf16 stream), so
    every paged launch takes the bf16-pool kernel (bf16 queries; split
    route at decode); the kernel at the decode shape on bf16 pools
    within 3e-2 of its plain version. Reports tokens/s, decode-step ms,
    TTFT, and the share of tokens equal to the f32 greedy streams (not
    enforced: bf16 rounding moves near ties)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import dtype_utils
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import (paged_window_attention,
                                      plain_window_attention)

    t_phase = time.perf_counter()
    main, logits, scope = model
    bf = amp.rewrite_program(main.clone(for_test=True))
    prompts = serving_prompts()
    run = serve_burst((bf, logits, scope), CacheConfig(**SERVING_CACHE),
                      prompts, counters=(paged_window_attention,))
    counts = route_counts(paged_window_attention)
    check_graphs(run, "amp serving")
    pools = sorted({dtype_utils.name(dt) for _, _, dt in
                    run["engines"][0].pair.pool_specs})
    steps = run["report"]["decode_step"]["count"]
    if pools != ["bfloat16"] or counts["generic_launches"] or \
            counts["int8_launches"] or counts["split_launches"] < \
            MODEL["n_layer"] * steps:
        fail("amp serving: pools %s, paged launches %s over %d decode "
             "steps" % (pools, counts, steps))
    args, scales = make_problem(16, 1, torch.bfloat16, seed=77,
                                inactive_row=True)
    out = paged_window_attention(*args, **scales)
    ref = plain_window_attention(*args, **scales)
    torch.cuda.synchronize()
    _, valid = window_masks(args[3], args[4], 1)
    err = float((out.float() - ref.float()).abs()[valid].max())
    if not err <= TOL[torch.bfloat16] or not bool(torch.isfinite(out).all()):
        fail("amp serving: the bf16-pool kernel parts from its plain "
             "version by %g (limit %g)" % (err, TOL[torch.bfloat16]))
    same = sum(a == b for s, g in zip(run["streams"], greedy)
               for a, b in zip(s, g))
    total = sum(len(g) for g in greedy)
    row = {**burst_row(run), "pools": pools, "route_launches": counts,
           "kernel_max_abs_err": err, "greedy_token_agreement": same / total,
           "streams_equal_f32": sum(s == g for s, g in
                                    zip(run["streams"], greedy)),
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "amp_serving", "card": card, **row})
    del run
    return row


# ---------------------------------------------------------------- phase 29

TUNING_ITERS, TUNING_SAMPLES = 16, 3
# rows 5a/5b: the tuned config may be at most this much slower than the
# default before the phase fails (the spread of two turns of one config)
TUNED_NOISE = 0.05
LOOKUP_CALLS = 20000
# the fused-CE sweep: the recipe's head (fused_ce=True), whose input is
# on the bf16 stream under the recipe's flags
FUSED_CE_PROBLEM = {"n_tokens": TRAIN_B * TRAIN_T, "d_model": 512,
                    "vocab": 32000}
FUSED_CE_DTYPE = ("bfloat16" if RECIPE_FLAGS["use_bfloat16"]
                  and RECIPE_FLAGS["bf16_activations"] else "float32")

_TUNING_WORKER = r"""
import json, sys
import torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch import tuning
store, mode, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
dev = torch.device("cuda", 0)
if mode == "store":
    # a second process on the same store: every sweep must be reused
    fluid.set_flags({"tuning_cache_dir": store})
    configs = []
    for kernel, problem, dtype in spec:
        cfg = tuning.lookup(kernel, problem, dtype=dtype, device=dev)
        rec = tuning.sweep(kernel, problem, dtype=dtype, device=dev)
        configs.append([cfg, rec.config])
else:
    # a fresh process with no store: the decode artifact seeds the memo
    from paddle_tpu_torch.models.causal_lm import causal_lm
    import chip_smoke
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        causal_lm(**chip_smoke.MODEL)
    fluid.io.load_decode_model(store, fluid.Executor(fluid.CPUPlace()),
                               scope=fluid.Scope(), program=main)
    configs = [tuning.lookup(kernel, problem, dtype=dtype, device=dev)
               for kernel, problem, dtype in spec]
print(json.dumps({"metrics": tuning.tuning_metrics(), "configs": configs}))
"""


def tuning_worker(store, mode, spec):
    """Run ``_TUNING_WORKER`` in a fresh process on the card, from this
    script's directory; returns its JSON line."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _TUNING_WORKER, store,
                           mode, json.dumps(spec)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail("tuning: the %s worker failed (rc %d): %s"
             % (mode, proc.returncode, proc.stderr[-3000:]))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def paged_tuning_bound(problem, dtype):
    """(bound ms, bound_by) of the sweep harness's paged call: sequence
    b's cached length from ``tuning.kernels.decode_lengths``, each of its
    cached + T keys' K/V rows read once (int8: one byte an element and 8
    bytes of scales a row), q and out once, the tables and lengths once;
    4 flops a query a key a head dim."""
    from paddle_tpu_torch.tuning.kernels import decode_lengths

    B, T, S = problem["batch"], problem["q_tokens"], problem["window"]
    keys = sum(n + T for n in decode_lengths(B, T, S))
    item = torch.finfo(dtype).bits // 8
    row = H * 2 * D + 8 if problem["kv_dtype"] == "int8" \
        else H * 2 * D * item
    nbytes = keys * row + 2 * B * T * H * D * item + B * (S // BS + 1) * 4
    ops = T * keys * H * 4 * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def candidate_rows(rec):
    """(each candidate's device ms, the winner's, the default's) of one
    sweep record; fails on a candidate that recorded an error."""
    from paddle_tpu_torch import tuning

    k = tuning.get_tunable(rec.kernel)
    errors = [m for m in rec.measurements if "error" in m]
    if errors:
        fail("tuning: %s %s: candidates failed: %s"
             % (rec.kernel, rec.bucket, errors))
    cands = [{"config": m["config"], "ms": m["ms"],
              "pruned": bool(m.get("pruned")), "timing": m.get("timing")}
             for m in rec.measurements]
    default = next((m["ms"] for m in rec.measurements
                    if m["config"] == k.defaults), None)
    return cands, rec.best_ms, default


def paged_candidates_match(problem, dtype):
    """Every candidate config of ``problem`` launched on the serving
    phase's decode inputs (make_problem: random pages, an inactive row)
    against ``plain_split_window_attention`` at the split count and
    length the config plans; returns the worst error over valid rows."""
    from paddle_tpu_torch import tuning
    from paddle_tpu_torch.ops import paged_attention as pa

    B, T = problem["batch"], problem["q_tokens"]
    kv = "int8" if problem["kv_dtype"] == "int8" else None
    args, scales = make_problem(B, T, dtype, seed=B * 10 + T,
                                inactive_row=B > 1, kv=kv)
    _, valid = window_masks(args[3], args[4], T)
    worst = 0.0
    for cfg in tuning.get_tunable("paged_attention").candidates(problem):
        plan = pa.plan_route(B, T, H, D, D, MB, BS, dtype, kv == "int8",
                             config=cfg)
        out = pa.paged_window_attention(*args, **scales, config=cfg)
        ref = pa.plain_split_window_attention(
            *args, **scales, n_splits=plan.n_splits,
            split_len=plan.split_len)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs()[valid].max())
        if not err <= TOL[dtype] or not bool(torch.isfinite(out).all()):
            fail("tuning: paged candidate %s (%s, %s) parts from the plain "
                 "split at %d x %d keys by %g (limit %g)"
                 % (cfg, problem, dtype, plan.n_splits, plan.split_len, err,
                    TOL[dtype]))
        worst = max(worst, err)
    return worst


def paged_config_ms(B, dtype, kv, configs):
    """Device ms of the kernel at the kernel phase's B x T=1 problem
    (rotating pool copies past the L2 cache, as ``time_problem``) under
    each config of ``configs``, in turns (a, b, b, a): the min of each."""
    from paddle_tpu_torch.ops import paged_window_attention

    args, scales = make_problem(B, 1, dtype, seed=B * 10 + 1,
                                inactive_row=B > 1, kv=kv)
    q, kp, vp, tables, cached = args
    pool_bytes = 2 * kp.numel() * kp.element_size()
    copies = [(args, scales)] + [
        ((q, kp.clone(), vp.clone(), tables, cached),
         {n: t.clone() for n, t in scales.items()})
        for _ in range(max(1, math.ceil(4 * L2_BYTES / pool_bytes)) - 1)]
    times = {i: [] for i in range(len(configs))}
    state = {"i": 0}

    def call(cfg):
        state["i"] = (state["i"] + 1) % len(copies)
        a, kw = copies[state["i"]]
        return paged_window_attention(*a, **kw, config=cfg)

    order = list(range(len(configs)))
    for i in order + order[::-1]:
        times[i].append(device_ms(lambda: call(configs[i]), 50))
    return [min(times[i]) for i in order]


def phase_tuning(card, model, n_recipe):
    """(29) Kernel autotuning on the card, in a temporary tuning store:
    the serving burst with default configs, then with
    ``DecodingConfig(autotune=True)`` (its warm-up sweeps the paged
    kernel at every ``decode_tuning_problems()`` point; tokens must be
    identical); sweeps of the paged kernel on bf16 pools at the same
    points (``amp_serving``'s) and on int8 pools at B=16, of the fused
    update at the recipe's Adam group and of ``fused_ce`` at the
    recipe's head. Every launched paged candidate is held to
    ``plain_split_window_attention`` at its planned splits, every grid
    cap of the fused update to the plain version bit for bit, every
    chunk cap's loss to the default's; no candidate may record an error.
    A second process on the same store must sweep nothing, hit the store
    and resolve the same configs; the served program exported with
    ``save_decode_model`` must carry ``tuned_configs`` that a fresh
    process seeds. Prints each candidate's device ms, the winner against
    the default and the bound, rows 4, 5a and 5b at the tuned and the
    default config (failing where a tuned 5a or 5b is slower than the
    default by more than ``TUNED_NOISE``), the decode step and warm-up
    with each, and the host cost of a memo-hit lookup."""
    import shutil
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import profiler, tuning
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import paged_window_attention
    from paddle_tpu_torch.ops.fused_ce import fused_linear_softmax_ce_fn
    from paddle_tpu_torch.ops.fused_optimizer import (fused_flat_update,
                                                      plain_flat_update)

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind_name = torch.cuda.get_device_name(0)
    root = tempfile.mkdtemp(prefix="chip_smoke_tuning_")
    store_dir = os.path.join(root, "store")
    try:
        fluid.set_flags({"tuning_cache_dir": ""})
        tuning.clear_memo()
        tuning.reset_tuning_metrics()
        prompts = serving_prompts()
        cache = CacheConfig(**SERVING_CACHE)
        default = serve_burst(model, cache, prompts,
                              counters=(paged_window_attention,))
        check_graphs(default, "tuning default")
        fluid.set_flags({"tuning_cache_dir": store_dir})
        tuning.clear_memo()
        sweep_s = profiler.event_totals().get("tuning/sweep", 0.0)
        tuned = serve_burst(model, cache, prompts,
                            counters=(paged_window_attention,),
                            autotune=True)
        sweep_s = profiler.event_totals()["tuning/sweep"] - sweep_s
        counts = route_counts(paged_window_attention)
        check_graphs(tuned, "tuning autotuned")
        if tuned["streams"] != default["streams"]:
            bad = [i for i, (a, b) in enumerate(zip(tuned["streams"],
                                                    default["streams"]))
                   if a != b]
            fail("tuning: the autotuned burst's tokens differ from the "
                 "default burst's (requests %s)" % bad)
        steps = tuned["report"]["decode_step"]["count"]
        if counts["split_launches"] < MODEL["n_layer"] * steps or \
                counts["generic_launches"]:
            fail("tuning: the autotuned burst's paged launches %s over %d "
                 "decode steps" % (counts, steps))
        engine = tuned["engines"][0]
        problems = engine.decode_tuning_problems()
        after_burst = tuning.tuning_metrics()
        if after_burst["sweeps"] != len(problems):
            fail("tuning: the autotuned warm-up swept %d times for %d "
                 "problems" % (after_burst["sweeps"], len(problems)))
        # the paged sweeps: f32 pools (the burst's, reused here), bf16
        # pools at the same points, int8 pools at the decode shape B=16
        paged = [(p, torch.float32) for p in problems] \
            + [(p, torch.bfloat16) for p in problems] \
            + [(dict(problems[-1], kv_dtype="int8"), torch.float32)]
        kernels = {"paged_attention": []}
        spec = []
        for problem, dtype in paged:
            dt = str(dtype)[6:]
            rec = tuning.sweep("paged_attention", problem, dtype=dt,
                               device=dev, iters=TUNING_ITERS,
                               samples=TUNING_SAMPLES)
            cands, best, dflt = candidate_rows(rec)
            bound, bound_by = paged_tuning_bound(problem, dtype)
            err = paged_candidates_match(problem, dtype)
            kernels["paged_attention"].append({
                "problem": problem, "dtype": dt, "candidates": cands,
                "winner": rec.config, "winner_ms": best,
                "default_ms": dflt, "bound_ms": bound, "bound_by": bound_by,
                "winner_over_bound": best / bound,
                "candidates_max_abs_err": err})
            spec.append(["paged_attention", problem, dt])
        # the fused update at the recipe's group (bf16 moments)
        n = n_recipe
        opt_problem = {"numel": n, "n_accs": 2, "n_shared": 2,
                       "moment_dtype": "bfloat16"}
        rec = tuning.sweep("fused_optimizer_update", opt_problem,
                           device=dev, iters=10, samples=TUNING_SAMPLES)
        cands, best, dflt = candidate_rows(rec)
        kind, consts, _ = FUSED_CONFIGS["adam"]
        p, g, lr, accs, shared = fused_inputs(kind, True, n, 290)
        want = plain_flat_update(kind, p, g, lr, accs, shared, True, consts)
        for cfg in tuning.get_tunable("fused_optimizer_update").candidates(
                opt_problem):
            got = fused_flat_update(kind, p.clone(), g, lr,
                                    [a.clone() for a in accs], shared, True,
                                    consts, blocks_per_sm=cfg["blocks_per_sm"])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail("tuning: the fused update at %s is not bit-equal to "
                     "the plain version" % cfg)
            del got
        del want
        bound, bound_by, _, _ = fused_work("adam", True, False, n)
        kernels["fused_optimizer_update"] = {
            "problem": opt_problem, "candidates": cands,
            "winner": rec.config, "winner_ms": best, "default_ms": dflt,
            "bound_ms": bound, "bound_by": bound_by,
            "winner_over_bound": best / bound, "bit_equal": True}
        spec.append(["fused_optimizer_update", opt_problem, "float32"])
        # row 4 (the recipe's group, owning the beta powers), 5a and 5b
        # at the tuned and the default config, in turns
        opt_default = tuning.get_tunable("fused_optimizer_update").defaults
        cfgs = [opt_default, rec.config]
        pk, ak = p.clone(), [a.clone() for a in accs]
        row4 = {i: [] for i in range(2)}
        for i in (0, 1, 1, 0):
            row4[i].append(device_ms(lambda: fused_flat_update(
                kind, pk, g, lr, ak, shared, True, consts,
                blocks_per_sm=cfgs[i]["blocks_per_sm"]), 10))
        del p, g, accs, pk, ak
        torch.cuda.empty_cache()
        rows = {"4": {"default": opt_default, "tuned": rec.config,
                      "default_device_ms": min(row4[0]),
                      "tuned_device_ms": min(row4[1])}}
        pa_default = tuning.get_tunable("paged_attention").defaults
        for label, dtype, kv in (("5a", torch.float32, None),
                                 ("5b", torch.float32, "int8")):
            problem = dict(problems[-1], kv_dtype=kv or "f32")
            cfg = tuning.lookup("paged_attention", problem, dtype="float32",
                                device=dev)
            d_ms, t_ms = paged_config_ms(16, dtype, kv, [pa_default, cfg])
            if t_ms > d_ms * (1 + TUNED_NOISE):
                fail("tuning: at row %s's problem the tuned config %s takes "
                     "%.5f ms, the default %s %.5f ms (more than %g slower)"
                     % (label, cfg, t_ms, pa_default, d_ms, TUNED_NOISE))
            rows[label] = {"default": pa_default, "tuned": cfg,
                           "default_device_ms": d_ms, "tuned_device_ms": t_ms}
        # the host cost of a memo-hit lookup, as each eager paged launch
        # of the decode path pays it (plan_route's lookup)
        hit_problem = dict(problems[-1])
        tuning.lookup("paged_attention", hit_problem, dtype="float32",
                      device=dev)
        t0 = time.perf_counter()
        for _ in range(LOOKUP_CALLS):
            tuning.lookup("paged_attention", hit_problem, dtype="float32",
                          device=dev)
        lookup_hit_us = (time.perf_counter() - t0) / LOOKUP_CALLS * 1e6
        # fused_ce at the recipe's head: each chunk cap's loss against
        # the default's on the same inputs
        # one call a sample: a call launches 200-1,600 kernels (4-32
        # chunks), the card queues about 1,024 (past that a sample is
        # host-paced, and flagged so)
        rec = tuning.sweep("fused_ce", FUSED_CE_PROBLEM,
                           dtype=FUSED_CE_DTYPE, device=dev, iters=1,
                           samples=3)
        cands, best, dflt = candidate_rows(rec)
        gen = torch.Generator(device=dev).manual_seed(SEED + 29)
        tdt = getattr(torch, FUSED_CE_DTYPE)
        x = torch.randn(FUSED_CE_PROBLEM["n_tokens"], 512, generator=gen,
                        device=dev).to(tdt)
        W = (0.02 * torch.randn(512, 32000, generator=gen,
                                device=dev)).to(tdt)
        y = torch.randint(0, 32000, (x.shape[0],), generator=gen, device=dev)
        bf16 = tdt == torch.bfloat16
        losses = {c["chunk_cap"]: fused_linear_softmax_ce_fn(
            x, W, None, y, chunk_cap=c["chunk_cap"], bf16=bf16).sum().item()
            for c in tuning.get_tunable("fused_ce").candidates()}
        ref = losses[tuning.get_tunable("fused_ce").defaults["chunk_cap"]]
        ce_rel = max(abs(v - ref) / abs(ref) for v in losses.values())
        if not ce_rel <= FUSED_CE_LOSS_TOL:
            fail("tuning: fused_ce's chunk caps part in the loss by %g of "
                 "it (limit %g): %s" % (ce_rel, FUSED_CE_LOSS_TOL, losses))
        ops = 3 * 2 * FUSED_CE_PROBLEM["n_tokens"] * 512 * 32000
        ce_bound = ops / PEAK_OPS[tdt] * 1e3
        kernels["fused_ce"] = {
            "problem": FUSED_CE_PROBLEM, "dtype": FUSED_CE_DTYPE,
            "candidates": cands, "winner": rec.config, "winner_ms": best,
            "default_ms": dflt, "bound_ms": ce_bound,
            "bound_by": "operations (three GEMMs: logits, dW, dx)",
            "loss_rel_spread": ce_rel}
        spec.append(["fused_ce", FUSED_CE_PROBLEM, FUSED_CE_DTYPE])
        del x, W, y
        torch.cuda.empty_cache()
        local = [tuning.lookup(kn, pr, dtype=dt, device=dev)
                 for kn, pr, dt in spec]
        # a second process on the same store: zero sweeps, store hits
        second = tuning_worker(store_dir, "store", spec)
        sm = second["metrics"]
        if sm["sweeps"] != 0 or sm["candidates_measured"] != 0 or \
                sm["store_hits"] < len(spec) or \
                sm["sweep_reused"] != len(spec) or \
                [c for c, _ in second["configs"]] != local or \
                [c for _, c in second["configs"]] != local:
            fail("tuning: the second process on the store: %s (configs %s "
                 "against %s)" % (sm, second["configs"], local))
        # the served program exported: the pair's tuned configs travel in
        # its manifest, and a fresh process with no store seeds them
        export = os.path.join(root, "decode_model")
        main, logits, scope = model
        fluid.io.save_decode_model(export, "tokens", logits,
                                   fluid.Executor(fluid.CUDAPlace(0)),
                                   main_program=main, scope=scope,
                                   cache_config=cache)
        with open(os.path.join(export, "__model__.json")) as f:
            shipped = json.load(f).get("tuned_configs", [])
        n_paged = sum(1 for r in shipped if r["kernel"] == "paged_attention")
        if n_paged != len(paged) or any(r["device_kind"] != kind_name
                                        for r in shipped):
            fail("tuning: the decode artifact ships %d paged configs (%d "
                 "swept): %s" % (n_paged, len(paged), shipped))
        paged_spec = [s for s in spec if s[0] == "paged_attention"]
        fresh = tuning_worker(export, "seed", paged_spec)
        want_cfg = [c for s, c in zip(spec, local) if s[0] ==
                    "paged_attention"]
        if fresh["metrics"]["seeded"] != len(shipped) or \
                fresh["configs"] != want_cfg or \
                fresh["metrics"]["store_hits"] != 0:
            fail("tuning: a fresh process seeded from the manifest: %s, "
                 "configs %s against %s" % (fresh["metrics"],
                                             fresh["configs"], want_cfg))
        d_row, t_row = burst_row(default), burst_row(tuned)
        emit({"phase": "tuning", "card": card, "device_kind": kind_name,
              "kernels": kernels, "rows": rows,
              "decode_step_ms": {"default": d_row["mean_decode_step_ms"],
                                 "tuned": t_row["mean_decode_step_ms"]},
              "tokens_per_s": {"default": d_row["tokens_per_s"],
                               "tuned": t_row["tokens_per_s"]},
              "warm_up_s": {"default": default["warm_up_s"],
                            "tuned": tuned["warm_up_s"],
                            "sweeps_in_tuned": sweep_s},
              "streams_equal_default": True,
              "route_launches": counts, "problems": len(problems),
              "lookup_hit_us": lookup_hit_us,
              "metrics": tuning.tuning_metrics(),
              "second_process": sm, "seeded_process": fresh["metrics"],
              "manifest_tuned_configs": len(shipped),
              "phase_s": time.perf_counter() - t_phase})
        del default, tuned
    finally:
        fluid.set_flags({"tuning_cache_dir": ""})
        tuning.clear_memo()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 8


def phase_recipe(card):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    place = fluid.CUDAPlace(0)
    feed = train_batch()
    nets = {}
    for fuse in (False, True):
        main, startup, cost = build_recipe(fuse)
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(seeded_weights(main), scope, place,
                                program=main)
        nets[fuse] = (main, cost, scope, exe)
    fused_main = nets[True][0]
    dense = [p.name for p in fused_main.all_parameters()
             if p.name in fused_main._flat_state_views]
    groups = sum(op.type.endswith("_fused")
                 for op in fused_main.global_block().ops)

    # the same program without fuse_optimizer_state: two steps
    main, cost, scope, exe = nets.pop(False)
    ref_losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                                scope=scope)[0]) for _ in range(2)]
    ref = {n: fluid.fetch_var(n, scope) for n in dense}
    del main, cost, scope, exe
    torch.cuda.empty_cache()

    main, cost, scope, exe = nets.pop(True)
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fused_flat_update)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in launchers:
        fn.launches = 0
    losses, step_s = [], []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
        if step == PARALLEL_STEPS - 1:
            # every parameter and its first moment after the parallel
            # phase's steps (its reference)
            at_parallel = {n: fluid.fetch_var(n, scope)
                           for n in parallel_state_names(main)}
        if step == 1:
            param_rel, n_equal = {}, 0
            for n in dense:
                got = fluid.fetch_var(n, scope)
                param_rel[n] = float(np.abs(got - ref[n]).max()
                                     / max(np.abs(ref[n]).max(), 1e-30))
                n_equal += bool(np.array_equal(got, ref[n]))
    # the dense parameters after the last step (the run_steps phase's
    # reference)
    final = {n: fluid.fetch_var(n, scope) for n in dense}
    launches = {fn.__name__: fn.launches for fn in launchers}
    peak = torch.cuda.max_memory_allocated()
    want = {fn.__name__: ATTN_PER_STEP * TRAIN_STEPS for fn in launchers[:3]}
    want["fused_flat_update"] = groups * TRAIN_STEPS
    if launches != want:
        fail("the recipe's %d steps launched %s, expected %s"
             % (TRAIN_STEPS, launches, want))
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite recipe loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("the recipe's loss did not fall over %d steps: %s"
             % (TRAIN_STEPS, losses))
    loss_rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    if not loss_rel <= 1e-5:
        fail("recipe step-0 loss: fused %r, per-parameter %r (rel %g > "
             "1e-5)" % (losses[0], ref_losses[0], loss_rel))
    worst = max(param_rel.values())
    if not worst <= 1e-6:
        fail("after two steps the dense parameters of the two routes part "
             "by %g of their max (> 1e-6): %s"
             % (worst, sorted(param_rel.items(), key=lambda kv: -kv[1])[:5]))
    steady = step_s[1:]
    step_ms = float(np.mean(steady)) * 1e3
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run(main, feed=feed, fetch_list=[cost], scope=scope))
    busy = sum(by_family.values())
    emit({"phase": "recipe", "card": card, "batch": TRAIN_B,
          "seq": TRAIN_T, "steps": TRAIN_STEPS, "flags": RECIPE_FLAGS,
          "groups": groups, "group_params": len(dense),
          "group_elements": int(main.global_block().var(
              "fused_param_storage_0").shape[0]),
          "losses": losses, "per_param_losses": ref_losses,
          "step0_loss_rel_err": loss_rel,
          "step1_param_max_rel_err": worst,
          "step1_params_bit_equal": "%d of %d" % (n_equal, len(dense)),
          "step_ms_mean": step_ms,
          "step_ms_p50": float(np.median(steady)) * 1e3,
          "first_step_ms": step_s[0] * 1e3,
          "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
          "max_memory_allocated": peak, "launches": launches,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall_ms,
          "device_idle_share_unprofiled": 1.0 - busy / step_ms,
          "kernel_launches_per_step": kernels,
          "device_ms_by_family": dict(sorted(by_family.items(),
                                             key=lambda kv: -kv[1])),
          "top_kernels": top})
    return launches, losses, final, at_parallel


# the offload phase: the recipe's eager steps with and without the
# host_offload pass, from one state
OFFLOAD_STEPS = 6
# the caching allocator hands out whole blocks: a tensor of n bytes
# holds n rounded up to 512, and a large block is not split when less
# than 1 MiB would remain, so each offloaded tensor may free up to this
# much more than its bytes
OFFLOAD_BLOCK_SLACK = (1 << 20) + 512
_FRACTION_CHILD = r"""
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
print("capped", memory.memory_usage().bytes_in_use)
"""


def _offload_run(place, offload, feed):
    """OFFLOAD_STEPS eager steps of the recipe from its seeded state,
    with the host_offload pass applied when ``offload``: (losses, step
    seconds, the card's allocated bytes after each step, the final
    state on the host, the program, the fused update's launches, the
    host-resident bytes, host ms a steady step by span)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import passes, profiler
    from paddle_tpu_torch.core import memory
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    main, startup, cost = build_recipe(True)
    if offload:
        passes.apply_passes([passes.HostOffloadPass()], main)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.params_from_numpy(seeded_weights(main), scope, place,
                            program=main)
    torch.cuda.synchronize()
    reset_counts(fused_flat_update)
    losses, step_s, between = [], [], []
    for step in range(OFFLOAD_STEPS):
        if step == 2:  # host spans of the steady steps
            profiler.reset_profiler()
            profiler.start_profiler("CPU")
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(out.tolist())
        torch.cuda.synchronize()
        between.append(memory.memory_usage().bytes_in_use)
    spans = {n: t * 1e3 / (OFFLOAD_STEPS - 2)
             for n, t in profiler.event_totals().items()
             if n in ("dispatch", "fetch_sync", "offload_d2h",
                      "offload_h2d")}
    profiler.stop_profiler()
    launches = fused_flat_update.launches
    names = tuple(getattr(main, "_host_offload_state", ()) or ())
    host = {n: scope.find_var(n) for n in names}
    not_host = [n for n, t in host.items()
                if t.device.type != "cpu" or not t.is_pinned()]
    if not_host:
        fail("offload: between steps %s are not in pinned host memory"
             % not_host[:5])
    host_bytes = sum(t.numel() * t.element_size() for t in host.values())
    state = {v.name: fluid.fetch_var(v.name, scope)
             for v in main.list_vars() if v.persistable
             and v.name not in getattr(main, "_flat_state_views", {})}
    exe.close()
    del exe, scope
    return (losses, step_s, between, state, main, launches, host_bytes,
            spans)


def phase_offload(card):
    """The recipe (RECIPE_FLAGS, one flat Adam group) for OFFLOAD_STEPS
    eager steps without ``host_offload``, then with it, from the same
    seeded state: losses and the whole state bit-equal; between steps
    the offloaded moments live in pinned host memory, so the card's
    allocated bytes drop by their size, which ``analyze_liveness``
    predicts from the two programs. Then ``set_memory_fraction`` caps a
    child process. Returns the fused update's launches with offload."""
    import gc

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import analysis

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    feed = train_batch()
    runs = {}
    for offload in (False, True):
        runs[offload] = _offload_run(place, offload, feed)
        gc.collect()
        torch.cuda.empty_cache()
    (b_loss, b_s, b_mem, b_state, b_main, _, _, b_spans) = runs[False]
    (o_loss, o_s, o_mem, o_state, o_main, launches, host_bytes,
     o_spans) = runs[True]
    if o_loss != b_loss:
        fail("offload: losses %s with host_offload, %s without"
             % (o_loss, b_loss))
    differ = [n for n in b_state if not np.array_equal(o_state[n],
                                                       b_state[n])]
    if differ or set(o_state) != set(b_state):
        fail("offload: state parts with host_offload: %s" % differ[:5])
    if launches != OFFLOAD_STEPS:
        fail("offload: the fused update launched %d times over %d steps"
             % (launches, OFFLOAD_STEPS))
    predicted = (analysis.analyze_liveness(b_main, assume_batch=TRAIN_B)
                 .persistable_device_bytes
                 - analysis.analyze_liveness(o_main, assume_batch=TRAIN_B)
                 .persistable_device_bytes)
    drops = [b - o for b, o in zip(b_mem, o_mem)]
    if predicted != host_bytes:
        fail("offload: liveness predicts %d bytes off the card, the scope "
             "holds %d on the host" % (predicted, host_bytes))
    slack = OFFLOAD_BLOCK_SLACK * len(o_main._host_offload_state)
    if any(not 0 <= d - predicted <= slack for d in drops):
        fail("offload: the card's bytes between steps dropped by %s, "
             "liveness predicts %d (allocator blocks: up to %d more)"
             % (drops, predicted, slack))
    proc = subprocess.run(
        [sys.executable, "-c", _FRACTION_CHILD],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or "capped" not in proc.stdout:
        fail("offload: set_memory_fraction did not cap a child process: %s"
             % proc.stderr[-2000:])
    # steady steps: from the third on (step 1 is the first to take a
    # staged copy, and its copy stream's pool allocates then)
    b_ms = float(np.median(b_s[2:])) * 1e3
    o_ms = float(np.median(o_s[2:])) * 1e3
    # the card's copy rates for the offloaded bytes, each way, from and
    # to pinned host memory (CUDA events around the copy)
    dev = torch.empty(predicted, dtype=torch.uint8, device="cuda")
    host = torch.empty(predicted, dtype=torch.uint8, pin_memory=True)
    d2h_ms = cuda_ms(lambda: host.copy_(dev, non_blocking=True), 5, 1)
    h2d_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 5, 1)
    del dev, host
    emit({"phase": "offload", "card": card, "batch": TRAIN_B,
          "seq": TRAIN_T, "steps": OFFLOAD_STEPS, "flags": RECIPE_FLAGS,
          "offloaded": list(o_main._host_offload_state),
          "schedule_stamp": o_main._schedule_stamp,
          "losses": o_loss, "losses_bit_equal": True,
          "state_bit_equal": len(b_state),
          "step_ms": {"base": b_ms, "offload": o_ms},
          "step_ms_each": {"base": [t * 1e3 for t in b_s],
                           "offload": [t * 1e3 for t in o_s]},
          "first_step_ms": {"base": b_s[0] * 1e3, "offload": o_s[0] * 1e3},
          "offload_cost_ms": o_ms - b_ms,
          "host_ms_by_span": {"base": b_spans, "offload": o_spans},
          "copy_ms": {"d2h": d2h_ms, "h2d": h2d_ms},
          "copy_gb_per_s": {"d2h": predicted / d2h_ms / 1e6,
                            "h2d": predicted / h2d_ms / 1e6},
          "allocated_between_steps": {"base": b_mem, "offload": o_mem},
          "drop_bytes": drops, "liveness_predicted_bytes": predicted,
          "block_slack_bytes": slack,
          "fused_flat_update_launches": launches,
          "fraction_child": proc.stdout.strip().splitlines()[-1],
          "phase_s": time.perf_counter() - t_phase})
    return {"fused_flat_update": launches}


# bench.py's loop: chunks of 10 steps a run_steps call on the card
# (bench.py:154), 20 timed steps (:100), a DataLoader of buffer 4 (:186)
CHUNK, BENCH_STEPS, LOADER_BUFFER = 10, 20, 4


def phase_run_steps(card, eager_losses, eager_params):
    """bench.py's training loop on the recipe: ``memory_optimize``, then
    ``Executor.run_steps`` (captured CUDA graphs) and
    ``Executor.run(feed=DataLoader)``, from the recipe phase's start
    state (``eager_losses``, ``eager_params``: its 10 eager steps)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    place = fluid.CUDAPlace(0)
    feed = train_batch()
    main, startup, cost = build_recipe(True)
    fluid.memory_optimize(main)
    groups = sum(op.type.endswith("_fused")
                 for op in main.global_block().ops)
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fused_flat_update)
    per_step = {fn.__name__: ATTN_PER_STEP for fn in launchers[:3]}
    per_step["fused_flat_update"] = groups

    def fresh():
        return _fresh(main, startup, place)

    def launched():
        return {fn.__name__: fn.launches for fn in launchers}

    def timed_chunks(exe, scope, unroll=False):
        """bench.py's timed leg: BENCH_STEPS steps in chunks, the feed on
        the card; seconds."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BENCH_STEPS // CHUNK):
            out, = exe.run_steps(main, feed=dev_feed, steps=CHUNK,
                                 fetch_list=[cost], scope=scope,
                                 return_numpy=False, unroll=unroll)
        out.cpu()
        return time.perf_counter() - t0

    # 1. ten steps in one call (the eager step, the capture, nine
    # replays) from the recipe phase's start state
    exe, scope = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in launchers:
        reset_counts(fn)
    t0 = time.perf_counter()
    losses, = exe.run_steps(main, feed=feed, steps=TRAIN_STEPS,
                            fetch_list=[cost], scope=scope)
    first_call_s = time.perf_counter() - t0
    launches = launched()
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if launches != want:
        fail("run_steps' %d steps launched %s, expected %s"
             % (TRAIN_STEPS, launches, want))
    if losses.shape != (TRAIN_STEPS,):
        fail("run_steps returned losses of shape %s" % (losses.shape,))
    loss_rel = [abs(float(a) - b) / abs(b)
                for a, b in zip(losses, eager_losses)]
    if not max(loss_rel) <= 1e-5:
        fail("run_steps' losses part from the eager steps' by rel %g "
             "(> 1e-5): %s against %s" % (max(loss_rel), losses.tolist(),
                                          eager_losses))
    param_rel, n_equal = {}, 0
    for n, ref in eager_params.items():
        got = fluid.fetch_var(n, scope)
        param_rel[n] = float(np.abs(got - ref).max()
                             / max(np.abs(ref).max(), 1e-30))
        n_equal += bool(np.array_equal(got, ref))
    worst = max(param_rel.values())
    if not worst <= 1e-6:
        fail("after %d steps the dense parameters of run_steps and the "
             "eager steps part by %g of their max (> 1e-6): %s"
             % (TRAIN_STEPS, worst, sorted(param_rel.items(),
                                           key=lambda kv: -kv[1])[:5]))

    # 2. a second call replays the graph: no new capture
    second, = exe.run_steps(main, feed=feed, steps=TRAIN_STEPS,
                            fetch_list=[cost], scope=scope)
    if exe.num_compiled != 1:
        fail("the second run_steps call captured again (%d graphs)"
             % exe.num_compiled)
    if not (np.isfinite(second).all() and second[-1] < second[0]
            and second[-1] < losses[-1]):
        fail("the second call's losses did not keep falling: %s after %s"
             % (second.tolist(), losses.tolist()))

    # bench.py's protocol, the feed on the card: a warm chunk, then two
    # timed chunks
    dev_feed = {n: torch.as_tensor(v).to(place.torch_device())
                for n, v in feed.items()}
    exe.run_steps(main, feed=dev_feed, steps=CHUNK, fetch_list=[cost],
                  scope=scope, return_numpy=False)
    dev_s = timed_chunks(exe, scope)

    # 3. one replayed step under torch.profiler (its graph captured by
    # the call before)
    exe.run_steps(main, feed=dev_feed, steps=1, fetch_list=[cost],
                  scope=scope)
    for fn in launchers:
        reset_counts(fn)
    fam_launches = {}
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run_steps(main, feed=dev_feed, steps=1,
                              fetch_list=[cost], scope=scope),
        family_launches=fam_launches)
    counted = launched()
    seen = {"flash_fwd": fam_launches.get("flash_fwd", 0),
            "flash_bwd_dq": fam_launches.get("flash_bwd_dq", 0),
            "flash_bwd_dkv": fam_launches.get("flash_bwd_dkv", 0),
            "fused_flat_update": fam_launches.get("fused_update", 0)}
    if seen != per_step or counted != per_step:
        fail("one replayed step: the profiler saw %s, the wrappers counted "
             "%s, expected %s" % (seen, counted, per_step))
    busy = sum(by_family.values())

    # 4. unroll=True: ten straight-line steps in one graph
    exe_u, scope_u = fresh()
    unrolled, = exe_u.run_steps(main, feed=feed, steps=TRAIN_STEPS,
                                fetch_list=[cost], scope=scope_u,
                                unroll=True)
    unroll_rel = max(abs(float(a) - float(b)) / abs(float(b))
                     for a, b in zip(unrolled, losses))
    if not unroll_rel <= 1e-5:
        fail("unroll=True's losses part from unroll=False's by rel %g "
             "(> 1e-5): %s against %s" % (unroll_rel, unrolled.tolist(),
                                          losses.tolist()))
    exe_u.run_steps(main, feed=dev_feed, steps=CHUNK, fetch_list=[cost],
                    scope=scope_u, return_numpy=False, unroll=True)
    unroll_s = timed_chunks(exe_u, scope_u, unroll=True)
    unroll_capture_s = exe_u.capture_seconds
    exe_u.close()
    del exe_u, scope_u
    torch.cuda.empty_cache()

    # the host-fed leg: every batch starts in host memory and reaches
    # the card through the loader, CHUNK batches a run_steps call; two
    # warm chunks, two timed
    n_batches = BENCH_STEPS + 2 * CHUNK

    def host_reader():
        for _ in range(n_batches):
            yield dict(feed)

    # the feeds' time axis is dynamic (-1); every batch here has T=256
    loader = fluid.reader.DataLoader(
        host_reader, place=place, program=main, chunk=CHUNK,
        buffer_size=LOADER_BUFFER, name="bench", check_recompile=False)
    for _ in range(2):
        out, = exe.run(main, feed=loader, fetch_list=[cost], scope=scope,
                       return_numpy="async")
        out.numpy()
    t0 = time.perf_counter()
    for _ in range(BENCH_STEPS // CHUNK):
        out, = exe.run(main, feed=loader, fetch_list=[cost], scope=scope,
                       return_numpy="async")
    host_losses = out.numpy()
    host_s = time.perf_counter() - t0
    stall = loader.metrics.stall_fraction()
    loader_report = loader.metrics.report()
    loader.close()
    if not np.isfinite(host_losses).all():
        fail("non-finite host-fed losses: %s" % host_losses.tolist())
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_B * TRAIN_T
    dev_tps = tokens * BENCH_STEPS / dev_s
    host_tps = tokens * BENCH_STEPS / host_s
    emit({"phase": "run_steps", "card": card, "batch": TRAIN_B,
          "seq": TRAIN_T, "chunk": CHUNK, "timed_steps": BENCH_STEPS,
          "groups": groups, "losses": losses.tolist(),
          "second_call_losses": second.tolist(),
          "eager_losses": list(eager_losses),
          "loss_max_rel_err": max(loss_rel),
          "param_max_rel_err": worst,
          "params_bit_equal": "%d of %d" % (n_equal, len(eager_params)),
          "unroll_loss_max_rel_err": unroll_rel,
          "launches": launches, "graphs": exe.num_compiled,
          "first_call_s": first_call_s,
          "capture_s": exe.capture_seconds,
          "unroll_capture_s": unroll_capture_s,
          "step_ms": dev_s / BENCH_STEPS * 1e3, "tokens_per_s": dev_tps,
          "unroll_step_ms": unroll_s / BENCH_STEPS * 1e3,
          "unroll_tokens_per_s": tokens * BENCH_STEPS / unroll_s,
          "host_fed_step_ms": host_s / BENCH_STEPS * 1e3,
          "host_fed_tokens_per_s": host_tps,
          "host_fed_ratio": host_tps / dev_tps,
          "stall_fraction": stall, "loader": loader_report,
          "max_memory_allocated": peak,
          "replayed_step_launches": seen,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall_ms,
          # the replayed step's busy time against a step of the timed
          # chunks (one call's host work spread over 10 steps)
          "device_idle_share_chunked": 1.0 - busy / (dev_s / BENCH_STEPS
                                                     * 1e3),
          "kernel_launches_per_step": kernels,
          "device_ms_by_family": dict(sorted(by_family.items(),
                                             key=lambda kv: -kv[1])),
          "top_kernels": top})
    exe.close()
    return {"step_ms": dev_s / BENCH_STEPS * 1e3, "tokens_per_s": dev_tps,
            "max_memory_allocated": peak,
            "timed": timed_program("recipe", main, feed, cost,
                                   dev_s / BENCH_STEPS * 1e3, peak,
                                   "bf16")}


# ---------------------------------------------------------------- phase 13


# bench_resnet.py's protocol (bench_resnet.py:45-114): ResNet-50 at B=64,
# 3x224x224, 1000 classes, Momentum(0.1, 0.9), the three bf16 flags,
# memory_optimize; a pool of 4 seeded batches on the card, one warm
# run_steps chunk, then 16 timed steps in chunks of 4
RESNET_B, RESNET_HW, RESNET_CLASSES = 64, 224, 1000
RESNET_FLAGS = {"use_bfloat16": True, "bf16_activations": True,
                "bf16_moments": True}
RESNET_POOL, RESNET_CHUNK, RESNET_STEPS = 4, 4, 16
RESNET_PARAMS, RESNET_N = 161, 25557032


# the parallel phase: the recipe on two ranks sharing card 0 over gloo
# (NCCL refuses two ranks on one card), PARALLEL_STEPS steps a mode.
# Tolerances against the one-card recipe (relative, every step): the
# batch reductions are summed over the ranks, so the loss is the whole
# batch's and only the products differ — bf16 roundings of GEMMs tiled
# for a rank's 4096 rows instead of 8192 (dp), and two bf16 partial
# products summed by the row-parallel fcs (tp). Reduce against
# AllReduce: the same sums and the same elementwise Adam on each half.
# The loss limits sit ~15x above the readings of the first card runs
# (6.0e-6 dp, 1.3e-5 tp, NVIDIA H100 80GB HBM3 at 700 W), below what a
# step missing its gradient reduction moves. Losses near log V hide a
# wrong update over 5 steps, so the state after them is held too,
# against the one-card run's (PARALLEL_STATE_TOL): ``moment``, the gap
# of all the first moments together over their norm (linear in the
# gradients: a half-batch, an unreduced or a scaled gradient moves it
# by its own size), and ``params``, the gap of all the parameters
# together over the one-card run's own 5-step update. Both are taken
# over the whole state: the gradient of an attention's query and key
# weights at a random start is a near-cancelling sum, rounding alone
# moves those leaves by their own size (a first card run: 1.3 of the
# norm of the last decoder layer's key moment), and Adam's update
# follows the gradient's sign. A one-card run on rank 0's half of the
# batch, what a rank with no gradient reduction does, must break both
# limits (the control). Readings of the card runs that set them (H100,
# 700 W): moment 0.034 dp, 0.063 tp, 0.98 the control (a gradient
# scaled by 2 gives 1.0); params 0.054 dp, 0.13 tp, 0.81 the control.
PARALLEL_STEPS = 5
PARALLEL_TOL = {"allreduce": 1e-4, "reduce": 1e-6, "tp": 2e-4}
PARALLEL_STATE_TOL = {"moment": 0.2, "params": 0.3}
PARALLEL_MODES = ("allreduce", "reduce", "tp")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_state_names(program):
    """Every parameter of the recipe and its Adam first moment."""
    names = [p.name for p in program.all_parameters()]
    return names + [n + "_moment1_0" for n in names]


def state_gaps(got, want, start):
    """``got`` against ``want`` (the one-card run's state after the
    parallel phase's steps; ``start`` the seeded parameters): the
    moment gap and the parameter gap of PARALLEL_STATE_TOL, and, to
    read beside them, the leaf of the largest moment gap with that gap,
    and the largest parameter gap over the largest |parameter| of any
    leaf."""
    worst, worst_gap, rel = None, 0.0, 0.0
    gap2 = step2 = mgap2 = mnorm2 = 0.0
    for n, w in want.items():
        w = w.astype(np.float64)
        d = got[n].astype(np.float64) - w
        if n in start:
            gap2 += float(np.square(d).sum())
            step2 += float(np.square(w - start[n]).sum())
            rel = max(rel, float(np.abs(d).max()
                                 / max(np.abs(w).max(), 1e-30)))
            continue
        g2, n2 = float(np.square(d).sum()), float(np.square(w).sum())
        mgap2 += g2
        mnorm2 += n2
        g = math.sqrt(g2 / n2) if n2 > 0 else (0.0 if g2 == 0
                                                else math.inf)
        if worst is None or g > worst_gap:
            worst, worst_gap = n, g
    return {"moment": math.sqrt(mgap2 / mnorm2),
            "params": math.sqrt(gap2 / step2), "moment_worst": worst,
            "moment_worst_gap": worst_gap, "param_max_rel_err": rel}


def whole_state_numpy(program, scope, names, spec_of, mesh):
    """Each of ``names`` whole, on the host in float32: a view of a flat
    group read from its storage, a block gathered over ``mesh``
    (``spec_of(name)`` its layout; collective: every rank calls it
    with the same names)."""
    from paddle_tpu_torch.sharding import comm

    gb = program.global_block()
    views = getattr(program, "_flat_state_views", None) or {}
    held = {}

    def whole(n):
        if n not in held:
            v = scope.find_var(n)
            if tuple(v.shape) != tuple(int(x) for x in gb.var(n).shape):
                v = comm.gather_full(v, spec_of(n), mesh)
            held[n] = v
        return held[n]

    out = {}
    for n in names:
        if n in views:
            store, off, numel, shape = views[n][:4]
            t = whole(store)[off:off + numel].reshape(shape)
        else:
            t = whole(n)
        out[n] = t.float().cpu().numpy()
    return out


def half_batch_state(place):
    """The control: the recipe on one card for PARALLEL_STEPS steps on
    the first half of the batch (rank 0's block), its state."""
    import paddle_tpu_torch as fluid

    main, startup, cost = build_recipe(True)
    scope, exe = fluid.Scope(), fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.params_from_numpy(seeded_weights(main), scope, place,
                            program=main)
    feed = {n: v[:TRAIN_B // 2] for n, v in train_batch().items()}
    for _ in range(PARALLEL_STEPS):
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    return {n: fluid.fetch_var(n, scope)
            for n in parallel_state_names(main)}


def _parallel_rank(rank, world, port, backend, out_dir, modes, ref_path):
    """One rank of the parallel phase (a spawned process): each mode's
    losses, step times, launches, collective bytes and held state, into
    ``out_dir/rank<r>.json``; rank 0 also holds every parameter after
    the steps against the one-card run's (``ref_path``, an .npz)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel, sharding
    from paddle_tpu_torch.core.enforce import GraphCaptureError
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update
    from paddle_tpu_torch.sharding import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = 0 if backend == "gloo" else rank
    torch.cuda.set_device(dev)
    parallel.init_distributed("localhost:%d" % port, world, rank,
                              backend=backend)
    place = fluid.CUDAPlace(dev)
    feed = train_batch()
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fused_flat_update)
    res = {"rank": rank, "backend": backend}
    ref = None
    if rank == 0:
        with np.load(ref_path) as z:
            ref = {n: z[n] for n in z.files}
    weights = None  # every mode's program names its parameters alike
    for mode in modes:
        scope, exe = fluid.Scope(), fluid.Executor(place)
        if mode == "tp":
            mesh = sharding.training_mesh(data=1, fsdp=1, tp=world)
            main, startup, cost = build_recipe(
                True, tp=True,
                shard=lambda m: sharding.shard_program(m, mesh))
        else:
            main, startup, cost = build_recipe(True)
        exe.run(startup, scope=scope)
        if weights is None:
            weights = seeded_weights(main)
        fluid.params_from_numpy(weights, scope, place, program=main)
        if mode == "tp":
            def run():
                return exe.run(main, feed=feed, fetch_list=[cost],
                               scope=scope)

            def steps():
                return exe.run_steps(main, feed_list=[feed] * 2,
                                     fetch_list=[cost], scope=scope)
        else:
            bs = fluid.BuildStrategy()
            bs.reduce_strategy = (fluid.parallel.ReduceStrategy.Reduce
                                  if mode == "reduce" else
                                  fluid.parallel.ReduceStrategy.AllReduce)
            pe = fluid.ParallelExecutor(
                main_program=main, loss_name=cost.name, build_strategy=bs,
                scope=scope, place=place)

            def run():
                return pe.run(feed=feed, fetch_list=[cost.name])

            def steps():
                return pe.run_steps(feed_list=[feed] * 2,
                                    fetch_list=[cost.name])
        heads, orig = set(), fa.flash_attention

        def spy(q, *a, **k):
            heads.add(int(q.shape[2]))
            return orig(q, *a, **k)

        fa.flash_attention = spy
        for fn in launchers:
            fn.launches = 0
        comm.reset_stats()
        losses, step_s = [], []
        try:
            for _ in range(PARALLEL_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(run()[0]))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        finally:
            fa.flash_attention = orig
        row = {"losses": losses,
               "step_ms": [t * 1e3 for t in step_s],
               "median_step_ms": float(np.median(step_s[1:])) * 1e3,
               "launches": {fn.__name__: fn.launches for fn in launchers},
               "collective_bytes_per_step":
                   comm.stats_bytes() / PARALLEL_STEPS,
               "collectives": {k: list(v) for k, v in comm.STATS.items()},
               "heads": sorted(heads)}
        gb = main.global_block()
        row["flat_moments"] = {
            n: {"whole_bytes": int(np.prod(gb.var(n).shape))
                * scope.find_var(n).element_size(),
                "held_bytes": scope.find_var(n).numel()
                * scope.find_var(n).element_size(),
                "aligned": scope.find_var(n).data_ptr() % 16 == 0}
            for n in scope.local_var_names()
            if n.startswith("fused_moment")}
        row["groups"] = {n: int(gb.var(n).shape[0])
                         for n in gb.vars
                         if n.startswith("fused_param_storage")}
        # every parameter and first moment whole (every rank gathers)
        if mode == "tp":
            plan = main._sharding_plan
            got = whole_state_numpy(
                main, scope, parallel_state_names(main),
                lambda n: plan.spec_for(gb._find_var_recursive(n), n),
                plan.mesh)
        else:
            got = whole_state_numpy(
                main, scope, parallel_state_names(main),
                lambda n: pe.state_shardings([n])[n].spec, pe.mesh)
        if ref is not None:
            row["state"] = state_gaps(got, ref, weights)
        del got
        try:
            steps()
            row["capture"] = None
        except GraphCaptureError as e:
            row["capture"] = str(e)
        res[mode] = row
        del run, steps, scope, exe, main, startup, cost
        if mode != "tp":
            del pe
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    parallel.env.shutdown()


def _run_ranks(world, backend, modes, timeout_s, ref_path):
    """Spawn ``world`` ranks of :func:`_parallel_rank`; their results.
    A rank that fails, or a call past ``timeout_s``, ends them all."""
    import tempfile

    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, world, port, backend, out, modes,
                               ref_path))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) \
                    or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        fail("parallel %s ranks exited %s" % (backend, codes))
    out_rows = []
    for r in range(world):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            out_rows.append(json.load(f))
    return out_rows


def phase_parallel(card, ref_losses, ref_params, n_recipe):
    """The recipe on two ranks sharing card 0 over gloo: (a) the
    ParallelExecutor at dp=2 (AllReduce), (b) the same with
    ReduceStrategy.Reduce (ZeRO: the fused update on each rank's half of
    the flat group), (c) ``shard_program`` at data=1 x fsdp=1 x tp=2 on
    the ``tp=True`` recipe (flash at 4 of the 8 heads). Losses held to
    the one-card recipe (``ref_losses``, the recipe phase's) at
    PARALLEL_TOL, the state after the steps to that run's
    (``ref_params``) at PARALLEL_STATE_TOL, which a one-card run on half
    the batch must break; every rank fetches the same
    losses; capture refused over gloo. Where the host has two cards,
    (a) over NCCL too."""
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import dropout, flash_attention, \
        fused_optimizer

    t0 = time.perf_counter()
    # built once here, so two ranks never build into build/ at once
    for mod in (flash_attention, fused_optimizer, dropout):
        mod.build()
    ref_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ref_"),
                            "params.npz")
    np.savez(ref_path, **ref_params)
    ranks = _run_ranks(2, "gloo", PARALLEL_MODES, 600, ref_path)
    ref = ref_losses[:PARALLEL_STEPS]

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    for mode in PARALLEL_MODES:
        if ranks[0][mode]["losses"] != ranks[1][mode]["losses"]:
            fail("parallel %s: the ranks fetched different losses %s, %s"
                 % (mode, ranks[0][mode]["losses"],
                    ranks[1][mode]["losses"]))
    errs = {"allreduce": rel(ranks[0]["allreduce"]["losses"], ref),
            "reduce": rel(ranks[0]["reduce"]["losses"],
                          ranks[0]["allreduce"]["losses"]),
            "tp": rel(ranks[0]["tp"]["losses"], ref)}
    for mode, err in errs.items():
        if not err <= PARALLEL_TOL[mode]:
            fail("parallel %s: losses %s part from %s by %g (> %g)"
                 % (mode, ranks[0][mode]["losses"],
                    ref if mode != "reduce" else "allreduce's", err,
                    PARALLEL_TOL[mode]))
    control = state_gaps(half_batch_state(fluid.CUDAPlace(0)), ref_params,
                         seeded_weights(build_recipe(True)[0]))
    per_mode = {}
    for mode in PARALLEL_MODES:
        want = {n: ATTN_PER_STEP * PARALLEL_STEPS
                for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        want["fused_flat_update"] = PARALLEL_STEPS * len(
            ranks[0][mode]["groups"])
        for r in ranks:
            if r[mode]["launches"] != want:
                fail("parallel %s rank %d launched %s, expected %s"
                     % (mode, r["rank"], r[mode]["launches"], want))
            if not r[mode]["capture"] or "gloo" not in r[mode]["capture"]:
                fail("parallel %s: run_steps over gloo was not refused "
                     "naming the backend: %r" % (mode, r[mode]["capture"]))
        per_mode[mode] = {n: sum(r[mode]["launches"][n] for r in ranks)
                          for n in want}
    want_heads = {"allreduce": [8], "reduce": [8], "tp": [4]}
    for mode, heads in want_heads.items():
        if any(r[mode]["heads"] != heads for r in ranks):
            fail("parallel %s: flash ran at heads %s, expected %s"
                 % (mode, [r[mode]["heads"] for r in ranks], heads))
    for r in ranks:
        groups = r["reduce"]["groups"]
        if list(groups.values()) != [n_recipe]:
            fail("parallel reduce: flat groups %s, expected one of %d"
                 % (groups, n_recipe))
        for n, m in r["reduce"]["flat_moments"].items():
            if m["held_bytes"] * 2 != m["whole_bytes"] or not m["aligned"]:
                fail("parallel reduce rank %d: moment %s holds %s"
                     % (r["rank"], n, m))
    nccl = "not run: %d card" % torch.cuda.device_count()
    if torch.cuda.device_count() >= 2:
        rows = _run_ranks(2, "nccl", ("allreduce",), 300, ref_path)
        err = rel(rows[0]["allreduce"]["losses"], ref)
        if not err <= PARALLEL_TOL["allreduce"]:
            fail("parallel nccl: losses part from the one-card run by %g"
                 % err)
        nccl = {"losses": rows[0]["allreduce"]["losses"], "rel_err": err,
                "median_step_ms": [r["allreduce"]["median_step_ms"]
                                   for r in rows],
                "capture": rows[0]["allreduce"]["capture"]}
    emit({"phase": "parallel", "card": card, "backend": "gloo",
          "ranks": 2, "batch": TRAIN_B, "seq": TRAIN_T,
          "steps": PARALLEL_STEPS, "one_card_losses": ref,
          "losses": {m: ranks[0][m]["losses"] for m in PARALLEL_MODES},
          "rel_err": errs, "tolerance": PARALLEL_TOL,
          "state": {m: ranks[0][m]["state"] for m in PARALLEL_MODES},
          "state_control_half_batch": control,
          "state_tolerance": PARALLEL_STATE_TOL,
          "median_step_ms": {m: [r[m]["median_step_ms"] for r in ranks]
                             for m in PARALLEL_MODES},
          "collective_bytes_per_step": {
              m: [r[m]["collective_bytes_per_step"] for r in ranks]
              for m in PARALLEL_MODES},
          "collectives": {m: ranks[0][m]["collectives"]
                          for m in PARALLEL_MODES},
          "launches": per_mode,
          "zero_moments": ranks[0]["reduce"]["flat_moments"],
          "tp_groups": ranks[0]["tp"]["groups"],
          "capture": ranks[0]["tp"]["capture"], "nccl": nccl,
          "parallel_s": time.perf_counter() - t0})
    # the state after the steps (checked once the readings are out)
    for mode in PARALLEL_MODES:
        got = ranks[0][mode]["state"]
        for key, tol in PARALLEL_STATE_TOL.items():
            if not got[key] <= tol:
                fail("parallel %s: after %d steps the %s gap to the "
                     "one-card run is %g (> %g; %s)"
                     % (mode, PARALLEL_STEPS, key, got[key], tol, got))
    for key, tol in PARALLEL_STATE_TOL.items():
        if not control[key] > tol:
            fail("parallel: a one-card run on half the batch keeps the %s "
                 "gap at %g (<= %g): the state check cannot tell a rank "
                 "that never reduced its gradient" % (key, control[key],
                                                       tol))
    return per_mode


def build_resnet(fuse):
    """(main, startup, avg_cost) of bench_resnet.py's program after
    ``memory_optimize``, with ``fuse_optimizer_state`` as ``fuse``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    values = dict(RESNET_FLAGS, fuse_optimizer_state=fuse)
    saved = {n: fluid.get_flag(n) for n in values}
    fluid.set_flags(values)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(
                name="img", shape=[-1, 3, RESNET_HW, RESNET_HW],
                dtype="float32", append_batch_size=False)
            lbl = fluid.layers.data(name="lbl", shape=[-1, 1],
                                    dtype="int64", append_batch_size=False)
            predict = resnet_imagenet(img, class_dim=RESNET_CLASSES)
            cost = fluid.layers.cross_entropy(input=predict, label=lbl)
            avg_cost = fluid.layers.mean(cost)
            fluid.optimizer.Momentum(learning_rate=0.1,
                                     momentum=0.9).minimize(avg_cost)
    finally:
        fluid.set_flags(saved)
    fluid.memory_optimize(main)
    return main, startup, avg_cost


def resnet_weights(program, seed=SEED):
    """Random weights from a numpy seed, as the model initializes them:
    conv filters N(0, 2 / fan_in), batch-norm scales 1 and biases 0, the
    fc weight N(0, 1 / fan_in) and its bias 0."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for p in program.all_parameters():
        shape = tuple(p.shape)
        if p.name.startswith("conv2d.w_"):
            a = rng.standard_normal(shape) * math.sqrt(
                2.0 / int(np.prod(shape[1:])))
        elif p.name.startswith("fc.w_"):
            a = rng.standard_normal(shape) / math.sqrt(shape[0])
        elif p.name.startswith("batch_norm.w_"):
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        arrays[p.name] = a.astype(np.float32)
    return arrays


def resnet_pool(seed=SEED + 5):
    """bench_resnet.py's synthetic batches: uniform images, uniform
    labels, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(RESNET_B, 3, RESNET_HW, RESNET_HW).astype(
                 np.float32),
             "lbl": rng.randint(0, RESNET_CLASSES,
                                (RESNET_B, 1)).astype(np.int64)}
            for _ in range(RESNET_POOL)]


def _resnet_family(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv",
                              "implicit")):
        return "conv"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "conv_layout"  # cuDNN's transposes around an NCHW conv
    if "batch_norm" in low or "bn_" in low:
        return "batch_norm"
    if "pool" in low:
        return "pool"
    return _train_family(name)


def _resnet_params(fluid, main, scope):
    return {p.name: fluid.fetch_var(p.name, scope)
            for p in main.all_parameters()}


def _worst_rel(got, want):
    """max over arrays of max |got - want| / max |want|."""
    return max(float(np.abs(got[n] - w).max()
                     / max(float(np.abs(w).max()), 1e-30))
               for n, w in want.items())


def s2d_stem_check(card):
    """The space-to-depth stem against the plain 7x7/s2 conv on the card
    at f32 (TF32 off), from the same weight: the same output shape, and
    within 1e-4 of the output's max."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.resnet import _s2d_stem_conv

    rng = np.random.RandomState(SEED + 6)
    x = rng.rand(8, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    w = (rng.standard_normal((64, 3, 7, 7)) * math.sqrt(2.0 / 147)).astype(
        np.float32)
    place = fluid.CUDAPlace(0)
    outs = {}
    for mode in ("plain", "s2d"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(name="img",
                                    shape=[-1, 3, RESNET_HW, RESNET_HW],
                                    dtype="float32", append_batch_size=False)
            out = (_s2d_stem_conv(img) if mode == "s2d" else
                   fluid.layers.conv2d(input=img, num_filters=64,
                                       filter_size=7, stride=2, padding=3,
                                       bias_attr=False))
        wname, = [p.name for p in main.all_parameters()]
        scope = fluid.Scope()
        fluid.params_from_numpy({wname: w}, scope, place, program=main)
        outs[mode] = fluid.Executor(place).run(
            main, feed={"img": x}, fetch_list=[out], scope=scope)[0]
    if outs["s2d"].shape != outs["plain"].shape:
        fail("s2d stem: output %s, plain stem %s"
             % (outs["s2d"].shape, outs["plain"].shape))
    rel = float(np.abs(outs["s2d"] - outs["plain"]).max()
                / np.abs(outs["plain"]).max())
    if not rel <= 1e-4:
        fail("s2d stem: parts from the plain stem by %g of its max "
             "(> 1e-4)" % rel)
    return {"shape": list(outs["plain"].shape), "max_rel_err": rel}


def phase_resnet(card):
    """bench_resnet.py's training path on the card in both layouts (per
    parameter, and fuse_optimizer_state with the momentum kind of the
    fused update); returns the fused layout's timed run's launches of
    ``fused_flat_update``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    place = fluid.CUDAPlace(0)
    pool = resnet_pool()
    dev_pool = {n: torch.stack([torch.as_tensor(b[n]) for b in pool]).to(
        place.torch_device()) for n in pool[0]}
    nets = {fuse: build_resnet(fuse) for fuse in (False, True)}
    main_f = nets[True][0]
    groups = sum(op.type == "momentum_fused"
                 for op in main_f.global_block().ops)
    n_flat = int(main_f.global_block().var(
        "fused_param_storage_0").shape[0])
    n_params = len(main_f.all_parameters())
    if (groups, n_flat, n_params) != (1, RESNET_N, RESNET_PARAMS):
        fail("resnet: %d momentum groups of %d elements over %d "
             "parameters, expected 1 of %d over %d"
             % (groups, n_flat, n_params, RESNET_N, RESNET_PARAMS))
    weights = resnet_weights(nets[False][0])

    def fresh(fuse):
        main, startup, cost = nets[fuse]
        scope, exe = fluid.Scope(), fluid.Executor(place)
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(weights, scope, place, program=main)
        return main, cost, scope, exe

    # 1. the equality checks, with deterministic cuDNN algorithms (its
    # weight-gradient algorithms may otherwise sum with atomics): two
    # eager steps in each layout, then run_steps from the same start
    torch.backends.cudnn.deterministic = True
    eager = {}
    try:
        for fuse in (False, True):
            main, cost, scope, exe = fresh(fuse)
            reset_counts(fused_flat_update)
            losses = [float(exe.run(main, feed=pool[i], fetch_list=[cost],
                                    scope=scope)[0]) for i in range(2)]
            if fused_flat_update.launches != (2 * groups if fuse else 0):
                fail("resnet: two eager steps (fuse=%s) launched the fused "
                     "update %d times" % (fuse, fused_flat_update.launches))
            eager[fuse] = (losses, _resnet_params(fluid, main, scope))
            del main, cost, scope, exe
        main, cost, scope, exe = fresh(True)
        rs_losses, = exe.run_steps(main, feed_list=pool[:2],
                                   fetch_list=[cost], scope=scope)
        rs_params = _resnet_params(fluid, main, scope)
        exe.close()
        del main, cost, scope, exe
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    losses = {f: eager[f][0] for f in eager}
    if not all(math.isfinite(x) for f in losses for x in losses[f]):
        fail("resnet: non-finite eager losses %s" % losses)
    layout_loss_rel = abs(losses[True][0] - losses[False][0]) / abs(
        losses[False][0])
    if not layout_loss_rel <= 1e-5:
        fail("resnet step-0 loss: fused %r, per-parameter %r (rel %g > "
             "1e-5)" % (losses[True][0], losses[False][0], layout_loss_rel))
    layout_param_rel = _worst_rel(eager[True][1], eager[False][1])
    if not layout_param_rel <= 1e-6:
        fail("resnet: after two eager steps the two layouts' parameters "
             "part by %g of their max (> 1e-6)" % layout_param_rel)
    rs_loss_rel = max(abs(float(a) - b) / abs(b)
                      for a, b in zip(rs_losses, losses[True]))
    rs_param_rel = _worst_rel(rs_params, eager[True][1])
    if not (rs_loss_rel <= 1e-5 and rs_param_rel <= 1e-6):
        fail("resnet: run_steps parts from the eager steps: losses %s "
             "against %s (rel %g), parameters by %g of their max"
             % (rs_losses.tolist(), losses[True], rs_loss_rel,
                rs_param_rel))
    n_equal = sum(bool(np.array_equal(eager[True][1][n], w))
                  for n, w in eager[False][1].items())
    del eager, rs_params

    # 2. bench_resnet.py's protocol in each layout (cuDNN's defaults):
    # a warm chunk, then RESNET_STEPS timed steps in chunks; the counts
    # set to 0 just before and read just after
    rows, launches, timed_run = {}, None, None
    for fuse in (False, True):
        main, cost, scope, exe = fresh(fuse)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in _cuda.LAUNCHERS:
            reset_counts(fn)
        out, = exe.run_steps(main, feed=dev_pool, steps=RESNET_CHUNK,
                             fetch_list=[cost], scope=scope,
                             return_numpy=False)
        out.cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = []
        for _ in range(RESNET_STEPS // RESNET_CHUNK):
            out, = exe.run_steps(main, feed=dev_pool, steps=RESNET_CHUNK,
                                 fetch_list=[cost], scope=scope,
                                 return_numpy=False)
            timed.append(out)
        timed = torch.cat(timed).cpu().numpy()
        dt = time.perf_counter() - t0
        counted = {fn.__name__: getattr(fn, c) for fn in _cuda.LAUNCHERS
                   for c in fn.counts if getattr(fn, c)}
        steps = RESNET_CHUNK + RESNET_STEPS
        want = {"fused_flat_update": groups * steps} if fuse else {}
        if counted != want:
            fail("resnet (fuse=%s): %d steps launched %s, expected %s"
                 % (fuse, steps, counted, want))
        if fuse:
            launches = counted["fused_flat_update"]
        if not np.isfinite(timed).all():
            fail("resnet (fuse=%s): non-finite losses %s"
                 % (fuse, timed.tolist()))
        peak = torch.cuda.max_memory_allocated()
        step_ms = dt / RESNET_STEPS * 1e3
        if fuse:
            timed_run = timed_program(
                "resnet50", main, {n: v[0] for n, v in dev_pool.items()},
                cost, step_ms, peak, "bf16")
        # one replayed step (its graph captured by the call before),
        # the batch already on the card
        batch = {n: v[0] for n, v in dev_pool.items()}
        exe.run_steps(main, feed=batch, steps=1, fetch_list=[cost],
                      scope=scope)
        wall_ms, by_family, kernels, top = profile_step(
            lambda: exe.run_steps(main, feed=batch, steps=1,
                                  fetch_list=[cost], scope=scope),
            family=_resnet_family)
        busy = sum(by_family.values())
        rows["fused" if fuse else "per_param"] = {
            "images_per_s": RESNET_B * RESNET_STEPS / dt,
            "step_ms": step_ms, "timed_losses": timed.tolist(),
            "capture_s": exe.capture_seconds,
            "max_memory_allocated": peak,
            "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_idle_share_unprofiled": 1.0 - busy / step_ms,
            "kernel_launches_per_step": kernels,
            "device_ms_by_family": dict(sorted(by_family.items(),
                                               key=lambda kv: -kv[1])),
            "top_kernels": top}
        exe.close()
        del main, cost, scope, exe
        torch.cuda.empty_cache()
    emit({"phase": "resnet", "card": card, "batch": RESNET_B,
          "image": [3, RESNET_HW, RESNET_HW], "classes": RESNET_CLASSES,
          "flags": RESNET_FLAGS, "groups": groups, "group_elements": n_flat,
          "group_params": n_params, "chunk": RESNET_CHUNK,
          "timed_steps": RESNET_STEPS,
          "deterministic_checks": "cudnn.deterministic on for the eager "
                                  "steps and run_steps compared; off for "
                                  "the timed runs",
          "eager_losses": {"per_param": losses[False],
                           "fused": losses[True]},
          "run_steps_losses": rs_losses.tolist(),
          "step0_layout_loss_rel_err": layout_loss_rel,
          "step1_layout_param_max_rel_err": layout_param_rel,
          "step1_params_bit_equal": "%d of %d" % (n_equal, n_params),
          "run_steps_loss_max_rel_err": rs_loss_rel,
          "run_steps_param_max_rel_err": rs_param_rel,
          "s2d_stem": s2d_stem_check(card),
          "momentum_launches": launches, **rows})
    return launches, timed_run


# ---------------------------------------------------------------- phase 14


# the dropout kernel's cases: the recipe's two mask shapes (d_model and
# FFN activations, B=32, T=256) in both types at p = 0.1 and 0.5, and a
# ragged length; each also with -0.0, +-inf and NaN at its head
DROPOUT_SHAPES = ((TRAIN_B, TRAIN_T, 512), (TRAIN_B, TRAIN_T, 2048),
                  (RAGGED_N,), (64, 128, 768), (64, 128, 3072))
# BERT-base's masks (B=64, T=128: hidden 768, FFN 3072) run as BERT
# draws them only: bf16 at p = 0.1
BERT_DROPOUT_SHAPES = ((64, 128, 768), (64, 128, 3072))
DROPOUT_SEED, DROPOUT_COUNTER = 12345, 7
KEEP_TOL = 0.002  # |kept fraction - (1 - p)|


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def phase_dropout(card):
    """The dropout kernel against ``plain_dropout`` on the card, forward
    and backward, bit for bit; the kept fraction; times and the bound.
    Returns the rows."""
    from paddle_tpu_torch.ops import dropout as dr

    dev = torch.device("cuda", 0)
    int_rate = dr.int_ops_per_s(0)
    counter = torch.tensor(DROPOUT_COUNTER, dtype=torch.int32, device=dev)
    rows = []
    for shape in DROPOUT_SHAPES:
        for dtype in BOTH:
            for p in (0.1, 0.5):
                if shape == (RAGGED_N,) and p != 0.1:
                    continue
                if shape in BERT_DROPOUT_SHAPES and (
                        dtype, p) != (torch.bfloat16, 0.1):
                    continue
                gen = torch.Generator(device=dev).manual_seed(
                    len(rows) + 1)
                x = torch.randn(shape, generator=gen, device=dev).to(dtype)
                flat = x.view(-1)
                flat[:4] = torch.tensor([-0.0, float("inf"), -float("inf"),
                                         float("nan")], dtype=dtype)
                g = torch.randn(shape, generator=gen, device=dev).to(dtype)
                # forward: the kernel (with the counter's advance) and
                # the plain version
                nxt = torch.empty((), dtype=torch.int32, device=dev)
                got = dr.dropout_apply(x, DROPOUT_SEED, counter, p,
                                       counter_out=nxt)
                want = dr.plain_dropout(x, DROPOUT_SEED, counter, p)
                # backward through the op: the kernel on g, same mask
                xt = x.clone().requires_grad_(True)
                out, _ = dr.dropout(xt, DROPOUT_SEED, counter, p)
                out.backward(g)
                want_g = dr.plain_dropout(g, DROPOUT_SEED, counter, p)
                kept = float((dr.dropout_apply(
                    torch.ones_like(x), DROPOUT_SEED, counter, p) != 0)
                    .float().mean())
                torch.cuda.synchronize()
                fwd_equal = bool(torch.equal(_bits(got), _bits(want)))
                op_equal = bool(torch.equal(_bits(out.detach()),
                                            _bits(want)))
                bwd_equal = bool(torch.equal(_bits(xt.grad), _bits(want_g)))
                label = "%s %s p=%g" % ("x".join(map(str, shape)),
                                        str(dtype)[6:], p)
                if not (fwd_equal and op_equal and bwd_equal):
                    fail("dropout %s: kernel and plain version differ "
                         "(forward %s, op %s, backward %s)"
                         % (label, fwd_equal, op_equal, bwd_equal))
                if int(nxt) != DROPOUT_COUNTER + 1:
                    fail("dropout %s: counter_out %d, expected %d"
                         % (label, int(nxt), DROPOUT_COUNTER + 1))
                if not abs(kept - (1 - p)) <= KEEP_TOL:
                    fail("dropout %s: kept %.5f of the elements, expected "
                         "%.3f +- %g" % (label, kept, 1 - p, KEEP_TOL))
                n = x.numel()
                bytes_ = 2 * n * x.element_size()
                ops = n * dr.INT_OPS_PER_ELEMENT
                bound = {"bytes": bytes_ / HBM_BYTES_PER_S * 1e3,
                         "operations": ops / int_rate * 1e3}
                bound_by = max(bound, key=bound.get)
                kernel = lambda: dr.dropout_apply(  # noqa: E731
                    x, DROPOUT_SEED, counter, p)
                rows.append({
                    "case": label, "shape": list(shape),
                    "dtype": str(dtype)[6:], "p": p, "n": n,
                    "bit_equal": True, "max_abs_err": 0.0,
                    "kept_fraction": kept,
                    "ms": cuda_ms(kernel, 50),
                    "device_ms": device_ms(kernel, 50),
                    "plain_ms": cuda_ms(lambda: dr.plain_dropout(
                        x, DROPOUT_SEED, counter, p), 3, warmup=1),
                    "f_dropout_ms": cuda_ms(lambda: F.dropout(
                        x, p, training=True), 50),
                    "bound_ms": bound[bound_by], "bound_by": bound_by,
                    "bytes_bound_ms": bound["bytes"],
                    "ops_bound_ms": bound["operations"]})
                del x, g, got, want, xt, out, want_g
    torch.cuda.empty_cache()
    emit({"phase": "dropout", "card": card, "seed": DROPOUT_SEED,
          "counter": DROPOUT_COUNTER,
          "int_ops_per_s": int_rate,
          "int_rate": "SMs x 128 lanes (4 schedulers, one warp "
                      "instruction a clock each) x SM clock "
                      "(cudaDevAttrMultiProcessorCount, "
                      "cudaDevAttrClockRate)",
          "int_ops_per_element": dr.INT_OPS_PER_ELEMENT,
          "f_dropout": "F.dropout at the same shape: a time yardstick "
                       "only (another stream, scaled by 1/(1-p))",
          "rows": rows})
    return rows


# ---------------------------------------------------------------- phase 15


RECIPE_DROPOUT = 0.1  # transformer_base's own default


def _fresh(main, startup, place):
    """An executor and a scope holding ``main``'s seeded weights."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.params_from_numpy(seeded_weights(main), scope, place,
                            program=main)
    return exe, scope


def _timed_chunks(exe, main, feed, cost, scope, chunks):
    """A warm ``run_steps`` chunk, then ``chunks`` timed ones: seconds
    of the timed ones and their losses."""
    exe.run_steps(main, feed=feed, steps=CHUNK, fetch_list=[cost],
                  scope=scope, return_numpy=False)[0].cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [exe.run_steps(main, feed=feed, steps=CHUNK, fetch_list=[cost],
                          scope=scope, return_numpy=False)[0]
            for _ in range(chunks)]
    losses = torch.cat(outs).cpu().numpy()
    return time.perf_counter() - t0, losses


def phase_dropout_recipe(card, base):
    """The recipe at transformer_base's dropout_rate 0.1 under
    ``memory_optimize`` and ``run_steps``: captured steps bit-equal to
    eager steps from the same state, 62 dropout sites launching the
    kernel forward and backward a step; step ms and tokens/s beside the
    dropout-0 figures of the run_steps phase (``base``). Returns the
    launches of the captured run."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import dropout as dr

    place = fluid.CUDAPlace(0)
    feed = train_batch()
    main, startup, cost = build_recipe(True, dropout_rate=RECIPE_DROPOUT)
    fluid.memory_optimize(main)
    sites = sum(op.type == "dropout" for op in main.global_block().ops)
    n_layer = TRAIN_MODEL["n_layer"]
    if sites != 4 * n_layer + 6 * n_layer + 2:
        fail("dropout_recipe: %d dropout sites, expected %d"
             % (sites, 10 * n_layer + 2))
    dense = [p.name for p in main.all_parameters()
             if p.name in main._flat_state_views]
    counter = "_dropout_rng_counter"

    # 1. TRAIN_STEPS eager steps, and the same steps as one run_steps
    # call (an eager step, the capture, replays) from the same state
    exe, scope = _fresh(main, startup, place)
    eager = [float(exe.run(main, feed=feed, fetch_list=[cost],
                           scope=scope)[0]) for _ in range(TRAIN_STEPS)]
    eager_params = {n: fluid.fetch_var(n, scope) for n in dense}
    eager_counter = int(fluid.fetch_var(counter, scope))
    del exe, scope
    torch.cuda.empty_cache()
    exe, scope = _fresh(main, startup, place)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    graph, = exe.run_steps(main, feed=feed, steps=TRAIN_STEPS,
                           fetch_list=[cost], scope=scope)
    launches = dr.dropout_apply.launches
    backward = dr.dropout_apply.backward_launches
    if (launches, backward) != (2 * sites * TRAIN_STEPS,
                                sites * TRAIN_STEPS):
        fail("dropout_recipe: %d steps launched the dropout kernel %d "
             "times (%d backward), expected %d (%d)"
             % (TRAIN_STEPS, launches, backward, 2 * sites * TRAIN_STEPS,
                sites * TRAIN_STEPS))
    n_equal = sum(bool(np.array_equal(fluid.fetch_var(n, scope), v))
                  for n, v in eager_params.items())
    graph_counter = int(fluid.fetch_var(counter, scope))
    losses_equal = bool(np.array_equal(graph, np.asarray(eager,
                                                         np.float32)))
    if not (losses_equal and n_equal == len(dense)
            and graph_counter == eager_counter == sites * TRAIN_STEPS):
        fail("dropout_recipe: run_steps is not bit-equal to the eager "
             "steps: losses %s against %s, %d of %d parameters equal, "
             "counters %d and %d" % (graph.tolist(), eager, n_equal,
                                     len(dense), graph_counter,
                                     eager_counter))
    if not np.isfinite(graph).all():
        fail("dropout_recipe: non-finite losses %s" % graph.tolist())

    # 2. bench.py's protocol with the feed on the card
    dev_feed = {n: torch.as_tensor(v).to(place.torch_device())
                for n, v in feed.items()}
    dt, timed = _timed_chunks(exe, main, dev_feed, cost, scope,
                              BENCH_STEPS // CHUNK)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(timed).all():
        fail("dropout_recipe: non-finite timed losses %s" % timed.tolist())
    step_ms = dt / BENCH_STEPS * 1e3
    # 3. one replayed step profiled
    exe.run_steps(main, feed=dev_feed, steps=1, fetch_list=[cost],
                  scope=scope)
    fam = {}
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run_steps(main, feed=dev_feed, steps=1,
                              fetch_list=[cost], scope=scope),
        family_launches=fam)
    if fam.get("dropout", 0) != 2 * sites:
        fail("dropout_recipe: one replayed step ran %d dropout kernels, "
             "expected %d" % (fam.get("dropout", 0), 2 * sites))
    busy = sum(by_family.values())
    tokens = TRAIN_B * TRAIN_T
    emit({"phase": "dropout_recipe", "card": card,
          "dropout_rate": RECIPE_DROPOUT, "sites": sites,
          "draws_per_step": int(sum(
              np.prod(s) for s in [(TRAIN_B, TRAIN_T, TRAIN_MODEL[
                  "d_model"])] * (sites - 2 * n_layer)
              + [(TRAIN_B, TRAIN_T, TRAIN_MODEL["d_inner_hid"])]
              * (2 * n_layer))),
          "eager_losses": eager, "run_steps_losses": graph.tolist(),
          "bit_equal": {"losses": losses_equal,
                        "params": "%d of %d" % (n_equal, len(dense)),
                        "counter": graph_counter},
          "launches": launches, "backward_launches": backward,
          "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
          "dropout0_step_ms": base["step_ms"],
          "dropout0_tokens_per_s": base["tokens_per_s"],
          "max_memory_allocated": peak,
          "dropout0_max_memory_allocated": base["max_memory_allocated"],
          "timed_losses": timed.tolist(),
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall_ms,
          "device_idle_share_chunked": 1.0 - busy / step_ms,
          "replayed_step_dropout_kernels": fam.get("dropout", 0),
          "kernel_launches_per_step": kernels,
          "device_ms_by_family": dict(sorted(by_family.items(),
                                             key=lambda kv: -kv[1])),
          "top_kernels": top})
    exe.close()
    return launches, step_ms


# ---------------------------------------------------------------- phase 16


# fused against unfused on the card: the loss and the head weight's
# gradient part by the bf16 rounding of the unfused head's logits (the
# fused op keeps them f32), so the loss is held to rel 1e-3 and the
# gradient to 3e-2 of its max (TOL[bf16])
FUSED_CE_LOSS_TOL, FUSED_CE_GRAD_TOL = 1e-3, TOL[torch.bfloat16]


def phase_fused_ce(card):
    """The recipe with ``fused_ce=True`` against the same recipe unfused:
    step 0's loss and the head weight's gradient, the predict head
    skipped, peak memory and step ms of each under ``run_steps``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import live_ops

    place = fluid.CUDAPlace(0)
    feed = train_batch()
    dev_feed = {n: torch.as_tensor(v).to(place.torch_device())
                for n, v in feed.items()}
    rows = {}
    for fused in (False, True):
        main, startup, cost = build_recipe(True, fused_ce=fused)
        gb = main.global_block()
        head = next(op for op in reversed(gb.ops) if op.type == "mul")
        head_w = head.input("Y")[0]
        head_calls = []
        if fused:
            at = next(i for i, op in enumerate(gb.ops)
                      if op.type == "fused_linear_softmax_ce")
            head = gb.ops[at + 1]
            if head.type != "mul" or head in live_ops(main, [cost.name]):
                fail("fused_ce: the predict head's mul is live with only "
                     "the loss fetched")
            fn = head.fn
            head.fn = lambda *a, _fn=fn: head_calls.append(1) or _fn(*a)
        exe, scope = _fresh(main, startup, place)
        step0 = exe.run(main, feed=feed, fetch_list=[cost, head_w + "@GRAD"],
                        scope=scope)
        if head_calls:
            fail("fused_ce: the predict head's mul ran %d times with only "
                 "the loss fetched" % len(head_calls))
        del exe, scope
        torch.cuda.empty_cache()
        fluid.memory_optimize(main)
        exe, scope = _fresh(main, startup, place)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dt, timed = _timed_chunks(exe, main, dev_feed, cost, scope,
                                  BENCH_STEPS // CHUNK)
        peak = torch.cuda.max_memory_allocated()
        if head_calls:
            fail("fused_ce: the predict head's mul ran under run_steps")
        if not np.isfinite(timed).all():
            fail("fused_ce (fused=%s): non-finite losses %s"
                 % (fused, timed.tolist()))
        step_ms = dt / BENCH_STEPS * 1e3
        rows["fused" if fused else "unfused"] = {
            "step0_loss": float(step0[0]), "head_grad": step0[1],
            "step_ms": step_ms,
            "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
            "max_memory_allocated": peak, "timed_losses": timed.tolist(),
            "head_mul_calls": len(head_calls)}
        exe.close()
        del exe, scope, main
        torch.cuda.empty_cache()
    f, u = rows["fused"], rows["unfused"]
    loss_rel = abs(f["step0_loss"] - u["step0_loss"]) / abs(u["step0_loss"])
    gf, gu = f.pop("head_grad"), u.pop("head_grad")
    grad_rel = float(np.abs(gf - gu).max() / np.abs(gu).max())
    if not (loss_rel <= FUSED_CE_LOSS_TOL and grad_rel <= FUSED_CE_GRAD_TOL):
        fail("fused_ce: step 0 parts from the unfused build: loss rel %g "
             "(> %g?), head gradient %g of its max (> %g?)"
             % (loss_rel, FUSED_CE_LOSS_TOL, grad_rel, FUSED_CE_GRAD_TOL))
    emit({"phase": "fused_ce", "card": card,
          "step0_loss_rel_err": loss_rel,
          "head_grad_max_rel_err": grad_rel,
          "tolerances": {"loss_rel": FUSED_CE_LOSS_TOL,
                         "head_grad_of_max": FUSED_CE_GRAD_TOL},
          "predict_head_skipped": True, **rows})


# ---------------------------------------------------------------- phase 17


VGG_PARAMS = 2 * (13 + 14 + 3)
VGG_SITES = 2


def build_vgg():
    """(main, startup, avg_cost) of bench_resnet.py's program with
    VGG-16 in place of ResNet-50, after ``memory_optimize``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.vgg import vgg16

    saved = {n: fluid.get_flag(n) for n in RESNET_FLAGS}
    fluid.set_flags(RESNET_FLAGS)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(
                name="img", shape=[-1, 3, RESNET_HW, RESNET_HW],
                dtype="float32", append_batch_size=False)
            lbl = fluid.layers.data(name="lbl", shape=[-1, 1],
                                    dtype="int64", append_batch_size=False)
            predict = vgg16(img, class_dim=RESNET_CLASSES)
            cost = fluid.layers.cross_entropy(input=predict, label=lbl)
            avg_cost = fluid.layers.mean(cost)
            fluid.optimizer.Momentum(learning_rate=0.1,
                                     momentum=0.9).minimize(avg_cost)
    finally:
        fluid.set_flags(saved)
    fluid.memory_optimize(main)
    return main, startup, avg_cost


def phase_vgg(card):
    """VGG-16 with bench_resnet.py's recipe: ``run_steps`` bit-equal to
    eager steps under ``cudnn.deterministic``, the dropout kernel 2 + 2
    launches a step; images/s, step ms, peak memory, one replayed step
    profiled. Returns the timed run's dropout launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import dropout as dr

    place = fluid.CUDAPlace(0)
    pool = resnet_pool()
    dev_pool = {n: torch.stack([torch.as_tensor(b[n]) for b in pool]).to(
        place.torch_device()) for n in pool[0]}
    main, startup, cost = build_vgg()
    params = [p.name for p in main.all_parameters()]
    sites = sum(op.type == "dropout" for op in main.global_block().ops)
    if (len(params), sites) != (VGG_PARAMS, VGG_SITES):
        fail("vgg: %d parameters and %d dropout sites, expected %d and %d"
             % (len(params), sites, VGG_PARAMS, VGG_SITES))
    weights = resnet_weights(main)

    def fresh():
        scope, exe = fluid.Scope(), fluid.Executor(place)
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(weights, scope, place, program=main)
        return exe, scope

    # 1. two eager steps against run_steps of the same two batches,
    # deterministic cuDNN algorithms
    torch.backends.cudnn.deterministic = True
    try:
        exe, scope = fresh()
        eager = [float(exe.run(main, feed=pool[i], fetch_list=[cost],
                               scope=scope)[0]) for i in range(2)]
        eager_params = _resnet_params(fluid, main, scope)
        del exe, scope
        exe, scope = fresh()
        rs, = exe.run_steps(main, feed_list=pool[:2], fetch_list=[cost],
                            scope=scope)
        rs_params = _resnet_params(fluid, main, scope)
        exe.close()
        del exe, scope
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    n_equal = sum(bool(np.array_equal(rs_params[n], v))
                  for n, v in eager_params.items())
    losses_equal = bool(np.array_equal(rs, np.asarray(eager, np.float32)))
    if not (losses_equal and n_equal == len(params)):
        fail("vgg: run_steps is not bit-equal to the eager steps: losses "
             "%s against %s, %d of %d parameters equal"
             % (rs.tolist(), eager, n_equal, len(params)))
    if not all(math.isfinite(x) for x in eager):
        fail("vgg: non-finite eager losses %s" % eager)
    del eager_params, rs_params

    # 2. bench_resnet.py's protocol (cuDNN's defaults), the counts set to
    # 0 just before and read just after
    exe, scope = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    out, = exe.run_steps(main, feed=dev_pool, steps=RESNET_CHUNK,
                         fetch_list=[cost], scope=scope, return_numpy=False)
    out.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [exe.run_steps(main, feed=dev_pool, steps=RESNET_CHUNK,
                           fetch_list=[cost], scope=scope,
                           return_numpy=False)[0]
             for _ in range(RESNET_STEPS // RESNET_CHUNK)]
    timed = torch.cat(timed).cpu().numpy()
    dt = time.perf_counter() - t0
    steps = RESNET_CHUNK + RESNET_STEPS
    launches = dr.dropout_apply.launches
    backward = dr.dropout_apply.backward_launches
    counted = {fn.__name__: getattr(fn, c) for fn in _cuda.LAUNCHERS
               for c in fn.counts if getattr(fn, c)}
    if (launches, backward) != (2 * sites * steps, sites * steps) or \
            set(counted) != {"dropout_apply"}:
        fail("vgg: %d steps launched %s (dropout %d, %d backward), "
             "expected the dropout kernel alone, %d (%d)"
             % (steps, counted, launches, backward, 2 * sites * steps,
                sites * steps))
    if not np.isfinite(timed).all():
        fail("vgg: non-finite losses %s" % timed.tolist())
    peak = torch.cuda.max_memory_allocated()
    step_ms = dt / RESNET_STEPS * 1e3
    batch = {n: v[0] for n, v in dev_pool.items()}
    exe.run_steps(main, feed=batch, steps=1, fetch_list=[cost], scope=scope)
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run_steps(main, feed=batch, steps=1, fetch_list=[cost],
                              scope=scope),
        family=_resnet_family)
    busy = sum(by_family.values())
    emit({"phase": "vgg", "card": card, "model": "vgg16 (batch norm)",
          "batch": RESNET_B, "image": [3, RESNET_HW, RESNET_HW],
          "classes": RESNET_CLASSES, "flags": RESNET_FLAGS,
          "params": len(params), "dropout_sites": sites,
          "chunk": RESNET_CHUNK, "timed_steps": RESNET_STEPS,
          "deterministic_checks": "cudnn.deterministic on for the eager "
                                  "steps and run_steps compared; off for "
                                  "the timed run",
          "eager_losses": eager, "run_steps_losses": rs.tolist(),
          "params_bit_equal": "%d of %d" % (n_equal, len(params)),
          "dropout_launches": launches,
          "dropout_backward_launches": backward,
          "images_per_s": RESNET_B * RESNET_STEPS / dt, "step_ms": step_ms,
          "capture_s": exe.capture_seconds, "timed_losses": timed.tolist(),
          "max_memory_allocated": peak,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall_ms,
          "device_idle_share_unprofiled": 1.0 - busy / step_ms,
          "kernel_launches_per_step": kernels,
          "device_ms_by_family": dict(sorted(by_family.items(),
                                             key=lambda kv: -kv[1])),
          "top_kernels": top})
    exe.close()
    return launches, timed_program("vgg16", main, batch, cost, step_ms,
                                   peak, "bf16")


# ---------------------------------------------------------------- phase 18


PERSIST_BATCHES, PERSIST_INTERVAL = 20, 10
PERSIST_FEEDS = ["src_word", "src_mask", "trg_word", "trg_mask", "lbl_word"]
PERSIST_ROOT = "build/chip_smoke_persist"  # under the checkout, ignored
FIT_BATCHES, FIT_B = 20, 32


def persist_reader(n=PERSIST_BATCHES):
    """The recipe's reader: ``n`` seeded batches of B=32 rows (one tuple
    of the five feeds a sentence), ragged masks as ``train_batch``'s."""
    batches = [train_batch(SEED + 100 + i) for i in range(n)]

    def reader():
        for b in batches:
            yield list(zip(*(b[name] for name in PERSIST_FEEDS)))
    return reader


def persist_trainer(ckpt_dir, async_save=False, keep=1):
    """A Trainer of the dropout recipe (phase 15's program: the recipe
    flags, sparse embeddings, one flat Adam group with bf16 moments,
    ``dropout_rate=0.1``, ``attn_impl="pallas"``) on the card, under
    ``memory_optimize``, checkpointing every PERSIST_INTERVAL steps into
    ``ckpt_dir`` (no epoch-end save: ``epoch_interval=2`` over one
    epoch)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import transformer_base

    def train_func():
        _, avg_cost, _ = transformer_base(
            **dict(TRAIN_MODEL, dropout_rate=RECIPE_DROPOUT),
            sparse_embedding=True, attn_impl="pallas")
        return avg_cost

    saved = {n: fluid.get_flag(n) for n in RECIPE_FLAGS}
    fluid.set_flags(RECIPE_FLAGS)
    try:
        trainer = fluid.Trainer(
            train_func, lambda: fluid.optimizer.Adam(learning_rate=TRAIN_LR),
            place=fluid.CUDAPlace(0),
            checkpoint_config=fluid.CheckpointConfig(
                ckpt_dir, step_interval=PERSIST_INTERVAL, epoch_interval=2,
                max_num_checkpoints=keep, async_save=async_save))
    finally:
        fluid.set_flags(saved)
    fluid.memory_optimize(trainer.train_program)
    return trainer


def persist_train(trainer, n=PERSIST_BATCHES):
    """``Trainer.train`` over the first ``n`` batches, ``steps_per_loop``
    = PERSIST_INTERVAL: ({step: loss}, {step: (begin s, end s)}, the
    caller-thread seconds of each checkpoint save)."""
    import paddle_tpu_torch as fluid

    losses, marks, saves = {}, {}, []
    inner = trainer._save_checkpoint

    def timed_save(*a):
        t0 = time.perf_counter()
        inner(*a)
        saves.append(time.perf_counter() - t0)

    def handler(e):
        if isinstance(e, fluid.BeginStepEvent):
            marks[e.step] = (time.perf_counter(), None)
        elif isinstance(e, fluid.EndStepEvent):
            marks[e.step] = (marks[e.step][0], time.perf_counter())
            losses[e.step] = float(np.asarray(e.metrics[0]))

    trainer._save_checkpoint = timed_save
    try:
        trainer.train(1, event_handler=handler, reader=persist_reader(n),
                      feed_order=PERSIST_FEEDS,
                      steps_per_loop=PERSIST_INTERVAL)
    finally:
        del trainer._save_checkpoint
    return losses, marks, saves


def scope_tensors(scope):
    """Every tensor of a scope, cloned."""
    return {n: scope.find_var(n).clone() for n in scope.local_var_names()
            if isinstance(scope.find_var(n), torch.Tensor)}


def state_diff(got, want):
    """Names whose tensors are not bit-equal (or missing)."""
    return sorted(n for n in set(got) | set(want)
                  if n not in got or n not in want
                  or got[n].dtype != want[n].dtype
                  or not torch.equal(got[n], want[n]))


def serial_bytes(root, serial):
    d = os.path.join(root, "checkpoint_%d" % serial)
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def phase_persist(card, model, greedy, base, dropout_step_ms):
    """Checkpoint, resume and serve a trained model through the port's
    entry points: (a) the dropout recipe through ``Trainer`` — C trains
    20 steps uninterrupted (async saves), A trains 10 (a sync save), B
    resumes A's checkpoint and B2 C's step-10 async checkpoint, each
    training steps 10-19, bit-equal to C; a restore into C after its
    graph was captured replays bit-equal; (b) the serving phase's causal
    LM through ``save_decode_model`` / ``load_decode_model`` into a new
    scope and ``serve_decoding``: the greedy streams again; (c)
    fit_a_line through ``Trainer``, ``save_inference_model`` /
    ``load_inference_model`` and ``Inferencer``. Returns B's launches by
    kernel and the decode burst's paged launches."""
    import shutil

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import ckpt
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_window_attention
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        PERSIST_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: os.path.join(root, k) for k in ("a", "c", "fit", "decode")}
    n_layer = TRAIN_MODEL["n_layer"]
    sites = 10 * n_layer + 2
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fused_flat_update, dr.dropout_apply)
    resumed = range(PERSIST_INTERVAL, PERSIST_BATCHES)

    # (a) C: 20 steps uninterrupted, async saves at steps 10 and 20
    c = persist_trainer(dirs["c"], async_save=True, keep=2)
    c_losses, c_marks, c_saves = persist_train(c)
    c_state = scope_tensors(c.scope)
    if sorted(ckpt.list_checkpoints(dirs["c"])) != [0, 1]:
        fail("persist: C left serials %s, expected [0, 1]"
             % ckpt.list_checkpoints(dirs["c"]))
    ckpt_bytes = serial_bytes(dirs["c"], 0)
    # the Trainer's own step: the second group (replays only) between
    # its BeginStepEvent and its EndStepEvent, feed conversion included
    step_ms = (c_marks[PERSIST_INTERVAL][1]
               - c_marks[PERSIST_INTERVAL][0]) * 1e3 / PERSIST_INTERVAL
    # a restore into C, whose graph is captured: the next replay reads it
    graphs = c.exe.num_compiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore(dirs["c"], program=c.train_program, scope=c.scope,
                 serial=0)
    torch.cuda.synchronize()
    restore_into_graph_s = time.perf_counter() - t0
    feeder = c._make_feeder(PERSIST_FEEDS)
    replay, = c.exe.run_steps(
        c.train_program,
        feed_list=[feeder.feed(b) for b in list(persist_reader()())[
            PERSIST_INTERVAL:]], fetch_list=[c.loss], scope=c.scope)
    if c.exe.num_compiled != graphs:
        fail("persist: the restore made C capture again (%d graphs, %d "
             "before)" % (c.exe.num_compiled, graphs))
    replay_diff = state_diff(scope_tensors(c.scope), c_state)
    if replay.tolist() != [c_losses[s] for s in resumed] or replay_diff:
        fail("persist: after a restore into C's captured graph the replay "
             "is not bit-equal: losses %s against %s, tensors differing %s"
             % (replay.tolist(), [c_losses[s] for s in resumed],
                replay_diff[:8]))
    c.stop()
    del c, feeder
    # B2 resumes C's async-written step-10 serial alone
    shutil.rmtree(os.path.join(dirs["c"], "checkpoint_1"))
    torch.cuda.empty_cache()

    # A: 10 steps, a sync save at step 10
    a = persist_trainer(dirs["a"])
    a_losses, _, a_saves = persist_train(a, PERSIST_INTERVAL)
    if [a_losses[s] for s in range(PERSIST_INTERVAL)] != \
            [c_losses[s] for s in range(PERSIST_INTERVAL)]:
        fail("persist: A's steps 0-9 differ from C's")
    a.stop()
    del a
    torch.cuda.empty_cache()

    rows = {}
    for label, ckpt_dir, async_save in (("sync", dirs["a"], False),
                                        ("async", dirs["c"], True)):
        restore_s = []
        inner = ckpt.restore

        def timed_restore(*args, **kw):
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
            return out

        ckpt.restore = timed_restore
        try:
            b = persist_trainer(ckpt_dir, async_save=async_save)
        finally:
            ckpt.restore = inner
        if b.checkpoint_cfg.step_id != PERSIST_INTERVAL:
            fail("persist %s: B resumed at step %d"
                 % (label, b.checkpoint_cfg.step_id))
        for fn in launchers:
            reset_counts(fn)
        b_losses, _, b_saves = persist_train(b)
        launches = {fn.__name__: fn.launches for fn in launchers}
        launches["dropout_backward"] = dr.dropout_apply.backward_launches
        want = {"flash_fwd": ATTN_PER_STEP * len(resumed),
                "flash_bwd_dq": ATTN_PER_STEP * len(resumed),
                "flash_bwd_dkv": ATTN_PER_STEP * len(resumed),
                "fused_flat_update": len(resumed),
                "dropout_apply": 2 * sites * len(resumed),
                "dropout_backward": sites * len(resumed)}
        if launches != want:
            fail("persist %s: B launched %s, expected %s"
                 % (label, launches, want))
        b_state = scope_tensors(b.scope)
        diff = state_diff(b_state, c_state)
        losses_equal = [b_losses.get(s) for s in resumed] == \
            [c_losses[s] for s in resumed]
        if not losses_equal or diff or sorted(b_losses) != list(resumed):
            fail("persist %s: B is not bit-equal to C: losses %s against "
                 "%s, tensors differing %s"
                 % (label, [b_losses.get(s) for s in resumed],
                    [c_losses[s] for s in resumed], diff[:8]))
        rows[label] = {"restore_ms": restore_s[0] * 1e3,
                       "step_20_save_ms": b_saves[0] * 1e3,
                       "losses": [b_losses[s] for s in resumed],
                       "tensors_bit_equal": len(b_state),
                       "counter": int(b_state["_dropout_rng_counter"]),
                       "launches": launches}
        b.stop()
        del b, b_state
        torch.cuda.empty_cache()
    del c_state
    torch.cuda.empty_cache()

    # (b) the serving phase's model through the decode artifact
    from paddle_tpu_torch.decoding import CacheConfig

    main, logits, scope = model
    exe = fluid.Executor(fluid.CUDAPlace(0))
    cache = CacheConfig(**SERVING_CACHE)
    t0 = time.perf_counter()
    section = fluid.io.save_decode_model(dirs["decode"], "tokens", logits,
                                         exe, main_program=main,
                                         cache_config=cache, scope=scope)
    decode_save_s = time.perf_counter() - t0
    fresh = fluid.Scope()
    t0 = time.perf_counter()
    pair, loaded = fluid.io.load_decode_model(dirs["decode"], exe,
                                              scope=fresh, program=main)
    torch.cuda.synchronize()
    decode_load_s = time.perf_counter() - t0
    if loaded != section or not pair.decode._decode_stamp.endswith(
            "+pallas"):
        fail("persist: the reloaded decode section %s differs from the "
             "saved %s" % (loaded, section))
    run = serve_burst((main, logits, fresh), pair.config, serving_prompts(),
                      counters=(paged_window_attention,))
    counts = route_counts(paged_window_attention)
    check_graphs(run, "persist decode")
    if run["streams"] != greedy:
        bad = [i for i, (x, y) in enumerate(zip(run["streams"], greedy))
               if x != y]
        fail("persist: the reloaded decode model's streams differ from the "
             "serving phase's (requests %s)" % bad)
    steps = run["report"]["decode_step"]["count"]
    if counts["generic_launches"] or counts["split_launches"] < \
            MODEL["n_layer"] * steps:
        fail("persist: the reloaded model's decode launches %s over %d "
             "steps are not on the split route" % (counts, steps))
    del fresh, pair, run
    torch.cuda.empty_cache()

    # (c) fit_a_line through Trainer, both inference artifacts
    from paddle_tpu_torch.models import fit_a_line

    def fit_func():
        _, _, avg_cost, y_predict = fit_a_line.build_train()
        return [avg_cost, y_predict]

    rng = np.random.RandomState(SEED + 7)
    true_w = rng.randn(13, 1).astype(np.float32)
    fit_data = []
    for _ in range(FIT_BATCHES):
        xb = rng.randn(FIT_B, 13).astype(np.float32)
        fit_data.append(list(zip(xb, xb @ true_w + 0.5)))
    fit = fluid.Trainer(fit_func,
                        lambda: fluid.optimizer.SGD(learning_rate=0.05),
                        place=fluid.CUDAPlace(0))
    fit_losses = persist_train_fit(fit, fit_data)
    if not (np.isfinite(fit_losses).all()
            and fit_losses[-1] < 0.05 * fit_losses[0]):
        fail("persist: fit_a_line did not converge: %s" % fit_losses)
    pred = fit.train_func_outputs[1].name
    x = rng.randn(16, 13).astype(np.float32)
    want, = fit.exe.run(fit.test_program.prune([pred]), feed={"x": x},
                        fetch_list=[pred], scope=fit.scope)
    fit.save_inference_model(dirs["fit"], ["x"], [1])
    inf_scope = fluid.Scope()
    prog, feeds, fetches = fluid.io.load_inference_model(
        dirs["fit"], exe, scope=inf_scope, program=fit.test_program)
    if (feeds, fetches) != (["x"], [pred]):
        fail("persist: fit_a_line's artifact names feeds %s and fetches %s"
             % (feeds, fetches))
    got, = exe.run(prog, feed={"x": x}, fetch_list=fetches, scope=inf_scope)
    fit.save_params(os.path.join(root, "fit_params"))

    def infer_func():
        xv = fluid.layers.data(name="x", shape=[13], dtype="float32")
        return fluid.layers.fc(input=xv, size=1, act=None)

    inferred, = fluid.Inferencer(infer_func, os.path.join(root, "fit_params"),
                                 place=fluid.CUDAPlace(0)).infer({"x": x})
    if not (np.array_equal(got, want) and np.array_equal(inferred, want)):
        fail("persist: fit_a_line's inference artifacts do not serve what "
             "Executor.run gives on the trained scope (max err %g, %g)"
             % (np.abs(got - want).max(), np.abs(inferred - want).max()))
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "persist", "card": card,
          "recipe": {"batches": PERSIST_BATCHES,
                     "step_interval": PERSIST_INTERVAL,
                     "checkpoint_bytes": ckpt_bytes,
                     "save_ms_sync": a_saves[0] * 1e3,
                     "save_ms_async_caller": c_saves[0] * 1e3,
                     "restore_ms": rows["sync"]["restore_ms"],
                     "restore_ms_async_serial": rows["async"]["restore_ms"],
                     "restore_into_captured_graph_ms":
                         restore_into_graph_s * 1e3,
                     "trainer_step_ms": step_ms,
                     "trainer_tokens_per_s": TRAIN_B * TRAIN_T
                     / (step_ms / 1e3),
                     "run_steps_phase_step_ms": base["step_ms"],
                     "dropout_recipe_step_ms": dropout_step_ms,
                     "c_losses": [c_losses[s] for s in range(PERSIST_BATCHES)],
                     "resumed": rows,
                     "replay_after_restore_bit_equal": True},
          "decode_model": {"save_s": decode_save_s, "load_s": decode_load_s,
                           "stamps": [section["prefill"]["stamp"],
                                      section["decode"]["stamp"]],
                           "streams_equal_serving": True,
                           "route_launches": counts},
          "fit_a_line": {"losses": fit_losses.tolist(),
                         "inference_equal": True},
          "phase_s": time.perf_counter() - t_phase})
    return rows["sync"]["launches"], counts


def persist_train_fit(trainer, data):
    """fit_a_line's Trainer over ``data`` (batches of rows), groups of 10
    steps: the losses."""
    import paddle_tpu_torch as fluid

    losses = {}

    def handler(e):
        if isinstance(e, fluid.EndStepEvent):
            losses[e.step] = float(np.asarray(e.metrics[0]))

    trainer.train(1, event_handler=handler, reader=lambda: iter(data),
                  feed_order=["x", "y"], steps_per_loop=10)
    return np.asarray([losses[s] for s in sorted(losses)])


# ---------------------------------------------------------------- phase 19


# BERT-base at its published widths (Devlin et al. 2019): 12 layers,
# hidden 768, 12 heads, FFN 3072, vocab 30522, 512 positions
BERT_MODEL = dict(vocab_size=30522, n_layer=12, n_head=12, d_model=768,
                  d_inner=3072, max_pos=512)
# pretraining's two shapes: (B, T, max_predictions) of phase 1 (T=128)
# and phase 2 (T=512, 80 = about 0.15 x 512 predictions)
BERT_LEGS = {"phase1": (64, 128, 20), "phase2": (16, 512, 80)}
BERT_LR, BERT_DROPOUT = 1e-4, 0.1
def build_bert(max_predictions, attn_impl="pallas", dropout=BERT_DROPOUT,
               flags=RECIPE_FLAGS):
    """(main, startup, [total, mlm, ns]) of ``bert_pretrain`` at
    BERT_MODEL's widths + ``Adam(BERT_LR)``, built under ``flags``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import bert_pretrain

    saved = {n: fluid.get_flag(n) for n in flags}
    fluid.set_flags(flags)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, total, (mlm, ns) = bert_pretrain(
                **BERT_MODEL, max_predictions=max_predictions,
                dropout=dropout, attn_impl=attn_impl)
            fluid.optimizer.Adam(learning_rate=BERT_LR).minimize(total)
    finally:
        fluid.set_flags(saved)
    return main, startup, [total, mlm, ns]


def bert_batch(B, T, P, seed=SEED + 7, vocab=BERT_MODEL["vocab_size"]):
    """A pretraining batch: lengths from T/2 to T (the key mask), two
    segments, about 15 % of each sequence's positions (at most P) drawn
    without replacement from 1..len-1; padded prediction slots point at
    0 with weight 0."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T + 1, size=B)
    mask = (np.arange(T)[None, :] < lens[:, None])
    pos = np.zeros((B, P), np.int64)
    weight = np.zeros((B, P), np.float32)
    for b, n in enumerate(lens):
        k = min(P, max(1, int(round(0.15 * n))))
        pos[b, :k] = rng.choice(np.arange(1, n), size=k, replace=False)
        weight[b, :k] = 1.0
    return {"src_ids": (rng.randint(1, vocab, size=(B, T)) * mask
                        ).astype(np.int64),
            "sent_ids": ((np.arange(T)[None, :] >= (lens // 2)[:, None])
                         & mask).astype(np.int64),
            "pos_ids": np.tile(np.arange(T, dtype=np.int64), (B, 1)),
            "input_mask": mask.astype(np.float32), "mask_pos": pos,
            "mask_label": rng.randint(1, vocab, size=(B, P)).astype(
                np.int64),
            "mask_weight": weight,
            "ns_label": rng.randint(0, 2, size=(B, 1)).astype(np.int64)}


def bert_routes(card):
    """Step 0 of BERT-base at f32, dropout 0, phase-1 shape, under
    ``attn_impl="pallas"`` (the flash kernels) and ``"fused"`` (plain
    torch attention) from the same weights: the total loss within rel
    1e-5, the gradients of ``word_embedding`` and the first layer's Q
    weight within 1e-3 of their max (or twice the distance of the fused
    step on the card from the same step on the host)."""
    import paddle_tpu_torch as fluid

    B, T, P = BERT_LEGS["phase1"]
    feed = bert_batch(B, T, P)
    checked = ["word_embedding@GRAD", "fc.w_0@GRAD"]
    out = {}
    for attn in ("pallas", "fused"):
        main, startup, loss = build_bert(P, attn, dropout=0.0, flags={})
        exe, scope = _fresh(main, startup, fluid.CUDAPlace(0))
        out[attn] = exe.run(main, feed=feed, fetch_list=[loss[0]] + checked,
                            scope=scope)
        del exe, scope
        torch.cuda.empty_cache()
    loss_rel = abs(float(out["pallas"][0]) - float(out["fused"][0])) / abs(
        float(out["fused"][0]))
    if not loss_rel <= 1e-5:
        fail("bert: step 0's loss under pallas %r, fused %r (rel %g > "
             "1e-5)" % (float(out["pallas"][0]), float(out["fused"][0]),
                        loss_rel))
    grad_rel = {n: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                for n, a, b in zip(checked, out["pallas"][1:],
                                   out["fused"][1:])}
    floor = None
    if max(grad_rel.values()) > 1e-3:
        # the f32 noise floor: the fused step on the host
        main, startup, loss = build_bert(P, "fused", dropout=0.0, flags={})
        exe, scope = _fresh(main, startup, fluid.CPUPlace())
        host = exe.run(main, feed=feed, fetch_list=checked, scope=scope)
        floor = {n: float(np.abs(d - h).max() / max(np.abs(h).max(), 1e-30))
                 for n, d, h in zip(checked, out["fused"][1:], host)}
        bad = {n: r for n, r in grad_rel.items()
               if r > max(1e-3, 2 * floor[n])}
        if bad:
            fail("bert: pallas and fused gradients part by %s of their max "
                 "(bound: 1e-3 or twice the card-vs-host distance %s)"
                 % (bad, floor))
    return {"step0_loss_pallas": float(out["pallas"][0]),
            "step0_loss_fused": float(out["fused"][0]),
            "step0_loss_rel_err": loss_rel, "grad_rel_err": grad_rel,
            "grad_noise_floor": floor}


def phase_bert(card):
    """BERT-base pretraining on the card: the f32 route check, then the
    recipe at the phase-1 shape (eager steps and ``run_steps`` bit-equal,
    exact launches, falling loss, bench.py's protocol, one replayed step
    profiled) and ten ``run_steps`` at the phase-2 shape. Returns the
    phase-1 ``run_steps`` call's launches by launcher."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    t_phase = time.perf_counter()
    routes = bert_routes(card)
    place = fluid.CUDAPlace(0)
    n_layer = BERT_MODEL["n_layer"]
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fused_flat_update, dr.dropout_apply)
    row = {"phase": "bert", "card": card, "model": BERT_MODEL,
           "flags": RECIPE_FLAGS, "lr": BERT_LR, "dropout": BERT_DROPOUT,
           "attn_impl": "pallas", "routes": routes}
    result, timed_runs = None, []
    for leg, (B, T, P) in BERT_LEGS.items():
        feed = bert_batch(B, T, P)
        main, startup, loss = build_bert(P)
        cost = loss[0]
        fluid.memory_optimize(main)
        gb = main.global_block()
        sites = sum(op.type == "dropout" for op in gb.ops)
        groups = sum(op.type.endswith("_fused") for op in gb.ops)
        n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
        per_step = {"flash_fwd": n_layer, "flash_bwd_dq": n_layer,
                    "flash_bwd_dkv": n_layer, "fused_flat_update": groups,
                    "dropout_apply": 2 * sites}
        if sites != 1 + 4 * n_layer:
            fail("bert: %d dropout sites, expected %d"
                 % (sites, 1 + 4 * n_layer))
        info = {"batch": B, "seq": T, "max_predictions": P,
                "masked_positions": int(feed["mask_weight"].sum()),
                "sites": sites, "groups": groups, "params": n_params,
                "group_elements": int(gb.var(
                    "fused_param_storage_0").shape[0])}
        steps = TRAIN_STEPS
        eager = None
        if leg == "phase1":
            # eager steps, then the same steps as one run_steps call from
            # the same start state
            exe, scope = _fresh(main, startup, place)
            eager = [float(exe.run(main, feed=feed, fetch_list=[cost],
                                   scope=scope)[0]) for _ in range(steps)]
            want = scope_tensors(scope)
            del exe, scope
            torch.cuda.empty_cache()
        exe, scope = _fresh(main, startup, place)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in _cuda.LAUNCHERS:
            reset_counts(fn)
        graph, = exe.run_steps(main, feed=feed, steps=steps,
                               fetch_list=[cost], scope=scope)
        launches = {fn.__name__: fn.launches for fn in launchers}
        expect = {k: v * steps for k, v in per_step.items()}
        if launches != expect:
            fail("bert %s: %d steps launched %s, expected %s"
                 % (leg, steps, launches, expect))
        if leg == "phase1":
            result = launches
            differ = state_diff(scope_tensors(scope), want)
            losses_equal = bool(np.array_equal(graph, np.asarray(
                eager, np.float32)))
            if differ or not losses_equal:
                fail("bert: run_steps is not bit-equal to the eager steps: "
                     "losses %s against %s, tensors differing %s"
                     % (graph.tolist(), eager, differ))
            del want
            info.update(eager_losses=eager, bit_equal={
                "losses": losses_equal,
                "scope_tensors": len(scope_tensors(scope))})
        dev_feed = {n: torch.as_tensor(v).to(place.torch_device())
                    for n, v in feed.items()}
        chunks = BENCH_STEPS // CHUNK if leg == "phase1" else 1
        dt, timed = _timed_chunks(exe, main, dev_feed, cost, scope, chunks)
        peak = torch.cuda.max_memory_allocated()
        losses = np.concatenate([graph, timed])
        if not np.isfinite(losses).all():
            fail("bert %s: non-finite losses %s" % (leg, losses.tolist()))
        if not losses[-1] < losses[0]:
            fail("bert %s: the loss did not fall: %s"
                 % (leg, losses.tolist()))
        step_ms = dt / (chunks * CHUNK) * 1e3
        info.update(run_steps_losses=graph.tolist(),
                    timed_losses=timed.tolist(), launches=launches,
                    launches_per_step=per_step, step_ms=step_ms,
                    tokens_per_s=B * T / (step_ms / 1e3),
                    sequences_per_s=B / (step_ms / 1e3),
                    max_memory_allocated=peak)
        timed_runs.append(timed_program("bert_" + leg, main, feed, cost,
                                        step_ms, peak, "bf16"))
        if leg == "phase1":
            exe.run_steps(main, feed=dev_feed, steps=1, fetch_list=[cost],
                          scope=scope)
            fam = {}
            wall_ms, by_family, kernels, top = profile_step(
                lambda: exe.run_steps(main, feed=dev_feed, steps=1,
                                      fetch_list=[cost], scope=scope),
                family_launches=fam)
            busy = sum(by_family.values())
            info.update(profiled_step_wall_ms=wall_ms, device_busy_ms=busy,
                        device_idle_share=1.0 - busy / wall_ms,
                        device_idle_share_unprofiled=1.0 - busy / step_ms,
                        kernel_launches_per_step=kernels,
                        family_launches=fam,
                        device_ms_by_family=dict(sorted(
                            by_family.items(), key=lambda kv: -kv[1])),
                        top_kernels=top)
        row[leg] = info
        exe.close()
        del exe, scope, dev_feed, startup
        torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return result, timed_runs


# ---------------------------------------------------------------- phase 20


# DeepFM at the JAX package's defaults (deepfm.py:21-23): 100000
# features, 39 fields, embed 16, MLP 400-400-400, the tables
# is_distributed (a plain lookup on one card)
DEEPFM_MODEL = dict(num_features=100000, num_fields=39, embed_dim=16,
                    mlp_dims=(400, 400, 400))
DEEPFM_B, DEEPFM_LR = 4096, 1e-3
AUC_TOL = 1e-6


def build_deepfm():
    """(main, startup, avg_cost, prob, auc) of ``deepfm()`` + ``auc`` +
    ``Adam(DEEPFM_LR)`` with ``fuse_optimizer_state`` (f32)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.deepfm import deepfm

    saved = fluid.get_flag("fuse_optimizer_state")
    fluid.set_flags({"fuse_optimizer_state": True})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            feeds, avg_cost, prob = deepfm(**DEEPFM_MODEL)
            auc = fluid.layers.auc(prob, feeds[2])
            fluid.optimizer.Adam(learning_rate=DEEPFM_LR).minimize(avg_cost)
    finally:
        fluid.set_flags({"fuse_optimizer_state": saved})
    return main, startup, avg_cost, prob, auc


def deepfm_batch(B=DEEPFM_B, seed=SEED + 8):
    """Feature ids uniform over the table, values in [0, 1), 0/1
    labels."""
    rng = np.random.RandomState(seed)
    F_ = DEEPFM_MODEL["num_fields"]
    return {"feat_ids": rng.randint(0, DEEPFM_MODEL["num_features"],
                                    size=(B, F_)).astype(np.int64),
            "feat_vals": rng.rand(B, F_).astype(np.float32),
            "label": rng.randint(0, 2, size=(B, 1)).astype(np.float32)}


def numpy_auc(prob, label, num_thresholds=200):
    """``layers.auc``'s binning in numpy: thresholds ``i / (n - 1)`` in
    f32, true and false positive rates, the trapezoid."""
    p = prob.reshape(-1)
    y = label.reshape(-1).astype(np.float64)
    th = np.arange(num_thresholds, dtype=np.float32) / np.float32(
        num_thresholds - 1)
    predpos = p[None, :] >= th[:, None]
    tpr = (predpos * y).sum(1) / (y.sum() + 1e-8)
    fpr = (predpos * (1 - y)).sum(1) / ((1 - y).sum() + 1e-8)
    return -float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2))


def phase_deepfm(card):
    """DeepFM at its defaults on the card: eager steps and ``run_steps``
    bit-equal, one fused ``adam`` update a step, a falling loss, ``auc``
    against numpy, bench.py's protocol, one replayed step profiled.
    Returns the ``run_steps`` call's fused-update launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    feed = deepfm_batch()
    main, startup, cost, prob, auc = build_deepfm()
    fluid.memory_optimize(main)
    gb = main.global_block()
    groups = sum(op.type.endswith("_fused") for op in gb.ops)
    steps = TRAIN_STEPS

    exe, scope = _fresh(main, startup, place)
    eager, aucs = [], []
    for _ in range(steps):
        c, p, a = exe.run(main, feed=feed, fetch_list=[cost, prob, auc],
                          scope=scope)
        eager.append(float(c))
        aucs.append((float(a), numpy_auc(p, feed["label"])))
    want = scope_tensors(scope)
    auc_err = max(abs(a - b) for a, b in aucs)
    if not auc_err <= AUC_TOL:
        fail("deepfm: auc parts from numpy's binning by %g (> %g): %s"
             % (auc_err, AUC_TOL, aucs))
    exe, scope = _fresh(main, startup, place)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    graph, = exe.run_steps(main, feed=feed, steps=steps, fetch_list=[cost],
                           scope=scope)
    launches = fused_flat_update.launches
    if launches != groups * steps:
        fail("deepfm: %d steps launched the fused update %d times, "
             "expected %d" % (steps, launches, groups * steps))
    differ = state_diff(scope_tensors(scope), want)
    losses_equal = bool(np.array_equal(graph, np.asarray(eager, np.float32)))
    if differ or not losses_equal:
        fail("deepfm: run_steps is not bit-equal to the eager steps: losses "
             "%s against %s, tensors differing %s"
             % (graph.tolist(), eager, differ))
    dev_feed = {n: torch.as_tensor(v).to(place.torch_device())
                for n, v in feed.items()}
    dt, timed = _timed_chunks(exe, main, dev_feed, cost, scope,
                              BENCH_STEPS // CHUNK)
    peak = torch.cuda.max_memory_allocated()
    losses = np.concatenate([graph, timed])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail("deepfm: the losses are not finite and falling: %s"
             % losses.tolist())
    step_ms = dt / BENCH_STEPS * 1e3
    exe.run_steps(main, feed=dev_feed, steps=1, fetch_list=[cost],
                  scope=scope)
    fam = {}
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run_steps(main, feed=dev_feed, steps=1,
                              fetch_list=[cost], scope=scope),
        family_launches=fam)
    busy = sum(by_family.values())
    emit({"phase": "deepfm", "card": card, "model": DEEPFM_MODEL,
          "batch": DEEPFM_B, "lr": DEEPFM_LR, "groups": groups,
          "group_elements": int(gb.var("fused_param_storage_0").shape[0]),
          "eager_losses": eager, "run_steps_losses": graph.tolist(),
          "bit_equal": {"losses": losses_equal,
                        "scope_tensors": len(want)},
          "auc": aucs[-1][0], "numpy_auc": aucs[-1][1],
          "auc_max_abs_err": auc_err, "launches": launches,
          "timed_losses": timed.tolist(), "step_ms": step_ms,
          "examples_per_s": DEEPFM_B / (step_ms / 1e3),
          "max_memory_allocated": peak,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall_ms,
          "device_idle_share_unprofiled": 1.0 - busy / step_ms,
          "kernel_launches_per_step": kernels, "family_launches": fam,
          "device_ms_by_family": dict(sorted(by_family.items(),
                                             key=lambda kv: -kv[1])),
          "top_kernels": top, "phase_s": time.perf_counter() - t_phase})
    exe.close()
    return launches, timed_program("deepfm", main, feed, cost, step_ms,
                                   peak, "f32")


# ---------------------------------------------------------------- phase 26

# the sequence models at the JAX package's default widths, f32, Adam on
# the flat fused group: the models' arguments, then (batch, steps)
SEQ2SEQ_MODEL = dict(src_dict_size=30000, trg_dict_size=30000, word_dim=256,
                     hidden_dim=512)
SENTIMENT_MODEL = dict(dict_dim=5147, model="stacked_lstm")
SRL_MODEL = {}  # db_lstm's defaults: word dict 44068, max_len 128, depth 4
SEQ_LR = 1e-3
SEQ_BATCHES = {"seq2seq": (64, 10), "sentiment": (64, 10), "srl": (32, 5)}


def build_sequence(name):
    """(main, startup, avg_cost, feed names, extra) of one sequence model
    with ``Adam(SEQ_LR)`` under ``fuse_optimizer_state``; for ``srl``
    ``extra`` is (emission var, transition var, length var)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import (label_semantic_roles,
                                         machine_translation, sentiment)

    saved = fluid.get_flag("fuse_optimizer_state")
    fluid.set_flags({"fuse_optimizer_state": True})
    extra = None
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            if name == "seq2seq":
                feeds, cost, _ = machine_translation.build_train(
                    **SEQ2SEQ_MODEL)
            elif name == "sentiment":
                data, label, cost, _, _ = sentiment.build_train(
                    **SENTIMENT_MODEL)
                feeds = [data, label]
            else:
                feeds, cost, crf = label_semantic_roles.db_lstm(**SRL_MODEL)
                ops = main.global_block().ops
                em = [op for op in ops if op.type == "linear_chain_crf"][0]
                extra = (main.global_block().var(em.input("Emission")[0]),
                         crf._crf_transition,
                         fluid.layers.length_var_of(feeds[0]))
            fluid.optimizer.Adam(learning_rate=SEQ_LR).minimize(cost)
    finally:
        fluid.set_flags({"fuse_optimizer_state": saved})
    return main, startup, cost, [v.name for v in feeds], extra


def build_srl_decode():
    """(program, emission var, path var): db_lstm's forward at
    ``SRL_MODEL`` and ``crf_decoding`` of its emissions with the CRF's
    transition, parameters named as build_sequence("srl") names them."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import label_semantic_roles

    main = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main,
                                                        fluid.Program()):
        feeds, _, crf = label_semantic_roles.db_lstm(**SRL_MODEL)
        em = [op for op in main.global_block().ops
              if op.type == "linear_chain_crf"][0].input("Emission")[0]
        emission = main.global_block().var(em)
        path = fluid.layers.crf_decoding(
            emission, transition=crf._crf_transition,
            length=fluid.layers.length_var_of(feeds[0]))
    return main, emission, path


def sequence_batches(name, main, feed_names, seed):
    """``SEQ_BATCHES[name]`` batches of synthetic rows from ``seed``,
    padded by the port's DataFeeder; each batch's first row has the
    longest length, so every batch pads to one width (one graph).
    seq2seq: source and target lengths 3..19, the target +1 for its
    start/end token (dataset/wmt14.py); sentiment: 8..100 tokens, the
    label whether their mean id is above half the vocabulary
    (dataset/imdb.py's rule); srl: 5..29 tokens (dataset/conll05.py) in
    the 128-wide slots, the eight features and the tags uniform.
    sentiment and srl train on one batch every step: the loss of a
    batch of 64 coin-flip-like labels, or a CRF loss summed over tokens
    of other lengths, moves more from batch to batch than ten steps
    lower it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import label_semantic_roles as srl

    B, n = SEQ_BATCHES[name]
    rng = np.random.RandomState(seed)
    if name == "srl":
        ids = lambda hi: rng.randint(0, hi, (B, 128)).astype(  # noqa
            np.int64)
        feed = {n_: ids(srl.WORD_DICT_LEN) for n_ in feed_names[:6]}
        feed.update(verb_data=ids(srl.PRED_DICT_LEN),
                    mark_data=ids(srl.MARK_DICT_LEN),
                    target=ids(srl.LABEL_DICT_LEN))
        feed["word_data@LEN"] = rng.randint(5, 30, B).astype(np.int32)
        return [feed] * n
    feeder = fluid.DataFeeder(feed_names, program=main)
    if name == "sentiment":
        rows = []
        for r in range(B):
            words = rng.randint(0, 5147, 100 if r == 0
                                else int(rng.randint(8, 101)))
            rows.append((words.tolist(), [int(words.mean() > 5147 / 2)]))
        return [feeder.feed(rows)] * n
    batches = []
    for _ in range(n):
        rows = []
        for r in range(B):
            sl = 19 if r == 0 else int(rng.randint(3, 20))
            tl = 19 if r == 0 else int(rng.randint(3, 20))
            trg = rng.randint(3, 30000, tl).tolist()
            rows.append((rng.randint(3, 30000, sl).tolist(), [0] + trg,
                         trg + [1]))
        batches.append(feeder.feed(rows))
    shapes = {tuple((k, v.shape) for k, v in sorted(b.items()))
              for b in batches}
    if len(shapes) != 1:
        fail("%s: the batches pad to different shapes %s" % (name, shapes))
    return batches


def numpy_viterbi(em, trans, lens):
    """Best tag paths of f32 emissions [B, T, N] under ``trans`` [N+2, N]
    in numpy f32 (the adds and maxima of crf_decoding, ties to the lower
    tag); 0 past each length."""
    B, T, N = em.shape
    start, stop, tr = trans[0], trans[1], trans[2:]
    out = np.zeros((B, T), np.int64)
    for b in range(B):
        L = int(lens[b])
        delta = start + em[b, 0]
        bps = []
        for t in range(1, L):
            scores = delta[:, None] + tr
            bps.append(np.argmax(scores, axis=0))
            delta = scores.max(axis=0) + em[b, t]
        tag = int(np.argmax(delta + stop))
        path = [tag]
        for bp in reversed(bps):
            tag = int(bp[tag])
            path.append(tag)
        out[b, :L] = path[::-1]
    return out


def _seq_family(name: str) -> str:
    fam = _train_family(name)
    low = name.lower()
    if fam == "other":
        for key in ("gather", "scatter", "index", "cat", "sort", "softmax",
                    "logsumexp"):
            if key in low:
                return key
    return fam


def phase_sequence_model(card, name):
    """One sequence model at the JAX package's widths on the card: 10
    eager steps (5 for srl) over seeded batches, the same steps as one
    ``run_steps`` call (a captured CUDA graph of the step replayed),
    bit-equal in losses and every scope tensor; the fused Adam update
    launched once a step; falling losses; step ms eager and replayed,
    tokens/s, peak memory, and one eager and one replayed step profiled
    (device busy, idle share, kernel launches). srl also decodes the
    trained emissions with ``crf_decoding`` and holds the paths to a
    numpy Viterbi. Returns (the run_steps call's fused-update launches,
    the group's element count)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    main, startup, cost, feed_names, extra = build_sequence(name)
    fluid.memory_optimize(main)
    gb = main.global_block()
    groups = sum(op.type.endswith("_fused") for op in gb.ops)
    n_group = int(gb.var("fused_param_storage_0").shape[0])
    batches = sequence_batches(name, main, feed_names, SEED + 20)
    steps = len(batches)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())

    exe, scope = _fresh(main, startup, place)
    eager = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for feed in batches:
        eager.append(float(exe.run(main, feed=feed, fetch_list=[cost],
                                   scope=scope)[0]))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / steps * 1e3
    want = scope_tensors(scope)
    fam_eager = {}
    eager_wall, eager_by_family, eager_kernels, _ = profile_step(
        lambda: exe.run(main, feed=batches[0], fetch_list=[cost],
                        scope=scope), family_launches=fam_eager,
        family=_seq_family)
    exe.close()
    del scope
    torch.cuda.empty_cache()

    exe, scope = _fresh(main, startup, place)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    t0 = time.perf_counter()
    graph, = exe.run_steps(main, feed_list=batches, fetch_list=[cost],
                           scope=scope)
    first_call_s = time.perf_counter() - t0
    launches = fused_flat_update.launches
    if launches != groups * steps:
        fail("%s: %d steps launched the fused update %d times, expected %d"
             % (name, steps, launches, groups * steps))
    differ = state_diff(scope_tensors(scope), want)
    losses_equal = bool(np.array_equal(graph, np.asarray(eager, np.float32)))
    if differ or not losses_equal:
        fail("%s: run_steps is not bit-equal to the eager steps: losses %s "
             "against %s, tensors differing %s"
             % (name, graph.tolist(), eager, differ))
    if not (np.isfinite(graph).all() and graph[-1] < graph[0]):
        fail("%s: the losses are not finite and falling: %s"
             % (name, graph.tolist()))
    # replayed steps timed: the same graph again, then a fresh call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe.run_steps(main, feed_list=batches, fetch_list=[cost], scope=scope,
                  return_numpy=False)[0].cpu()
    replay_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated()
    dev_feed = {n: torch.as_tensor(v).to(place.torch_device())
                for n, v in batches[0].items()}
    exe.run_steps(main, feed=dev_feed, steps=1, fetch_list=[cost],
                  scope=scope)
    fam = {}
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run_steps(main, feed=dev_feed, steps=1,
                              fetch_list=[cost], scope=scope),
        family_launches=fam, family=_seq_family)
    busy = sum(by_family.values())
    eager_busy = sum(eager_by_family.values())
    if name == "seq2seq":
        tokens = [float(b["target_language_word@LEN"].sum())
                  for b in batches]
    elif name == "sentiment":
        tokens = [float(b["words@LEN"].sum()) for b in batches]
    else:
        tokens = [float(b["word_data@LEN"].sum()) for b in batches]
    row = {"phase": name, "card": card, "batch": SEQ_BATCHES[name][0],
           "padded_shapes": {n: list(v.shape) for n, v in
                             batches[0].items()},
           "params": n_params, "groups": groups, "group_elements": n_group,
           "lr": SEQ_LR, "eager_losses": eager,
           "run_steps_losses": graph.tolist(),
           "bit_equal": {"losses": losses_equal,
                         "scope_tensors": len(want)},
           "launches": launches, "eager_step_ms": eager_ms,
           "replay_step_ms": replay_ms,
           "first_run_steps_call_s": first_call_s,
           "capture_s": exe.capture_seconds,
           "tokens_per_s_replayed": sum(tokens) / (replay_ms * steps / 1e3),
           "tokens_per_s_eager": sum(tokens) / (eager_ms * steps / 1e3),
           "max_memory_allocated": peak,
           "eager_profiled_wall_ms": eager_wall,
           "eager_device_busy_ms": eager_busy,
           "eager_device_idle_share": 1.0 - eager_busy / eager_wall,
           "eager_kernel_launches_per_step": eager_kernels,
           "eager_family_launches": fam_eager,
           "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms,
           "device_idle_share_unprofiled": 1.0 - busy / replay_ms,
           "kernel_launches_per_step": kernels, "family_launches": fam,
           "device_ms_by_family": dict(sorted(by_family.items(),
                                              key=lambda kv: -kv[1])),
           "top_kernels": top}
    if name == "srl":
        # the trained emissions decoded by an inference program of the
        # same model function (its parameters, by name, are the trained
        # scope's views of the flat group)
        infer, emission, path = build_srl_decode()
        em, got = exe.run(infer, feed=batches[0],
                          fetch_list=[emission, path], scope=scope)
        trans = fluid.fetch_var(extra[1].name, scope)
        want_path = numpy_viterbi(em, trans, batches[0]["word_data@LEN"])
        differ = int((np.asarray(got) != want_path).sum())
        if differ:
            fail("srl: crf_decoding on the card parts from the numpy "
                 "Viterbi at %d positions" % differ)
        row["crf_decoding"] = {"positions": int(
            batches[0]["word_data@LEN"].sum()), "differing": differ}
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    exe.close()
    return launches, n_group


def phase_sequence(card):
    """Phase 26: the seq2seq NMT, the stacked-LSTM sentiment model and the
    SRL db-lstm, each trained on the card. Returns {model: (fused
    launches, group elements)}."""
    out = {}
    for name in ("seq2seq", "sentiment", "srl"):
        out[name] = phase_sequence_model(card, name)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 27

# MobileNet-SSD on PASCAL VOC at 300x300 (PaddlePaddle/models,
# fluid/object_detection/mobilenet_ssd.py and train.py): 21 classes,
# RMSProp under a piecewise decay with L2 decay 5e-5, NMS at 0.45
SSD_CLASSES, SSD_HW, SSD_B, SSD_G = 21, 300, 64, 16
SSD_MIN_SIZES = [60.0, 105.0, 150.0, 195.0, 240.0, 285.0]
SSD_MAX_SIZES = [[], 150.0, 195.0, 240.0, 285.0, 300.0]
SSD_ARS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
           [2.0, 3.0]]
SSD_PRIORS = 19 * 19 * 3 + (10 * 10 + 5 * 5 + 3 * 3 + 2 * 2 + 1) * 6  # 1917
SSD_LR = ([40000, 60000], [1e-3, 5e-4, 2.5e-4])
SSD_L2 = 5e-5
SSD_POOL, SSD_EAGER, SSD_REPLAY, SSD_TEST_BATCHES = 4, 2, 10, 2
SSD_FLAGS = {"fuse_optimizer_state": True}


def mobilenet_ssd(fluid, img, num_classes, scale=1.0, hw=SSD_HW,
                  bn_is_test=False):
    """mobilenet_ssd.py's ``mobile_net`` in either package (``fluid``):
    a 3x3/s2 conv-bn of 32, thirteen depthwise-separable blocks (module11
    the 19x19x512 map at 300x300, module13 the 10x10x1024 one), four
    extra blocks (1x1, then 3x3/s2) of 512, 256, 256 and 128, and
    ``multi_box_head`` over the six maps. ``scale`` multiplies every
    width (an extra block's groups stay 1); the prior sizes scale with
    ``hw / 300``. Convs carry ``ParamAttr(learning_rate=0.1,
    initializer=MSRA())``, as the original's."""
    L = fluid.layers

    def conv_bn(x, k, n, stride, pad, groups=1):
        attr = fluid.ParamAttr(learning_rate=0.1,
                               initializer=fluid.initializer.MSRA())
        conv = L.conv2d(x, num_filters=n, filter_size=k, stride=stride,
                        padding=pad, groups=groups, param_attr=attr,
                        bias_attr=False)
        return L.batch_norm(conv, act="relu", is_test=bn_is_test)

    def separable(x, n1, n2, groups, stride):
        dw = conv_bn(x, 3, int(n1 * scale), stride, 1,
                     groups=int(groups * scale))
        return conv_bn(dw, 1, int(n2 * scale), 1, 0)

    def extra(x, n1, n2):
        pw = conv_bn(x, 1, int(n1 * scale), 1, 0)
        return conv_bn(pw, 3, int(n2 * scale), 2, 1)

    t = conv_bn(img, 3, int(32 * scale), 2, 1)
    for n1, n2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2)):
        t = separable(t, n1, n2, n1, stride)
    for _ in range(5):
        t = separable(t, 512, 512, 512, 1)
    module11 = t
    t = separable(t, 512, 1024, 512, 2)
    module13 = separable(t, 1024, 1024, 1024, 1)
    module14 = extra(module13, 256, 512)
    module15 = extra(module14, 128, 256)
    module16 = extra(module15, 128, 256)
    module17 = extra(module16, 64, 128)
    size = hw / 300.0
    return L.multi_box_head(
        inputs=[module11, module13, module14, module15, module16,
                module17],
        image=img, num_classes=num_classes, min_ratio=20, max_ratio=90,
        min_sizes=[s * size for s in SSD_MIN_SIZES],
        max_sizes=[[]] + [s * size for s in SSD_MAX_SIZES[1:]],
        aspect_ratios=SSD_ARS, base_size=hw, offset=0.5, flip=True)


def build_ssd(fluid, scale=1.0, hw=SSD_HW, classes=SSD_CLASSES, G=SSD_G,
              bn_is_test=False):
    """train.py's programs in either package: (main, startup, test
    program, eval program, loss, detections, (cur_map, accum_map)). The
    test program is main's ``clone(for_test=True)`` before the
    optimizer (``detection_output`` at nms_threshold 0.45 and the loss);
    the eval program is another clone with ``evaluator.DetectionMAP``
    (11-point, difficult boxes left out) appended. Ground truth: ``G``
    padded rows an image, with the ``gt_box@LEN`` count; ``bn_is_test``
    as in :func:`mobilenet_ssd`."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        img = L.data(name="image", shape=[-1, 3, hw, hw], dtype="float32",
                     append_batch_size=False)
        gt_box = L.data(name="gt_box", shape=[-1, G, 4], dtype="float32",
                        append_batch_size=False, lod_level=1)
        gt_label = L.data(name="gt_label", shape=[-1, G, 1], dtype="int32",
                          append_batch_size=False)
        difficult = L.data(name="gt_difficult", shape=[-1, G, 1],
                           dtype="int32", append_batch_size=False)
        locs, confs, box, box_var = mobilenet_ssd(fluid, img, classes,
                                                  scale, hw, bn_is_test)
        nmsed = L.detection_output(locs, confs, box, box_var,
                                   nms_threshold=0.45)
        loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box,
                                       box_var))
        test_program = main.clone(for_test=True)
        eval_program = main.clone(for_test=True)
        with fluid.program_guard(eval_program):
            map_eval = fluid.evaluator.DetectionMAP(
                nmsed, gt_label, gt_box, difficult, classes,
                overlap_threshold=0.5, evaluate_difficult=False,
                ap_version="11point")
        fluid.optimizer.RMSProp(
            learning_rate=L.piecewise_decay(*SSD_LR),
            regularization=fluid.regularizer.L2Decay(SSD_L2)).minimize(loss)
    return (main, startup, test_program, eval_program, loss, nmsed,
            map_eval.get_map_var())


def ssd_batches(n, B=SSD_B, hw=SSD_HW, classes=SSD_CLASSES, G=SSD_G,
                seed=SEED + 30):
    """``n`` synthetic batches from a numpy seed: uniform images; 1 +
    Poisson(1.5) boxes an image (VOC averages about 2.5), at most 8 (and
    ``G``),
    corners uniform with sides 0.05-0.5, labels 1-20, one box in ten
    difficult; padding rows label -1, box 0."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        cnt = np.minimum(1 + rng.poisson(1.5, B), min(8, G))
        lo = rng.rand(B, G, 2) * 0.7
        box = np.concatenate(
            [lo, np.minimum(lo + 0.05 + rng.rand(B, G, 2) * 0.45, 1.0)],
            -1).astype(np.float32)
        lab = rng.randint(1, classes, (B, G, 1)).astype(np.int32)
        diff = (rng.rand(B, G, 1) < 0.1).astype(np.int32)
        pad = np.arange(G)[None, :] >= cnt[:, None]
        box[pad], lab[pad], diff[pad] = 0.0, -1, 0
        out.append({"image": rng.rand(B, 3, hw, hw).astype(np.float32),
                    "gt_box": box, "gt_box@LEN": cnt.astype(np.int32),
                    "gt_label": lab, "gt_difficult": diff})
    return out


def numpy_map(dets, batches, overlap=0.5, evaluate_difficult=False,
              ap_version="11point"):
    """The mAP of fetched detection rows ``dets`` (one ``[B, D, 6]``
    array a batch) against the batches' ground truth, by
    ``metrics.DetectionMAP`` (the numpy evaluator) alone."""
    from paddle_tpu_torch.layers.detection import update_map_from_padded
    from paddle_tpu_torch.metrics import DetectionMAP

    m = DetectionMAP(overlap_threshold=overlap,
                     evaluate_difficult=evaluate_difficult,
                     ap_version=ap_version)
    for det, b in zip(dets, batches):
        lab = np.concatenate([b["gt_label"], b["gt_difficult"],
                              b["gt_box"]], -1).astype(np.float32)
        update_map_from_padded(m, det, lab)
    return m.eval()


def voc_map_11point(dets, batches, overlap=0.5):
    """The VOC 11-point mAP of fetched detection rows ``dets`` (one
    ``[B, D, 6]`` array a batch: label, score, x1, y1, x2, y2; label -1
    empty) against the batches' ground truth, written here from the
    definition and independent of the port's metrics. In each image the
    detections, in falling score order, each take the box of their
    class with the highest IoU: a true positive when it is at least
    ``overlap`` and the box is not yet taken, left out when the box is
    difficult, else a false positive. Difficult boxes count in no
    class's total. A class's AP is the mean over the recalls 0, 0.1,
    ..., 1 of the highest precision at that recall or beyond; the mAP is
    the mean over the classes that have a box."""
    scores, hits, n_gt = {}, {}, {}
    for det, b in zip(dets, batches):
        for i in range(det.shape[0]):
            cnt = int(b["gt_box@LEN"][i])
            gbox = b["gt_box"][i, :cnt].astype(np.float64)
            glab = b["gt_label"][i, :cnt, 0]
            gdiff = b["gt_difficult"][i, :cnt, 0] != 0
            for c in glab[~gdiff]:
                n_gt[int(c)] = n_gt.get(int(c), 0) + 1
            rows = det[i][det[i][:, 0] >= 0].astype(np.float64)
            rows = rows[np.argsort(-rows[:, 1], kind="stable")]
            taken = np.zeros(cnt, bool)
            for c, score, x1, y1, x2, y2 in rows:
                c = int(c)
                ix = np.maximum(0.0, np.minimum(x2, gbox[:, 2])
                                - np.maximum(x1, gbox[:, 0]))
                iy = np.maximum(0.0, np.minimum(y2, gbox[:, 3])
                                - np.maximum(y1, gbox[:, 1]))
                inter = ix * iy
                union = ((x2 - x1) * (y2 - y1) + (gbox[:, 2] - gbox[:, 0])
                         * (gbox[:, 3] - gbox[:, 1]) - inter)
                iou = np.where((glab == c) & (union > 0),
                               inter / np.where(union > 0, union, 1.0), 0.0)
                j = int(np.argmax(iou)) if cnt else -1
                hit = False
                if j >= 0 and iou[j] >= overlap:
                    if gdiff[j]:
                        continue
                    hit, taken[j] = not taken[j], True
                scores.setdefault(c, []).append(score)
                hits.setdefault(c, []).append(hit)
    aps = []
    for c, total in n_gt.items():
        if c not in scores:
            aps.append(0.0)
            continue
        order = np.argsort(-np.asarray(scores[c]), kind="stable")
        hit = np.asarray(hits[c])[order]
        tp, fp = np.cumsum(hit), np.cumsum(~hit)
        recall, precision = tp / total, tp / (tp + fp)
        aps.append(np.mean([precision[recall >= t].max(initial=0.0)
                            for t in np.linspace(0, 1, 11)]))
    return float(np.mean(aps)) if aps else 0.0


def ssd_conv_group():
    """The element count of the full-size MobileNet-SSD's conv group
    (the fused RMSProp group at lr scale 0.1)."""
    import paddle_tpu_torch as fluid

    saved = {n: fluid.get_flag(n) for n in SSD_FLAGS}
    fluid.set_flags(SSD_FLAGS)
    try:
        main = build_ssd(fluid)[0]
    finally:
        fluid.set_flags(saved)
    return ssd_groups(main)[0.1]


def ssd_groups(program):
    """{lr scale: elements} of the fused RMSProp groups of ``program``
    (the convs train at 0.1, the rest at 1.0)."""
    out = {}
    for p in program.all_parameters():
        scale = float(p.optimize_attr.get("learning_rate", 1.0))
        out[scale] = out.get(scale, 0) + int(np.prod(p.shape))
    return out


def ssd_weights(program, seed=SEED + 31):
    """Random weights from a numpy seed: conv filters N(0, 2 / fan_in),
    batch-norm scales 1, biases 0."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for p in program.all_parameters():
        shape = tuple(p.shape)
        if p.name.startswith("conv2d.w_"):
            a = rng.standard_normal(shape) * math.sqrt(
                2.0 / int(np.prod(shape[1:])))
        elif p.name.startswith("batch_norm.w_"):
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        arrays[p.name] = a.astype(np.float32)
    return arrays


def _ssd_family(name: str) -> str:
    fam = _resnet_family(name)
    if fam == "other":
        return _seq_family(name)
    return fam


def ssd_detection(exe, scope, test_prog, eval_prog, nmsed, maps):
    """The trained model's test clone on two test batches through
    ``run_graph`` (captured), bit-equal to ``Executor.run``; the eval
    clone's ``DetectionMAP`` (host ops, ``Executor.run``) equal to the
    numpy evaluator over the fetched rows (a check of the plumbing: the
    host ops run that evaluator) and within 1e-6 of
    :func:`voc_map_11point` (a check of the mAP), and refused by
    ``run_steps`` and ``run_graph``; ``detection_output`` alone on the fetched heads,
    captured and eager, profiled."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.enforce import GraphCaptureError

    batches = ssd_batches(SSD_TEST_BATCHES, seed=SEED + 32)
    det_op = next(op for op in test_prog.global_block().ops
                  if op.type == "detection_output")
    heads = det_op.input_arg_names          # loc, conf, prior, variances
    captured, eager, head_vals = [], [], []
    for b in batches:
        captured.append(exe.run_graph(test_prog, feed=b,
                                      fetch_list=[nmsed], scope=scope)[0])
        got = exe.run(test_prog, feed=b, fetch_list=[nmsed] + heads,
                      scope=scope)
        eager.append(got[0])
        head_vals.append(got[1:])
    differ = [int((a != e).sum()) for a, e in zip(captured, eager)]
    if any(differ):
        fail("ssd: the captured test program's detections part from "
             "Executor.run's at %s elements" % differ)
    kept = [int((d[..., 0] >= 0).sum()) for d in captured]
    if not all(k > 0 for k in kept):
        fail("ssd: detection_output kept no box in a batch: %s" % kept)
    mp = [[float(v) for v in exe.run(eval_prog, feed=b,
                                      fetch_list=list(maps), scope=scope)]
          for b in batches]
    # plumbing: the host ops run the port's numpy evaluator, so this
    # holds only the feeds and fetches of the eval clone
    want = [float(np.float32(numpy_map(captured[:1], batches[:1]))),
            float(np.float32(numpy_map(captured, batches)))]
    if [mp[0][0], mp[1][1]] != want:
        fail("ssd: DetectionMAP gives cur %r and accumulated %r, the numpy "
             "evaluator over the fetched rows %r" % (mp[0][0], mp[1][1],
                                                      want))
    # the mAP itself, against the definition (tolerance 1e-6: the f32
    # result of another summation order)
    voc = [voc_map_11point(captured[:1], batches[:1]),
           voc_map_11point(captured, batches)]
    if not all(abs(a - b) <= 1e-6 for a, b in zip(want, voc)):
        fail("ssd: DetectionMAP gives %r, the VOC 11-point definition %r"
             % (want, voc))
    refused = {}
    for how, call in (
            ("run_steps", lambda: exe.run_steps(
                eval_prog, feed=batches[0], steps=1,
                fetch_list=list(maps), scope=scope)),
            ("run_graph", lambda: exe.run_graph(
                eval_prog, feed=batches[0], fetch_list=list(maps),
                scope=scope))):
        try:
            call()
        except GraphCaptureError as e:
            refused[how] = str(e)[:120]
        else:
            fail("ssd: %s captured a program holding detection_map" % how)

    # detection_output alone on the fetched heads
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ins = [L.data(name=n, shape=[-1] + list(v.shape[1:]) if i < 2
                      else list(v.shape), dtype="float32",
                      append_batch_size=False)
               for i, (n, v) in enumerate(zip(("loc", "conf", "prior",
                                               "pvar"), head_vals[0]))]
        out = L.detection_output(*ins, nms_threshold=0.45)
    feed = {n: torch.as_tensor(v).cuda() for n, v in
            zip(("loc", "conf", "prior", "pvar"), head_vals[0])}
    det_exe = fluid.Executor(fluid.CUDAPlace(0))
    alone = det_exe.run_graph(main, feed=feed, fetch_list=[out])[0]
    if not np.array_equal(alone, captured[0]):
        fail("ssd: detection_output alone parts from the test program's")
    eager_wall, eager_fam, eager_launches, _ = profile_step(
        lambda: det_exe.run(main, feed=feed, fetch_list=[out],
                            return_numpy=False)[0].cpu(),
        family=_ssd_family)
    wall, fam, launches, top = profile_step(
        lambda: det_exe.run_graph(main, feed=feed, fetch_list=[out]),
        family=_ssd_family)
    det_row = {"batch": SSD_B, "priors": int(head_vals[0][2].shape[0]),
               "classes": SSD_CLASSES, "nms_top_k": 400, "keep_top_k": 200,
               "kept_rows": kept,
               "device_ms": sum(fam.values()),
               "device_ms_by_family": fam, "launches": launches,
               "replay_wall_ms": wall, "top_kernels": top,
               "eager_wall_ms": eager_wall,
               "eager_device_ms": sum(eager_fam.values()),
               "eager_launches": eager_launches}
    det_exe.close()
    return {"test_batches": SSD_TEST_BATCHES,
            "captured_equals_eager": True, "map": mp,
            "numpy_map": want, "voc_map": voc, "refused": refused,
            "detection_output": det_row}


def phase_ssd(card):
    """Phase 27: MobileNet-SSD (VOC, 300x300) trains and detects on the
    card. Returns (the fused RMSProp launches of the 10-step replay,
    {lr scale: group elements})."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    saved = {n: fluid.get_flag(n) for n in SSD_FLAGS}
    fluid.set_flags(SSD_FLAGS)
    try:
        (main, startup, test_prog, eval_prog, loss, nmsed,
         maps) = build_ssd(fluid)
    finally:
        fluid.set_flags(saved)
    gb = main.global_block()
    ssd_op = next(op for op in gb.ops if op.type == "ssd_loss")
    priors = gb.var(ssd_op.input_arg_names[4]).shape
    if tuple(priors) != (SSD_PRIORS, 4):
        fail("ssd: %s priors, expected (%d, 4)" % (priors, SSD_PRIORS))
    groups = sum(op.type == "rmsprop_fused" for op in gb.ops)
    sizes = ssd_groups(main)
    if groups != len(sizes):
        fail("ssd: %d fused RMSProp groups for lr scales %s"
             % (groups, sizes))
    weights = ssd_weights(main)

    def fresh():
        scope, exe = fluid.Scope(), fluid.Executor(place)
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(weights, scope, place, program=main)
        return exe, scope

    pool = ssd_batches(SSD_POOL)
    feeds = [pool[i % SSD_POOL] for i in range(SSD_REPLAY)]

    # 1. equality, with deterministic cuDNN algorithms: eager steps, and
    # the same steps replayed from the same start
    torch.backends.cudnn.deterministic = True
    try:
        exe, scope = fresh()
        reset_counts(fused_flat_update)
        eager = []
        for i in range(SSD_EAGER):
            # the last step timed (the first warms the allocator and cuDNN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager.append(float(exe.run(main, feed=feeds[i],
                                       fetch_list=[loss], scope=scope)[0]))
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3
        if fused_flat_update.launches != groups * SSD_EAGER:
            fail("ssd: %d eager steps launched the fused update %d times"
                 % (SSD_EAGER, fused_flat_update.launches))
        want = scope_tensors(scope)
        exe.close()
        exe, scope = fresh()
        rs, = exe.run_steps(main, feed_list=feeds[:SSD_EAGER],
                            fetch_list=[loss], scope=scope)
        differ = state_diff(scope_tensors(scope), want)
        if differ or not np.array_equal(rs, np.asarray(eager, np.float32)):
            fail("ssd: run_steps is not bit-equal to the eager steps: "
                 "losses %s against %s, tensors differing %s"
                 % (rs.tolist(), eager, differ[:10]))
        exe.close()
        del want
        exe, scope = fresh()
        for fn in _cuda.LAUNCHERS:
            reset_counts(fn)
        graph, = exe.run_steps(main, feed_list=feeds, fetch_list=[loss],
                               scope=scope)
        counted = {fn.__name__: getattr(fn, c) for fn in _cuda.LAUNCHERS
                   for c in fn.counts if getattr(fn, c)}
        if counted != {"fused_flat_update": groups * SSD_REPLAY}:
            fail("ssd: %d replayed steps launched %s, expected the fused "
                 "update %d times" % (SSD_REPLAY, counted,
                                      groups * SSD_REPLAY))
        launches = counted["fused_flat_update"]
        if not np.array_equal(graph[:SSD_EAGER],
                              np.asarray(eager, np.float32)):
            fail("ssd: the replay's first losses %s are not the eager "
                 "steps' %s" % (graph[:SSD_EAGER].tolist(), eager))
        first, last = graph[:SSD_POOL].mean(), graph[-SSD_POOL:].mean()
        if not (np.isfinite(graph).all() and last < first):
            fail("ssd: the losses are not finite and falling over the "
                 "pool: %s" % graph.tolist())
        # a capture cannot release the allocator's cached blocks to make
        # a new segment, and the detection graphs below need ~0.8 GB
        # ones: release them first (the training graphs stay)
        torch.cuda.empty_cache()
        detection = ssd_detection(exe, scope, test_prog, eval_prog, nmsed,
                                  maps)
        exe.close()
        del scope
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # 2. timing with cuDNN's defaults and the batches already on the card
    # (stacked on a leading steps axis): the 10 steps captured and
    # replayed, then replayed again, timed
    dev = place.torch_device()
    dev_feeds = {n: torch.stack([torch.as_tensor(f[n]) for f in feeds]).to(
        dev) for n in feeds[0]}
    exe, scope = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe.run_steps(main, feed=dev_feeds, steps=SSD_REPLAY, fetch_list=[loss],
                  scope=scope, return_numpy=False)[0].cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe.run_steps(main, feed=dev_feeds, steps=SSD_REPLAY, fetch_list=[loss],
                  scope=scope, return_numpy=False)[0].cpu()
    replay_ms = (time.perf_counter() - t0) / SSD_REPLAY * 1e3
    peak = torch.cuda.max_memory_allocated()
    del dev_feeds
    dev_feed = {n: torch.as_tensor(v).to(dev) for n, v in pool[0].items()}
    exe.run_steps(main, feed=dev_feed, steps=1, fetch_list=[loss],
                  scope=scope)
    fam_launches = {}
    wall_ms, by_family, kernels, top = profile_step(
        lambda: exe.run_steps(main, feed=dev_feed, steps=1,
                              fetch_list=[loss], scope=scope),
        family_launches=fam_launches, family=_ssd_family)
    busy = sum(by_family.values())
    row = {"phase": "ssd", "card": card, "batch": SSD_B,
           "image": [3, SSD_HW, SSD_HW], "classes": SSD_CLASSES,
           "priors": SSD_PRIORS, "gt_rows": SSD_G,
           "gt_boxes_per_image": [float(b["gt_box@LEN"].mean())
                                  for b in pool],
           "params": sum(sizes.values()), "groups": groups,
           "group_elements_by_lr_scale": {str(k): v
                                          for k, v in sizes.items()},
           "flags": SSD_FLAGS, "eager_losses": eager,
           "run_steps_losses": graph.tolist(), "bit_equal": True,
           "deterministic_checks": "cudnn.deterministic on for the eager "
                                   "steps, the replays compared and the "
                                   "detections; off for the timed replay",
           "eager_step_ms_is": "the second eager step's",
           "replay_feed": "stacked on the card",
           "rmsprop_launches": launches, "eager_step_ms": eager_ms,
           "eager_images_per_s": SSD_B / eager_ms * 1e3,
           "replay_step_ms": replay_ms,
           "images_per_s": SSD_B / replay_ms * 1e3,
           "capture_s": exe.capture_seconds,
           "max_memory_allocated": peak,
           "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms,
           "device_idle_share_unprofiled": 1.0 - busy / replay_ms,
           "kernel_launches_per_step": kernels,
           "family_launches": fam_launches,
           "device_ms_by_family": dict(sorted(by_family.items(),
                                              key=lambda kv: -kv[1])),
           "top_kernels": top, "detection": detection}
    exe.close()
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return launches, sizes


# ---------------------------------------------------------------- phase 28

# the op tier's other layers, one realistic shape each: (name, shapes)
IMIKOLOV_DICT = 2074   # paddle_tpu/dataset/imikolov.py:6, VOCAB_SIZE
OP_TIER_TOL = 1e-4     # of the max, card against the port's CPU result


def _op_program(build, feeds, seed):
    """(main, startup, the output var, the feed arrays) of ``build(L)``
    over data vars named and shaped as ``feeds`` (name -> array)."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        data = {n: L.data(name=n, shape=list(a.shape),
                          dtype=str(a.dtype), append_batch_size=False)
                for n, a in feeds.items()}
        out = build(L, data)
    return main, startup, out


def _op_env(main, startup, feeds, device, grads):
    """(environment, leaves) for runs of ``main``'s ops on ``device``:
    the startup program's values (run on the CPU, so both devices start
    alike) and the feeds, those named in ``grads`` autograd leaves."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    env = {n: scope.find_var(n).to(device) for n in scope.local_var_names()
           if isinstance(scope.find_var(n), torch.Tensor)}
    env.update({n: torch.as_tensor(a).to(device) for n, a in feeds.items()})
    leaves = {n: env[n].detach().requires_grad_(True) for n in grads}
    env.update(leaves)
    return env, leaves


def _op_apply(main, out, env, leaves, grads):
    """One run of ``main``'s ops over a copy of ``env`` under autograd:
    (the output, the gradients of ``sum(out * r)``, r seeded, with
    respect to the leaves named in ``grads``)."""
    from paddle_tpu_torch.executor import run_program_ops

    env = dict(env)
    with torch.enable_grad():
        run_program_ops(main.global_block().ops, env,
                        device=next(iter(env.values())).device)
        y = env[out.name]
        if not grads:
            return y.detach(), []
        gs = torch.autograd.grad((y.float() * _cotangent(y)).sum(),
                                 [leaves[n] for n in grads])
    return y.detach(), [g.detach() for g in gs]


_COTANGENTS = {}


def _cotangent(y):
    """A seeded normal tensor of ``y``'s shape on its device, made once
    per shape and device (the same values on every device)."""
    key = (tuple(y.shape), str(y.device))
    if key not in _COTANGENTS:
        _COTANGENTS[key] = torch.as_tensor(np.random.RandomState(
            7).standard_normal(key[0]).astype(np.float32)).to(y.device)
    return _COTANGENTS[key]


def _op_cases():
    """name -> (build(L, data), full-size feeds, {input: the leading rows
    the parity check takes}, the inputs whose gradients are held)."""
    r = np.random.RandomState(SEED + 40)
    f32 = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    lo = r.rand(128, 2) * 300
    rois = np.concatenate([lo, lo + 40 + r.rand(128, 2) * 200], 1)
    words = r.randint(0, IMIKOLOV_DICT, (1024, 1)).astype(np.int64)
    moe_x = f32(64, 128, 768)
    cases = {
        # ResNet-50's first batch norm, channels last
        "batch_norm_nhwc": (lambda L, d: L.batch_norm(
            d["x"], data_layout="NHWC"), {"x": f32(64, 112, 112, 64)},
            {}, ["x"]),
        # a DCGAN generator layer
        "conv2d_transpose": (lambda L, d: L.conv2d_transpose(
            d["x"], num_filters=256, filter_size=4, stride=2, padding=1),
            {"x": f32(64, 512, 4, 4)}, {"x": 8}, ["x"]),
        "conv3d_transpose": (lambda L, d: L.conv3d_transpose(
            d["x"], num_filters=64, filter_size=2, stride=2),
            {"x": f32(8, 128, 8, 28, 28)}, {"x": 1}, ["x"]),
        # a C3D block: conv 64 -> 128 (3x3x3), pool 2x2x2
        "conv3d": (lambda L, d: L.conv3d(d["x"], num_filters=128,
                                         filter_size=3, padding=1),
                   {"x": f32(8, 64, 16, 56, 56)}, {"x": 1}, ["x"]),
        "pool3d": (lambda L, d: L.pool3d(d["x"], pool_size=2,
                                         pool_stride=2),
                   {"x": f32(8, 128, 16, 56, 56)}, {"x": 1}, ["x"]),
        # AlexNet's first LRN
        "lrn": (lambda L, d: L.lrn(d["x"], n=5, alpha=1e-4, beta=0.75),
                {"x": f32(64, 96, 55, 55)}, {"x": 8}, ["x"]),
        # an OCR line (CRNN's patches)
        "im2sequence": (lambda L, d: L.im2sequence(
            d["x"], filter_size=3, stride=1, padding=1),
            {"x": f32(64, 1, 32, 100)}, {"x": 8}, ["x"]),
        "image_resize_up": (lambda L, d: L.image_resize(
            d["x"], out_shape=[600, 600]), {"x": f32(16, 3, 300, 300)},
            {"x": 4}, ["x"]),
        "image_resize_down_nearest": (lambda L, d: L.image_resize(
            d["x"], out_shape=[300, 300], resample="NEAREST"),
            {"x": f32(16, 3, 600, 600)}, {"x": 4}, ["x"]),
        # Fast R-CNN's pool5 on a VGG conv5 map
        "roi_pool": (lambda L, d: L.roi_pool(
            d["x"], d["rois"], pooled_height=7, pooled_width=7,
            spatial_scale=1.0 / 16, rois_batch_idx=d["idx"]),
            {"x": f32(8, 512, 38, 50), "rois": rois.astype(np.float32),
             "idx": r.randint(0, 8, 128).astype(np.int32)},
            {"rois": 16, "idx": 16}, ["x"]),
        # word2vec on imikolov, 512 hidden
        "hsigmoid": (lambda L, d: L.hsigmoid(d["x"], d["y"],
                                             IMIKOLOV_DICT),
                     {"x": f32(1024, 512), "y": words}, {}, ["x"]),
        "nce": (lambda L, d: L.nce(d["x"], d["y"], IMIKOLOV_DICT,
                                   num_neg_samples=10, seed=1),
                {"x": f32(1024, 512), "y": words}, {}, ["x"]),
        "sampled_softmax": (lambda L, d:
                            L.sampled_softmax_with_cross_entropy(
                                d["x"], d["y"], IMIKOLOV_DICT,
                                num_samples=64, seed=2),
                            {"x": f32(1024, 512), "y": words}, {},
                            ["x"]),
        "fake_quantize_dequantize": (
            lambda L, d: L.fake_dequantize_max_abs(
                *L.fake_quantize_abs_max(d["x"]), max_range=127.0),
            {"x": f32(64, 4096)}, {}, ["x"]),
        "fake_quantize_range_abs_max": (
            lambda L, d: L.fake_quantize_range_abs_max(d["x"])[0],
            {"x": f32(64, 4096)}, {}, ["x"]),
        # google/switch-base-8: d_model 768, d_ff 3072, 8 experts
        "switch_moe": (lambda L, d: L.switch_moe(d["x"], 8, 3072)[0],
                       {"x": moe_x}, {"x": 4}, ["x"]),
    }
    return cases


def phase_op_tier(card):
    """Phase 28: each other new layer once on the card at a realistic
    shape, its forward and input gradient held to the port's CPU result
    on the same inputs within 1e-4 of the max (on a leading slice where
    the CPU would take long; switch_moe at 4 x 128 tokens), NHWC batch
    norm also to the NCHW batch norm on the card; the card's forward and
    forward+backward ms at the full shape."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    rows = []
    for name, (build, feeds, cut, grads) in _op_cases().items():
        main, startup, out = _op_program(build, feeds, SEED + 41)
        small = {n: a[:cut[n]] if n in cut else a for n, a in feeds.items()}
        sm, ss, so = _op_program(build, small, SEED + 41)
        got = _op_apply(sm, so, *_op_env(sm, ss, small, gpu, grads), grads)
        want = _op_apply(sm, so, *_op_env(sm, ss, small, cpu, grads), grads)
        errs = {}
        for label, a, b in [("out", got[0], want[0])] + [
                ("d" + n, g, c) for n, g, c in zip(grads, got[1], want[1])]:
            a, b = a.float().cpu(), b.float()
            if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                fail("op_tier %s: %s on the card %s (finite %s), CPU %s"
                     % (name, label, tuple(a.shape),
                        bool(torch.isfinite(a).all()), tuple(b.shape)))
            errs[label] = float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
        env, leaves = _op_env(main, startup, feeds, gpu, grads)
        if name == "batch_norm_nhwc":
            full = _op_apply(main, out, env, leaves, grads)
            nchw = {"x": np.ascontiguousarray(feeds["x"].transpose(0, 3, 1,
                                                                   2))}
            # the NCHW batch norm, its output transposed back (the same
            # cotangent then meets both)
            cm, cs_, co = _op_program(lambda L, d: L.transpose(
                L.batch_norm(d["x"]), perm=[0, 2, 3, 1]), nchw, SEED + 41)
            ref = _op_apply(cm, co, *_op_env(cm, cs_, nchw, gpu, grads),
                            grads)
            for label, a, b in (("nchw_out", full[0], ref[0]),
                                ("nchw_dx", full[1][0],
                                 ref[1][0].permute(0, 2, 3, 1))):
                errs[label] = float((a - b).abs().max()) / max(
                    float(b.abs().max()), 1e-30)
            del full, ref
        if max(errs.values()) > OP_TIER_TOL:
            fail("op_tier %s: the card parts from the reference by %s of "
                 "the max (> %g)" % (name, errs, OP_TIER_TOL))
        _COTANGENTS.clear()
        row = {"phase": "op_tier", "card": card, "op": name,
               "shapes": {n: list(a.shape) for n, a in feeds.items()},
               "parity_shapes": {n: list(a.shape) for n, a in small.items()},
               "max_rel_err": errs,
               "fwd_ms": cuda_ms(lambda: _op_apply(main, out, env, leaves,
                                                   []), 3, warmup=1),
               "fwd_bwd_ms": cuda_ms(lambda: _op_apply(main, out, env,
                                                       leaves, grads), 3,
                                     warmup=1)}
        emit(row)
        rows.append(row)
        del env, leaves, got, want
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 21

# MFU denominators: NVIDIA's published dense peaks of the H100 SXM (the
# card of these runs, "NVIDIA H100 80GB HBM3", at its 700 W limit),
# without sparsity; f32 is the rate outside the tensor cores (no TF32:
# main() turns TF32 off)
MFU_PEAK_CARD = "NVIDIA H100 SXM 80GB (H100 80GB HBM3), 700 W"
MFU_PEAK_FLOPS = {"bf16": 989.4e12, "f32": 66.9e12}
# families whose unknown ops would make the MFU numerator undercount
COMPUTE_FAMILIES = ("matmul", "conv", "attention")


def timed_program(label, program, feed, fetch, step_ms, peak, dtype):
    """What the static phase reads of a phase's timed training run: the
    program, one step's feed shapes, the fetched loss, the measured step
    ms and peak memory, and the step's matmul dtype (its MFU peak)."""
    return {"label": label, "program": program,
            "feed_shapes": {n: tuple(v.shape) for n, v in feed.items()},
            "fetch": [fetch.name], "step_ms": step_ms,
            "max_memory_allocated": peak, "dtype": dtype}


def concrete_program(program, feed_shapes):
    """A clone of ``program`` whose symbol table holds the shapes of
    ``feed_shapes`` (a -1 stays dynamic) and every other variable's
    shape as inference derives it from them. The liveness report counts
    each -1 as ``assume_batch``, which a free sequence axis breaks (a
    [B, T] feed declared [-1, -1] would count as [B, B]); the clone pins
    the axes the run pinned."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core.program import _DYN_SENTINEL

    p = program.clone()
    gb = p.global_block()
    for n, shape in feed_shapes.items():
        gb.var(n).shape = tuple(shape)
    for (b, n), t in analysis.infer_program_types(p).types.items():
        v = p.blocks[b]._find_var_recursive(n)
        if v is None or v.shape is None or t.shape is None \
                or len(t.shape) != len(v.shape):
            continue
        # an extent that is a multiple of the dynamic-dim stand-in is a
        # product with a dynamic axis (a flattened [-1, T]): it stays -1
        v.shape = tuple(d if d >= 0 and (d == 0 or d % _DYN_SENTINEL)
                        else -1 for d in t.shape)
    return p


def predicted_peak(program, feed_shapes, fetch):
    """``analyze_liveness``' peak for one run of ``program`` at
    ``feed_shapes``, under the program's own remat policy and donation."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.executor import _resolve_donation, _resolve_remat

    rep = analysis.analyze_liveness(
        concrete_program(program, feed_shapes), feed=list(feed_shapes),
        fetch_list=fetch, remat=_resolve_remat(program),
        donation=_resolve_donation(program))
    return {"peak_bytes": rep.peak_bytes, "peak_op": "%d (%s)" % (
        rep.peak_op_index, rep.peak_op_type),
        "persistable_bytes": rep.persistable_bytes,
        "unsized_vars": len(rep.unsized_vars)}


def phase_static(card, runs):
    """The static tier over the training programs the earlier phases
    built and timed: ``obs.cost.report`` at the run's feed shapes
    (FLOPs and bytes a step, by family, unknown op types), achieved
    TFLOP/s and MFU from the measured step ms against the card's peak
    for the step's matmul dtype, ``analysis.check_program`` (no error),
    and ``analyze_liveness``' predicted peak beside the run's
    ``torch.cuda.max_memory_allocated``; then one recipe step with the
    ``check_program`` flag on, checked before any kernel launched."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.obs import cost
    from paddle_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    rows = []
    for r in runs:
        prog, shapes = r["program"], r["feed_shapes"]
        rep = cost.report(prog, feed_shapes=shapes)
        fam = rep.by_family()
        blind = {f: fam[f]["unknown"] for f in COMPUTE_FAMILIES
                 if fam.get(f, {}).get("unknown")}
        if blind:
            fail("static %s: unknown ops in the compute families %s: the "
                 "MFU numerator would undercount" % (r["label"], blind))
        check = analysis.check_program(prog, feed=list(shapes),
                                       fetch_list=r["fetch"])
        if not check.ok:
            fail("static %s: check_program reports errors:\n%s"
                 % (r["label"], check))
        peak_flops = MFU_PEAK_FLOPS[r["dtype"]]
        ach = cost.achieved(rep.total_flops, r["step_ms"] / 1e3, peak_flops)
        live = predicted_peak(prog, shapes, r["fetch"])
        rows.append({
            "program": r["label"], "feed_shapes": shapes,
            "ops": len(rep.ops), "flops_per_step": rep.total_flops,
            "bytes_per_step": rep.total_bytes,
            "by_family": fam, "unknown_op_types": rep.unknown_op_types(),
            "step_ms": r["step_ms"],
            "achieved_tflops": ach["flops_per_sec"] / 1e12,
            "matmul_dtype": r["dtype"], "peak_tflops": peak_flops / 1e12,
            "mfu": ach["mfu"],
            "check_program": {"errors": len(check.errors),
                              "warnings": sorted(
                                  {d.code for d in check.warnings})},
            "liveness": live,
            "max_memory_allocated": r["max_memory_allocated"],
            "predicted_over_measured": live["peak_bytes"]
            / r["max_memory_allocated"]})

    # one recipe step with the check_program flag on: the check runs
    # once, before any kernel of the step launched, and passes
    place = fluid.CUDAPlace(0)
    main, startup, loss = build_recipe(True)
    fluid.memory_optimize(main)
    exe, scope = _fresh(main, startup, place)
    feed = train_batch()
    seen = []
    real = analysis.check_program

    def recorded(*args, **kwargs):
        seen.append(sum(_cuda.launch_counts().values()))
        report = real(*args, **kwargs)
        seen.append(report.ok)
        return report

    saved = fluid.get_flag("check_program")
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    analysis.check_program = recorded
    fluid.set_flags({"check_program": True})
    try:
        flagged = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]) for _ in range(2)]
    finally:
        analysis.check_program = real
        fluid.set_flags({"check_program": saved})
    launched = sum(_cuda.launch_counts().values())
    if seen != [0, True] or not launched or \
            not np.isfinite(flagged).all():
        fail("static: with the check_program flag on, the check saw %s "
             "(launches before it, its verdict; want [0, True] once) and "
             "the steps launched %d kernels, losses %s"
             % (seen, launched, flagged))
    exe.close()
    del exe, scope
    torch.cuda.empty_cache()
    emit({"phase": "static", "card": card, "peak_card": MFU_PEAK_CARD,
          "peak_tflops": {k: v / 1e12 for k, v in MFU_PEAK_FLOPS.items()},
          "programs": rows,
          "check_program_flag": {"checks": len(seen) // 2,
                                 "launches_before_check": seen[0],
                                 "passed": seen[1], "losses": flagged,
                                 "launches": launched},
          "phase_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------- phase 22

REMAT_B, REMAT_T, REMAT_P = BERT_LEGS["phase2"]
REMAT_TARGET_B = 2 * REMAT_B


def remat_run(main, startup, feed, loss, place, launchers):
    """``_timed_chunks`` from the seeded state, the feed on the card: a
    warm chunk (the eager step, the capture, replays) and a timed one,
    launches counted and the peak taken over both. Returns the row (the
    timed losses, the launches of the 2 x CHUNK steps, step ms, peak)
    and the final scope tensors."""
    from paddle_tpu_torch.ops import _cuda

    exe, scope = _fresh(main, startup, place)
    dev_feed = {n: torch.as_tensor(v).to(place.torch_device())
                for n, v in feed.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    dt, losses = _timed_chunks(exe, main, dev_feed, loss, scope, 1)
    counts = {fn.__name__: fn.launches for fn in launchers}
    peak = torch.cuda.max_memory_allocated()
    state = scope_tensors(scope)
    exe.close()
    del exe, scope, dev_feed
    torch.cuda.empty_cache()
    if not np.isfinite(losses).all():
        fail("remat: non-finite losses %s" % losses.tolist())
    return {"losses": losses.tolist(), "launches": counts,
            "step_ms": dt / CHUNK * 1e3,
            "max_memory_allocated": peak}, state


def phase_remat(card):
    """BERT-base at the phase-2 shape (B=16, T=512), the bert phase's
    flags, dropout 0.1, ``attn_impl="pallas"``, under ``run_steps`` at
    ``memory_optimize(level=0)`` and ``level=1``: losses and the final
    scope bit-equal, exact launches a replayed step (the recompute
    relaunches the flash forward and dropout kernels), a lower peak.
    Then ``RematPolicyPass(assume_batch=16, target_batch=32)`` picks
    segments, and B=32 runs with them and without remat: bit-equal.
    Returns the level-1 run's launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update
    from paddle_tpu_torch.passes import PassManager, RematPolicyPass

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 dr.dropout_apply, fused_flat_update)
    n_layer = BERT_MODEL["n_layer"]
    feed = bert_batch(REMAT_B, REMAT_T, REMAT_P)
    shapes = {n: tuple(v.shape) for n, v in feed.items()}
    runs, states = {}, {}
    for level in (0, 1):
        main, startup, loss = build_bert(REMAT_P)
        fluid.memory_optimize(main, level=level)
        sites = sum(op.type == "dropout" for op in main.global_block().ops)
        row, states[level] = remat_run(main, startup, feed, loss[0], place,
                                       launchers)
        row["liveness"] = predicted_peak(main, shapes, [loss[0].name])
        runs["level%d" % level] = row
    groups = sum(op.type.endswith("_fused")
                 for op in main.global_block().ops)
    per_step = {"flash_fwd": (1 + 1) * n_layer, "flash_bwd_dq": n_layer,
                "flash_bwd_dkv": n_layer, "dropout_apply": 3 * sites,
                "fused_flat_update": groups}
    # two chunks: the eager step, the capture (its launches put back)
    # and 2 x CHUNK - 1 replays
    steps = 2 * CHUNK
    got = runs["level1"]["launches"]
    if got != {k: v * steps for k, v in per_step.items()}:
        fail("remat: level 1 launched %s in %d steps, expected %s a step"
             % (got, steps, per_step))
    base = {k: v * steps for k, v in per_step.items()}
    base.update(flash_fwd=n_layer * steps, dropout_apply=2 * sites * steps)
    if runs["level0"]["launches"] != base:
        fail("remat: level 0 launched %s, expected %s"
             % (runs["level0"]["launches"], base))
    differ = state_diff(states[1], states[0])
    equal = runs["level1"]["losses"] == runs["level0"]["losses"]
    if differ or not equal:
        fail("remat: level 1 is not bit-equal to level 0: losses %s against "
             "%s, tensors differing %s" % (runs["level1"]["losses"],
                                          runs["level0"]["losses"], differ))
    if not runs["level1"]["max_memory_allocated"] < \
            runs["level0"]["max_memory_allocated"]:
        fail("remat: level 1's peak %d is not below level 0's %d"
             % (runs["level1"]["max_memory_allocated"],
                runs["level0"]["max_memory_allocated"]))
    del states

    # the remat_policy pass at the phase-2 shape: its static model
    # counts each -1 as the batch, so the sequence axis is pinned first
    feed32 = bert_batch(REMAT_TARGET_B, REMAT_T, REMAT_P)
    shapes32 = {n: tuple(v.shape) for n, v in feed32.items()}
    pinned = {n: (-1,) + s[1:] for n, s in shapes.items()}
    main, startup, loss = build_bert(REMAT_P)
    main = concrete_program(main, pinned)
    plain = main.clone()
    for prog in (main, plain):
        fluid.memory_optimize(prog)
    main = PassManager([RematPolicyPass(assume_batch=REMAT_B,
                                        target_batch=REMAT_TARGET_B)]
                       ).apply(main)
    chosen = list(getattr(main, "_remat_policy", ()) or ())
    if not chosen:
        fail("remat: RematPolicyPass chose no segment for B=%d"
             % REMAT_TARGET_B)
    segs = sorted({op.attrs["_remat_segment"]
                   for op in main.global_block().ops
                   if "_remat_segment" in op.attrs})
    b32, states = {}, {}
    for label, prog in (("none", plain), ("segments", main)):
        row, states[label] = remat_run(prog, startup, feed32, loss[0],
                                       place, launchers)
        row["liveness"] = predicted_peak(prog, shapes32, [loss[0].name])
        b32[label] = row
    differ = state_diff(states["segments"], states["none"])
    if differ or b32["segments"]["losses"] != b32["none"]["losses"]:
        fail("remat: B=%d with segments %s is not bit-equal to no remat: "
             "losses %s against %s, tensors differing %s"
             % (REMAT_TARGET_B, chosen, b32["segments"]["losses"],
                b32["none"]["losses"], differ))
    del states
    torch.cuda.empty_cache()
    emit({"phase": "remat", "card": card, "model": BERT_MODEL,
          "flags": RECIPE_FLAGS, "dropout": BERT_DROPOUT,
          "attn_impl": "pallas", "batch": REMAT_B, "seq": REMAT_T,
          "max_predictions": REMAT_P, "chunk": CHUNK, "sites": sites,
          "launches_per_step": per_step, "bit_equal": True, **runs,
          "policy": {"assume_batch": REMAT_B,
                     "target_batch": REMAT_TARGET_B, "segments": segs,
                     "chosen": chosen, "stamp": main._schedule_stamp},
          "b32": b32, "phase_s": time.perf_counter() - t_phase})
    return runs["level1"]["launches"]

# ---------------------------------------------------------------- phase 25


ARTIFACT_ROOT = "build/chip_smoke_artifact"  # under the checkout, ignored
PR11_DROPOUT_STEP_MS = 35.23  # the dropout recipe under run_steps, PR 11
RESNET_FOLD_TOL = TOL[torch.bfloat16]  # of the probabilities


def _cpu_scope(scope):
    """A copy of ``scope`` with every tensor on the CPU."""
    import paddle_tpu_torch as fluid

    out = fluid.Scope()
    for n in scope.local_var_names():
        v = scope.find_var(n)
        out.set_var(n, v.detach().cpu() if torch.is_tensor(v) else v)
    return out


def _bucket_feed(reqs, rows):
    """The first ``rows`` rows of the requests, concatenated."""
    out = {n: np.concatenate([r[n] for r in reqs])[:rows] for n in reqs[0]}
    if len(out["src_ids"]) < rows:
        fail("artifact: the requests hold fewer than %d rows" % rows)
    return out


def artifact_serving(card, root, server_figures, cache_dir):
    """(a) BERT-base classification exported from a CPU scope through a
    fresh compile cache at ``cache_dir`` (the cold export: 7 misses, 7
    publishes) and served from its directory alone: 7 captured graphs,
    each bucket bit-equal to ``Executor.run`` of the same optimized
    program on the card, traffic within TOL[bf16] of eager runs of its
    own rows, the flash forward launched 12 times an executed batch.
    Returns its figures and (program, feed names, probabilities, the
    CPU scope) for the compile_cache phase."""
    import json as _json
    import threading

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.compile_cache import (cache_metrics,
                                                reset_cache_metrics)
    from paddle_tpu_torch.obs import metrics as obs_metrics
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.passes.manager import inference_pass_pipeline
    from paddle_tpu_torch.serving import ServingConfig, serve_program

    main, feed_names, prob, scope = build_server_model()
    cpu_scope = _cpu_scope(scope)
    reset_cache_metrics()
    fluid.set_flags({"compile_cache_dir": cache_dir})
    try:
        t0 = time.perf_counter()
        fluid.io.save_inference_model(
            root, feed_names, [prob], fluid.Executor(fluid.CPUPlace()),
            main_program=main, scope=cpu_scope,
            export_batch_sizes=SERVER_BUCKETS)
        export_s = time.perf_counter() - t0
    finally:
        fluid.set_flags({"compile_cache_dir": ""})
    cold = cache_metrics()
    n = len(SERVER_BUCKETS)
    if (cold["miss"], cold["publish"], cold["hit"], cold["bad_entry"]) != \
            (n, n, 0, 0):
        fail("artifact: the cold export counted %s, expected %d misses "
             "and %d publishes" % (cold, n, n))
    with open(os.path.join(root, "__model__.json")) as f:
        manifest = _json.load(f)
    buckets = sorted(int(b) for b in manifest.get("torch_export_buckets",
                                                  {}))
    if buckets != list(SERVER_BUCKETS):
        fail("artifact: the manifest's torch_export_buckets are %s, "
             "expected %s" % (buckets, list(SERVER_BUCKETS)))
    config = ServingConfig(buckets=SERVER_BUCKETS, batch_timeout_ms=2.0,
                           queue_capacity=4 * SERVER_REQUESTS)
    t0 = time.perf_counter()
    server = serve_program(root, config=config, auto_start=False)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.start()  # warm_up: one capture per bucket
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    engine = server.engine
    if engine.compile_count != len(SERVER_BUCKETS):
        fail("artifact: %d graphs after warm-up, expected %d"
             % (engine.compile_count, len(SERVER_BUCKETS)))
    reqs = server_requests()
    replies = [None] * len(reqs)

    def client(c):
        for i in range(c, SERVER_REQUESTS, SERVER_CLIENTS):
            replies[i], = server.infer(reqs[i], timeout=600)

    reset_counts(fa.flash_fwd)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(
            r is None for r in replies[:SERVER_REQUESTS]):
        fail("artifact: not every client request was answered")
    replies[-1], = server.infer(reqs[-1], timeout=600)  # oversize
    server.shutdown(drain=True, timeout=120)
    rep = server.metrics.report()
    executed = rep["batch_execute"]["count"]
    launches = fa.flash_fwd.launches
    if launches != BERT_MODEL["n_layer"] * executed:
        fail("artifact: the flash forward launched %d times over %d "
             "executed batches of %d layers"
             % (launches, executed, BERT_MODEL["n_layer"]))
    if engine.compile_count != len(SERVER_BUCKETS):
        fail("artifact: %d graphs after the traffic, expected %d"
             % (engine.compile_count, len(SERVER_BUCKETS)))
    # the same pruned, optimized program run eagerly on the card
    exe = fluid.Executor(fluid.CUDAPlace(0))
    program = inference_pass_pipeline([prob.name]).apply(
        main.prune([prob.name]))
    bit_equal, bucket_err = {}, 0.0
    for b in SERVER_BUCKETS:
        feed = _bucket_feed(reqs, b)
        got, = engine.run(feed)
        want, = exe.run(program, feed=feed, fetch_list=[prob.name],
                        scope=scope)
        bit_equal[b] = bool(np.array_equal(got, want))
        bucket_err = max(bucket_err, float(np.abs(got - want).max()))
    worst = 0.0
    for i, (feed, got) in enumerate(zip(reqs, replies)):
        want, = exe.run(program, feed=feed, fetch_list=[prob.name],
                        scope=scope)
        if got.shape != want.shape or not np.isfinite(got).all():
            fail("artifact: request %d replied %s, eager %s"
                 % (i, got.shape, want.shape))
        worst = max(worst, float(np.abs(got - want).max()))
    if not all(bit_equal.values()) and bucket_err > TOL[torch.bfloat16]:
        fail("artifact: a bucket differs from Executor.run by %g"
             % bucket_err)
    if worst > TOL[torch.bfloat16]:
        fail("artifact: a reply differs from its eager run by %g" % worst)
    rows = sum(len(r["src_ids"]) for r in reqs)
    out = {"export_s": export_s, "cold_cache": cold,
           "load_s": load_s, "warm_up_s": warm_s,
           "graphs": engine.compile_count,
           "rows_per_s": (rows - SERVER_OVERSIZE) / wall_s,
           "padded_row_share": rep["padding_overhead"],
           "executed_batches": executed, "flash_fwd_launches": launches,
           "buckets_bit_equal_to_executor": bit_equal,
           "bucket_max_abs_err": bucket_err,
           "max_abs_err_vs_eager_own_rows": worst,
           "server_phase": server_figures,
           "prometheus_lines": len(
               obs_metrics.render_prometheus().splitlines())}
    del server, engine, scope, exe
    torch.cuda.empty_cache()
    return out, (main, feed_names, prob, cpu_scope)


def _state_diff(got, want):
    """Names whose tensors differ (bit for bit) between two states."""
    return [n for n, w in want.items()
            if n in got and not torch.equal(got[n].to(w.device), w)]


def artifact_training(card, root, dropout_step_ms):
    """(b) The dropout recipe's trainable artifact, written after step 0
    from the card scope: 10 ``run`` steps and one ``run_steps(10)`` call
    bit-equal to 10 ``Executor.run`` steps from the same state (losses
    and every state tensor), exact launches; the run_steps step ms.
    Returns (figures, launches of the ``run`` leg)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_optimizer as fu

    place = fluid.CUDAPlace(0)
    main, startup, cost = build_recipe(True, dropout_rate=RECIPE_DROPOUT)
    fluid.memory_optimize(main)
    sites = sum(op.type == "dropout" for op in main.global_block().ops)
    groups = sum(op.type.endswith("_fused")
                 for op in main.global_block().ops)
    batches = [train_batch(SEED + 20 + i) for i in range(TRAIN_STEPS + 1)]
    exe, scope = _fresh(main, startup, place)
    exe.run(main, feed=batches[0], fetch_list=[cost], scope=scope)
    shapes = {n: v.shape for n, v in batches[0].items()}
    t0 = time.perf_counter()
    fluid.io.save_trainable_program(root, shapes, [cost], exe,
                                    main_program=main, scope=scope)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_run = fluid.io.load_trainable_program(root)
    load_s = time.perf_counter() - t0
    by_steps = fluid.io.load_trainable_program(root)
    names = list(by_run.state_dict())

    steps = batches[1:]
    want = [float(exe.run(main, feed=b, fetch_list=[cost],
                          scope=scope)[0]) for b in steps]
    ref = {n: scope.get(n) for n in names}
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    got = [float(by_run.run(b)[0]) for b in steps]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches
                for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                           fu.fused_flat_update, dr.dropout_apply)}
    expect = {"flash_fwd": ATTN_PER_STEP * TRAIN_STEPS,
              "flash_bwd_dq": ATTN_PER_STEP * TRAIN_STEPS,
              "flash_bwd_dkv": ATTN_PER_STEP * TRAIN_STEPS,
              "fused_flat_update": groups * TRAIN_STEPS,
              "dropout_apply": 2 * sites * TRAIN_STEPS}
    if launches != expect:
        fail("artifact: 10 steps from the trainable artifact launched %s, "
             "expected %s" % (launches, expect))
    stacked = {n: np.stack([b[n] for b in steps]) for n in shapes}
    for fn in _cuda.LAUNCHERS:
        reset_counts(fn)
    graph = by_steps.run_steps(stacked, steps=TRAIN_STEPS)[0]
    graph_launches = {fn.__name__: fn.launches
                      for fn in (fa.flash_fwd, fa.flash_bwd_dq,
                                 fa.flash_bwd_dkv, fu.fused_flat_update,
                                 dr.dropout_apply)}
    if graph_launches != expect:
        fail("artifact: run_steps(10) launched %s, expected %s"
             % (graph_launches, expect))
    run_diff = _state_diff(by_run.state_dict(), ref)
    steps_diff = _state_diff(by_steps.state_dict(), ref)
    equal = {"run_losses": got == want,
             "run_steps_losses": [float(v) for v in graph] == want,
             "run_state_differs": run_diff,
             "run_steps_state_differs": steps_diff}
    if not (equal["run_losses"] and equal["run_steps_losses"]
            and not run_diff and not steps_diff):
        fail("artifact: the trainable artifact is not bit-equal to "
             "Executor.run: %s (losses %s / %s against %s)"
             % (equal, got, [float(v) for v in graph], want))
    # replays only: two more calls of TRAIN_STEPS steps, timed
    dev = {n: torch.as_tensor(v).to(place.torch_device())
           for n, v in stacked.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [by_steps.run_steps(dev, steps=TRAIN_STEPS,
                                return_numpy=False)[0] for _ in range(2)]
    timed = torch.cat(timed).cpu().numpy()
    step_ms = (time.perf_counter() - t0) / (2 * TRAIN_STEPS) * 1e3
    if not np.isfinite(timed).all():
        fail("artifact: non-finite timed losses %s" % timed.tolist())
    out = {"export_s": export_s, "load_s": load_s, "losses": got,
           "bit_equal": equal, "launches": launches,
           "run_steps_launches": graph_launches, "sites": sites,
           "groups": groups, "run_steps_step_ms": step_ms,
           "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
           "dropout_recipe_step_ms": dropout_step_ms,
           "pr11_dropout_recipe_step_ms": PR11_DROPOUT_STEP_MS}
    exe.close()
    del by_run, by_steps, exe, scope, ref
    torch.cuda.empty_cache()
    return out, launches


def artifact_resnet(card, root):
    """(c) ResNet-50 in test mode, folded (``InferenceTranspiler``) and
    cast to bf16 (``transpile_to_bfloat16``), exported at B=64 and run
    from its artifact: bit-equal to ``Executor.run`` of the folded
    program, within RESNET_FOLD_TOL of the unfolded one; images/s."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import (NativeConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    saved = {n: fluid.get_flag(n) for n in RESNET_FLAGS}
    fluid.set_flags(RESNET_FLAGS)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(
                name="img", shape=[-1, 3, RESNET_HW, RESNET_HW],
                dtype="float32", append_batch_size=False)
            prob = resnet_imagenet(img, class_dim=RESNET_CLASSES,
                                   is_test=True)
    finally:
        fluid.set_flags(saved)
    place = fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.params_from_numpy(resnet_weights(main), scope, place,
                            program=main)
    # running statistics away from 0 and 1, so the fold moves weights
    rng = np.random.RandomState(SEED + 21)
    stats = {}
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            c = int(main.global_block().var(op.input("Mean")[0]).shape[0])
            stats[op.input("Mean")[0]] = 0.1 * rng.standard_normal(c)
            stats[op.input("Variance")[0]] = rng.uniform(0.5, 1.5, c)
    for n, a in stats.items():
        scope.set_var(n, torch.from_numpy(a.astype(np.float32)).to(
            place.torch_device()))
    # the logits too: random weights saturate the softmax, so the
    # probabilities alone would hide a difference
    logits = next(op for op in main.global_block().ops
                  if op.type == "softmax").input_arg_names[0]
    fetch = [prob.name, logits]
    feed = {"img": resnet_pool()[0]["img"]}
    unfolded = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    folded = fluid.InferenceTranspiler().transpile(main, scope=scope)
    fluid.transpile_to_bfloat16(folded, scope=scope)
    n_bn = sum(op.type == "batch_norm" for op in folded.global_block().ops)
    want = exe.run(folded, feed=feed, fetch_list=fetch, scope=scope)
    t0 = time.perf_counter()
    fluid.io.save_inference_model(root, ["img"], fetch, exe,
                                  main_program=folded, scope=scope,
                                  export_batch_sizes=[RESNET_B])
    export_s = time.perf_counter() - t0
    pred = create_paddle_predictor(NativeConfig(model_dir=root))
    got = pred.run_batch(feed)
    if pred.compile_count != 1:
        fail("artifact: the ResNet-50 predictor captured %d graphs"
             % pred.compile_count)
    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.run_batch(feed)
    images_s = iters * RESNET_B / (time.perf_counter() - t0)
    # the card's time for the captured forward alone (no feed copies)
    replay_ms = cuda_ms(pred._graphs[RESNET_B].graph.replay, iters)
    err_folded = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    err_prob = float(np.abs(got[0] - unfolded[0]).max())
    rel_logits = float(np.abs(got[1] - unfolded[1]).max()
                       / np.abs(unfolded[1]).max())
    if not all(np.isfinite(g).all() for g in got) or n_bn:
        fail("artifact: the folded ResNet-50 kept %d batch norms or gave "
             "non-finite outputs" % n_bn)
    if err_folded > RESNET_FOLD_TOL or err_prob > RESNET_FOLD_TOL \
            or rel_logits > RESNET_FOLD_TOL:
        fail("artifact: the folded ResNet-50's artifact differs by %g from "
             "the folded program; from the unfolded one by %g "
             "(probabilities) and %g of max |logit|"
             % (err_folded, err_prob, rel_logits))
    out = {"batch": RESNET_B, "export_s": export_s,
           "batch_norms_left": n_bn,
           "bit_equal_to_folded_executor": all(
               bool(np.array_equal(g, w)) for g, w in zip(got, want)),
           "max_abs_err_vs_folded": err_folded,
           "prob_max_abs_err_vs_unfolded": err_prob,
           "logits_rel_err_vs_unfolded": rel_logits,
           "max_abs_logit": float(np.abs(unfolded[1]).max()),
           "tolerance": RESNET_FOLD_TOL,
           "top1_agreement_vs_unfolded": float(np.mean(
               got[0].argmax(-1) == unfolded[0].argmax(-1))),
           "images_per_s": images_s, "graph_replay_ms": replay_ms,
           "replay_images_per_s": RESNET_B / (replay_ms / 1e3)}
    del pred, exe, scope
    torch.cuda.empty_cache()
    return out


def binding_host_us(calls=500):
    """Host microseconds a call of the flash forward at a tiny shape
    (B=1, T=64, H=1, D=64, bf16) through its custom op, through the op
    under autograd (``flash_attention`` on inputs that require grad),
    and as the CUDA kernel function called directly: what the custom-op
    binding costs an eager path per kernel call."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q = torch.randn(1, 64, 1, 64, device="cuda", dtype=torch.bfloat16)
    qg = q.clone().requires_grad_()
    ways = {"op": lambda: fa.flash_fwd(q, q, q),
            "op_autograd": lambda: fa.flash_attention(qg, qg, qg),
            "direct": lambda: fa._flash_fwd_cuda(q, q, q, None, False,
                                                 0.125)}
    out = {}
    for name, fn in ways.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def phase_artifact(card, server_figures, dropout_step_ms, cache_root):
    """Exported artifacts on the card: (a) serving BERT-base from its
    artifact alone, exported through a fresh compile cache into
    ``cache_root`` (which the compile_cache phase reuses), (b) training
    the dropout recipe from its trainable artifact, (c) the folded bf16
    ResNet-50 from its artifact. Returns the launches of (a)'s flash
    forward and of (b)'s kernels, and what (a) built."""
    import shutil

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ARTIFACT_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(cache_root, ignore_errors=True)
    try:
        serving, built = artifact_serving(
            card, os.path.join(cache_root, "cold"), server_figures,
            os.path.join(cache_root, "store"))
        training, train_launches = artifact_training(
            card, os.path.join(root, "training"), dropout_step_ms)
        resnet = artifact_resnet(card, os.path.join(root, "resnet"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "artifact", "card": card, "serving": serving,
          "training": training, "resnet": resnet,
          "binding_host_us": binding_host_us(),
          "phase_s": time.perf_counter() - t_phase})
    return {"serving_flash_fwd": serving["flash_fwd_launches"],
            "training": train_launches,
            "export_s": serving["export_s"]}, built


COMPILE_CACHE_ROOT = "build/chip_smoke_compile_cache"  # ignored
# the second process of the compile_cache phase: the server model built
# again, its scope copied to the CPU, exported through the same cache
_WARM_EXPORT = r"""
import json, sys, time
import chip_smoke as cs
import paddle_tpu_torch as fluid
from paddle_tpu_torch.compile_cache import cache_metrics
main, feeds, prob, scope = cs.build_server_model()
cpu = cs._cpu_scope(scope)
del scope
fluid.set_flags({"compile_cache_dir": sys.argv[1]})
t0 = time.perf_counter()
fluid.io.save_inference_model(
    sys.argv[2], feeds, [prob], fluid.Executor(fluid.CPUPlace()),
    main_program=main, scope=cpu, export_batch_sizes=cs.SERVER_BUCKETS)
print(json.dumps({"export_s": time.perf_counter() - t0,
                  "metrics": cache_metrics()}))
"""


def _pt2_shas(d):
    import hashlib

    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d))
            if f.endswith(".pt2")}


def _predictor_outputs(d, feeds):
    """``NativePredictor`` over the artifact ``d`` on the card: its
    outputs for each feed of ``feeds`` (one per bucket run)."""
    from paddle_tpu_torch.inference import (NativeConfig,
                                            create_paddle_predictor)

    pred = create_paddle_predictor(NativeConfig(model_dir=d, use_gpu=True))
    return [pred.run_batch(f)[0] for f in feeds]


def phase_compile_cache(card, cache_root, built, cold_export_s):
    """The persistent compile cache over the artifact phase's BERT-base
    export (its cold export: 7 misses, 7 publishes into
    ``<cache_root>/store``). A second process builds the same program
    and exports it through the same store into a second directory: 7
    hits, 0 misses, every ``.pt2`` sha256-equal to the cold one; the
    smallest and largest buckets of the two directories through
    ``NativePredictor`` bit-equal on the same rows. Meanwhile, in a copy
    of the store with one byte of the batch-1 entry's payload flipped,
    this process exports the batch-1 program again: 1 bad entry, 1
    miss, 1 publish, the file the republished entry's payload, a warm
    export of it the same file, and its output the cold one's."""
    import shutil

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.compile_cache import (CacheStore, cache_metrics,
                                                reset_cache_metrics)
    from paddle_tpu_torch.compile_cache.store import EXECUTABLE_FILE

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    store, cold = (os.path.join(cache_root, n) for n in ("store", "cold"))
    warm, again = (os.path.join(cache_root, n) for n in ("warm", "again"))
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", _WARM_EXPORT, store,
                                  warm], cwd=here, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            main, feed_names, prob, cpu_scope = built
            reqs = server_requests()
            rows = {b: _bucket_feed(reqs, b)
                    for b in (SERVER_BUCKETS[0], SERVER_BUCKETS[-1])}
            cold_out = _predictor_outputs(cold, list(rows.values()))
            # the corrupted entry, in a copy of the store (the second
            # process reads the original)
            bad_store = os.path.join(cache_root, "store_bad")
            shutil.copytree(store, bad_store)
            want = open(os.path.join(cold, "__model__.pt2"), "rb").read()
            bad = CacheStore(bad_store)
            entry = next(bad.entry_dir(e["fingerprint"])
                         for e in bad.entries()
                         if open(os.path.join(bad.entry_dir(
                             e["fingerprint"]), EXECUTABLE_FILE),
                             "rb").read() == want)
            payload = bytearray(want)
            payload[len(payload) // 2] ^= 0xFF
            open(os.path.join(entry, EXECUTABLE_FILE), "wb").write(
                bytes(payload))
            exe = fluid.Executor(fluid.CPUPlace())
            fluid.set_flags({"compile_cache_dir": bad_store})
            try:
                reset_cache_metrics()
                t1 = time.perf_counter()
                fluid.io.save_inference_model(
                    again, feed_names, [prob], exe, main_program=main,
                    scope=cpu_scope)
                reexport_s = time.perf_counter() - t1
                repaired = cache_metrics()
                republished = open(os.path.join(
                    entry, EXECUTABLE_FILE), "rb").read()
                reset_cache_metrics()
                fluid.io.save_inference_model(
                    again + "_warm", feed_names, [prob], exe,
                    main_program=main, scope=cpu_scope)
                rewarm = cache_metrics()
            finally:
                fluid.set_flags({"compile_cache_dir": ""})
            if (repaired["bad_entry"], repaired["miss"],
                    repaired["publish"], repaired["hit"]) != (1, 1, 1, 0):
                fail("compile_cache: the corrupted entry counted %s, "
                     "expected 1 bad entry, 1 miss, 1 publish" % repaired)
            again_file = open(os.path.join(again, "__model__.pt2"),
                              "rb").read()
            if again_file != republished or _pt2_shas(again) != \
                    _pt2_shas(again + "_warm") or rewarm["hit"] != 1:
                fail("compile_cache: the re-export's file is not the "
                     "republished entry (or a warm export of it differs)")
            again_out = _predictor_outputs(again, [rows[1]])
            if not np.array_equal(again_out[0], cold_out[0]):
                fail("compile_cache: the re-exported batch-1 program's "
                     "output differs from the cold one's")
            out, err = child.communicate(timeout=900)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            fail("compile_cache: the second process failed (rc %s): %s"
                 % (child.returncode, err[-3000:]))
        warm_run = json.loads(out.strip().splitlines()[-1])
        m = warm_run["metrics"]
        n = len(SERVER_BUCKETS)
        if (m["hit"], m["miss"], m["publish"], m["bad_entry"]) != \
                (n, 0, 0, 0):
            fail("compile_cache: the second process counted %s, expected "
                 "%d hits and no miss" % (m, n))
        cold_shas, warm_shas = _pt2_shas(cold), _pt2_shas(warm)
        if len(cold_shas) != n or warm_shas != cold_shas:
            fail("compile_cache: the warm directory's .pt2 files are not "
                 "sha256-equal to the cold ones")
        warm_out = _predictor_outputs(warm, list(rows.values()))
        for b, c, w in zip(rows, cold_out, warm_out):
            if not np.array_equal(c, w):
                fail("compile_cache: bucket %d's outputs differ between "
                     "the warm and the cold directory" % b)
        stats = CacheStore(store).stats()
    finally:
        shutil.rmtree(cache_root, ignore_errors=True)
    gc.collect()  # the predictors' captured graphs (see phase_obs)
    torch.cuda.empty_cache()
    emit({"phase": "compile_cache", "card": card, "buckets": SERVER_BUCKETS,
          "cold_export_s": cold_export_s,
          "warm_export_s": warm_run["export_s"],
          "warm_process_s": child_s, "warm_metrics": m,
          "store": stats, "pt2_sha256_equal": True,
          "predictor_bit_equal_buckets": list(rows),
          "corrupted_entry": {"metrics": repaired, "reexport_s": reexport_s,
                              "warm_metrics": rewarm},
          "memory_allocated_after": torch.cuda.memory_allocated(),
          "phase_s": time.perf_counter() - t_phase})


OBS_ROOT = "build/chip_smoke_obs"  # under the checkout, ignored
OBS_STEPS, OBS_CHUNK = 12, 4       # 3 run_steps chunks of the recipe
OBS_REQUESTS, OBS_NEW = 4, 8       # the profiled decode burst
STEPLOG_KEYS = {"epoch", "step", "dt_s", "loss", "fresh_compiles", "t"}


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (return, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def obs_steplog(root):
    """The recipe (flagship widths, RECIPE_FLAGS, one flat Adam group)
    through ``Trainer(steplog=)`` on the card, OBS_STEPS steps as
    ``run_steps`` chunks of OBS_CHUNK: one StepStats line a step with
    the JAX package's keys, ``tools.top --once`` reading them. Returns
    its figures and the kernels' launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.obs.steplog import read_steplog
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.fused_optimizer import fused_flat_update
    from paddle_tpu_torch.tools import top

    path = os.path.join(root, "run.jsonl")

    def train_func():
        _, avg_cost, _ = transformer_base(**TRAIN_MODEL,
                                          sparse_embedding=True,
                                          attn_impl="pallas")
        return avg_cost

    saved = {n: fluid.get_flag(n) for n in RECIPE_FLAGS}
    fluid.set_flags(RECIPE_FLAGS)
    try:
        trainer = fluid.Trainer(
            train_func, lambda: fluid.optimizer.Adam(learning_rate=TRAIN_LR),
            place=fluid.CUDAPlace(0), steplog=path)
    finally:
        fluid.set_flags(saved)
    groups = sum(op.type.endswith("_fused")
                 for op in trainer.train_program.global_block().ops)
    launchers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                 fused_flat_update)
    for fn in launchers:
        reset_counts(fn)
    t0 = time.perf_counter()
    trainer.train(1, reader=persist_reader(OBS_STEPS),
                  feed_order=PERSIST_FEEDS, steps_per_loop=OBS_CHUNK)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer.stop()
    launches = {fn.__name__: fn.launches for fn in launchers}
    want = {fn.__name__: ATTN_PER_STEP * OBS_STEPS for fn in launchers[:3]}
    want["fused_flat_update"] = groups * OBS_STEPS
    if launches != want:
        fail("obs: the steplog Trainer launched %s, expected %s"
             % (launches, want))
    recs = list(read_steplog(path))
    if [r.get("step") for r in recs] != list(range(OBS_STEPS)):
        fail("obs: the steplog holds steps %s, expected 0..%d"
             % ([r.get("step") for r in recs], OBS_STEPS - 1))
    if any(set(r) != STEPLOG_KEYS for r in recs):
        fail("obs: steplog keys %s, expected the JAX package's %s"
             % (sorted({k for r in recs for k in r}), sorted(STEPLOG_KEYS)))
    losses = [r["loss"] for r in recs]
    if not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        fail("obs: steplog losses %s" % losses)
    if sum(r["fresh_compiles"] for r in recs) != 1:
        fail("obs: the steplog counts %d fresh captures, expected 1 (one "
             "graph for the chunks)" % sum(r["fresh_compiles"]
                                           for r in recs))
    rc, text = _quiet(top.main, [path, "--once", "--tail", str(OBS_STEPS)])
    snap = json.loads(text.strip()) if rc == 0 else None
    if snap is None or [r["step"] for r in snap["records"]] != \
            list(range(OBS_STEPS)):
        fail("obs: tools.top --once exited %s on the steplog" % rc)
    del trainer
    torch.cuda.empty_cache()
    return {"steps": OBS_STEPS, "chunk": OBS_CHUNK, "train_s": train_s,
            "losses": losses, "keys": sorted(STEPLOG_KEYS),
            "top_steps_per_sec": snap.get("steps_per_sec"),
            "top_mean_ms_per_step": snap.get("mean_ms_per_step"),
            "launches": launches}


def obs_bundle(root, held):
    """The flight recorder on the server phase's BERT engine: a server
    whose worker loop dies (its batcher broken, so the exception escapes
    the loop) writes an ``-exception`` bundle that ``tools.postmortem
    validate`` accepts, with env pins naming torch, CUDA and the card
    and the 7 bucket captures' fingerprints among its program
    stamps."""
    import threading

    from paddle_tpu_torch.obs import record
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig
    from paddle_tpu_torch.tools import postmortem

    rec_dir = os.path.join(root, "rec")
    record.enable(dir=rec_dir, interval_s=60.0, rolling=False,
                  install_handlers=False)
    hook = threading.excepthook
    died = []
    threading.excepthook = lambda a: died.append(a.exc_type.__name__)
    try:
        server = InferenceServer(held["engine"], config=ServingConfig(
            buckets=SERVER_BUCKETS, batch_timeout_ms=2.0, warm_up=False),
            auto_start=False)
        server.start()
        server.batcher.next_batch = None  # TypeError at the next poll
        server.submit(server_requests()[0])
        server._worker.join(timeout=60)
        if server._worker.is_alive():
            fail("obs: the broken worker did not die")
        server.shutdown(drain=False, timeout=10)
    finally:
        threading.excepthook = hook
        record.disable()
    bundle = record.latest_bundle(rec_dir)
    if bundle is None or not bundle.endswith("-exception"):
        fail("obs: no exception bundle after the worker died (%s)" % bundle)
    rc, text = _quiet(postmortem.main, ["validate", rec_dir])
    if rc != 0:
        fail("obs: tools.postmortem validate exited %s: %s" % (rc, text))
    b = record.read_bundle(bundle)
    env = b["manifest"]["env"]
    want_env = {"torch": torch.__version__, "cuda": torch.version.cuda,
                "device_kind": torch.cuda.get_device_name(0),
                "platform": "cuda"}
    if {k: env.get(k) for k in want_env} != want_env:
        fail("obs: the bundle's env pins %s, expected %s" % (env, want_env))
    stamped = {r["fingerprint"]
               for r in b["manifest"]["stamps"]["fingerprints"]}
    if not set(held["fingerprints"]) <= stamped:
        fail("obs: the bundle's program stamps lack the captured buckets' "
             "fingerprints")
    if "InferenceServer.worker" not in b["errors"][-1]["context"]:
        fail("obs: the bundle's last error is %s" % b["errors"][-1])
    return {"bundle": os.path.basename(bundle), "env": env,
            "stamps": len(stamped), "worker_exception": died,
            "error": b["errors"][-1]["type"],
            "files": len(b["manifest"]["files"])}


def obs_traces(root, model):
    """A decode burst (OBS_REQUESTS prompts, OBS_NEW tokens, captured
    buckets) with structured tracing on and the profiler's device trace:
    the host timeline (``timeline.export_chrome_trace``) and
    ``start_profiler(trace_dir=)``'s chrome trace both pass ``tools.trace
    validate``, the host one holds a trace per request, the device one
    the paged kernel's rows."""
    from paddle_tpu_torch import profiler, timeline
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.obs import trace
    from paddle_tpu_torch.ops import paged_window_attention
    from paddle_tpu_torch.tools import trace as trace_cli

    session, _ = open_session(model, CacheConfig(**SERVING_CACHE))
    prompts = serving_prompts()[:OBS_REQUESTS]
    reset_counts(paged_window_attention)
    profiler.reset_profiler()
    trace.enable()
    profiler.start_profiler("All", trace_dir=os.path.join(root, "device"))
    try:
        futs = [session.submit(p, max_new_tokens=OBS_NEW) for p in prompts]
        session.start()
        streams = [f.result(timeout=600) for f in futs]
    finally:
        session.shutdown(drain=True, timeout=120)
        profiler.stop_profiler(print_report=False)
        trace.disable()
    launches = paged_window_attention.launches
    if any(len(st) != OBS_NEW for st in streams) or launches == 0:
        fail("obs: the traced burst gave %s tokens, %d paged launches"
             % ([len(st) for st in streams], launches))
    host = timeline.export_chrome_trace(os.path.join(root, "host.json"))
    device = profiler.device_trace_path()
    rcs = {}
    for name, path in (("host", host), ("device", device)):
        rcs[name], text = _quiet(trace_cli.main, ["validate", path])
        if rcs[name] != 0:
            fail("obs: tools.trace validate exited %s on the %s trace: %s"
                 % (rcs[name], name, text[-2000:]))
    events = json.load(open(host))["traceEvents"]
    traces = {e["args"]["trace_id"] for e in events
              if e.get("ph") == "X" and (e.get("args") or {}).get(
                  "trace_id")}
    if len(traces) < len(prompts):
        fail("obs: the host trace holds %d structured traces for %d "
             "requests" % (len(traces), len(prompts)))
    dev = [e for e in json.load(open(device))["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "kernel"]
    paged = [e for e in dev if "paged_window_attention" in e["name"]]
    if not paged:
        fail("obs: the device trace shows no paged kernel row (%d kernel "
             "events)" % len(dev))
    torch.cuda.empty_cache()
    return {"requests": len(prompts), "new_tokens": OBS_NEW,
            "paged_launches": launches, "host_spans": sum(
                e.get("ph") == "X" for e in events),
            "host_traces": len(traces), "device_kernel_events": len(dev),
            "device_paged_events": len(paged),
            "device_paged_ms": sum(e.get("dur", 0.0) for e in paged) / 1e3,
            "validate_rcs": rcs}


def phase_obs(card, model, held):
    """The observability tooling on the card: the recipe through
    ``Trainer(steplog=)``, the flight recorder on the server phase's BERT
    engine, a profiled decode burst's host and device traces. Returns
    the launches of the steplog run and of the traced burst."""
    import shutil

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        OBS_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        steplog = obs_steplog(root)
        bundle = obs_bundle(root, held)
        held.clear()  # the server engine goes
        traces = obs_traces(root, model)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the Trainer, the sessions and the engines hold CUDA graphs' pools;
    # some sit in reference cycles, which only the collector frees
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "obs", "card": card, "steplog": steplog,
          "bundle": bundle, "traces": traces,
          "memory_allocated_after": torch.cuda.memory_allocated(),
          "phase_s": time.perf_counter() - t_phase})
    return dict(steplog["launches"],
                paged_window_attention=traces["paged_launches"])


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device is visible (torch.cuda.is_available() is "
             "False)")
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        fail("paddle_tpu_torch is not importable here (%s): run from the "
             "repository root" % e)
    # a float32 matmul on the card is full fp32 by default; set it
    # explicitly, convolutions too, so no check runs in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device()
    rows = phase_kernel()
    flash_rows = phase_flash()
    phase_routes()
    flash_launches, f32_step_ms = phase_training(card)
    torch.cuda.empty_cache()
    n_recipe, n_bert, n_deepfm, n_seq2seq = (
        int(prog.global_block().var("fused_param_storage_0").shape[0])
        for prog in (build_recipe(True)[0],
                     build_bert(BERT_LEGS["phase1"][2])[0],
                     build_deepfm()[0], build_sequence("seq2seq")[0]))
    n_ssd = ssd_conv_group()
    fused_rows = phase_fused_update(card, n_recipe, RESNET_N, n_bert,
                                    n_deepfm, n_seq2seq, n_ssd)
    torch.cuda.empty_cache()
    amp_row, amp_timed = phase_amp(card, RESNET_N, f32_step_ms)
    torch.cuda.empty_cache()
    dropout_rows = phase_dropout(card)
    recipe_launches, recipe_losses, recipe_params, parallel_ref = \
        phase_recipe(card)
    torch.cuda.empty_cache()
    base = phase_run_steps(card, recipe_losses, recipe_params)
    del recipe_params
    torch.cuda.empty_cache()
    parallel_launches = phase_parallel(card, recipe_losses, parallel_ref,
                                       n_recipe)
    del parallel_ref
    offload_launches = phase_offload(card)
    torch.cuda.empty_cache()
    dropout_launches, dropout_step_ms = phase_dropout_recipe(card, base)
    torch.cuda.empty_cache()
    phase_fused_ce(card)
    torch.cuda.empty_cache()
    resnet_launches, resnet_timed = phase_resnet(card)
    vgg_launches, vgg_timed = phase_vgg(card)
    torch.cuda.empty_cache()
    serving_counts, model, greedy = phase_serving(card)
    amp_row["serving"] = phase_amp_serving(card, model, greedy)
    torch.cuda.empty_cache()
    phase_tuning(card, model, n_recipe)
    prefix_counts, prefix_streams = phase_prefix_int8(card, model)
    phase_sampling(card, model, greedy)
    spec_counts = phase_speculative(card, model, greedy)
    torch.cuda.empty_cache()
    resilience_counts = phase_resilience(card, model, greedy,
                                         serving_counts, prefix_streams)
    torch.cuda.empty_cache()
    held = {}
    server_launches = phase_server(card, held)
    torch.cuda.empty_cache()
    ptq_launches = phase_ptq(card)
    torch.cuda.empty_cache()
    obs_launches = phase_obs(card, model, held)
    torch.cuda.empty_cache()
    cache_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              COMPILE_CACHE_ROOT)
    artifact_launches, built = phase_artifact(card, server_launches,
                                              dropout_step_ms, cache_root)
    torch.cuda.empty_cache()
    phase_compile_cache(card, cache_root, built,
                        artifact_launches["export_s"])
    del built
    torch.cuda.empty_cache()
    persist_launches, persist_counts = phase_persist(
        card, model, greedy, base, dropout_step_ms)
    del model
    torch.cuda.empty_cache()
    bert_launches, bert_timed = phase_bert(card)
    deepfm_launches, deepfm_timed = phase_deepfm(card)
    torch.cuda.empty_cache()
    seq = phase_sequence(card)
    if seq["seq2seq"][1] != n_seq2seq:
        fail("seq2seq: the trained group has %d elements, the fused_update "
             "phase timed %d" % (seq["seq2seq"][1], n_seq2seq))
    torch.cuda.empty_cache()
    ssd_launches, ssd_sizes = phase_ssd(card)
    if ssd_sizes[0.1] != n_ssd:
        fail("ssd: the trained conv group has %d elements, the "
             "fused_update phase timed %d" % (ssd_sizes[0.1], n_ssd))
    torch.cuda.empty_cache()
    phase_op_tier(card)
    torch.cuda.empty_cache()
    phase_static(card, [base["timed"], amp_timed, resnet_timed, vgg_timed]
                 + bert_timed + [deepfm_timed])
    torch.cuda.empty_cache()
    remat_launches = phase_remat(card)

    def paged_entry(name, replaces, launches, row):
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/paged_attention.cu",
                "replaces": "paddle_tpu/ops/paged_attention.py:%d"
                            % replaces,
                "launches": launches, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "device_ms": row["device_ms"],
                "library_device_ms": row["library_device_ms"],
                "generic_device_ms": row["generic_device_ms"],
                "kernel_route": row["route"]}

    def kernel_row(T, dtype, pools):
        return next(r for r in rows if r["B"] == 16 and r["T"] == T
                    and r["dtype"] == dtype and r["pools"] == pools)

    # the decode shape, f32 pools (split route; the serving phase's
    # launches, all on that route, and the speculative phase's: the
    # draft's decode steps and the k=3 verify windows)
    kernels = [paged_entry("paged_window_attention", 137,
                           serving_counts["split_launches"]
                           + sum(c["split_launches"]
                                 for c in spec_counts.values()),
                           kernel_row(1, "float32", "float32"))]
    # the persist phase's paths (Trainer B of the dropout recipe, the
    # reloaded decode model) ran these kernels too, counted apart; so did
    # the resilience phase's legs (faults, re-steps, preemption and
    # resumption, the draft and verify faults), by route
    kernels[0]["persist_launches"] = persist_counts["split_launches"]
    res_f32 = [c for leg, c in resilience_counts.items() if leg != "faults"]
    kernels[0]["resilience_launches"] = sum(c["split_launches"]
                                            for c in res_f32)
    # the obs phase's traced decode burst
    kernels[0]["obs_launches"] = obs_launches["paged_window_attention"]
    # the k=8 verify window (T=9): the query-tile route on f32 pools
    kernels.append(paged_entry("paged_window_attention_verify", 200,
                               spec_counts["k8"]["tile_launches"],
                               kernel_row(9, "float32", "float32")))
    # f32 query-tile launches of the resilience phase: the ladder leg's
    # suffix prefills of resumed requests
    kernels[-1]["resilience_launches"] = sum(c["tile_launches"]
                                             for c in res_f32)
    # the int8 variant at the decode shape, f32 queries (every launch of
    # the shared-prompt burst), and its query-tile route at the T=64
    # suffix bucket (the burst's suffix prefills past the threshold)
    kernels.append(paged_entry("paged_window_attention_int8", 218,
                               prefix_counts["int8_launches"],
                               kernel_row(1, "float32", "int8")))
    # the resilience phase's faulted int8 burst, by route
    kernels[-1]["resilience_launches"] = resilience_counts["faults"][
        "int8_launches"]
    kernels.append(paged_entry("paged_window_attention_tile", 200,
                               prefix_counts["tile_launches"],
                               kernel_row(64, "float32", "int8")))
    kernels[-1]["resilience_launches"] = resilience_counts["faults"][
        "tile_launches"]
    # the training path's shape with its key mask (12 of the 18
    # attention calls of a step are key-masked; PERF.md has the rest):
    # f32 with the f32 training phase's launches, bf16 with the recipe's;
    # and bf16 at BERT-base's shape with the bert phase's
    for case, dtype, launches, suffix in (
            ("path_masked", "float32", flash_launches, ""),
            ("path_masked", "bfloat16", recipe_launches, "_bf16"),
            ("bert", "bfloat16", bert_launches, "_bert_bf16")):
        fr = next(r for r in flash_rows if r["case"] == case
                  and r["dtype"] == dtype)
        for name, line, err, plain, lib in (
                ("flash_fwd", 184, fr["errors"]["o"], fr["plain_fwd_ms"],
                 fr["sdpa_fwd_ms"]),
                ("flash_bwd_dq", 250, fr["errors"]["dq"],
                 fr["plain_bwd_ms"], fr["sdpa_bwd_ms"]),
                ("flash_bwd_dkv", 298, max(fr["errors"]["dk"],
                                           fr["errors"]["dv"]),
                 fr["plain_bwd_ms"], fr["sdpa_bwd_ms"])):
            which = "fwd" if name == "flash_fwd" else "bwd"
            kernels.append({
                "name": name + suffix, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                "replaces": "paddle_tpu/ops/flash_attention.py:%d" % line,
                "launches": launches[name], "max_abs_err": err,
                "ms": fr["ms"][name], "plain_ms": plain,
                "bound_ms": fr["bound_ms"][name],
                "bound_by": fr["bound_by"][name], "library_ms": lib,
                "device_ms": fr["device_ms"][name],
                "plain_device_ms": fr["plain_device_ms"][which],
                "library_device_ms": fr["sdpa_device_ms"][which]})
            if suffix == "_bf16":
                # the AMP recipe (the amp phase: 10 eager steps and one
                # run_steps call of 10) runs this shape in bf16 too
                kernels[-1]["amp_launches"] = amp_row["launches"][name]
                # the parallel phase's dp=2 ranks (AllReduce and Reduce,
                # 5 steps each, both ranks) at B=16 a rank
                kernels[-1]["parallel_launches"] = (
                    parallel_launches["allreduce"][name]
                    + parallel_launches["reduce"][name])
                kernels[-1]["persist_launches"] = persist_launches[name]
                kernels[-1]["bert_launches"] = bert_launches[name]
                # the dropout recipe's trainable artifact, 10 run steps
                kernels[-1]["artifact_launches"] = artifact_launches[
                    "training"][name]
                # the obs phase's Trainer(steplog=): 12 replayed steps
                kernels[-1]["obs_launches"] = obs_launches[name]
            if suffix == "_bert_bf16":
                # the remat phase's level-1 run (20 steps at the phase-2
                # shape): the recompute relaunches the forward
                kernels[-1]["remat_launches"] = remat_launches[name]
                if name == "flash_fwd":
                    # the server phase: 12 launches an executed batch;
                    # the artifact phase's server, the same
                    kernels[-1]["server_launches"] = server_launches[
                        "flash_fwd"]
                    kernels[-1]["artifact_launches"] = artifact_launches[
                        "serving_flash_fwd"]
    # the training path at a rank's 4 heads under tp=2, with the parallel
    # phase's tensor-parallel launches (both ranks, 5 steps)
    fr = next(r for r in flash_rows if r["case"] == "path_masked_tp")
    for name, line, err, plain, lib, way in (
            ("flash_fwd", 184, fr["errors"]["o"], fr["plain_fwd_ms"],
             fr["sdpa_fwd_ms"], "fwd"),
            ("flash_bwd_dq", 250, fr["errors"]["dq"], fr["plain_bwd_ms"],
             fr["sdpa_bwd_ms"], "bwd"),
            ("flash_bwd_dkv", 298, max(fr["errors"]["dk"],
                                       fr["errors"]["dv"]),
             fr["plain_bwd_ms"], fr["sdpa_bwd_ms"], "bwd")):
        kernels.append({
            "name": name + "_tp_bf16", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/flash_attention.py:%d" % line,
            "launches": parallel_launches["tp"][name],
            "parallel_launches": parallel_launches["tp"][name],
            "max_abs_err": err, "ms": fr["ms"][name], "plain_ms": plain,
            "bound_ms": fr["bound_ms"][name],
            "bound_by": fr["bound_by"][name], "library_ms": lib,
            "device_ms": fr["device_ms"][name],
            "plain_device_ms": fr["plain_device_ms"][way],
            "library_device_ms": fr["sdpa_device_ms"][way]})
    # the f32 forward at BERT-base's shape (row 1d): the ptq phase's int8
    # BERT-base keeps its attention in f32, 12 launches an executed batch
    fr = next(r for r in flash_rows if r["case"] == "bert"
              and r["dtype"] == "float32")
    kernels.append({
        "name": "flash_fwd_bert_f32", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:184",
        "launches": ptq_launches["flash_fwd"],
        "max_abs_err": fr["errors"]["o"], "ms": fr["ms"]["flash_fwd"],
        "plain_ms": fr["plain_fwd_ms"],
        "bound_ms": fr["bound_ms"]["flash_fwd"],
        "bound_by": fr["bound_by"]["flash_fwd"],
        "library_ms": fr["sdpa_fwd_ms"],
        "device_ms": fr["device_ms"]["flash_fwd"],
        "plain_device_ms": fr["plain_device_ms"]["fwd"],
        "library_device_ms": fr["sdpa_device_ms"]["fwd"]})
    # the recipe's own group: Adam, bf16 moments, owning the beta powers
    fu = next(r for r in fused_rows if r["n"] == n_recipe
              and (r["kind"], r["moments"], r["owns"]) == ("adam", "bf16",
                                                           True))
    kernels.append({
        "name": "fused_flat_update", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
        "replaces": "paddle_tpu/ops/fused_optimizer.py:71",
        "launches": recipe_launches["fused_flat_update"],
        "max_abs_err": max(r["max_abs_err"] for r in fused_rows),
        "ms": fu["ms"], "plain_ms": fu["plain_ms"],
        "bound_ms": fu["bound_ms"], "bound_by": fu["bound_by"],
        "library_ms": fu["library_ms"], "device_ms": fu["device_ms"],
        "library_device_ms": fu["library_device_ms"],
        "persist_launches": persist_launches["fused_flat_update"],
        "bert_launches": bert_launches["fused_flat_update"],
        "deepfm_launches": deepfm_launches,
        "artifact_launches": artifact_launches["training"][
            "fused_flat_update"],
        "obs_launches": obs_launches["fused_flat_update"],
        # the offload phase's steps with host_offload: the moments come
        # back from pinned host memory before each launch
        "offload_launches": offload_launches["fused_flat_update"],
        "seq2seq_launches": seq["seq2seq"][0],
        "sentiment_launches": seq["sentiment"][0],
        "srl_launches": seq["srl"][0],
        # the parallel phase's AllReduce ranks and its tp ranks' smaller
        # group (the tp-split weights stay out of it)
        "parallel_launches": parallel_launches["allreduce"][
            "fused_flat_update"] + parallel_launches["tp"][
            "fused_flat_update"]})
    # the recipe's group at one rank's ZeRO half (Reduce over two ranks)
    fz = next(r for r in fused_rows if r["n"] == n_recipe // 2
              and (r["kind"], r["moments"], r["owns"]) == ("adam", "bf16",
                                                           True))
    kernels.append({
        "name": "fused_flat_update_zero", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
        "replaces": "paddle_tpu/ops/fused_optimizer.py:71",
        "launches": parallel_launches["reduce"]["fused_flat_update"],
        "parallel_launches": parallel_launches["reduce"][
            "fused_flat_update"],
        "max_abs_err": fz["max_abs_err"], "ms": fz["ms"],
        "plain_ms": fz["plain_ms"], "bound_ms": fz["bound_ms"],
        "bound_by": fz["bound_by"], "library_ms": fz["library_ms"],
        "device_ms": fz["device_ms"],
        "library_device_ms": fz["library_device_ms"], "n": fz["n"]})
    # the gated Adam of the AMP path, timed at the AMP recipe's group
    # shape (its N, f32 moments, owning the beta powers): its launches on
    # the AMP recipe, the skipped ones of the overflow replay
    ga = amp_row["gate"]
    kernels.append({
        "name": "fused_flat_update_amp", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
        "replaces": "paddle_tpu/ops/fused_optimizer.py:71",
        "launches": amp_row["launches"]["fused_flat_update"],
        "gated_launches": amp_row["launches"]["gated"],
        "skipped_launches": amp_row["overflow"]["skipped_launches"],
        "overflow_replay_launches": amp_row["overflow"]["gated_launches"],
        "accumulation_launches": amp_row["accumulation"]["gated_launches"],
        "max_abs_err": ga["max_abs_err"], "ms": ga["ms"],
        "plain_ms": ga["plain_ms"], "bound_ms": ga["bound_ms"],
        "bound_by": ga["bound_by"], "library_ms": ga["library_ms"],
        "device_ms": ga["device_ms"],
        "library_device_ms": ga["library_device_ms"],
        "skipped_ms": ga["skipped_ms"],
        "skipped_device_ms": ga["skipped_device_ms"],
        "skipped_bound_ms": ga["skipped_bound_ms"],
        "library_skipped_ms": ga["library_skipped_ms"],
        "ungated_ms": ga["ungated_ms"],
        "ungated_device_ms": ga["ungated_device_ms"], "n": ga["n"],
        "moments": ga["moments"]})
    # BERT-base's group (Adam, bf16 moments), DeepFM's and the seq2seq
    # NMT's (Adam, f32)
    for name, n, moments, launches in (
            ("fused_flat_update_bert", n_bert, "bf16",
             bert_launches["fused_flat_update"]),
            ("fused_flat_update_deepfm", n_deepfm, "f32",
             deepfm_launches),
            ("fused_flat_update_seq2seq", n_seq2seq, "f32",
             seq["seq2seq"][0])):
        fm = next(r for r in fused_rows if r["n"] == n
                  and (r["kind"], r["moments"]) == ("adam", moments))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "replaces": "paddle_tpu/ops/fused_optimizer.py:71",
            "launches": launches, "max_abs_err": fm["max_abs_err"],
            "ms": fm["ms"], "plain_ms": fm["plain_ms"],
            "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
            "library_ms": fm["library_ms"], "device_ms": fm["device_ms"],
            "library_device_ms": fm["library_device_ms"], "n": n})
        if name == "fused_flat_update_bert":
            kernels[-1]["remat_launches"] = remat_launches[
                "fused_flat_update"]
    # MobileNet-SSD's conv group: RMSProp, f32 moments, lr scale 0.1;
    # the launches of the ssd phase's replay (both groups, 10 steps)
    rm = next(r for r in fused_rows if r["label"] == "rmsprop_ssd")
    kernels.append({
        "name": "fused_flat_update_rmsprop", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
        "replaces": "paddle_tpu/ops/fused_optimizer.py:71",
        "launches": ssd_launches, "max_abs_err": rm["max_abs_err"],
        "ms": rm["ms"], "plain_ms": rm["plain_ms"],
        "bound_ms": rm["bound_ms"], "bound_by": rm["bound_by"],
        "library_ms": rm["library_ms"], "device_ms": rm["device_ms"],
        "library_device_ms": rm["library_device_ms"], "n": n_ssd})
    # ResNet-50's group: Momentum with a bf16 velocity
    mo = next(r for r in fused_rows if r["n"] == RESNET_N
              and (r["label"], r["moments"]) == ("momentum", "bf16"))
    kernels.append({
        "name": "fused_flat_update_momentum", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
        "replaces": "paddle_tpu/ops/fused_optimizer.py:71",
        "launches": resnet_launches,
        "max_abs_err": max(r["max_abs_err"] for r in fused_rows
                           if r["kind"] == "momentum"),
        "ms": mo["ms"], "plain_ms": mo["plain_ms"],
        "bound_ms": mo["bound_ms"], "bound_by": mo["bound_by"],
        "library_ms": mo["library_ms"], "device_ms": mo["device_ms"],
        "library_device_ms": mo["library_device_ms"]})
    # the dropout kernel at the recipe's FFN mask ([32, 256, 2048] bf16,
    # p = 0.1), with the dropout recipe's launches (62 sites, forward
    # and backward, 10 steps); VGG-16's in vgg_launches
    dr = next(r for r in dropout_rows
              if r["shape"] == [TRAIN_B, TRAIN_T, 2048]
              and r["dtype"] == "bfloat16" and r["p"] == 0.1)
    kernels.append({
        "name": "dropout", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/dropout.cu",
        "replaces": "paddle_tpu/layers/nn.py:649",
        "launches": dropout_launches,
        "max_abs_err": max(r["max_abs_err"] for r in dropout_rows),
        "ms": dr["ms"], "plain_ms": dr["plain_ms"],
        "bound_ms": dr["bound_ms"], "bound_by": dr["bound_by"],
        "library_ms": None, "device_ms": dr["device_ms"],
        "f_dropout_ms": dr["f_dropout_ms"],
        "vgg_launches": vgg_launches,
        "persist_launches": persist_launches["dropout_apply"],
        "bert_launches": bert_launches["dropout_apply"],
        "artifact_launches": artifact_launches["training"][
            "dropout_apply"]})
    # at BERT-base's FFN mask ([64, 128, 3072] bf16, p = 0.1), with the
    # bert phase's launches (49 sites, forward and backward, 10 steps)
    db = next(r for r in dropout_rows if r["shape"] == [64, 128, 3072])
    kernels.append({
        "name": "dropout_bert", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/dropout.cu",
        "replaces": "paddle_tpu/layers/nn.py:649",
        "launches": bert_launches["dropout_apply"],
        "max_abs_err": db["max_abs_err"], "ms": db["ms"],
        "plain_ms": db["plain_ms"], "bound_ms": db["bound_ms"],
        "bound_by": db["bound_by"], "library_ms": None,
        "device_ms": db["device_ms"], "f_dropout_ms": db["f_dropout_ms"],
        "remat_launches": remat_launches["dropout_apply"]})
    emit({"phase": "call", "card": card,
          "call_s": time.perf_counter() - T_START})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
