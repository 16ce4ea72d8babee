#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path on one NVIDIA card and hold every
kernel of that path to its plain torch version.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc.
Phases, one JSON line each (or one per shape):

1. device  — the card's name and power limit (nvidia-smi); builds the
             kernels from csrc/ (paged_attention.cu, flash_attention.cu,
             fused_optimizer.cu; one nvcc each, started together) and
             reports the build seconds, ptxas' register/spill report, and
             each flash kernel's shared bytes and blocks an SM.
2. kernel  — ``ops.paged_window_attention`` (the CUDA kernels) against
             ``ops.plain_window_attention`` on the card at the decode
             shapes (B in {1, 16}, T in {1, 4}, H=8, D=64, block 16,
             32 pages per sequence; random cached lengths, -1 padding
             pages, one inactive row), f32 and bf16 pools, also at
             the suffix windows T in {64, 512}; and int8 pools (the same
             K/V quantized per slot, f32 scales) with f32 and bf16
             queries at T in {1, 4, 64, 512}. Each row checks the route
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
             32 new tokens each). Checks every request completes, the
             kernel launched at least 6 times per decode step, all on
             the split route (none on the generic one), and two
             streams equal greedy decoding by the full unpaged forward.
4. flash   — the three flash-attention kernels (``flash_fwd``,
             ``flash_bwd_dq``, ``flash_bwd_dkv``) against
             ``plain_flash_forward`` / ``plain_flash_backward`` on the
             card: the training path's shape (B=32, T=256, H=8, D=64)
             unmasked, causal and key-masked (ragged tails), a ragged
             cross shape (Tq=200, Tk=333), the long-context shape (B=4,
             T=2048) plain and causal, and D=128 (B=4, T=512, H=4,
             causal, key-masked), each in f32 and bf16.
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
             long-context shapes and D=128 also device times
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
             ``plain_flat_update`` on the card: SGD, Adagrad and Adam,
             Adam with and without the beta-power advance, f32 and bf16
             moments, at N = the recipe's flat group size and a ragged
             N = 128*4099+37. Every output bit-equal (max abs error 0).
             CUDA-event ms of the kernel and the plain version, the
             bound (bytes read and written once over 3.35 TB/s), and
             ``torch._fused_adam_`` (what ``torch.optim.Adam(fused=True)``
             calls) over the same flat tensors with f32 moments, a time
             yardstick only (it places eps differently).
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
             streams' token agreement with the f32 ones.

Then the card's name and power limit, the kernels JSON line (wall and
device ms of each kernel and its library call), and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero. Without a visible CUDA device — or outside a checkout that
holds ``paddle_tpu_torch`` — it exits non-zero and prints no result.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

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
       for B in (1, 16) for T in (1, 4, 64, 512)])

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
]
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}  # of max |grad|
# flash cases whose rows also carry device times (device_ms): the
# training shape with its key mask, the long-context shapes, and D=128
DEVICE_CASES = ("path_masked", "long", "long_causal", "d128")


def emit(obj) -> None:
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


KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_optimizer")


def phase_device():
    from paddle_tpu_torch.ops import (_cuda, flash_attention, fused_optimizer,
                                      paged_attention)

    card = card_line()
    t0 = time.perf_counter()
    _cuda.build_all(KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    paged_attention.build()
    flash_attention.build()
    fused_optimizer.build()
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


def build_model():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.causal_lm import causal_lm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, logits = causal_lm(**MODEL)
    scope = fluid.Scope()
    fluid.params_from_numpy(seeded_weights(main), scope, fluid.CUDAPlace(0),
                            program=main)
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


def serve_burst(model, cache, prompts, counters=()):
    """Serve ``prompts`` as one burst of concurrent requests (32 new
    tokens each) through ``serve_decoding`` on the card with ``cache``.
    Each launcher in ``counters`` has its counts set to 0 after the
    session's warm-up, just before the burst. Returns a dict: streams,
    wall seconds, TTFTs, the metrics report, the pools' bytes, the
    warm-up seconds and peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import DecodingConfig, serve_decoding

    main, logits, scope = model
    config = DecodingConfig(cache=cache, decode_buckets=(1, 2, 4, 8, 16),
                            max_new_tokens=MAX_NEW)
    t0 = time.perf_counter()
    session = serve_decoding(main, "tokens", logits.name, scope=scope,
                             config=config, place=fluid.CUDAPlace(0))
    warm_s = time.perf_counter() - t0
    first_t, submit_t = {}, {}

    def on_token(i):
        def cb(tok):
            first_t.setdefault(i, time.perf_counter())
        return cb

    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        reset_counts(fn)
    try:
        t0 = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            submit_t[i] = time.perf_counter()
            futs.append(session.submit(p, max_new_tokens=MAX_NEW,
                                       on_token=on_token(i)))
        streams = [f.result(timeout=600) for f in futs]
        wall_s = time.perf_counter() - t0
    finally:
        session.shutdown(drain=True, timeout=120)
    if len(streams) != len(prompts) or any(len(s) != MAX_NEW
                                           for s in streams):
        fail("not every request completed with %d tokens (%s)"
             % (MAX_NEW, cache))
    ttft = np.asarray([(first_t[i] - submit_t[i]) * 1e3
                       for i in range(len(prompts))])
    return {"streams": streams, "wall_s": wall_s, "ttft": ttft,
            "report": session.metrics.report(), "warm_up_s": warm_s,
            "pool_bytes": session.engine.pair.pool_bytes,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def burst_row(run):
    """The end-to-end numbers of one burst."""
    rep, ttft = run["report"], run["ttft"]
    n_tokens = sum(len(s) for s in run["streams"])
    row = {"requests": len(run["streams"]), "tokens": n_tokens,
           "wall_s": run["wall_s"], "tokens_per_s": n_tokens / run["wall_s"],
           "decode_steps": rep["decode_step_ms"]["count"],
           "mean_decode_step_ms": rep["decode_step_ms"]["mean"],
           "p50_decode_step_ms": rep["decode_step_ms"]["p50"],
           "ttft_ms_mean": float(ttft.mean()),
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_max": float(ttft.max()),
           "warm_up_s": run["warm_up_s"], "pool_bytes": run["pool_bytes"],
           "max_memory_allocated": run["max_memory_allocated"]}
    for name in ("prefill_ms", "extend_ms"):
        if name in rep:
            row["mean_" + name] = rep[name]["mean"]
            row[name.replace("_ms", "s")] = rep[name]["count"]
    return row


def phase_serving(card):
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import paged_window_attention

    model = build_model()
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, MODEL["vocab_size"],
                           size=rng.randint(16, 201)).tolist()
               for _ in range(N_REQUESTS)]
    run = serve_burst(model, CacheConfig(num_blocks=512, block_size=16,
                                         max_blocks_per_seq=32),
                      prompts, counters=(paged_window_attention,))
    counts = route_counts(paged_window_attention)
    launches = counts["launches"]
    steps = run["report"]["decode_step_ms"]["count"]
    if launches < MODEL["n_layer"] * steps or launches == 0:
        fail("kernel launched %d times over %d decode steps of %d layers"
             % (launches, steps, MODEL["n_layer"]))
    # every decode launch (T=1) takes the split route
    if counts["generic_launches"] or counts["split_launches"] < \
            MODEL["n_layer"] * steps or counts["split_launches"] + \
            counts["tile_launches"] != launches:
        fail("serving: the paged launches did not take the split route "
             "(decode) and the query-tile route only: %s" % counts)
    emit({"phase": "serving", "card": card, **burst_row(run),
          "kernel_launches": launches, "route_launches": counts})
    check_oracle(*model, prompts, run["streams"])
    return counts, model


def first_divergence(a, b):
    """Index of the first token where two streams differ, or None."""
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_prefix_int8(card, model):
    """Shared-prompt serving with prefix caching on int8 pools, and the
    same traffic on f32 pools with and without prefix caching."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import CacheConfig
    from paddle_tpu_torch.ops import paged_window_attention

    rng = np.random.RandomState(SEED + 3)
    system = rng.randint(0, MODEL["vocab_size"], size=SYSTEM_PROMPT).tolist()
    prompts = [system + rng.randint(0, MODEL["vocab_size"], size=rng.randint(
        SUFFIX_TOKENS[0], SUFFIX_TOKENS[1] + 1)).tolist()
        for _ in range(N_REQUESTS)]
    geo = dict(num_blocks=512, block_size=16, max_blocks_per_seq=32)
    runs = {}
    for name, kw in (("int8", dict(kv_dtype="int8", prefix_cache=True)),
                     ("f32", dict(prefix_cache=True)), ("f32_nocache", {})):
        runs[name] = serve_burst(model, CacheConfig(**geo, **kw), prompts,
                                 counters=(paged_window_attention,))
        if name == "int8":
            counts = route_counts(paged_window_attention)
            launches = counts["launches"]
            int8_launches = counts["int8_launches"]
    rep = runs["int8"]["report"]
    calls = (rep["decode_step_ms"]["count"] + rep["extend_ms"]["count"])
    want = (N_REQUESTS - 1, 1, (N_REQUESTS - 1) * SYSTEM_PROMPT)
    for name in ("int8", "f32"):
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
            MODEL["n_layer"] * rep["decode_step_ms"]["count"] or \
            counts["tile_launches"] < MODEL["n_layer"] or \
            counts["split_launches"] + counts["tile_launches"] != launches:
        fail("prefix_int8: the paged launches did not take the split and "
             "query-tile routes: %s" % counts)
    # f32 pools: prefix caching must not change the streams, except
    # where the full forward's top-2 logit gap says the two are a tie
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, logits, scope = model
    near_ties = []
    for i, (a, b) in enumerate(zip(runs["f32"]["streams"],
                                   runs["f32_nocache"]["streams"])):
        j = first_divergence(a, b)
        if j is None:
            continue
        out, = exe.run(main, feed={"tokens": np.asarray(
            [prompts[i] + b[:j]], np.int64)}, fetch_list=[logits],
            scope=scope)
        top2 = np.sort(out[0, -1])[-2:]
        gap = float(top2[1] - top2[0])
        if gap >= 1e-3:
            fail("request %d token %d: prefix caching served %d, without "
                 "it %d (top-2 gap %g)" % (i, j, a[j], b[j], gap))
        near_ties.append({"request": i, "token": j, "top2_gap": gap})
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
           "f32_near_ties": near_ties,
           "int8_vs_f32_streams_identical": sum(a is None for a in agree),
           "int8_vs_f32_tokens_equal": same,
           "int8_vs_f32_first_divergence": agree}
    for name, run in runs.items():
        row[name] = burst_row(run)
    emit(row)
    return counts


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


def profile_step(run_step, top=15, family_launches=None):
    """One training step under torch.profiler: (host wall ms, device ms
    by kernel family, kernel launches, the ``top`` kernels by device ms
    as [name, ms, launches] rows). A dict passed as ``family_launches``
    receives the kernels launched by family."""
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
        fam = _train_family(e.name)
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
    return launches


# ---------------------------------------------------------------- phase 7


# bench.py's mixed-precision recipe (bench.py:80-86, :120)
RECIPE_FLAGS = {"use_bfloat16": True, "bf16_activations": True,
                "bf16_moments": True, "fuse_optimizer_state": True}
FUSED_CONSTS = {"sgd": (1.0,), "adagrad": (1.0, 1e-6),
                "adam": (1.0, 0.9, 0.999, 1e-8)}
# (kind, bf16 moments, owns the beta-power advance); the recipe's group
# is the last one
FUSED_CASES = [("sgd", False, False), ("adagrad", False, False),
               ("adagrad", True, False), ("adam", False, False),
               ("adam", False, True), ("adam", True, False),
               ("adam", True, True)]
RAGGED_N = 128 * 4099 + 37
# flops per element of each kind's update, in the plain version's order
FUSED_OPS = {"sgd": 2, "adagrad": 7, "adam": 12}


def build_recipe(fuse):
    """(main, startup, avg_cost) of the recipe, with
    ``fuse_optimizer_state`` as ``fuse``; the flags are read while the
    program is built."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import transformer_base

    values = dict(RECIPE_FLAGS, fuse_optimizer_state=fuse)
    saved = {n: fluid.get_flag(n) for n in values}
    fluid.set_flags(values)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, avg_cost, _ = transformer_base(
                **TRAIN_MODEL, sparse_embedding=True, attn_impl="pallas")
            fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(avg_cost)
    finally:
        fluid.set_flags(saved)
    return main, startup, avg_cost


def fused_inputs(kind, bf16, n, seed):
    """(p, g, lr, moments, shared scalars) on the card, from a seeded
    generator: normals, Adam's first moment 0.1 N(0, 1), the other
    moments squares of normals, beta powers of step 3."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda: torch.randn(n, generator=gen, device=dev)  # noqa: E731
    accs = []
    for i in range({"sgd": 0, "adagrad": 1, "adam": 2}[kind]):
        a = rand()
        a = 0.1 * a if (kind, i) == ("adam", 0) else a * a
        accs.append(a.to(torch.bfloat16 if bf16 else torch.float32))
    shared = ((torch.tensor(0.9 ** 3, device=dev),
               torch.tensor(0.999 ** 3, device=dev)) if kind == "adam"
              else ())
    return rand(), rand(), torch.tensor(TRAIN_LR, device=dev), accs, shared


def fused_work(kind, bf16, owns, n):
    """(bound ms, bound_by, bytes, ops): p and g read and p written, each
    moment read and written, lr and the shared scalars read and the
    advanced ones written, once; the update's flops over the f32 peak."""
    n_acc = {"sgd": 0, "adagrad": 1, "adam": 2}[kind]
    n_sh = 2 if kind == "adam" else 0
    nbytes = (n * (12 + 2 * n_acc * (2 if bf16 else 4))
              + 4 * (1 + n_sh + (n_sh if owns else 0)))
    ops = FUSED_OPS[kind] * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[torch.float32] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def phase_fused_update(card, n_recipe):
    """Every case bit-equal to the plain version at the recipe's group
    size and a ragged size; times at the recipe's size."""
    from paddle_tpu_torch.ops.fused_optimizer import (fused_flat_update,
                                                      plain_flat_update)

    rows = []
    for n in (n_recipe, RAGGED_N):
        for i, (kind, bf16, owns) in enumerate(FUSED_CASES):
            consts = FUSED_CONSTS[kind]
            p, g, lr, accs, shared = fused_inputs(kind, bf16, n, 200 + i)
            want = plain_flat_update(kind, p, g, lr, accs, shared, owns,
                                     consts)
            # the kernel updates p and the moments in place: copies
            got = fused_flat_update(kind, p.clone(), g, lr,
                                    [a.clone() for a in accs], shared, owns,
                                    consts)
            torch.cuda.synchronize()
            if len(got) != len(want) or not all(
                    a.dtype == b.dtype and a.shape == b.shape
                    for a, b in zip(got, want)):
                fail("fused_update %s: kernel outputs %s, plain %s"
                     % ((kind, bf16, owns, n),
                        [(a.dtype, tuple(a.shape)) for a in got],
                        [(b.dtype, tuple(b.shape)) for b in want]))
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
            if err != 0.0 or not all(torch.equal(a, b)
                                     for a, b in zip(got, want)):
                fail("fused_update %s: the kernel is not bit-equal to the "
                     "plain version (max abs err %g)"
                     % ((kind, bf16, owns, n), err))
            row = {"phase": "fused_update", "card": card, "kind": kind,
                   "moments": "bf16" if bf16 else "f32", "owns": owns,
                   "n": n, "max_abs_err": err, "bit_equal": True}
            if n == n_recipe:
                pk, ak = p.clone(), [a.clone() for a in accs]
                row["ms"] = cuda_ms(lambda: fused_flat_update(
                    kind, pk, g, lr, ak, shared, owns, consts), 20)
                row["plain_ms"] = cuda_ms(lambda: plain_flat_update(
                    kind, p, g, lr, accs, shared, owns, consts), 5, warmup=1)
                (row["bound_ms"], row["bound_by"], row["bytes"],
                 row["ops"]) = fused_work(kind, bf16, owns, n)
                row["device_ms"] = device_ms(lambda: fused_flat_update(
                    kind, pk, g, lr, ak, shared, owns, consts), 10)
                row["library_ms"] = row["library_device_ms"] = None
                if kind == "adam":
                    (row["library_ms"], row["library_device_ms"],
                     row["library_error"]) = fused_adam_ms(p, g, accs)
                del pk, ak
            emit(row)
            rows.append(row)
            del p, g, lr, accs, shared, want, got
            torch.cuda.empty_cache()
    return rows


def fused_adam_ms(p, g, accs):
    """(wall ms, device ms, error) of ``torch._fused_adam_`` — what
    ``torch.optim.Adam(fused=True)`` calls — over the same flat tensors
    with f32 moments; (None, None, the error) where this torch lacks
    it."""
    pl = p.clone()
    m1, m2 = (a.float().clone() for a in accs)
    step = torch.tensor(3.0, device=p.device)
    def call():
        torch._fused_adam_(
            [pl], [g], [m1], [m2], [], [step], lr=TRAIN_LR, beta1=0.9,
            beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
            maximize=False)

    try:
        return cuda_ms(call, 20), device_ms(call, 10), None
    except (AttributeError, RuntimeError, TypeError) as e:
        return None, None, repr(e)


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
    return launches, losses, final


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
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        fluid.params_from_numpy(seeded_weights(main), scope, place,
                                program=main)
        return exe, scope

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
    flash_launches = phase_training(card)
    torch.cuda.empty_cache()
    n_recipe = int(build_recipe(True)[0].global_block().var(
        "fused_param_storage_0").shape[0])
    fused_rows = phase_fused_update(card, n_recipe)
    recipe_launches, recipe_losses, recipe_params = phase_recipe(card)
    torch.cuda.empty_cache()
    phase_run_steps(card, recipe_losses, recipe_params)
    del recipe_params
    torch.cuda.empty_cache()
    serving_counts, model = phase_serving(card)
    prefix_counts = phase_prefix_int8(card, model)
    del model
    torch.cuda.empty_cache()

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
    # launches, all on that route)
    kernels = [paged_entry("paged_window_attention", 137,
                           serving_counts["split_launches"],
                           kernel_row(1, "float32", "float32"))]
    # the int8 variant at the decode shape, f32 queries (every launch of
    # the shared-prompt burst), and its query-tile route at the T=64
    # suffix bucket (the burst's suffix prefills past the threshold)
    kernels.append(paged_entry("paged_window_attention_int8", 218,
                               prefix_counts["int8_launches"],
                               kernel_row(1, "float32", "int8")))
    kernels.append(paged_entry("paged_window_attention_tile", 200,
                               prefix_counts["tile_launches"],
                               kernel_row(64, "float32", "int8")))
    # the training path's shape with its key mask (12 of the 18
    # attention calls of a step are key-masked; PERF.md has the rest):
    # f32 with the f32 training phase's launches, bf16 with the recipe's
    for dtype, launches, suffix in (("float32", flash_launches, ""),
                                    ("bfloat16", recipe_launches, "_bf16")):
        fr = next(r for r in flash_rows if r["case"] == "path_masked"
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
        "library_device_ms": fu["library_device_ms"]})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
