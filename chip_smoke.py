#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path on one NVIDIA card and hold every
kernel of that path to its plain torch version.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc.
Phases, one JSON line each:

1. device  — the card's name and power limit (nvidia-smi); builds the
             paged-attention kernel from csrc/ with nvcc and reports the
             build seconds and ptxas' register/spill report.
2. kernel  — ``ops.paged_window_attention`` (the CUDA kernel) against
             ``ops.plain_window_attention`` on the card at the decode
             shapes (B in {1, 16}, T in {1, 4}, H=8, D=64, block 16,
             32 pages per sequence; random cached lengths, -1 padding
             pages, one inactive row), f32 and bf16: max abs error over
             rows with a valid key, finiteness everywhere, and CUDA-event
             times of the kernel, the plain version and
             ``F.scaled_dot_product_attention`` over the pre-gathered
             window (gather excluded), beside the byte/flop bound.
3. serving — ``serve_decoding`` of a Transformer-base-width causal LM
             (vocab 32000, 6 layers, 8 heads, d_model 512, FFN 2048;
             random weights from a numpy seed) on ``CUDAPlace(0)``
             answering 16 concurrent requests (prompts of 16-200 tokens,
             32 new tokens each). Checks every request completes, the
             kernel launched at least 6 times per decode step, and two
             streams equal greedy decoding by the full unpaged forward.

Then the card's name and power limit, the kernels JSON line, and as the
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
L2_BYTES = 50 * 2 ** 20

# paged-attention decode shapes
H, D, BS, MB, NB = 8, 64, 16, 32, 512

# Transformer-base widths (the repo's flagship config, bench.py)
MODEL = dict(vocab_size=32000, n_layer=6, n_head=8, d_model=512,
             d_inner_hid=2048)
N_REQUESTS = 16
MAX_NEW = 32
SEED = 0


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


# ---------------------------------------------------------------- phase 1


def phase_device():
    from paddle_tpu_torch.ops import _cuda, paged_attention

    card = card_line()
    t0 = time.perf_counter()
    paged_attention.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             _cuda.build_logs.get("paged_attention", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "ptxas": ptxas})
    return card


# ---------------------------------------------------------------- phase 2


def make_problem(B, T, dtype, seed, inactive_row):
    """A paged-window problem at the decode shapes: each sequence owns
    its own random pages (as the allocator hands them out), a random
    number of them valid and the rest -1, and a cached length inside
    its valid span. The inactive row has an all -1 table and position
    -1, as the engine pads a decode batch."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda", 0)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    pages = rng.permutation(NB)
    tables = np.full((B, MB), -1, np.int32)
    cached = np.zeros(B, np.int32)
    for b in range(B):
        n_valid = rng.randint(1, MB + 1)
        tables[b, :n_valid] = pages[b * MB:b * MB + n_valid]
        cached[b] = rng.randint(0, n_valid * BS - T + 1)
    if inactive_row:
        tables[-1] = -1
        cached[-1] = -1
    as_t = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    return (as_t(q, dtype), as_t(kp, dtype), as_t(vp, dtype),
            as_t(tables, torch.int32), as_t(cached, torch.int32))


def window_masks(tables, cached, T):
    """(per-(b, t) key mask [B, T, S], rows with a valid key [B, T])."""
    B = tables.shape[0]
    S = MB * BS
    pos = cached.long()[:, None] + torch.arange(T, device=tables.device)
    page_ok = (tables.long() >= 0).repeat_interleave(BS, dim=1)   # [B, S]
    m = ((torch.arange(S, device=tables.device)[None, None, :]
          <= pos[:, :, None]) & page_ok[:, None, :])
    return m, m.any(-1)


def work(tables, cached, T, dtype):
    """Bytes the function must move and operations it must do for these
    inputs: each valid K/V row read once (all heads), q and out once,
    the tables and lengths; two flops per multiply-add of QK and PV."""
    m, _ = window_masks(tables, cached, T)
    B = tables.shape[0]
    item = torch.finfo(dtype).bits // 8
    last = (cached.long() + T - 1)[:, None]
    page_ok = (tables.long() >= 0).repeat_interleave(BS, dim=1)
    rows_read = int(((torch.arange(MB * BS, device=tables.device)[None, :]
                      <= last) & page_ok).sum())
    nbytes = (rows_read * H * 2 * D * item + 2 * B * T * H * D * item
              + tables.numel() * 4 + cached.numel() * 4)
    ops = int(m.sum()) * H * 2 * (2 * D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def phase_kernel():
    from paddle_tpu_torch.ops import (paged_window_attention,
                                      plain_window_attention)

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 16):
            for T in (1, 4):
                prob = make_problem(B, T, dtype, seed=B * 10 + T,
                                    inactive_row=B > 1)
                out = paged_window_attention(*prob)
                ref = plain_window_attention(*prob)
                torch.cuda.synchronize()
                _, valid = window_masks(prob[3], prob[4], T)
                err = float((out.float() - ref.float()).abs()[valid].max())
                finite = bool(torch.isfinite(out).all())
                if not finite:
                    fail("kernel output not finite (B=%d T=%d %s)"
                         % (B, T, dtype))
                if not err <= TOL[dtype]:
                    fail("kernel disagrees with the plain version: max abs "
                         "err %g > %g (B=%d T=%d %s)"
                         % (err, TOL[dtype], B, T, dtype))
                rows.append(dict(B=B, T=T, dtype=str(dtype)[6:],
                                 max_abs_err=err, prob=prob))
    for r in rows:
        r.update(time_problem(r.pop("prob")))
        emit({"phase": "kernel", **r})
    return rows


def time_problem(prob):
    """Kernel, plain and SDPA times on rotating copies of the problem
    whose pools together exceed the L2 cache, so each launch reads its
    K/V from device memory as a decode step over many layers would."""
    from paddle_tpu_torch.ops import (paged_window_attention,
                                      plain_window_attention)

    q, kp, vp, tables, cached = prob
    B, T = q.shape[:2]
    pool_bytes = 2 * kp.numel() * kp.element_size()
    copies = [prob] + [(q, kp.clone(), vp.clone(), tables, cached)
                       for _ in range(max(1, math.ceil(4 * L2_BYTES
                                                       / pool_bytes)) - 1)]
    state = {"i": 0}

    def rotating(fn, args):
        def call():
            state["i"] = (state["i"] + 1) % len(args)
            return fn(*args[state["i"]])
        return call

    mask, _ = window_masks(tables, cached, T)
    sdpa_args = []
    for cq, ck, cv, ct, _ in copies:
        gidx = (ct.long()[:, :, None] * BS
                + torch.arange(BS, device=ct.device)).reshape(B, -1)
        gidx = gidx.clamp(min=0)
        keys = ck.reshape(NB * BS, H, D)[gidx].permute(0, 2, 1, 3).contiguous()
        vals = cv.reshape(NB * BS, H, D)[gidx].permute(0, 2, 1, 3).contiguous()
        sdpa_args.append((cq.permute(0, 2, 1, 3).contiguous(), keys, vals,
                          mask[:, None, :, :]))
    iters = 200
    kernel_ms = cuda_ms(rotating(paged_window_attention, copies), iters)
    plain_ms = cuda_ms(rotating(plain_window_attention, copies), 20)
    library_ms = cuda_ms(rotating(
        lambda a, b, c, m: F.scaled_dot_product_attention(
            a, b, c, attn_mask=m), sdpa_args), iters)
    bound_ms, bound_by, nbytes, ops = work(tables, cached, T, q.dtype)
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention over the "
                       "pre-gathered window (gather excluded)",
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by, "bytes": nbytes, "ops": ops, "copies": len(copies)}


# ---------------------------------------------------------------- phase 3


def build_model():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.causal_lm import causal_lm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, logits = causal_lm(**MODEL)
    rng = np.random.RandomState(SEED)
    arrays = {}
    for p in main.all_parameters():
        if p.name.startswith("layer_norm") and ".w_" in p.name:
            a = 1.0 + 0.02 * rng.standard_normal(p.shape)
        elif len(p.shape) == 2 and p.name != "lm_word_emb_table":
            a = rng.standard_normal(p.shape) / math.sqrt(p.shape[0])
        else:
            a = 0.02 * rng.standard_normal(p.shape)
        arrays[p.name] = a.astype(np.float32)
    scope = fluid.Scope()
    fluid.params_from_numpy(arrays, scope, fluid.CUDAPlace(0), program=main)
    return main, logits, scope


def phase_serving(card):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import (CacheConfig, DecodingConfig,
                                           serve_decoding)
    from paddle_tpu_torch.ops import paged_window_attention

    main, logits, scope = build_model()
    config = DecodingConfig(
        cache=CacheConfig(num_blocks=512, block_size=16,
                          max_blocks_per_seq=32),
        decode_buckets=(1, 2, 4, 8, 16), max_new_tokens=MAX_NEW)
    t0 = time.perf_counter()
    session = serve_decoding(main, "tokens", logits.name, scope=scope,
                             config=config, place=fluid.CUDAPlace(0))
    warm_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, MODEL["vocab_size"],
                           size=rng.randint(16, 201)).tolist()
               for _ in range(N_REQUESTS)]
    first_t = {}

    def on_token(i):
        def cb(tok):
            first_t.setdefault(i, time.perf_counter())
        return cb

    torch.cuda.reset_peak_memory_stats()
    paged_window_attention.launches = 0
    try:
        t0 = time.perf_counter()
        submit_t = {}
        futs = []
        for i, p in enumerate(prompts):
            submit_t[i] = time.perf_counter()
            futs.append(session.submit(p, max_new_tokens=MAX_NEW,
                                       on_token=on_token(i)))
        streams = [f.result(timeout=600) for f in futs]
        wall_s = time.perf_counter() - t0
    finally:
        session.shutdown(drain=True, timeout=120)
    launches = paged_window_attention.launches
    rep = session.metrics.report()
    steps = rep["decode_step_ms"]["count"]
    if len(streams) != N_REQUESTS or any(len(s) != MAX_NEW
                                         for s in streams):
        fail("not every request completed with %d tokens" % MAX_NEW)
    if launches < MODEL["n_layer"] * steps or launches == 0:
        fail("kernel launched %d times over %d decode steps of %d layers"
             % (launches, steps, MODEL["n_layer"]))
    n_tokens = sum(len(s) for s in streams)
    ttft = np.asarray([(first_t[i] - submit_t[i]) * 1e3
                       for i in range(N_REQUESTS)])
    emit({"phase": "serving", "card": card, "requests": N_REQUESTS,
          "tokens": n_tokens, "wall_s": wall_s,
          "tokens_per_s": n_tokens / wall_s,
          "decode_steps": steps,
          "mean_decode_step_ms": rep["decode_step_ms"]["mean"],
          "p50_decode_step_ms": rep["decode_step_ms"]["p50"],
          "mean_prefill_ms": rep["prefill_ms"]["mean"],
          "ttft_ms_mean": float(ttft.mean()),
          "ttft_ms_p50": float(np.percentile(ttft, 50)),
          "ttft_ms_max": float(ttft.max()),
          "kernel_launches": launches, "warm_up_s": warm_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check_oracle(main, logits, scope, prompts, streams)
    return launches


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
    launches = phase_serving(card)

    main_row = next(r for r in rows if r["B"] == 16 and r["T"] == 1
                    and r["dtype"] == "float32")
    print(card_line(), flush=True)
    emit({"kernels": [{
        "name": "paged_window_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/paged_attention.py:137",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
