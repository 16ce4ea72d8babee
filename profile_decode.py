#!/usr/bin/env python3
"""Where a decode step of paddle_tpu_torch's serving path spends its time
on one NVIDIA card.

    python3 profile_decode.py [--steps 20] [--kv-dtype f32|int8]
                              [--out TABLE.json]

Builds the causal LM of chip_smoke.py (Transformer-base widths, random
weights from a seed) on ``CUDAPlace(0)``, prefills 16 prompts of 16-200
tokens into the paged pools (f32, or int8 codes with per-slot scales
under ``--kv-dtype int8``), then times decode steps of the full 16-row
batch through ``DecodeEngine.decode``:

1. host wall time per step, without a profiler;
2. the same steps under ``torch.profiler`` (CPU + CUDA activity): the
   device time per step, summed over the kernels and copies the trace
   records, split into the paged-attention kernel, matrix products,
   copies and everything else, and the kernel launches per step;
3. the device's idle share of a step: one minus device time over the
   profiled wall time, and over the unprofiled wall time of (1) (the
   profiler slows the host, not the card).

Prints one JSON line per measurement and the eight kernels that take
the most device time; ``--out`` also writes the whole per-kernel table.
Exits non-zero when no card is visible or the trace holds no device
activity.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def _device_events(prof):
    """(name, device microseconds) of every kernel and copy the trace
    recorded on the card (not the host spans' ranges, which show on the
    card's timeline too)."""
    return [(e.name, float(e.time_range.elapsed_us()))
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _family(name: str) -> str:
    low = name.lower()
    if "paged_window_attention" in low:
        return "paged_attention_kernel"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "matmul")):
        return "matmul"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--kv-dtype", choices=("f32", "int8"), default="f32",
                    help="the KV pools' storage type")
    ap.add_argument("--out", help="write the per-kernel table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import (CacheConfig, DecodeEngine,
                                           DecodingConfig, KVCacheManager)

    card = cs.card_line()
    main_prog, logits, scope = cs.build_model()
    config = DecodingConfig(
        cache=CacheConfig(num_blocks=512, block_size=16,
                          max_blocks_per_seq=32,
                          kv_dtype=None if args.kv_dtype == "f32"
                          else args.kv_dtype),
        decode_buckets=(1, 2, 4, 8, 16), max_new_tokens=cs.MAX_NEW)
    engine = DecodeEngine(main_prog, "tokens", logits.name, scope=scope,
                          config=config, place=fluid.CUDAPlace(0))
    engine.warm_up()

    n = cs.N_REQUESTS
    budget = 2 * args.steps + 3
    rng = np.random.RandomState(cs.SEED + 1)
    prompts = [rng.randint(0, cs.MODEL["vocab_size"],
                           size=rng.randint(16, 201)) for _ in range(n)]
    kv = KVCacheManager(engine.cache_config)
    sids = [kv.admit(len(p), budget) for p in prompts]
    if any(s is None for s in sids):
        cs.fail("the pools cannot hold %d sequences of %d new tokens"
                % (n, budget))
    tables = np.stack([kv.table_row(s) for s in sids])
    tokens = np.concatenate([engine.prefill([p], tables[i:i + 1],
                                            np.asarray([len(p)], np.int32))
                             for i, p in enumerate(prompts)])
    positions = np.asarray([len(p) for p in prompts], np.int32)

    def step():
        nonlocal tokens, positions
        tokens = engine.decode(tokens, positions, tables)
        positions = positions + 1

    for _ in range(3):
        step()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    events = _device_events(prof)
    if not events:
        cs.fail("the profiler recorded no device activity")

    by_family, by_name = {}, {}
    for name, us in events:
        f = _family(name)
        by_family[f] = by_family.get(f, 0.0) + us
        count, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, tot + us)
    device_ms = sum(by_family.values()) / 1e3 / args.steps
    launches = sum(1 for name, _ in events if _family(name) != "copies")
    cs.emit({"phase": "decode_step", "card": card, "batch": n,
             "kv_dtype": args.kv_dtype,
             "steps": args.steps, "host_wall_ms": wall_ms,
             "profiled_wall_ms": prof_wall_ms,
             "device_busy_ms": device_ms,
             "device_idle_share": 1.0 - device_ms / prof_wall_ms,
             "device_idle_share_unprofiled": 1.0 - device_ms / wall_ms,
             "kernel_launches_per_step": launches / args.steps,
             "device_ms_by_family": {
                 f: us / 1e3 / args.steps
                 for f, us in sorted(by_family.items(),
                                     key=lambda kv_: -kv_[1])}})
    table = sorted(({"name": name, "calls_per_step": c / args.steps,
                     "device_ms_per_step": us / 1e3 / args.steps}
                    for name, (c, us) in by_name.items()),
                   key=lambda r: -r["device_ms_per_step"])
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": table}, fh, indent=1)
    for row in table[:8]:
        cs.emit({"phase": "kernel_share", "kv_dtype": args.kv_dtype, **row})
    return 0


if __name__ == "__main__":
    sys.exit(main())
