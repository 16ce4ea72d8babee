#!/usr/bin/env python3
"""Where BERT-base's int8 forward spends its device time on one NVIDIA
card, beside the f32 program's, and what ``torch._int_mm`` costs by the
weight's layout.

    python3 profile_int8.py

Builds ``chip_smoke.py``'s BERT-base sentence-pair classifier in f32
(random weights from a seed), quantizes it with
``passes.quantize_for_serving`` on two batches of 8 requests (the
``ptq`` phase's), then runs the int8 and the f32 program once each at
bucket 64 (B=64, T=128) under ``torch.profiler`` (CUDA activity) and
prints each one's kernels by device time. Last it times
``torch._int_mm`` at BERT-base's three product shapes with the weight
row-major and column-major, beside an f32 product (CUDA events around
20 calls). Exits non-zero when no card is visible.
"""

import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_int8: no CUDA device is visible", file=sys.stderr)
        return 1
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import passes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    place = fluid.CUDAPlace(0)
    main_prog, _, prob, scope = cs.build_server_model(cs.PTQ_FLAGS)
    reqs = cs.server_requests(cs.SEED + 40)[:cs.PTQ_REQUESTS]
    per, n = cs.PTQ_CALIB
    calib = [cs._stack(reqs[i * per:(i + 1) * per]) for i in range(n)]
    q = passes.quantize_for_serving(main_prog, scope, calib, place=place)
    feed = {k: v[:cs.SERVER_BUCKETS[-1]]
            for k, v in cs._stack(reqs).items()}
    exe = fluid.Executor(place)
    for name, prog in (("int8", q), ("f32", main_prog)):
        for _ in range(2):
            exe.run(prog, feed=feed, fetch_list=[prob.name], scope=scope)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
            exe.run(prog, feed=feed, fetch_list=[prob.name], scope=scope)
            torch.cuda.synchronize()
        print("=====", name, cs.card_line())
        print(p.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=18,
                                     max_name_column_width=70))
    for M, K, N in ((8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768)):
        a = torch.randint(-127, 127, (M, K), dtype=torch.int8, device="cuda")
        b = torch.randint(-127, 127, (K, N), dtype=torch.int8, device="cuda")
        b_cols = b.t().contiguous().t()
        af, bf = a.float(), b.float()
        print({"M": M, "K": K, "N": N,
               "int_mm_row_major_ms": cs.cuda_ms(
                   lambda: torch._int_mm(a, b), 20),
               "int_mm_column_major_ms": cs.cuda_ms(
                   lambda: torch._int_mm(a, b_cols), 20),
               "f32_mm_ms": cs.cuda_ms(lambda: af @ bf, 20)}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
