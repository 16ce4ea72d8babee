#!/usr/bin/env python3
"""Where a block of the flash-attention kernels spends its cycles on
one NVIDIA card, or how they compare with another version.

    python3 profile_flash.py [--cases path_masked,long]
    python3 profile_flash.py --compare-src OLD/flash_attention.cu [--cases ...]

Builds ``paddle_tpu_torch/csrc/flash_attention.cu`` once more with
``-DFLASH_PROBE`` (the kernels then add clock64 phase sums for thread 0
of each block; the default build carries no probe) into
``build/paddle_tpu_torch/``, runs the forward, dQ and dK/dV kernels once
per case of chip_smoke.py's flash phase, in bf16 and f32, and prints one
JSON line per (case, dtype): for each kernel the mean cycles per block in

- ``prologue``: staging the block's fixed tiles (forward: q and the
  first key tile, scanning the key mask for the walk's end, and for
  bf16 tile 0's scores and softmax; dQ: q, dO, O, lse, then delta;
  dK/dV: k, v and the key mask) and starting the ring;
- ``wait``: each walk step's wait for its tile, the barrier, and issuing
  the next tile's copies (a warp that computes faster waits here for
  the slowest one);
- ``compute``: the products and the softmax (or its gradient) of each
  step (for the bf16 forward also the last tile's O += P V);
- ``epilogue``: the output stores;

and each phase's share. The probes cost a few percent of the kernels'
time; chip_smoke.py times the default build.

With ``--compare-src`` it builds that source as well (another version of
``flash_attention.cu`` with the same C entry points, e.g. the parent
commit's) and prints, per (case, dtype), the device ms (chip_smoke.py's
``device_ms``) of both versions' forward, dQ and dK/dV kernels, timed in
turns (this, other, other, this) on the same inputs, their errors (the
forward's o against ``plain_flash_forward``, absolute and for bf16 in
bf16 ulps; the backward's against ``plain_flash_backward``, of max
|grad|), and SDPA's forward and backward on the same inputs. Exits
non-zero without a card.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from unittest import mock

import torch

import chip_smoke as cs

PHASES = ("prologue", "wait", "compute", "epilogue")
CASES = {c[0]: c for c in cs.FLASH_CASES}
N_SLOTS = 24  # flash_attention.cu: kProbeSlots
# first probe slot of each kernel (4 phases each), by dtype
SLOTS = {torch.bfloat16: {"flash_fwd": 16, "flash_bwd_dq": 0,
                          "flash_bwd_dkv": 4},
         torch.float32: {"flash_fwd": 20, "flash_bwd_dq": 8,
                         "flash_bwd_dkv": 12}}


def probe_library():
    """The kernel library built with -DFLASH_PROBE, bound as the
    default one is."""
    from paddle_tpu_torch.ops import _cuda
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    src = _cuda.CSRC / "flash_attention.cu"
    key = hashlib.sha256(_cuda.library_path("flash_attention").name.encode())
    out = _cuda.BUILD_DIR / ("flash_attention-probe-%s.so"
                             % key.hexdigest()[:16])
    if not out.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DFLASH_PROBE",
                        "-I", str(_cuda.CSRC), "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    fa._bind(lib)
    lib.flash_probe_take.argtypes = [ctypes.c_void_p]
    lib.flash_probe_take.restype = ctypes.c_int
    return lib


def other_library(src):
    """``src`` built as a kernel library beside this tree's, bound as
    this tree's is (its C entry points must match)."""
    from paddle_tpu_torch.ops import _cuda
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_cuda.NVCC_FLAGS).encode())
    key = key.hexdigest()[:16]
    out = _cuda.BUILD_DIR / ("flash_attention-other-%s.so" % key)
    if not out.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                        "-o", str(out), src], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    fa._bind(lib)
    return lib


def compare(src, labels):
    import torch.nn.functional as F
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    libs = {"this": fa._library(), "other": other_library(src)}
    print(cs.card_line(), flush=True)
    for label in labels:
        _, B, Tq, Tk, H, D, causal, masked, dtypes = CASES[label]
        for dtype in dtypes:
            q, k, v, do, mask = cs.flash_inputs(B, Tq, Tk, H, D, masked,
                                                dtype, seed=1)
            o, lse = fa.flash_fwd(q, k, v, causal, None, mask)
            ro, _ = fa.plain_flash_forward(q, k, v, causal, None, mask)
            ref = fa.plain_flash_backward(q, k, v, o, lse, do, causal, None,
                                          mask)
            iters = 10 if Tq * Tk > 10 ** 6 else 30
            row = {"case": label, "dtype": str(dtype)[6:], "B": B, "Tq": Tq,
                   "Tk": Tk, "H": H, "D": D}
            for name in ("this", "other", "other", "this"):
                with mock.patch.object(fa, "_library", lambda: libs[name]):
                    o_n, _ = fa.flash_fwd(q, k, v, causal, None, mask)
                    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal,
                                                None, mask)
                    dk, dv = fa.flash_bwd_dkv(q, k, v, lse, delta, do,
                                              causal, None, mask)
                    err = max(float((g.float() - r.float()).abs().max()
                                    / r.float().abs().max())
                              for g, r in zip((dq, dk, dv), ref))
                    errs = {"o_abs_err": float((o_n.float() - ro.float())
                                               .abs().max()),
                            "max_rel_err": err}
                    if dtype == torch.bfloat16:
                        errs["o_ulps"] = fa.bf16_ulps(o_n, ro)
                    t = [cs.device_ms(lambda: fa.flash_fwd(
                             q, k, v, causal, None, mask), iters),
                         cs.device_ms(lambda: fa.flash_bwd_dq(
                             q, k, v, o, lse, do, causal, None, mask), iters),
                         cs.device_ms(lambda: fa.flash_bwd_dkv(
                             q, k, v, lse, delta, do, causal, None, mask),
                             iters)]
                r = row.setdefault(name, {"flash_fwd": [], "flash_bwd_dq": [],
                                          "flash_bwd_dkv": [], **errs})
                r["flash_fwd"].append(t[0])
                r["flash_bwd_dq"].append(t[1])
                r["flash_bwd_dkv"].append(t[2])
            (sq, sk, sv), kw = cs.sdpa_args(q, k, v, causal, mask)
            row["sdpa_fwd"] = cs.device_ms(
                lambda: F.scaled_dot_product_attention(sq, sk, sv, **kw),
                iters)
            gq, gk, gv = (x.detach().requires_grad_() for x in (sq, sk, sv))
            out = F.scaled_dot_product_attention(gq, gk, gv, **kw)
            g_out = do.transpose(1, 2).contiguous()
            row["sdpa_bwd"] = cs.device_ms(lambda: torch.autograd.grad(
                out, (gq, gk, gv), g_out, retain_graph=True), iters)
            print(json.dumps(row), flush=True)
            del q, k, v, do, mask, o, lse, ro, ref, out, gq, gk, gv, o_n
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="path_masked,long",
                    help="comma-separated chip_smoke.py FLASH_CASES labels")
    ap.add_argument("--compare-src", default=None,
                    help="another flash_attention.cu to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible")
    if args.compare_src:
        return compare(args.compare_src, args.cases.split(","))
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    lib = probe_library()
    sums = (ctypes.c_ulonglong * N_SLOTS)()
    print(cs.card_line(), flush=True)
    with mock.patch.object(fa, "_library", lambda: lib):
        for label in args.cases.split(","):
            _, B, Tq, Tk, H, D, causal, masked, dtypes = CASES[label]
            for dtype in dtypes:
                q, k, v, do, mask = cs.flash_inputs(B, Tq, Tk, H, D, masked,
                                                    dtype, seed=1)
                for _ in range(2):  # the second run is the one read
                    torch.cuda.synchronize()
                    lib.flash_probe_take(sums)
                    o, lse = fa.flash_fwd(q, k, v, causal, None, mask)
                    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal,
                                                None, mask)
                    fa.flash_bwd_dkv(q, k, v, lse, delta, do, causal, None,
                                     mask)
                    torch.cuda.synchronize()
                    err = lib.flash_probe_take(sums)
                    if err:
                        cs.fail("reading the probes: CUDA error %d" % err)
                row = {"case": label, "dtype": str(dtype)[6:], "B": B,
                       "Tq": Tq, "Tk": Tk, "H": H, "D": D}
                for name, n_tiles in (("flash_fwd", Tq), ("flash_bwd_dq", Tq),
                                      ("flash_bwd_dkv", Tk)):
                    blocks = B * H * ((n_tiles + 63) // 64)
                    base = SLOTS[dtype][name]
                    cyc = [sums[base + j] / blocks for j in range(4)]
                    total = sum(cyc)
                    row[name] = {"blocks": blocks,
                                 "cycles_per_block": dict(zip(PHASES, cyc)),
                                 "share": {p: c / total for p, c in
                                           zip(PHASES, cyc)}}
                print(json.dumps(row), flush=True)
                del q, k, v, do, mask, o, lse
                torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
