"""The built-in tunable-kernel declarations (counterpart of
paddle_tpu/tuning/kernels.py: the same four names and the same bucket
functions, so ``tuning_key`` gives the JAX package's strings for the
same problem; the spaces are the Hopper kernels' launch knobs).

* ``paged_attention`` — the key-split targets of csrc/paged_attention.cu's
  two fast routes, in waves of the H100's 132 SMs: ``split_waves`` for
  the split route (decode, a verify window), ``tile_waves`` for the
  query-tile route (0: no key split). Bucketed on the decode serving
  point (batch, q_tokens, window, block_size, heads, head_dim,
  kv_dtype), so ``DecodeEngine.autotune_decode_shapes`` sweeps exactly
  the shapes its bucket config serves.
* ``fused_optimizer_update`` — the grid cap of csrc/fused_optimizer.cu's
  grid-stride launch, in blocks an SM.
* ``fused_ce`` — the vocab-chunk cap of ops/fused_ce.py (torch work on
  cuBLAS, not a hand kernel; declared because the JAX package declares
  it).
* ``flash_attention`` — the tile csrc/flash_attention.cu is built with:
  one point, since the library holds one instantiation.

Each declaration carries the measurement harness the sweep engine
drives: ``iters`` calls chained by data dependency (sweep.py times them:
device time on the card, the plain versions' host time on the CPU).
Version fingerprints hash the kernel's CUDA source, ``csrc/hopper.cuh``,
its Python launcher and this module (the harness that elected the
config), so editing a kernel or its measurement orphans its stale store
entries instead of replaying them.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List

import torch

from ..core import dtype_utils
from ..ops import fused_ce as _ce
from ..ops import fused_optimizer as _opt
from ..ops import paged_attention as _pa
from ..ops.flash_attention import BUILT_TILE, flash_attention
from .registry import (Constraint, TunableKernel, pow2_bucket,
                       register_tunable, source_version)
from .sweep import chained_grad_scan

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_OPS = _PKG / "ops"


def _version(*names) -> str:
    """source_version of ``csrc/<name>.cu`` or ``ops/<name>.py`` files
    (and ``csrc/hopper.cuh``), and of this module's harnesses."""
    paths = []
    for n in names:
        paths.append(_CSRC / n if n.endswith((".cu", ".cuh"))
                     else _OPS / n)
    return source_version(*paths, Path(__file__).resolve())


def _on_card(device_kind: str) -> bool:
    return device_kind != "cpu"


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

_FA_BUILT = Constraint(
    "built_tile",
    "csrc/flash_attention.cu is built with one tile: 64 query rows a "
    "block (kTile; key tiles of 64 on the bf16 routes, 32 on the f32 "
    "ones); the space is that one point until a second instantiation "
    "is built (ROADMAP Queue B 1-2)",
    lambda c, _p: c["tile"] == BUILT_TILE)


def _fa_bucket(problem: dict) -> dict:
    return {"seq_q": pow2_bucket(problem.get("seq_q",
                                             problem.get("seq", 2048))),
            "seq_k": pow2_bucket(problem.get("seq_k",
                                             problem.get("seq", 2048))),
            "head_dim": int(problem.get("head_dim", 64)),
            "causal": bool(problem.get("causal", True))}


def _fa_default_problem(device_kind: str) -> dict:
    if _on_card(device_kind):
        # the training path's shape (B=32, T=256, 8 heads of 64)
        return {"batch": 32, "seq_q": 256, "seq_k": 256, "heads": 8,
                "head_dim": 64, "causal": False}
    return {"batch": 1, "seq_q": 128, "seq_k": 128, "heads": 1,
            "head_dim": 8, "causal": True}


def _fa_measure(problem, config, dtype, iters, device):
    del config  # one built tile: nothing to pass
    B = int(problem.get("batch", 1))
    Tq = int(problem.get("seq_q", problem.get("seq", 2048)))
    Tk = int(problem.get("seq_k", problem.get("seq", Tq)))
    H = int(problem.get("heads", 1))
    D = int(problem.get("head_dim", 64))
    causal = bool(problem.get("causal", True))
    gen = _generator(device)
    tdt = dtype_utils.to_torch(dtype)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device=device
                           ).to(tdt) for T in (Tq, Tk, Tk))

    def grad(qv, kv, vv):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (qv, kv, vv)]
            out = flash_attention(*leaves, causal=causal)
            return torch.autograd.grad(out.float().sum(), leaves)

    return chained_grad_scan(grad, (q, k, v), iters)


register_tunable(TunableKernel(
    "flash_attention",
    space={"tile": (BUILT_TILE,)},
    defaults={"tile": BUILT_TILE},
    version=_version("flash_attention.cu", "hopper.cuh",
                     "flash_attention.py"),
    op_types=("fused_attention",),
    constraints=(_FA_BUILT,),
    bucket=_fa_bucket,
    default_problem=_fa_default_problem,
    build_measure=_fa_measure,
))


# ---------------------------------------------------------------------------
# fused_ce
# ---------------------------------------------------------------------------

_CE_ALIGN = Constraint(
    "chunk_alignment",
    "chunk_cap must be a multiple of 128 (the width _chunking rounds a "
    "padded chunk to)",
    lambda c, _p: c["chunk_cap"] % 128 == 0)


def _ce_bucket(problem: dict) -> dict:
    # vocab stays EXACT: _chunking prefers exact divisors of V, so a
    # pow2 bucket would tune the wrong chunk geometry entirely
    return {"n_tokens": pow2_bucket(problem.get("n_tokens", 8192)),
            "d_model": pow2_bucket(problem.get("d_model", 512)),
            "vocab": int(problem.get("vocab", 32000))}


def _ce_default_problem(device_kind: str) -> dict:
    if _on_card(device_kind):
        # the recipe's head: B=32 x T=256 tokens, d 512, V 32k
        return {"n_tokens": 8192, "d_model": 512, "vocab": 32000}
    return {"n_tokens": 64, "d_model": 16, "vocab": 512}


def _ce_measure(problem, config, dtype, iters, device):
    N = int(problem.get("n_tokens", 8192))
    d = int(problem.get("d_model", 512))
    V = int(problem.get("vocab", 32000))
    gen = _generator(device)
    tdt = dtype_utils.to_torch(dtype)
    x = torch.randn(N, d, generator=gen, device=device).to(tdt)
    W = (torch.randn(d, V, generator=gen, device=device) * 0.02).to(tdt)
    b = torch.zeros(V, device=device, dtype=tdt)
    idx = torch.randint(0, V, (N,), generator=gen, device=device)
    bf16 = tdt == torch.bfloat16

    def grad(xv, wv, bv):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (xv, wv, bv)]
            loss = _ce.fused_linear_softmax_ce_fn(
                leaves[0], leaves[1], leaves[2], idx,
                chunk_cap=config["chunk_cap"], bf16=bf16)
            return torch.autograd.grad(loss.sum(), leaves)

    return chained_grad_scan(grad, (x, W, b), iters)


register_tunable(TunableKernel(
    "fused_ce",
    space={"chunk_cap": (1024, 2048, 4096, 8192)},
    defaults={"chunk_cap": _ce.DEFAULT_CHUNK_CAP},
    version=_version("fused_ce.py"),
    op_types=("fused_linear_softmax_ce",),
    constraints=(_CE_ALIGN,),
    bucket=_ce_bucket,
    default_problem=_ce_default_problem,
    build_measure=_ce_measure,
))


# ---------------------------------------------------------------------------
# fused_optimizer_update
# ---------------------------------------------------------------------------

# hyperparameters the harness gives each kind (the update's cost does not
# depend on them)
_OPT_CONSTS = {"sgd": (1.0,), "adagrad": (1.0, 1e-6),
               "adam": (1.0, 0.9, 0.999, 1e-8), "momentum": (1.0, 0.9, 0),
               "adamax": (1.0, 0.9, 0.999, 1e-8),
               "decayed_adagrad": (1.0, 0.95, 1e-6),
               "adadelta": (1.0, 0.95, 1e-6),
               "rmsprop": (1.0, 0.95, 1e-6, 0.0, 0),
               "ftrl": (1.0, 0.0, 0.0, -0.5), "proximal_gd": (1.0, 0.0, 0.0),
               "proximal_adagrad": (1.0, 0.0, 0.0)}


def _opt_bucket(problem: dict) -> dict:
    return {"numel": pow2_bucket(problem.get("numel", 1 << 20)),
            "n_accs": int(problem.get("n_accs", 2)),
            "n_shared": int(problem.get("n_shared", 0))}


def _opt_default_problem(device_kind: str) -> dict:
    if _on_card(device_kind):
        # the recipe's flat Adam group (Transformer-base, 60,519,680)
        return {"numel": 60519680, "n_accs": 2, "n_shared": 2}
    return {"numel": 4096, "n_accs": 2, "n_shared": 2}


def _opt_kind(problem: dict) -> str:
    """The problem's ``kind``, else the first kind of the fused update
    with its moment and shared-scalar counts (2 and 2: Adam)."""
    if "kind" in problem:
        return str(problem["kind"])
    n_accs = int(problem.get("n_accs", 2))
    n_shared = int(problem.get("n_shared", 0))
    return next(k for k, (a, s, _) in _opt.KINDS.items()
                if (a, s) == (n_accs, n_shared))


def _opt_measure(problem, config, dtype, iters, device):
    N = int(problem.get("numel", 1 << 20))
    kind = _opt_kind(problem)
    n_accs, n_shared, _ = _opt.KINDS[kind]
    mdt = dtype_utils.to_torch(problem.get("moment_dtype", "float32"))
    gen = _generator(device)
    p = torch.randn(N, generator=gen, device=device)
    g = torch.randn(N, generator=gen, device=device) * 1e-2
    accs = tuple(torch.zeros(N, device=device, dtype=mdt)
                 for _ in range(n_accs))
    shared = tuple(torch.tensor(b, device=device)
                   for b in (0.9, 0.999)[:n_shared])
    lr = torch.tensor(1e-3, device=device)
    consts = _OPT_CONSTS[kind]

    def step(pv, *accs_in):
        return _opt.fused_flat_update(
            kind, pv, g, lr, accs_in, shared, False, consts,
            blocks_per_sm=config["blocks_per_sm"])

    return chained_grad_scan(step, (p,) + accs, iters)


register_tunable(TunableKernel(
    "fused_optimizer_update",
    space={"blocks_per_sm": (2, 4, 8, 16, 32)},
    defaults={"blocks_per_sm": _opt.DEFAULT_BLOCKS_PER_SM},
    version=_version("fused_optimizer.cu", "hopper.cuh",
                     "fused_optimizer.py"),
    # every flat-state group op: sgd_fused, momentum_fused, adam_fused…
    op_types=(),
    matches_op=lambda t: t.endswith("_fused"),
    bucket=_opt_bucket,
    default_problem=_opt_default_problem,
    build_measure=_opt_measure,
))


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------


def _pa_fast_route(p) -> bool:
    """The problem reaches a fast route (plan_route's conditions): the
    block table fits shared memory and the head dim loads as 16-byte
    vectors. Otherwise the generic route runs, reading neither knob."""
    D = int(p.get("head_dim", 64))
    mb = max(int(p.get("window", 2048)) // int(p.get("block_size", 16)), 1)
    return (mb <= _pa.MAX_TABLE and D % 8 == 0 and D <= _pa.MAX_HEAD_DIM
            and (p.get("kv_dtype") != "int8" or D % 16 == 0))


_PA_ROUTE = Constraint(
    "fast_route",
    "the split and query-tile routes stage a sequence's block-table row "
    "in shared memory (at most MAX_TABLE = 2048 pages) and load head "
    "rows as 16-byte vectors (head_dim a multiple of 8, at most 128; "
    "of 16 for int8 pools); other geometries run the generic route, "
    "which reads neither knob",
    lambda c, p: p is None or _pa_fast_route(p))

_PA_KNOB = Constraint(
    "route_knob",
    "split_waves is read only by the split route (q_tokens <= "
    "SPLIT_MAX_T = 8) and tile_waves only by the query-tile route: a "
    "problem keeps the knob its route does not read at its default",
    lambda c, p: p is None or (
        c["tile_waves"] == _pa.DEFAULT_TILE_WAVES
        if int(p.get("q_tokens", 1)) <= _pa.SPLIT_MAX_T
        else c["split_waves"] == _pa.DEFAULT_SPLIT_WAVES))


def _pa_scratch_ok(c, p) -> bool:
    B, T, H = (int(p.get(n, d)) for n, d in
               (("batch", 1), ("q_tokens", 1), ("heads", 8)))
    D, bs = int(p.get("head_dim", 64)), int(p.get("block_size", 16))
    mb = max(int(p.get("window", 2048)) // bs, 1)
    quant = p.get("kv_dtype") == "int8"
    plan = _pa.plan_route(B, T, H, D, D, mb, bs, torch.float32, quant,
                          config=c)
    return plan.scratch_bytes <= _pa.SCRATCH_LIMIT


_PA_SCRATCH = Constraint(
    "scratch",
    "the key splits' f32 partials ([B, H, n_splits, T, 2 + Dv]) must "
    "stay within SCRATCH_LIMIT (1 GiB) of device memory",
    lambda c, p: p is None or not _pa_fast_route(p) or _pa_scratch_ok(c, p))


def _pa_bucket(problem: dict) -> dict:
    # batch/q_tokens bucket pow2 (the engine's decode buckets are pow2
    # already); pool geometry and kv_dtype are exact — a config tuned
    # for one block_size says nothing about another
    return {"batch": pow2_bucket(problem.get("batch", 1)),
            "q_tokens": pow2_bucket(problem.get("q_tokens", 1)),
            "window": int(problem.get("window", 2048)),
            "block_size": int(problem.get("block_size", 16)),
            "heads": int(problem.get("heads", 8)),
            "head_dim": int(problem.get("head_dim", 64)),
            "kv_dtype": str(problem.get("kv_dtype", "f32"))}


def _pa_default_problem(device_kind: str) -> dict:
    if _on_card(device_kind):
        # the serving phase's largest decode bucket: 16 sequences
        # against a 512-token window of 16-slot blocks, 8 heads of 64
        return {"batch": 16, "q_tokens": 1, "window": 512,
                "block_size": 16, "heads": 8, "head_dim": 64,
                "kv_dtype": "f32"}
    return {"batch": 2, "q_tokens": 1, "window": 32, "block_size": 8,
            "heads": 2, "head_dim": 8, "kv_dtype": "f32"}


# bytes of pool copies a paged measurement rotates over: twice the
# H100's 50 MB L2 cache
_L2_SPAN_BYTES = 2 * 50 * 2 ** 20


def _fill_quantile(q: float) -> float:
    """The ``q`` quantile of the product of two uniform draws on (0, 1]
    (its distribution function is x (1 - ln x))."""
    lo, hi = 0.0, 1.0
    for _ in range(50):
        mid = (lo + hi) / 2
        if mid * (1 - math.log(mid)) < q:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def decode_lengths(batch: int, q_tokens: int, window: int) -> List[int]:
    """The cached lengths of the paged measurement's sequences: ragged,
    at evenly spaced quantiles of a window fraction drawn as a uniform
    number of pages times a uniform share of them. Its density falls
    with length and its mean is a quarter of the window: the engine
    reserves the window for the longest sequence it admits, and a decode
    step holds mostly shorter ones (a burst of 16 requests with prompts
    of 16-200 tokens holds 16-232 keys of a 512-key window). The split
    count is planned from shapes alone, so the fill decides the winner:
    full windows reward few long splits, short ragged ones the many
    short splits that keep every block busy."""
    span = max(window - q_tokens, 0)
    return [int(_fill_quantile((b + 0.5) / batch) * span)
            for b in range(batch)]


def _pa_measure(problem, config, dtype, iters, device):
    B = int(problem.get("batch", 1))
    T = int(problem.get("q_tokens", 1))
    S = int(problem.get("window", 2048))
    bs = int(problem.get("block_size", 16))
    H = int(problem.get("heads", 8))
    D = int(problem.get("head_dim", 64))
    q8 = str(problem.get("kv_dtype", "f32")) == "int8"
    mb = max(S // bs, 1)
    nb = B * mb + 1
    gen = _generator(device)
    host = torch.Generator().manual_seed(0)
    tdt = dtype_utils.to_torch(dtype)
    q = torch.randn(B, T, H, D, generator=gen, device=device).to(tdt)
    if q8:
        kp, vp = (torch.randint(-127, 128, (nb, bs, H, D), generator=gen,
                                device=device, dtype=torch.int8)
                  for _ in range(2))
        kw = {n: torch.rand(nb, bs, generator=gen, device=device) * 0.05
              for n in ("k_scale", "v_scale")}
    else:
        kp, vp = (torch.randn(nb, bs, H, D, generator=gen,
                              device=device).to(tdt) for _ in range(2))
        kw = {}
    # ragged windows in the order the engine's slots hold them, each
    # on pages the allocator hands out in no order, -1 past its keys
    lengths = decode_lengths(B, T, mb * bs)
    lengths = [lengths[i] for i in torch.randperm(B, generator=host).tolist()]
    pages = torch.randperm(B * mb, generator=host).to(torch.int32)
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        used = min(mb, -(-(n + T) // bs))
        tables[b, :used] = pages[b * mb:b * mb + used]
    tables = tables.to(device)
    cached = torch.tensor(lengths, dtype=torch.int32, device=device)
    # a decode step reads each layer's pools from device memory: on the
    # card the chained calls rotate over copies of the pools that
    # together exceed the L2 cache, so no call finds its keys there
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (kp, vp, *kw.values()))
    n = (max(1, -(-_L2_SPAN_BYTES // pool_bytes))
         if torch.device(device).type == "cuda" else 1)
    copies = [(kp, vp, kw)] + [
        (kp.clone(), vp.clone(), {k: t.clone() for k, t in kw.items()})
        for _ in range(n - 1)]
    turn = [0]

    def step(qv):
        turn[0] = (turn[0] + 1) % n
        k_c, v_c, kw_c = copies[turn[0]]
        return _pa.paged_window_attention(qv, k_c, v_c, tables, cached,
                                          config=config, **kw_c)

    # decode is inference-only: the output feeds the next query
    return chained_grad_scan(step, (q,), iters)


register_tunable(TunableKernel(
    "paged_attention",
    space={"split_waves": (1, 2, 4, 8, 16),
           "tile_waves": (0, 1, 2, 4, 8)},
    defaults={"split_waves": _pa.DEFAULT_SPLIT_WAVES,
              "tile_waves": _pa.DEFAULT_TILE_WAVES},
    version=_version("paged_attention.cu", "hopper.cuh",
                     "paged_attention.py"),
    op_types=("paged_attention_decode", "paged_attention_extend"),
    constraints=(_PA_ROUTE, _PA_KNOB, _PA_SCRATCH),
    bucket=_pa_bucket,
    default_problem=_pa_default_problem,
    build_measure=_pa_measure,
))
