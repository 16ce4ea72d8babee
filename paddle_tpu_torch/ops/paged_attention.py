"""Paged window attention: the block-table window attention as
hand-written CUDA kernels for Hopper (csrc/paged_attention.cu).

Replaces ``paddle_tpu/ops/paged_attention.py:paged_window_attention``,
the Pallas kernel that walks the block table page by page in VMEM, for
f32/bf16 pools and for int8 pools with per-slot f32 scales (dequantize
on gather). The kernel never materializes the gathered window; each
block walks the block table itself. Three routes, chosen by
:func:`plan_route` from the shapes alone:

* **split** (T <= ``SPLIT_MAX_T``: decode, a verify window): the key
  axis is cut into splits across blocks (grid head x sequence x split),
  each folding its keys into a partial (m, l, acc) in f32 scratch; a
  second small kernel merges the splits. Both launch from one C call.
* **tile** (longer windows): one block per (head, sequence, 64-row
  query tile), register-tiled f32 products, online softmax in
  registers, stopping at the tile's last visible key; with bf16
  queries the products run on the tensor cores (``tile_mma``, 128-row
  tiles past T=64). A grid under two waves also splits its keys and
  merges like the split route.
* **generic**: the first design (one block per query tile, scalar
  loads), for head dims the other two do not take.

The TPU schedule knobs (``schedule``, ``heads_per_tile``) and its VMEM
budget have no counterpart here. The Hopper knobs are the key-split
targets of the two fast routes, in waves of the H100's 132 SMs
(``split_waves``, ``tile_waves``): ``plan_route`` reads them from
``paddle_tpu_torch.tuning.lookup`` (the ``paged_attention`` tunable),
which returns the defaults below when nothing is tuned.

Functions:

* :func:`plain_window_attention` — the exact torch transcription of the
  JAX package's ``xla_window_attention``, gather included. It is what
  the CPU runs and what the kernel is held to on the card.
* :func:`plain_split_window_attention` — the split route's algorithm,
  partials and merge, in torch.
* :func:`plan_route` — the route planner the wrapper calls, and
  :func:`tuning_problem`, the shape it looks its knobs up by.
* :func:`paged_window_attention` — the
  ``paddle_tpu_torch::paged_window_attention`` custom op: the plain
  version for tensors on the CPU, a kernel for tensors on a CUDA device
  (or an error; there is no fallback on the card). It counts launches
  in ``LAUNCH_COUNTS`` attributes: all, int8, and per route.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..core import dtype_utils
from ..core.dtype_utils import rounded_sqrt
from ..core.enforce import enforce
from . import _cuda

__all__ = ["paged_window_attention", "plain_window_attention",
           "plain_split_window_attention", "plan_route", "tuning_problem"]


def _take_fill(src, idx):
    """``jnp.take(src, idx, axis=0, mode="fill", fill_value=0)``:
    indices in ``[-N, 0)`` wrap from the end (the fill only triggers
    outside ``[-N, N)``) — fully masked rows of the JAX package depend
    on that wrap."""
    n = src.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = src[idx.clamp(0, n - 1)]
    ok = ok.reshape(ok.shape + (1,) * (src.dim() - 1))
    return torch.where(ok, out, torch.zeros((), dtype=src.dtype,
                                            device=src.device))


def plain_window_attention(q, k_pool, v_pool, tables, cached_lens, *,
                           k_scale=None, v_scale=None):
    """Window attention over a paged KV pool, written with plain torch
    ops: gather the whole block window position-ordered, attend under
    the ``window_pos <= cached + t`` mask (``-1`` table pages masked),
    softmax in f32.

    q: ``[B, T, H, Dk]``; pools ``[nb, bs, H, D]`` (int8 codes plus
    ``[nb, bs]`` f32 scale pools when ``k_scale``/``v_scale`` are
    given); tables ``[B, mb]``; cached_lens ``[B]``. Returns
    ``[B, T, H, Dv]``."""
    B, T, H, Dk = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    Dv = v_pool.shape[-1]
    mb = tables.shape[1]
    S = mb * bs
    dev = q.device
    tables = tables.to(torch.int64)
    pos = (cached_lens.to(torch.int64)[:, None]
           + torch.arange(T, device=dev)[None, :])                # [B, T]
    gidx = (tables[:, :, None] * bs
            + torch.arange(bs, device=dev)[None, None, :]).reshape(B, S)
    keys = _take_fill(k_pool.reshape(nb * bs, H, Dk), gidx)
    vals = _take_fill(v_pool.reshape(nb * bs, H, Dv), gidx)
    if k_scale is not None:
        ks = _take_fill(k_scale.reshape(nb * bs), gidx)
        vs = _take_fill(v_scale.reshape(nb * bs), gidx)
        keys = (keys.to(torch.float32) * ks[..., None, None]).to(q.dtype)
        vals = (vals.to(torch.float32) * vs[..., None, None]).to(q.dtype)
    att = (torch.einsum("bqhd,bkhd->bhqk", q, keys)
           / rounded_sqrt(Dk, q.dtype))
    m = ((torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None])
         & (gidx >= 0)[:, None, :])
    att = torch.where(m[:, None, :, :], att,
                      torch.full((), -1e9, dtype=att.dtype, device=dev))
    w = torch.softmax(att.to(torch.float32), dim=-1).to(vals.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vals)


# The routes of the CUDA kernel (csrc/paged_attention.cu). A window of at
# most SPLIT_MAX_T query rows (decode at T=1, a speculative verify window)
# takes the split route; a longer one the query-tile route, on the tensor
# cores when q is bf16 and both head dims are multiples of 16. Shapes the
# two do not take go to the generic route (the first design).
SPLIT_MAX_T = 8
SPLIT_TILE = 32        # keys per pipelined tile of the split route
QUERY_TILE = 64        # query rows per block of the query-tile route
MMA_WIDE_T = 64        # tensor-core blocks take 128 query rows past it
KEY_TILE = 64          # keys per pipelined tile of the query-tile route
MAX_HEAD_DIM = 128
MAX_TABLE = 2048       # block-table entries a fast-route block stages
# Blocks a grid should reach, in waves of the H100's SMS streaming
# multiprocessors: the tunable knobs (tuning/kernels.py,
# ``paged_attention``), here their defaults. A split block is short and
# bound by the latency of its few tiles, so the split route goes for
# DEFAULT_SPLIT_WAVES waves. A query-tile block carries a 64- or 128-row
# accumulator whose partial costs scratch bytes, so that route splits
# keys only when its grid is under TILE_SPLIT_BELOW blocks (2 waves),
# and then goes for DEFAULT_TILE_WAVES waves (0: no split).
SMS = 132
DEFAULT_SPLIT_WAVES = 8
DEFAULT_TILE_WAVES = 4
TARGET_BLOCKS = DEFAULT_SPLIT_WAVES * SMS
TILE_SPLIT_BELOW = 2 * SMS
TILE_TARGET_BLOCKS = DEFAULT_TILE_WAVES * SMS
SCRATCH_LIMIT = 1 << 30  # bytes of f32 partials a launch may allocate
ROUTE_CODES = {"generic": 0, "split": 1, "tile": 2, "tile_mma": 3}


class RoutePlan(NamedTuple):
    """The route of one launch: its name, its key splits (``n_splits``
    splits of ``split_len`` keys; 1 and the window when the grid is full
    without), and the shapes of its f32 scratch: per split and query row
    the running max and sum ``[B, H, n_splits, T, 2]`` and the
    unnormalized accumulator ``[B, H, n_splits, T, Dv]`` (empty for one
    split)."""
    route: str
    n_splits: int
    split_len: int
    scratch: tuple

    @property
    def scratch_bytes(self) -> int:
        return sum(4 * math.prod(shape) for shape in self.scratch
                   if shape)


def tuning_problem(B, T, H, Dk, mb, bs, quant) -> dict:
    """The ``paged_attention`` tuning problem of a launch (the JAX
    package's problem dict: pools are "f32" unless int8; bf16 pools
    differ from f32 ones by the lookup's dtype, q's)."""
    return {"batch": B, "q_tokens": T, "window": mb * bs,
            "block_size": bs, "heads": H, "head_dim": Dk,
            "kv_dtype": "int8" if quant else "f32"}


def plan_route(B, T, H, Dk, Dv, mb, bs, q_dtype, quant, config=None,
               device=None) -> RoutePlan:
    """Choose the kernel's route from the shapes alone (never from the
    data: the host does not read ``cached_lens``). Both fast routes load
    pool rows as 16-byte vectors, so each head dim must be a multiple of
    8, at most 128, and a whole number of 16 bytes in the pool's storage
    type (int8 pools: a multiple of 16); and each block stages its
    sequence's block-table row in shared memory, at most ``MAX_TABLE``
    entries. The key-split count makes the
    split route's grid (head, sequence, split) at least
    ``TARGET_BLOCKS`` blocks, and the query-tile route's (head,
    sequence, query tile x split) at least ``TILE_TARGET_BLOCKS`` when
    it would have fewer than ``TILE_SPLIT_BELOW`` blocks unsplit,
    where the window has enough key tiles for it. A query-tile grid
    that needs one split writes ``out`` itself (no scratch, no merge);
    the split route always merges its partials.

    The two targets are ``config``'s ``split_waves`` and ``tile_waves``
    times ``SMS`` (their defaults give the constants above); with no
    ``config`` they come from ``tuning.lookup`` for this launch's
    :func:`tuning_problem` on ``device`` (default: the current card, or
    the host)."""
    item = 1 if quant else torch.empty((), dtype=q_dtype).element_size()
    aligned = mb <= MAX_TABLE and all(
        d % 8 == 0 and d <= MAX_HEAD_DIM and (d * item) % 16 == 0
        for d in (Dk, Dv))
    S = mb * bs
    if not aligned:
        return RoutePlan("generic", 1, S, ((), ()))
    if config is None:
        from .. import tuning

        config = tuning.lookup(
            "paged_attention", tuning_problem(B, T, H, Dk, mb, bs, quant),
            dtype=dtype_utils.name(q_dtype), device=device)
    if T > SPLIT_MAX_T:
        mma = (q_dtype == torch.bfloat16 and Dk % 16 == 0
               and Dv % 16 == 0)
        route = "tile_mma" if mma else "tile"
        rows = 2 * QUERY_TILE if mma and T > MMA_WIDE_T else QUERY_TILE
        blocks, tile = B * H * -(-T // rows), KEY_TILE
        waves = config.get("tile_waves", DEFAULT_TILE_WAVES)
        target = waves * SMS if blocks < TILE_SPLIT_BELOW else 1
    else:
        route = "split"
        waves = config.get("split_waves", DEFAULT_SPLIT_WAVES)
        blocks, target, tile = B * H, waves * SMS, SPLIT_TILE
    want = max(1, -(-target // blocks))      # key splits for the target
    tiles = -(-S // tile)
    split_len = max(1, tiles // want) * tile
    n_splits = -(-S // split_len)
    if n_splits == 1 and route != "split":  # the split route always merges
        return RoutePlan(route, 1, S, ((), ()))
    return RoutePlan(route, n_splits, split_len,
                     ((B, H, n_splits, T, 2), (B, H, n_splits, T, Dv)))


def plain_split_window_attention(q, k_pool, v_pool, tables, cached_lens,
                                 *, k_scale=None, v_scale=None,
                                 n_splits, split_len=None, partials=False):
    """The split route's algorithm in torch, in the kernel's order: the
    window's keys ``[0, min(mb*bs, cached + T))`` are cut into
    ``n_splits`` splits of ``split_len`` keys; each split folds its keys
    into a partial (m, l, acc) in f32 — the max score, the sum of
    ``exp(score - m)`` and the unnormalized ``sum exp(score - m) v`` —
    with m = -inf, l = 0, acc = 0 where it sees no valid key; the merge
    weighs each split by ``exp(m_s - M)`` (zero for m_s = -inf) and
    divides. A row with no valid key comes out as zeros, as the kernel
    writes it. Keys are converted (int8: dequantized) to q's type, then
    computed on in f32. With ``partials=True`` returns ``(out, m, l,
    acc)``, the partials ``[B, H, n_splits, T]`` (acc ``[.., Dv]``)."""
    B, T, H, Dk = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    Dv = v_pool.shape[-1]
    mb = tables.shape[1]
    S = mb * bs
    if split_len is None:
        split_len = -(-S // n_splits)
    dev = q.device
    tables = tables.to(torch.int64)
    page = tables.repeat_interleave(bs, dim=1)                   # [B, S]
    gidx = page * bs + torch.arange(S, device=dev).remainder(bs)[None, :]
    ok_page = page >= 0
    gidx = torch.where(ok_page, gidx, torch.zeros_like(gidx))
    keys = k_pool.reshape(nb * bs, H, Dk)[gidx]
    vals = v_pool.reshape(nb * bs, H, Dv)[gidx]
    if k_scale is not None:
        keys = (keys.to(torch.float32)
                * k_scale.reshape(-1)[gidx][..., None, None]).to(q.dtype)
        vals = (vals.to(torch.float32)
                * v_scale.reshape(-1)[gidx][..., None, None]).to(q.dtype)
    keys, vals = keys.to(torch.float32), vals.to(torch.float32)
    pos = (cached_lens.to(torch.int64)[:, None]
           + torch.arange(T, device=dev)[None, :])              # [B, T]
    w = torch.arange(S, device=dev)
    visible = ((w[None, None, :] <= pos[:, :, None])
               & ok_page[:, None, :])                           # [B, T, S]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          keys) / rounded_sqrt(Dk, q.dtype)
    ms, ls, accs = [], [], []
    for s in range(n_splits):
        lo, hi = s * split_len, min((s + 1) * split_len, S)
        if lo >= hi:
            ms.append(torch.full((B, H, T), -math.inf, device=dev))
            ls.append(torch.zeros((B, H, T), device=dev))
            accs.append(torch.zeros((B, H, T, Dv), device=dev))
            continue
        sc = scores[..., lo:hi]
        vis = visible[:, None, :, lo:hi]
        sc = torch.where(vis, sc, torch.full((), -math.inf, device=dev))
        m = sc.amax(-1)                                           # [B,H,T]
        live = m > -math.inf
        p = torch.where(vis & live[..., None],
                        torch.exp(sc - torch.where(live, m, 0.0)[..., None]),
                        torch.zeros((), device=dev))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", p, vals[:, lo:hi]))
    m = torch.stack(ms, 2)                                      # [B,H,n,T]
    big = m.amax(2, keepdim=True)
    live = m > -math.inf
    wgt = torch.where(live, torch.exp(m - torch.where(live, big, 0.0)),
                      torch.zeros((), device=dev))
    l_sum = (wgt * torch.stack(ls, 2)).sum(2)                   # [B,H,T]
    acc = (wgt[..., None] * torch.stack(accs, 2)).sum(2)        # [B,H,T,Dv]
    out = torch.where(l_sum[..., None] > 0,
                      acc / torch.where(l_sum > 0, l_sum, 1.0)[..., None],
                      torch.zeros((), device=dev))
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    if partials:
        return out, m, torch.stack(ls, 2), torch.stack(accs, 2)
    return out


# q, k_pool, v_pool, tables, cached_lens, out, scratch_ml, scratch_acc;
# B, T, H, Dk, Dv, nb, bs, mb, route, n_splits, split_len; stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
             + [ctypes.c_void_p])
# the int8 entry points take k_scale, v_scale after the pools
_ARGTYPES_Q8 = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                + [ctypes.c_void_p])
_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper


def _library():
    lib = _cuda.load("paged_attention")
    if not getattr(lib, "_bound", False):
        for fn in (lib.paged_window_attention_f32,
                   lib.paged_window_attention_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        for fn in (lib.paged_window_attention_q8_f32,
                   lib.paged_window_attention_q8_bf16):
            fn.argtypes = _ARGTYPES_Q8
            fn.restype = ctypes.c_int
        lib.paged_window_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.paged_window_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


# The kernel as a torch.library custom op (see ops/flash_attention.py):
# the CPU kernel is plain_window_attention, the CUDA kernel plans a route
# and launches it.


@torch.library.custom_op("paddle_tpu_torch::paged_window_attention",
                         mutates_args=(), device_types="cpu")
def _paged_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
              tables: torch.Tensor, cached_lens: torch.Tensor,
              k_scale: Optional[torch.Tensor],
              v_scale: Optional[torch.Tensor],
              route: Optional[str], split_waves: Optional[int] = None,
              tile_waves: Optional[int] = None) -> torch.Tensor:
    return plain_window_attention(q, k_pool, v_pool, tables, cached_lens,
                                  k_scale=k_scale,
                                  v_scale=v_scale).contiguous()


@_paged_op.register_fake
def _(q, k_pool, v_pool, tables, cached_lens, k_scale, v_scale, route,
      split_waves=None, tile_waves=None):
    return q.new_empty(tuple(q.shape[:3]) + (v_pool.shape[-1],))


@_paged_op.register_kernel("cuda")
def _(q, k_pool, v_pool, tables, cached_lens, k_scale, v_scale, route,
      split_waves=None, tile_waves=None):
    quant = k_scale is not None
    B, T, H, Dk = q.shape
    enforce(k_pool.dim() == 4 and v_pool.dim() == 4,
            "paged_window_attention: pools must be [nb, bs, H, D]")
    nb, bs = int(k_pool.shape[0]), int(k_pool.shape[1])
    Dv = int(v_pool.shape[-1])
    enforce(tuple(k_pool.shape) == (nb, bs, H, Dk)
            and tuple(v_pool.shape[:3]) == (nb, bs, H),
            "paged_window_attention: pool shapes %s / %s do not match q %s"
            % (tuple(k_pool.shape), tuple(v_pool.shape), tuple(q.shape)))
    enforce(tables.dim() == 2 and tables.shape[0] == B
            and tuple(cached_lens.shape) == (B,),
            "paged_window_attention: tables must be [B, mb] and "
            "cached_lens [B] for B=%d" % B)
    mb = int(tables.shape[1])
    enforce(q.dtype in (torch.float32, torch.bfloat16),
            "paged_window_attention: q must be float32 or bfloat16, got %s"
            % q.dtype)
    pool_dtype = torch.int8 if quant else q.dtype
    enforce(k_pool.dtype == pool_dtype and v_pool.dtype == pool_dtype,
            "paged_window_attention: pools must be %s, got %s / %s"
            % (pool_dtype, k_pool.dtype, v_pool.dtype))
    scales = (k_scale, v_scale) if quant else ()
    for sc in scales:
        enforce(sc.dtype == torch.float32 and sc.numel() == nb * bs,
                "paged_window_attention: scale pools must be float32 "
                "[nb, bs] = [%d, %d], got %s %s"
                % (nb, bs, sc.dtype, tuple(sc.shape)))
    enforce(tables.dtype == torch.int32 and cached_lens.dtype == torch.int32,
            "paged_window_attention: tables and cached_lens must be int32")
    for t in (k_pool, v_pool, tables, cached_lens) + scales:
        enforce(t.device == q.device,
                "paged_window_attention: inputs on %s and %s"
                % (q.device, t.device))
    for t in (q, k_pool, v_pool, tables, cached_lens) + scales:
        enforce(t.is_contiguous(),
                "paged_window_attention: inputs must be contiguous")
    enforce(nb * bs * H * max(Dk, Dv) < 2 ** 31 and B <= 65535,
            "paged_window_attention: pool or batch too large for the "
            "kernel's 32-bit slot indexing")
    config = None
    if split_waves is not None or tile_waves is not None:
        config = {"split_waves": (DEFAULT_SPLIT_WAVES if split_waves is None
                                  else split_waves),
                  "tile_waves": (DEFAULT_TILE_WAVES if tile_waves is None
                                 else tile_waves)}
    plan = (RoutePlan("generic", 1, mb * bs, ((), ())) if route
            else plan_route(B, T, H, Dk, Dv, mb, bs, q.dtype, quant,
                            config=config, device=q.device))
    lib = _library()
    if plan.route == "generic":
        smem = lib.paged_window_attention_smem_bytes(T, Dk, Dv)
        enforce(smem <= _SMEM_LIMIT,
                "paged_window_attention: Dk=%d, Dv=%d need %d bytes of "
                "shared memory per query tile (limit %d)"
                % (Dk, Dv, smem, _SMEM_LIMIT))
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    ml, acc = (torch.empty(shape, dtype=torch.float32, device=q.device)
               for shape in plan.scratch)
    bf16 = q.dtype == torch.bfloat16
    ptrs = [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr()]
    if quant:
        fn = (lib.paged_window_attention_q8_bf16 if bf16
              else lib.paged_window_attention_q8_f32)
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    else:
        fn = (lib.paged_window_attention_bf16 if bf16
              else lib.paged_window_attention_f32)
    ptrs += [tables.data_ptr(), cached_lens.data_ptr(), out.data_ptr(),
             ml.data_ptr(), acc.data_ptr()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, B, T, H, Dk, Dv, nb, bs, mb,
                 ROUTE_CODES[plan.route], plan.n_splits, plan.split_len,
                 stream)
    if err != 0:
        raise RuntimeError("paged_window_attention: kernel launch failed "
                           "(%s route): CUDA error %d (%s)" % (
                               plan.route, err,
                               lib.paged_attention_error_string(
                                   err).decode()))
    fn_self = paged_window_attention
    fn_self.launches += 1
    if quant:
        fn_self.int8_launches += 1
    if plan.route == "split":
        fn_self.split_launches += 1
    elif plan.route == "generic":
        fn_self.generic_launches += 1
    else:
        fn_self.tile_launches += 1
        if plan.route == "tile_mma":
            fn_self.mma_launches += 1
    return out




def paged_window_attention(q, k_pool, v_pool, tables, cached_lens, *,
                           k_scale=None, v_scale=None, route=None,
                           config=None):
    """Window attention over the paged KV pool (the contract of
    :func:`plain_window_attention`).

    The ``paged_window_attention`` op: CPU tensors take the plain
    version. CUDA tensors launch the kernel:
    q float32 or bfloat16; pools of q's type, or int8 codes with
    ``k_scale``/``v_scale`` (given together) float32 ``[nb, bs]`` scale
    pools; tables and cached_lens int32; all contiguous on one device;
    anything else raises. Any window length T launches. The route comes
    from :func:`plan_route` (the shapes alone, and the tuned knobs:
    ``config``, a ``paged_attention`` config, fixes them for this call,
    as a sweep's candidate does; None looks them up); ``route="generic"``
    launches the generic route's kernel instead, on any shape (the yardstick
    ``chip_smoke.py`` times beside the planned route). For rows with at
    least one valid key the kernel
    matches the plain version; a fully masked row (an inactive slot)
    comes out as zeros, where the plain version averages whatever the
    wrapped ``-1`` indices gather — both are finite, and neither is ever
    read."""
    enforce((k_scale is None) == (v_scale is None),
            "paged_window_attention: k_scale and v_scale go together")
    quant = k_scale is not None
    enforce(route in (None, "generic"),
            "paged_window_attention: route must be None or 'generic', "
            "got %r" % (route,))
    for t in (k_pool, v_pool, tables, cached_lens) + (
            (k_scale, v_scale) if quant else ()):
        enforce(t.device == q.device,
                "paged_window_attention: q is on %s but an input is on %s"
                % (q.device, t.device))
    config = config or {}
    return _paged_op(q, k_pool, v_pool, tables, cached_lens, k_scale,
                     v_scale, route, config.get("split_waves"),
                     config.get("tile_waves"))


# .launches counts every kernel launch; .int8_launches those on int8
# pools; .split_launches, .tile_launches (.mma_launches: those on the
# tensor cores) and .generic_launches those of each route
LAUNCH_COUNTS = ("launches", "int8_launches", "split_launches",
                 "tile_launches", "mma_launches", "generic_launches")
_cuda.register_launcher(paged_window_attention, LAUNCH_COUNTS)
