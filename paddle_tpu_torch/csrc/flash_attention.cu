// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels (dQ; dK/dV), with a plain C interface for ctypes
// (paddle_tpu_torch/ops/flash_attention.py binds and launches them;
// paddle_tpu_torch/ops/_cuda.py builds this file with nvcc).
//
// Replaces paddle_tpu/ops/flash_attention.py: _mha_forward (Pallas body
// _fwd_kernel) and _mha_backward (bodies _bwd_dq_kernel and
// _bwd_dkv_kernel).
//
// Computes, for batch b, head h, query row i and key j of q, k, v in the
// public [B, T, H, D] layout (read through strides):
//   s[i, j] = q[i] . k[j] * scale, or -inf where kv_mask[b, j] <= 0, or,
//             under causal, where j > i;
//   forward:  o[i] = sum_j softmax_j(s[i]) v[j],  lse[i] = logsumexp_j s[i];
//             a row with no valid key writes o = 0 and lse = +inf;
//   backward: p = exp(s - lse), delta[i] = dO[i] . o[i],
//             ds = p * (dO[i] . v[j] - delta[i]) * scale,
//             dq[i] = sum_j ds[i, j] k[j],  dk[j] = sum_i ds[i, j] q[i],
//             dv[j] = sum_i p[i, j] dO[i].
// Sums, max and exponentials run in f32 whatever the storage type
// (float or bfloat16); head dims 64 and 128 are instantiated.
//
// Bounds on an H100 (3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores,
// 989 TFLOP/s bf16 on them). Per (batch, head) the forward does
// 4*Tq*Tk*D flops, dQ 6*Tq*Tk*D and dK/dV 8*Tq*Tk*D (fewer under causal
// and key masks) on inputs of O(T*D) bytes. At the training shape (B=32,
// T=256, H=8, D=64, ragged key masks) that makes f32 bound by operations
// (forward 0.046 ms, dQ 0.069 ms, dK/dV 0.091 ms of FMAs against ~0.02-
// 0.03 ms of bytes each) and bf16 bound by bytes (each kernel reads q, k,
// v (dO, o) once and writes its outputs: forward ~0.010 ms, dQ and dK/dV
// ~0.015 ms each, against 0.003-0.006 ms of tensor-core operations).
//
// The forward, redesigned for Hopper:
// - one block per (64-row query tile, batch*head), longest causal tiles
//   first, walking 64-key (bf16) or 32-key (f32) tiles only up to the
//   causal end and the last key the mask lets through (key_end, shared
//   with dQ); a query tile with nothing to walk writes o = 0, lse = +inf;
// - bf16, D=64 and 128: one warpgroup; Q staged once and K, V streamed
//   through two-stage cp.async rings, all in the 128-byte swizzle
//   layout; S = Q K^T on wgmma m64n64k16 with both operands read from
//   shared memory; the softmax in the accumulator registers with one
//   exp2 a score; P packed as the A fragments of O += P V (V MN-major),
//   never stored; in FA3's order, S_i and tile i-1's O += P V are issued
//   back to back and tile i's softmax runs while O += P V does, so the
//   tensor cores work across the softmax. Rounding: the tensor cores
//   take p as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi) (16
//   significant bits: one bf16 rounding, as other bf16 flash kernels
//   do, would put o past one bf16 ulp of the unrounded forward at long
//   context), while the row sum l takes the unrounded p in f32
//   (ops/flash_attention.py: plain_flash_forward_bf16 models this);
//   42,496 B a block at D=64, 83,456 B at D=128;
// - f32, D=64 and 128: no TF32; 4x4 register micro-tiles of scalar FMAs
//   fed by float4 loads, K and V through a two-stage cp.async ring, P
//   through one padded shared tile; 61,696 B a block at D=64 (three
//   blocks an SM), 110,848 B at D=128 (two).
//
// The backward pair, redesigned for Hopper:
// - two kernels, no atomics, so every run gives the same bits: dQ (also
//   writing delta) one block per (64-row query tile, batch*head), longest
//   causal tiles first, walking key tiles up to the causal end and to the
//   last key the mask lets through; dK/dV one block per (64-row key tile,
//   batch*head) walking query tiles from the causal start (a key tile the
//   mask wholly excludes writes zeros without walking);
// - operands staged in their storage type (bf16 as bf16) through a ring
//   of 16-byte cp.async copies, so the next tiles land while one is
//   computed; the dQ kernel stages O for delta in the ring's last stage;
//   rows padded (or swizzled) so copies, ldmatrix and float4 loads hit no
//   bank conflicts;
// - bf16, D=64 (the training shape): both products of each kernel on the
//   tensor cores as wgmma m64n64k16 (f32 accumulate): the block is one
//   warpgroup of 64 rows, its fixed operand enters as A fragments from
//   registers, and the streamed tiles, staged in the 128-byte swizzle
//   layout, are read by the tensor cores from shared memory once per
//   block, K-major for S = Q K^T (S^T = K Q^T) and MN-major for the second
//   products; P and dS are computed in the accumulator registers, rounded
//   to bf16 and re-packed as the A fragments of the second products, never
//   written to shared memory (ops/flash_attention.py:
//   plain_flash_backward_bf16 models that rounding); 72 KB (dQ, three
//   blocks an SM) and 70 KB (dK/dV, two: its four accumulators) a block;
// - bf16, D=128: the same walks on mma.sync m16n8k16 fed by ldmatrix
//   (the wgmma accumulators of a 128-wide head do not fit beside the
//   rest), two blocks an SM;
// - f32: no TF32 (the f32 tolerances rule it out); scalar FMAs in 4x4
//   register micro-tiles fed by float4 loads (8 loads for 64 FMAs in the
//   score products, 8 for 128 in the second ones), P and dS through one
//   shared tile each for the second products, 128 threads a block, two
//   blocks an SM at D=64.
// What still holds them back (PERF.md, profile_flash.py): at T=256 the
// dQ block's prologue (its q, dO and O tiles arrive while every block of
// the wave loads at once: ~45 % of its cycles); the f32 route reaches
// about a third of the f32 FMA peak. Occupancy at D=64 falls short of
// three blocks an SM in three of the four kernels: only the bf16 dQ
// kernel has three; the bf16 dK/dV kernel is held to two by its
// registers (four accumulator sets), the f32 kernels by their shared
// memory (97 KB dQ, 106 KB dK/dV). Each wgmma batch is waited for before
// the softmax that follows it, so no tensor-core work overlaps it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;  // query rows and key rows per tile

struct Strides {
  long long b, t, h;  // elements; the head dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;
  const void* o;
  const float* mask;  // [B, Tk] (batch stride mask_sb) or null
  float* lse;         // [B, H, Tq]
  float* delta;       // [B, H, Tq]
  void* out0;         // o | dq | dk
  void* out1;         // dv
  int heads, tq, tk;
  Strides sq, sk, sv, sdo, so;
  long long mask_sb;
  int causal;
  float scale;
};

// ------------------------------------------------------------ backward
// Two kernels, two passes, no atomics: dQ runs one block per (64-row
// query tile, batch*head) over key tiles up to the causal end and the
// last key the mask lets through (longest causal tiles first); dK/dV one
// block per (64-row key tile, batch*head) over query tiles from the
// causal start. Each block stages its fixed tiles once and streams the
// other operand's tiles through a ring of 16-byte cp.async copies, so the
// next tiles are in flight while one is computed; the dQ kernel stages O
// for delta in the ring's last stage before the walk needs it. Apart
// from the key mask, no thread waits on a device-memory load of its own.
// Rows are padded so copies, ldmatrix and float4 loads hit no bank
// conflicts.

// Phase clocks for profile_flash.py, compiled in only with -DFLASH_PROBE:
// thread 0 of each block adds the cycles since its last probe to a
// per-kernel, per-phase sum (kernel k: slots 4k .. 4k + 3 = prologue,
// waits for the ring and the barrier, compute, epilogue; k = 0 .. 3 the
// bf16 and f32 dQ and dK/dV kernels, 4 the bf16 forward, 5 the f32 one).
#ifdef FLASH_PROBE
constexpr int kProbeSlots = 24;
__device__ unsigned long long flash_probe_cycles[kProbeSlots];
#define PROBE_T0 long long probe_t = clock64();
#define PROBE(k)                                                  \
  do {                                                            \
    if (threadIdx.x == 0) {                                       \
      const long long now = clock64();                            \
      atomicAdd(&flash_probe_cycles[k],                           \
                (unsigned long long)(now - probe_t));             \
      probe_t = now;                                              \
    }                                                             \
  } while (0)
#else
#define PROBE_T0
#define PROBE(k)
#endif

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Tensor-core routes (bf16): 4 warps (one warpgroup), each owns 16 rows
// of the block's fixed 64-row tile, padded rows of kLd bytes; k-steps
// and n-tiles over the head dim.
constexpr int kMmaThreads = 128;
template <int D>
struct Mma {
  static constexpr int kLd = D * 2 + 16;
  static constexpr int kTile = 64 * kLd;
  static constexpr int kKSteps = D / 16;
  static constexpr int kDTiles = D / 8;
};
// The mma.sync kernels take D = 128 only (D = 64 takes wgmma). They
// stream 64 keys (dQ) or 32 queries (dK/dV: with the dK and dV
// accumulators, 64 would spill) through two stages, two blocks an SM.
constexpr int kSyncD = 128;
using MmaSync = Mma<kSyncD>;
constexpr int kSyncK = 64;
constexpr int kSyncQ = 32;
constexpr int kSyncStages = 2;

// f32 route: 128 threads, thread (tx, ty) = (tid % 8, tid / 8) owns rows
// 4 ty .. 4 ty + 3 of each product, columns tx + 8 j of a score tile (a
// 4x4 micro-tile) and 4 tx .. 4 tx + 3 (+ 32, 64, 96) of the head dim.
// Rows are D + 4 words apart (float4-aligned, four banks apart), score
// tiles (P, dS) 32 + 4. Streamed tiles of 32 keys (dQ) or queries
// (dK/dV) keep two blocks on an SM at D=64.
constexpr int kTX = 8;  // lanes along the columns
constexpr int kF32Threads = 16 * kTX;
template <int D>
struct F32 {
  static constexpr int kLdW = D + 4;
  static constexpr int kLd = kLdW * 4;
  static constexpr int kTile = 64 * kLd;
  static constexpr int kK = 32;
  static constexpr int kQ = 32;
  static constexpr int kLdS = 32 + 4;
  static constexpr int kCols = D / (4 * kTX);  // float4 column groups
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
};

// rows [row0, row0 + rows) of (b, h) of a [B, T, H, D] tensor (base has
// b and h applied, st is the time stride) into shared memory, `ld`
// bytes a row, by 16-byte cp.async; rows past n_rows are zero-filled
template <typename T, int D, int kN>
__device__ __forceinline__ void issue_rows(unsigned char* dst, int ld,
                                           const T* base, long long st,
                                           int row0, int rows, int n_rows) {
  constexpr int kVec = D * (int)sizeof(T) / 16;
  for (int c = threadIdx.x; c < rows * kVec; c += kN) {
    const int r = c / kVec, v = c - r * kVec;
    const bool ok = row0 + r < n_rows;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        base + (ok ? (long long)(row0 + r) * st : 0));
    cp_async16(dst + r * ld + v * 16, src + v * 16, ok);
  }
}

// floats [i0, i0 + count) of src into dst by 4-byte cp.async; past n
// zero-filled
template <int kN>
__device__ __forceinline__ void issue_floats(float* dst, const float* src,
                                             int i0, int n, int count) {
  for (int c = threadIdx.x; c < count; c += kN) {
    const bool ok = i0 + c < n;
    cp_async4(dst + c, src + (ok ? i0 + c : 0), ok);
  }
}

// 1 + the last key the mask lets through (tk without a mask): keys past
// it are masked for every row, so their tiles are skipped. With kFull,
// *full gets the first key the mask stops (tk if none): every key before
// it passes, so a tile below it needs no mask.
template <int kN, bool kFull = false>
__device__ int key_end(const float* mrow, int tk, int* full = nullptr) {
  __shared__ int red[kFull ? 2 : 1][kN / 32];
  if (mrow == nullptr) {
    if constexpr (kFull) *full = tk;
    return tk;
  }
  int last = -1, hole = tk;
  for (int j = threadIdx.x; j < tk; j += kN) {
    if (mrow[j] > 0.f)
      last = j;
    else if (kFull)
      hole = min(hole, j);
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) red[0][threadIdx.x >> 5] = last;
  if constexpr (kFull) {
    hole = __reduce_min_sync(0xffffffffu, hole);
    if ((threadIdx.x & 31) == 0) red[1][threadIdx.x >> 5] = hole;
  }
  __syncthreads();
  int m = red[0][0];
#pragma unroll
  for (int w = 1; w < kN / 32; ++w) m = max(m, red[0][w]);
  if constexpr (kFull) {
    int f = red[1][0];
#pragma unroll
    for (int w = 1; w < kN / 32; ++w) f = min(f, red[1][w]);
    *full = f;
  }
  return m + 1;
}

// 16 bytes of shared memory as f32: 8 bf16 or 4 f32 values
__device__ __forceinline__ void vec_f32(const unsigned char* src, float* out,
                                        const bf16*) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void vec_f32(const unsigned char* src, float* out,
                                        const float*) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

// delta = rowsum(dO * O) in f32 for a tile's 64 rows, both staged: 16
// lanes a row in a fixed order, so every run gives the same bits;
// written to delta_s and, for rows < tq, out
template <typename T, int D, int kN>
__device__ void tile_delta(const unsigned char* do_s,
                           const unsigned char* o_s, int ld, int q0, int tq,
                           float* delta_s, float* out) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kVec = D / kPer;
  const int l = threadIdx.x & 15;
  for (int r = threadIdx.x >> 4; r < 64; r += kN / 16) {
    float sum = 0.f;
    for (int v = l; v < kVec; v += 16) {
      float a[8], c[8];
      vec_f32(do_s + r * ld + v * 16, a, static_cast<const T*>(nullptr));
      vec_f32(o_s + r * ld + v * 16, c, static_cast<const T*>(nullptr));
#pragma unroll
      for (int e = 0; e < kPer; ++e) sum = fmaf(a[e], c[e], sum);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (l == 0) {
      delta_s[r] = sum;
      if (q0 + r < tq) out[q0 + r] = sum;
    }
  }
}

// The prologue the dQ kernels share: stage q, dO, O (in the ring's last
// stage, free until the walk reaches it) and lse of the query tile, find
// the walk's end (n_tiles key tiles), start the first key tiles, compute
// delta.
template <typename T, int D, int kN, int kLd, int kK, int kS, typename Issue>
__device__ void dq_prologue(const Params& p, int b, int h, int bh, int q0,
                            unsigned char* q_s, unsigned char* do_s,
                            unsigned char* o_s, float* lse_s, float* delta_s,
                            const float* mrow, Issue& issue, int& n_tiles) {
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* dob = static_cast<const T*>(p.d_o) + b * p.sdo.b + h * p.sdo.h;
  const T* ob = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h;
  issue_rows<T, D, kN>(q_s, kLd, qb, p.sq.t, q0, 64, p.tq);
  issue_rows<T, D, kN>(do_s, kLd, dob, p.sdo.t, q0, 64, p.tq);
  issue_rows<T, D, kN>(o_s, kLd, ob, p.so.t, q0, 64, p.tq);
  issue_floats<kN>(lse_s, p.lse + (long long)bh * p.tq, q0, p.tq, 64);
  cp_async_commit();
  const int k_end = min(p.causal ? min(p.tk, q0 + 64) : p.tk,
                        key_end<kN>(mrow, p.tk));
  n_tiles = (max(k_end, 0) + kK - 1) / kK;
#pragma unroll
  for (int it = 0; it < kS - 1; ++it) issue(it);
  cp_async_wait<kS - 1>();  // q, dO, O and lse landed
  __syncthreads();
  tile_delta<T, D, kN>(do_s, o_s, kLd, q0, p.tq, delta_s,
                       p.delta + (long long)bh * p.tq);
  __syncthreads();  // delta_s is read below; the ring's last stage is free
}

// ---------------------------------------- dQ, bf16 mma.sync (D = 128)
// Shared memory: q and dO tiles, lse and delta of the tile's rows, and
// the ring of K and V tiles with their key mask.
constexpr size_t dq_mma_smem() {
  return 2 * MmaSync::kTile + 2 * 64 * 4 +
         kSyncStages * (2 * kSyncK * MmaSync::kLd + kSyncK * 4);
}

// Per key tile each warp computes S = Q K^T and dP = dO V^T for its 16
// query rows (mma.sync m16n8k16, bf16 in, f32 accumulate; Q and dO by
// ldmatrix, K and V by ldmatrix as the col-major operand), turns them
// into dS = P (dP - delta) scale in registers, rounds dS to bf16 into the
// A fragment of the next product and adds dS K into dQ (K by
// ldmatrix.trans). dS never leaves the registers.
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dq_mma_kernel(const Params p) {
  PROBE_T0
  constexpr int D = kSyncD;
  using M = MmaSync;
  constexpr int kS = kSyncStages;
  constexpr int kK = kSyncK;
  constexpr int kKTile = kK * M::kLd;
  constexpr int kStage = 2 * kKTile + kK * 4;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* q_s = dsmem;
  unsigned char* do_s = q_s + M::kTile;
  float* lse_s = reinterpret_cast<float*>(do_s + M::kTile);
  float* delta_s = lse_s + 64;
  unsigned char* ring = reinterpret_cast<unsigned char*>(delta_s + 64);

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  // under causal the last query tiles have the most keys: start them first
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* mrow = p.mask == nullptr ? nullptr : p.mask + b * p.mask_sb;

  int n_tiles = 0;
  auto issue = [&](int it) {  // key tile `it` into its stage, if any
    if (it < n_tiles) {
      unsigned char* st = ring + (it % kS) * kStage;
      issue_rows<bf16, D, kMmaThreads>(st, M::kLd, kb, p.sk.t, it * kK, kK,
                                       p.tk);
      issue_rows<bf16, D, kMmaThreads>(st + kKTile, M::kLd, vb, p.sv.t,
                                       it * kK, kK, p.tk);
      if (mrow != nullptr)
        issue_floats<kMmaThreads>(reinterpret_cast<float*>(st + 2 * kKTile),
                                  mrow, it * kK, p.tk, kK);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  dq_prologue<bf16, D, kMmaThreads, M::kLd, kK, kS>(
      p, b, h, bh, q0, q_s, do_s, ring + (kS - 1) * kStage, lse_s,
      delta_s, mrow, issue, n_tiles);

  // this lane's rows: warp * 16 + g and + 8 (rows past Tq: p = 0)
  float lse2[2], dlt[2];
  int qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    qrow[i] = q0 + r;
    lse2[i] = qrow[i] < p.tq ? lse_s[r] * kLog2e : INFINITY;
    dlt[i] = delta_s[r];
  }
  const float sc2 = p.scale * kLog2e;
  const int arow = warp * 16 + (lane & 15);

  float dq[M::kDTiles][4];
#pragma unroll
  for (int n = 0; n < M::kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  PROBE(0);
  for (int it = 0; it < n_tiles; ++it) {
    PROBE(2);
    cp_async_wait<kS - 2>();
    __syncthreads();  // tile `it` landed; tile it-1's stage is free
    issue(it + kS - 1);
    PROBE(1);
    const unsigned char* kt = ring + (it % kS) * kStage;
    const unsigned char* vt = kt + kKTile;
    const float* mk = reinterpret_cast<const float*>(vt + kKTile);
    const int k0 = it * kK;

    float s[kK / 8][4], dp[kK / 8][4];
#pragma unroll
    for (int n = 0; n < kK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk) {
      unsigned qa[4], da[4];
      const int acol = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_u32(q_s + arow * M::kLd + acol * 2), qa);
      ldsm_x4(smem_u32(do_s + arow * M::kLd + acol * 2), da);
#pragma unroll
      for (int np = 0; np < kK / 16; ++np) {
        const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned kf[4], vf[4];
        ldsm_x4(smem_u32(kt + key * M::kLd + col * 2), kf);
        ldsm_x4(smem_u32(vt + key * M::kLd + col * 2), vf);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }
    // dS = P (dP - delta) scale, P = exp(S scale - lse), 0 where masked
#pragma unroll
    for (int n = 0; n < kK / 8; ++n) {
      const int c = 8 * n + 2 * qd, key = k0 + c;
      const float2 m = mrow == nullptr
                           ? make_float2(1.f, 1.f)
                           : *reinterpret_cast<const float2*>(mk + c);
      const bool ok0 = key < p.tk && m.x > 0.f;
      const bool ok1 = key + 1 < p.tk && m.y > 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kj = key + (e & 1);
        const bool ok = ((e & 1) ? ok1 : ok0) && (!p.causal || kj <= qrow[i]);
        const float pr = ok ? exp2f(fmaf(s[n][e], sc2, -lse2[i])) : 0.f;
        s[n][e] = pr * (dp[n][e] - dlt[i]) * p.scale;
      }
    }
    // dQ += dS K over k-steps of 16 keys
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < M::kDTiles / 2; ++np) {
        const int key = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = 16 * np + (lane >> 4) * 8;
        unsigned kf[4];
        ldsm_x4_trans(smem_u32(kt + key * M::kLd + col * 2), kf);
        mma_bf16(dq[2 * np], a, kf[0], kf[1]);
        mma_bf16(dq[2 * np + 1], a, kf[2], kf[3]);
      }
    }
  }
  PROBE(2);
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(p.out0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= p.tq) continue;
    bf16* orow = out + (((long long)b * p.tq + qrow[i]) * p.heads + h) * D;
#pragma unroll
    for (int n = 0; n < M::kDTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * qd) =
          __floats2bfloat162_rn(dq[n][2 * i], dq[n][2 * i + 1]);
  }
  PROBE(3);
}

// ------------------------------------- dK/dV, bf16 mma.sync (D = 128)
// Shared memory: k and v tiles, and the ring of q and dO tiles (kQ rows)
// with the lse and delta of their rows.
constexpr size_t dkv_mma_smem() {
  return 2 * MmaSync::kTile +
         kSyncStages * (2 * kSyncQ * MmaSync::kLd + 2 * kSyncQ * 4);
}

// The key tile's validity, shared by the dK/dV kernels: kok[i] for keys
// k0 + row(i) (the mask's batch row, keys past Tk invalid); true in
// every thread when any key of the tile is valid.
template <int kRows>
__device__ __forceinline__ bool key_tile_ok(const Params& p, int b, int k0,
                                            const int* rows, bool* kok) {
  bool mine = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + rows[i];
    kok[i] = key < p.tk &&
             (p.mask == nullptr || p.mask[b * p.mask_sb + key] > 0.f);
    mine |= kok[i];
  }
  return __syncthreads_or(mine);
}

// Per query tile each warp computes S^T = K Q^T and dP^T = V dO^T for its
// 16 keys, P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q
// with P^T and dS^T rounded to bf16 into A fragments (dO and Q by
// ldmatrix.trans). A key tile the mask wholly excludes skips the walk.
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dkv_mma_kernel(const Params p) {
  PROBE_T0
  constexpr int D = kSyncD;
  using M = MmaSync;
  constexpr int kS = kSyncStages;
  constexpr int kQ = kSyncQ;
  constexpr int kQTile = kQ * M::kLd;
  constexpr int kStage = 2 * kQTile + 2 * kQ * 4;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* k_s = dsmem;
  unsigned char* v_s = k_s + M::kTile;
  unsigned char* ring = v_s + M::kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.y * 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const bf16* dob =
      static_cast<const bf16*>(p.d_o) + b * p.sdo.b + h * p.sdo.h;
  const float* lse_g = p.lse + (long long)bh * p.tq;
  const float* delta_g = p.delta + (long long)bh * p.tq;

  issue_rows<bf16, D, kMmaThreads>(k_s, M::kLd, kb, p.sk.t, k0, 64, p.tk);
  issue_rows<bf16, D, kMmaThreads>(v_s, M::kLd, vb, p.sv.t, k0, 64, p.tk);
  cp_async_commit();
  // this lane's keys: rows warp * 16 + g and + 8 of the tile
  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
  int key[2];
  bool kok[2];
  const bool any = key_tile_ok<2>(p, b, k0, rows, kok);
  key[0] = k0 + rows[0];
  key[1] = k0 + rows[1];
  // under causal no query before k0 sees a key of this tile
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = any ? (max(p.tq - q_start, 0) + kQ - 1) / kQ : 0;

  auto issue = [&](int it) {  // query tile `it` into its stage, if any
    if (it < n_tiles) {
      unsigned char* st = ring + (it % kS) * kStage;
      const int r0 = q_start + it * kQ;
      issue_rows<bf16, D, kMmaThreads>(st, M::kLd, qb, p.sq.t, r0, kQ, p.tq);
      issue_rows<bf16, D, kMmaThreads>(st + kQTile, M::kLd, dob, p.sdo.t, r0,
                                       kQ, p.tq);
      float* stats = reinterpret_cast<float*>(st + 2 * kQTile);
      issue_floats<kMmaThreads>(stats, lse_g, r0, p.tq, kQ);
      issue_floats<kMmaThreads>(stats + kQ, delta_g, r0, p.tq, kQ);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < kS - 1; ++it) issue(it);

  const float sc2 = p.scale * kLog2e;
  const int arow = warp * 16 + (lane & 15);
  float dk[M::kDTiles][4], dv[M::kDTiles][4];
#pragma unroll
  for (int n = 0; n < M::kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  PROBE(4);
  for (int it = 0; it < n_tiles; ++it) {
    PROBE(6);
    cp_async_wait<kS - 2>();
    __syncthreads();  // tile `it` (and k, v) landed; tile it-1's stage free
    issue(it + kS - 1);
    PROBE(5);
    const unsigned char* qt = ring + (it % kS) * kStage;
    const unsigned char* dot = qt + kQTile;
    const float* lse_s = reinterpret_cast<const float*>(dot + kQTile);
    const float* dl_s = lse_s + kQ;
    const int r0 = q_start + it * kQ;

    float st[kQ / 8][4], dpt[kQ / 8][4];
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk) {
      unsigned ka[4], va[4];
      const int acol = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_u32(k_s + arow * M::kLd + acol * 2), ka);
      ldsm_x4(smem_u32(v_s + arow * M::kLd + acol * 2), va);
#pragma unroll
      for (int np = 0; np < kQ / 16; ++np) {
        const int row = 16 * np + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned qf[4], df[4];
        ldsm_x4(smem_u32(qt + row * M::kLd + col * 2), qf);
        ldsm_x4(smem_u32(dot + row * M::kLd + col * 2), df);
        mma_bf16(st[2 * np], ka, qf[0], qf[1]);
        mma_bf16(st[2 * np + 1], ka, qf[2], qf[3]);
        mma_bf16(dpt[2 * np], va, df[0], df[1]);
        mma_bf16(dpt[2 * np + 1], va, df[2], df[3]);
      }
    }
    // P^T and dS^T = P^T (dP^T - delta) scale, 0 where masked
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) {
      const int c = 8 * n + 2 * qd;
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, query = r0 + c + (e & 1);
        const bool ok = kok[i] && query < p.tq &&
                        (!p.causal || key[i] <= query);
        const float l = (e & 1) ? lse.y : lse.x;
        const float d = (e & 1) ? dl.y : dl.x;
        const float pr = ok ? exp2f(fmaf(st[n][e], sc2, -l * kLog2e)) : 0.f;
        st[n][e] = pr;
        dpt[n][e] = pr * (dpt[n][e] - d) * p.scale;
      }
    }
    // dV += P^T dO, dK += dS^T Q over k-steps of 16 queries
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      unsigned pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * ks][0], st[2 * ks][1]);
      pa[1] = pack_bf16(st[2 * ks][2], st[2 * ks][3]);
      pa[2] = pack_bf16(st[2 * ks + 1][0], st[2 * ks + 1][1]);
      pa[3] = pack_bf16(st[2 * ks + 1][2], st[2 * ks + 1][3]);
      sa[0] = pack_bf16(dpt[2 * ks][0], dpt[2 * ks][1]);
      sa[1] = pack_bf16(dpt[2 * ks][2], dpt[2 * ks][3]);
      sa[2] = pack_bf16(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]);
      sa[3] = pack_bf16(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < M::kDTiles / 2; ++np) {
        const int row = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = 16 * np + (lane >> 4) * 8;
        unsigned df[4], qf[4];
        ldsm_x4_trans(smem_u32(dot + row * M::kLd + col * 2), df);
        ldsm_x4_trans(smem_u32(qt + row * M::kLd + col * 2), qf);
        mma_bf16(dv[2 * np], pa, df[0], df[1]);
        mma_bf16(dv[2 * np + 1], pa, df[2], df[3]);
        mma_bf16(dk[2 * np], sa, qf[0], qf[1]);
        mma_bf16(dk[2 * np + 1], sa, qf[2], qf[3]);
      }
    }
  }
  PROBE(6);
  cp_async_wait<0>();

  // dK and dV through the k and v tiles (free once every warp is past
  // its last product), then out in 16-byte stores of whole rows
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n = 0; n < M::kDTiles; ++n) {
      const int at = rows[i] * M::kLd + (8 * n + 2 * qd) * 2;
      *reinterpret_cast<__nv_bfloat162*>(k_s + at) =
          __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(v_s + at) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
  __syncthreads();
  bf16* dk_out = static_cast<bf16*>(p.out0);
  bf16* dv_out = static_cast<bf16*>(p.out1);
  constexpr int kVec = D / 8;
  for (int c = tid; c < 64 * kVec; c += kMmaThreads) {
    const int r = c / kVec, v = c - r * kVec;
    if (k0 + r >= p.tk) continue;
    const long long off =
        (((long long)b * p.tk + k0 + r) * p.heads + h) * D + v * 8;
    *reinterpret_cast<uint4*>(dk_out + off) =
        *reinterpret_cast<const uint4*>(k_s + r * M::kLd + v * 16);
    *reinterpret_cast<uint4*>(dv_out + off) =
        *reinterpret_cast<const uint4*>(v_s + r * M::kLd + v * 16);
  }
  PROBE(7);
}

// ----------------------------------------- dK/dV, bf16 wgmma (D = 64)
// The walk of flash_bwd_dkv_mma_kernel with warpgroup products: one
// warpgroup owns the 64 keys, K and V enter as A fragments from
// registers; each query tile (64 rows of q and dO, staged in the 128-byte
// swizzle layout) is read by the tensor cores straight from shared
// memory, once for the block (no per-warp ldmatrix): S^T = K Q^T and
// dP^T = V dO^T with q and dO K-major, then dV += P^T dO and dK +=
// dS^T Q with the same tiles read transposed (MN-major).
// Stages are whole KB so the next stage's tiles stay 1024-byte aligned.
constexpr int kb_round(int bytes) { return (bytes + 1023) / 1024 * 1024; }
constexpr int kWgQ = 64;                            // queries a step
constexpr int kWgStages = 3;
constexpr int kWgStage = kb_round(2 * kWgQ * 128 + 2 * kWgQ * 4);
constexpr size_t dkv_wgmma_smem() {
  return 1024 + kWgStages * kWgStage + 2 * Mma<64>::kTile;
}

// rows [row0, row0 + rows) of a [B, T, H, D] bf16 tensor into 128-byte-
// row swizzled panels of `rows` rows, one a 64 columns (panel j at
// j * rows * 128 bytes; D = 64 is one panel); rows past n_rows zero
template <int kN, int D = 64>
__device__ __forceinline__ void issue_rows_sw128(unsigned char* dst,
                                                 const bf16* base,
                                                 long long st, int row0,
                                                 int rows, int n_rows) {
  constexpr unsigned kVec = D / 8;  // unsigned: shifts and masks
  for (unsigned c = threadIdx.x; c < rows * kVec; c += kN) {
    const int r = c / kVec, v = c % kVec;
    const bool ok = row0 + r < n_rows;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        base + (ok ? (long long)(row0 + r) * st : 0));
    cp_async16(dst + (v >> 3) * rows * 128 + sw128(r, v & 7), src + v * 16,
               ok);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dkv_wgmma_kernel(const Params p) {
  PROBE_T0
  using M = Mma<64>;
  constexpr int kS = kWgStages, kQ = kWgQ;
  constexpr int kQTile = kQ * 128;
  extern __shared__ __align__(16) unsigned char dsmem[];
  // the tensor cores need the swizzled tiles 1024-byte aligned
  unsigned char* ring = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  unsigned char* k_s = ring + kS * kWgStage;
  unsigned char* v_s = k_s + M::kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.y * 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const bf16* dob =
      static_cast<const bf16*>(p.d_o) + b * p.sdo.b + h * p.sdo.h;
  const float* lse_g = p.lse + (long long)bh * p.tq;
  const float* delta_g = p.delta + (long long)bh * p.tq;

  issue_rows<bf16, 64, kMmaThreads>(k_s, M::kLd, kb, p.sk.t, k0, 64, p.tk);
  issue_rows<bf16, 64, kMmaThreads>(v_s, M::kLd, vb, p.sv.t, k0, 64, p.tk);
  cp_async_commit();
  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
  int key[2];
  bool kok[2];
  const bool any = key_tile_ok<2>(p, b, k0, rows, kok);
  key[0] = k0 + rows[0];
  key[1] = k0 + rows[1];
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = any ? (max(p.tq - q_start, 0) + kQ - 1) / kQ : 0;

  auto issue = [&](int it) {
    if (it < n_tiles) {
      unsigned char* st = ring + (it % kS) * kWgStage;
      const int r0 = q_start + it * kQ;
      issue_rows_sw128<kMmaThreads>(st, qb, p.sq.t, r0, kQ, p.tq);
      issue_rows_sw128<kMmaThreads>(st + kQTile, dob, p.sdo.t, r0, kQ, p.tq);
      float* stats = reinterpret_cast<float*>(st + 2 * kQTile);
      issue_floats<kMmaThreads>(stats, lse_g, r0, p.tq, kQ);
      issue_floats<kMmaThreads>(stats + kQ, delta_g, r0, p.tq, kQ);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < kS - 1; ++it) issue(it);

  const int arow = warp * 16 + (lane & 15);
  const float sc2 = p.scale * kLog2e;
  float dk[32], dv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;

  PROBE(4);
  for (int it = 0; it < n_tiles; ++it) {
    PROBE(6);
    cp_async_wait<kS - 2>();
    fence_proxy_async();
    __syncthreads();  // tile `it` landed; tile it-1's stage is free
    issue(it + kS - 1);
    PROBE(5);
    const unsigned char* qt = ring + (it % kS) * kWgStage;
    const unsigned char* dot = qt + kQTile;
    const float* lse_s = reinterpret_cast<const float*>(dot + kQTile);
    const float* dl_s = lse_s + kQ;
    const int r0 = q_start + it * kQ;
    const unsigned long long dq_desc = desc_sw128(qt);
    const unsigned long long do_desc = desc_sw128(dot);

    // K and V as A fragments, loaded anew each step (as in the dQ kernel)
    unsigned ka[M::kKSteps][4], va[M::kKSteps][4];
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk) {
      const int acol = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_u32(k_s + arow * M::kLd + acol * 2), ka[kk]);
      ldsm_x4(smem_u32(v_s + arow * M::kLd + acol * 2), va[kk]);
    }
    float st[kQ / 2], dpt[kQ / 2];
#pragma unroll
    for (int e = 0; e < kQ / 2; ++e) st[e] = dpt[e] = 0.f;
    wgmma_pin<kQ / 2>(st);
    wgmma_pin<kQ / 2>(dpt);
    wgmma_pin<4 * M::kKSteps>(&ka[0][0]);
    wgmma_pin<4 * M::kKSteps>(&va[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk)
      wgmma_m64n64k16<0>(st, ka[kk], dq_desc + 2 * kk);
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk)
      wgmma_m64n64k16<0>(dpt, va[kk], do_desc + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin<kQ / 2>(st);
    wgmma_pin<kQ / 2>(dpt);
    wgmma_pin<4 * M::kKSteps>(&ka[0][0]);
    wgmma_pin<4 * M::kKSteps>(&va[0][0]);
    // P^T and dS^T = P^T (dP^T - delta) scale, 0 where masked
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) {
      const int c = 8 * n + 2 * qd;
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, query = r0 + c + (e & 1);
        const bool ok = kok[i] && query < p.tq &&
                        (!p.causal || key[i] <= query);
        const float l = (e & 1) ? lse.y : lse.x;
        const float d = (e & 1) ? dl.y : dl.x;
        const float x = st[4 * n + e];
        const float pr = ok ? exp2f(fmaf(x, sc2, -l * kLog2e)) : 0.f;
        st[4 * n + e] = pr;
        dpt[4 * n + e] = pr * (dpt[4 * n + e] - d) * p.scale;
      }
    }
    // dV += P^T dO, dK += dS^T Q over kQ / 16 k-steps of 16 queries
    unsigned pa[kQ / 16][4], sa[kQ / 16][4];
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[ks][j] = pack_bf16(st[8 * ks + 2 * j], st[8 * ks + 2 * j + 1]);
        sa[ks][j] = pack_bf16(dpt[8 * ks + 2 * j], dpt[8 * ks + 2 * j + 1]);
      }
    wgmma_pin<32>(dv);
    wgmma_pin<32>(dk);
    wgmma_pin<4 * (kQ / 16)>(&pa[0][0]);
    wgmma_pin<4 * (kQ / 16)>(&sa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      wgmma_m64n64k16<1>(dv, pa[ks], do_desc + 128 * ks);
      wgmma_m64n64k16<1>(dk, sa[ks], dq_desc + 128 * ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin<32>(dv);
    wgmma_pin<32>(dk);
    wgmma_pin<4 * (kQ / 16)>(&pa[0][0]);
    wgmma_pin<4 * (kQ / 16)>(&sa[0][0]);
  }
  PROBE(6);
  cp_async_wait<0>();

  // dK and dV through the k and v tiles, then out in 16-byte stores
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int at = rows[i] * M::kLd + (8 * n + 2 * qd) * 2;
      *reinterpret_cast<__nv_bfloat162*>(k_s + at) =
          __floats2bfloat162_rn(dk[4 * n + 2 * i], dk[4 * n + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(v_s + at) =
          __floats2bfloat162_rn(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
  __syncthreads();
  bf16* dk_out = static_cast<bf16*>(p.out0);
  bf16* dv_out = static_cast<bf16*>(p.out1);
  for (int c = tid; c < 64 * 8; c += kMmaThreads) {
    const int r = c >> 3, v = c & 7;
    if (k0 + r >= p.tk) continue;
    const long long off =
        (((long long)b * p.tk + k0 + r) * p.heads + h) * 64 + v * 8;
    *reinterpret_cast<uint4*>(dk_out + off) =
        *reinterpret_cast<const uint4*>(k_s + r * M::kLd + v * 16);
    *reinterpret_cast<uint4*>(dv_out + off) =
        *reinterpret_cast<const uint4*>(v_s + r * M::kLd + v * 16);
  }
  PROBE(7);
}

// -------------------------------------------- dQ, bf16 wgmma (D = 64)
// The walk of flash_bwd_dq_mma_kernel with warpgroup products: one
// warpgroup owns the 64 query rows, Q and dO enter as A fragments from
// registers; each key tile (64 rows of K and V, staged in the 128-byte
// swizzle layout) is read by the tensor cores straight from shared
// memory: S = Q K^T and dP = dO V^T with K and V K-major, then dQ +=
// dS K with the same K tile read transposed.
constexpr int kWgK = 64;                            // keys a step
constexpr int kWgDqStages = 3;
constexpr int kWgKStage = kb_round(2 * kWgK * 128 + kWgK * 4);  // K, V, mask
static_assert(kWgKStage >= 64 * Mma<64>::kLd, "a stage holds the O tile");
constexpr size_t dq_wgmma_smem() {
  return 1024 + kWgDqStages * kWgKStage + 2 * Mma<64>::kTile + 2 * 64 * 4;
}

__global__ void __launch_bounds__(kMmaThreads, 3)
    flash_bwd_dq_wgmma_kernel(const Params p) {
  PROBE_T0
  using M = Mma<64>;
  constexpr int kS = kWgDqStages, kK = kWgK;
  constexpr int kKTile = kK * 128;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* ring = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  unsigned char* q_s = ring + kS * kWgKStage;
  unsigned char* do_s = q_s + M::kTile;
  float* lse_s = reinterpret_cast<float*>(do_s + M::kTile);
  float* delta_s = lse_s + 64;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* mrow = p.mask == nullptr ? nullptr : p.mask + b * p.mask_sb;

  int n_tiles = 0;
  auto issue = [&](int it) {  // key tile `it` into its stage, if any
    if (it < n_tiles) {
      unsigned char* st = ring + (it % kS) * kWgKStage;
      issue_rows_sw128<kMmaThreads>(st, kb, p.sk.t, it * kK, kK, p.tk);
      issue_rows_sw128<kMmaThreads>(st + kKTile, vb, p.sv.t, it * kK, kK,
                                    p.tk);
      if (mrow != nullptr)
        issue_floats<kMmaThreads>(reinterpret_cast<float*>(st + 2 * kKTile),
                                  mrow, it * kK, p.tk, kK);
    }
    cp_async_commit();
  };
  dq_prologue<bf16, 64, kMmaThreads, M::kLd, kK, kS>(
      p, b, h, bh, q0, q_s, do_s, ring + (kS - 1) * kWgKStage, lse_s,
      delta_s, mrow, issue, n_tiles);

  float lse2[2], dlt[2];
  int qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    qrow[i] = q0 + r;
    lse2[i] = qrow[i] < p.tq ? lse_s[r] * kLog2e : INFINITY;
    dlt[i] = delta_s[r];
  }
  const float sc2 = p.scale * kLog2e;
  const int arow = warp * 16 + (lane & 15);
  float dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;

  PROBE(0);
  for (int it = 0; it < n_tiles; ++it) {
    PROBE(2);
    cp_async_wait<kS - 2>();
    fence_proxy_async();
    __syncthreads();  // tile `it` landed; tile it-1's stage is free
    issue(it + kS - 1);
    PROBE(1);
    const unsigned char* kt = ring + (it % kS) * kWgKStage;
    const unsigned char* vt = kt + kKTile;
    const float* mk = reinterpret_cast<const float*>(vt + kKTile);
    const int k0 = it * kK;
    const unsigned long long k_desc = desc_sw128(kt);
    const unsigned long long v_desc = desc_sw128(vt);

    // Q and dO as A fragments (loaded anew each step: held across the
    // walk, the registers did not survive the asynchronous products)
    unsigned qa[M::kKSteps][4], da[M::kKSteps][4];
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk) {
      const int acol = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_u32(q_s + arow * M::kLd + acol * 2), qa[kk]);
      ldsm_x4(smem_u32(do_s + arow * M::kLd + acol * 2), da[kk]);
    }
    float s[kK / 2], dp[kK / 2];
#pragma unroll
    for (int e = 0; e < kK / 2; ++e) s[e] = dp[e] = 0.f;
    wgmma_pin<kK / 2>(s);
    wgmma_pin<kK / 2>(dp);
    wgmma_pin<4 * M::kKSteps>(&qa[0][0]);
    wgmma_pin<4 * M::kKSteps>(&da[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk)
      wgmma_m64n64k16<0>(s, qa[kk], k_desc + 2 * kk);
#pragma unroll
    for (int kk = 0; kk < M::kKSteps; ++kk)
      wgmma_m64n64k16<0>(dp, da[kk], v_desc + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin<kK / 2>(s);
    wgmma_pin<kK / 2>(dp);
    wgmma_pin<4 * M::kKSteps>(&qa[0][0]);
    wgmma_pin<4 * M::kKSteps>(&da[0][0]);
    // dS = P (dP - delta) scale, P = exp(S scale - lse), 0 where masked
#pragma unroll
    for (int n = 0; n < kK / 8; ++n) {
      const int c = 8 * n + 2 * qd, key = k0 + c;
      const float2 m = mrow == nullptr
                           ? make_float2(1.f, 1.f)
                           : *reinterpret_cast<const float2*>(mk + c);
      const bool ok0 = key < p.tk && m.x > 0.f;
      const bool ok1 = key + 1 < p.tk && m.y > 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kj = key + (e & 1);
        const bool ok = ((e & 1) ? ok1 : ok0) && (!p.causal || kj <= qrow[i]);
        const float pr =
            ok ? exp2f(fmaf(s[4 * n + e], sc2, -lse2[i])) : 0.f;
        s[4 * n + e] = pr * (dp[4 * n + e] - dlt[i]) * p.scale;
      }
    }
    // dQ += dS K over 4 k-steps of 16 keys
    unsigned a[kK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[ks][j] = pack_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);
    wgmma_pin<32>(dq);
    wgmma_pin<4 * (kK / 16)>(&a[0][0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks)
      wgmma_m64n64k16<1>(dq, a[ks], k_desc + 128 * ks);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin<32>(dq);
    wgmma_pin<4 * (kK / 16)>(&a[0][0]);
  }
  PROBE(2);
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(p.out0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= p.tq) continue;
    bf16* orow = out + (((long long)b * p.tq + qrow[i]) * p.heads + h) * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * qd) =
          __floats2bfloat162_rn(dq[4 * n + 2 * i], dq[4 * n + 2 * i + 1]);
  }
  PROBE(3);
}

// ------------------------------------------------------------ dQ, f32
// Shared memory: q and dO tiles, lse and delta of the tile's rows, the
// dS tile (64 x kK), and the ring of K and V tiles with their key mask.
template <int D>
constexpr size_t dq_f32_smem() {
  return 2 * F32<D>::kTile + 2 * 64 * 4 + 64 * F32<D>::kLdS * 4 +
         F32<D>::kStages * (2 * F32<D>::kK * F32<D>::kLd + F32<D>::kK * 4);
}

// Per key tile: S = Q K^T and dP = dO V^T as 4x4 register micro-tiles per
// thread (float4 loads along the head dim: 8 loads feed 64 FMAs), dS to
// shared memory, then dQ += dS K as 4 x (8 or 16) micro-tiles (float4
// loads along the key and head dims: 8 loads feed 128 FMAs).
template <int D>
__global__ void __launch_bounds__(kF32Threads, F32<D>::kMinBlocks)
    flash_bwd_dq_f32_kernel(const Params p) {
  PROBE_T0
  using C = F32<D>;
  constexpr int kS = C::kStages;
  constexpr int kK = C::kK, kJ = kK / kTX;
  constexpr int kLdW = C::kLdW, kLdS = C::kLdS;
  constexpr int kKTile = kK * C::kLd;
  constexpr int kStage = 2 * kKTile + kK * 4;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* q_s = dsmem;
  unsigned char* do_s = q_s + C::kTile;
  float* lse_s = reinterpret_cast<float*>(do_s + C::kTile);
  float* delta_s = lse_s + 64;
  float* ds_s = delta_s + 64;
  unsigned char* ring = reinterpret_cast<unsigned char*>(ds_s + 64 * kLdS);

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 64;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const float* kb = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* mrow = p.mask == nullptr ? nullptr : p.mask + b * p.mask_sb;

  int n_tiles = 0;
  auto issue = [&](int it) {
    if (it < n_tiles) {
      unsigned char* st = ring + (it % kS) * kStage;
      issue_rows<float, D, kF32Threads>(st, C::kLd, kb, p.sk.t, it * kK, kK,
                                        p.tk);
      issue_rows<float, D, kF32Threads>(st + kKTile, C::kLd, vb, p.sv.t,
                                        it * kK, kK, p.tk);
      if (mrow != nullptr)
        issue_floats<kF32Threads>(reinterpret_cast<float*>(st + 2 * kKTile),
                                  mrow, it * kK, p.tk, kK);
    }
    cp_async_commit();
  };
  dq_prologue<float, D, kF32Threads, C::kLd, kK, kS>(
      p, b, h, bh, q0, q_s, do_s, ring + (kS - 1) * kStage, lse_s,
      delta_s, mrow, issue, n_tiles);

  const float* qf = reinterpret_cast<const float*>(q_s);
  const float* dof = reinterpret_cast<const float*>(do_s);
  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    lse[i] = q0 + r < p.tq ? lse_s[r] : INFINITY;
    dlt[i] = delta_s[r];
  }
  float dq[4][4 * C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * C::kCols; ++j) dq[i][j] = 0.f;

  PROBE(8);
  for (int it = 0; it < n_tiles; ++it) {
    PROBE(10);
    cp_async_wait<kS - 2>();
    __syncthreads();  // also: every thread is done with the last dS tile
    issue(it + kS - 1);
    PROBE(9);
    const float* kt =
        reinterpret_cast<const float*>(ring + (it % kS) * kStage);
    const float* vt = kt + kK * kLdW;
    const float* mk = vt + kK * kLdW;
    const int k0 = it * kK;

    float s[4][kJ], dp[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qf + (4 * ty + i) * kLdW + d);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        c[j] = *reinterpret_cast<const float4*>(kt + (tx + kTX * j) * kLdW + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(dof + (4 * ty + i) * kLdW + d);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        c[j] = *reinterpret_cast<const float4*>(vt + (tx + kTX * j) * kLdW + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          dp[i][j] = fmaf(a[i].x, c[j].x, dp[i][j]);
          dp[i][j] = fmaf(a[i].y, c[j].y, dp[i][j]);
          dp[i][j] = fmaf(a[i].z, c[j].z, dp[i][j]);
          dp[i][j] = fmaf(a[i].w, c[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = tx + kTX * j, key = k0 + c;
      const bool key_ok = key < p.tk && (mrow == nullptr || mk[c] > 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = key_ok && (!p.causal || key <= q0 + 4 * ty + i);
        const float pr = ok ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        ds_s[(4 * ty + i) * kLdS + c] = pr * (dp[i][j] - dlt[i]) * p.scale;
      }
    }
    __syncthreads();
    // dQ += dS K
#pragma unroll 2
    for (int r = 0; r < kK; r += 4) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const float4*>(ds_s + (4 * ty + i) * kLdS + r);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cg = 0; cg < C::kCols; ++cg) {
          const float4 m = *reinterpret_cast<const float4*>(
              kt + (r + u) * kLdW + 4 * tx + 4 * kTX * cg);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = u == 0 ? w[i].x : u == 1 ? w[i].y
                                     : u == 2 ? w[i].z : w[i].w;
            dq[i][4 * cg + 0] = fmaf(wv, m.x, dq[i][4 * cg + 0]);
            dq[i][4 * cg + 1] = fmaf(wv, m.y, dq[i][4 * cg + 1]);
            dq[i][4 * cg + 2] = fmaf(wv, m.z, dq[i][4 * cg + 2]);
            dq[i][4 * cg + 3] = fmaf(wv, m.w, dq[i][4 * cg + 3]);
          }
        }
      }
    }
  }
  PROBE(10);
  cp_async_wait<0>();

  float* out = static_cast<float*>(p.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= p.tq) continue;
    float* orow = out + (((long long)b * p.tq + row) * p.heads + h) * D;
#pragma unroll
    for (int cg = 0; cg < C::kCols; ++cg)
      *reinterpret_cast<float4*>(orow + 4 * tx + 4 * kTX * cg) =
          make_float4(dq[i][4 * cg], dq[i][4 * cg + 1], dq[i][4 * cg + 2],
                      dq[i][4 * cg + 3]);
  }
  PROBE(11);
}

// --------------------------------------------------------- dK/dV, f32
// Shared memory: k and v tiles, the P^T and dS^T tiles (64 x kQ), and
// the ring of q and dO tiles (kQ rows) with their lse and delta.
template <int D>
constexpr size_t dkv_f32_smem() {
  return 2 * F32<D>::kTile + 2 * 64 * F32<D>::kLdS * 4 +
         F32<D>::kStages * (2 * F32<D>::kQ * F32<D>::kLd + 2 * F32<D>::kQ * 4);
}

// Per query tile: S^T = K Q^T and dP^T = V dO^T as 4x4 micro-tiles per
// thread, P^T and dS^T to shared memory, then dV += P^T dO and dK +=
// dS^T Q as 4 x (8 or 16) micro-tiles.
template <int D>
__global__ void __launch_bounds__(kF32Threads, F32<D>::kMinBlocks)
    flash_bwd_dkv_f32_kernel(const Params p) {
  PROBE_T0
  using C = F32<D>;
  constexpr int kS = C::kStages;
  constexpr int kQ = C::kQ, kJ = kQ / kTX;
  constexpr int kLdW = C::kLdW, kLdS = C::kLdS;
  constexpr int kQTile = kQ * C::kLd;
  constexpr int kStage = 2 * kQTile + 2 * kQ * 4;
  extern __shared__ __align__(16) unsigned char dsmem[];
  const float* k_s = reinterpret_cast<const float*>(dsmem);
  const float* v_s = k_s + 64 * kLdW;
  float* pt_s = const_cast<float*>(v_s) + 64 * kLdW;
  float* dst_s = pt_s + 64 * kLdS;
  unsigned char* ring = reinterpret_cast<unsigned char*>(dst_s + 64 * kLdS);

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.y * 64;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const float* qb = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kb = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* dob =
      static_cast<const float*>(p.d_o) + b * p.sdo.b + h * p.sdo.h;
  const float* lse_g = p.lse + (long long)bh * p.tq;
  const float* delta_g = p.delta + (long long)bh * p.tq;

  issue_rows<float, D, kF32Threads>(dsmem, C::kLd, kb, p.sk.t, k0, 64, p.tk);
  issue_rows<float, D, kF32Threads>(dsmem + C::kTile, C::kLd, vb, p.sv.t, k0,
                                    64, p.tk);
  cp_async_commit();
  const int rows[4] = {4 * ty, 4 * ty + 1, 4 * ty + 2, 4 * ty + 3};
  bool kok[4];
  const bool any = key_tile_ok<4>(p, b, k0, rows, kok);
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = any ? (max(p.tq - q_start, 0) + kQ - 1) / kQ : 0;

  auto issue = [&](int it) {
    if (it < n_tiles) {
      unsigned char* st = ring + (it % kS) * kStage;
      const int r0 = q_start + it * kQ;
      issue_rows<float, D, kF32Threads>(st, C::kLd, qb, p.sq.t, r0, kQ, p.tq);
      issue_rows<float, D, kF32Threads>(st + kQTile, C::kLd, dob, p.sdo.t,
                                        r0, kQ, p.tq);
      float* stats = reinterpret_cast<float*>(st + 2 * kQTile);
      issue_floats<kF32Threads>(stats, lse_g, r0, p.tq, kQ);
      issue_floats<kF32Threads>(stats + kQ, delta_g, r0, p.tq, kQ);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < kS - 1; ++it) issue(it);

  float dk[4][4 * C::kCols], dv[4][4 * C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * C::kCols; ++j) dk[i][j] = dv[i][j] = 0.f;

  PROBE(12);
  for (int it = 0; it < n_tiles; ++it) {
    PROBE(14);
    cp_async_wait<kS - 2>();
    __syncthreads();
    issue(it + kS - 1);
    PROBE(13);
    const float* qt =
        reinterpret_cast<const float*>(ring + (it % kS) * kStage);
    const float* dot = qt + kQ * kLdW;
    const float* lse_s = dot + kQ * kLdW;
    const float* dl_s = lse_s + kQ;
    const int r0 = q_start + it * kQ;

    float st[4][kJ], dpt[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(k_s + (4 * ty + i) * kLdW + d);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        c[j] = *reinterpret_cast<const float4*>(qt + (tx + kTX * j) * kLdW + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          st[i][j] = fmaf(a[i].x, c[j].x, st[i][j]);
          st[i][j] = fmaf(a[i].y, c[j].y, st[i][j]);
          st[i][j] = fmaf(a[i].z, c[j].z, st[i][j]);
          st[i][j] = fmaf(a[i].w, c[j].w, st[i][j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(v_s + (4 * ty + i) * kLdW + d);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        c[j] = *reinterpret_cast<const float4*>(dot + (tx + kTX * j) * kLdW +
                                                d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          dpt[i][j] = fmaf(a[i].x, c[j].x, dpt[i][j]);
          dpt[i][j] = fmaf(a[i].y, c[j].y, dpt[i][j]);
          dpt[i][j] = fmaf(a[i].z, c[j].z, dpt[i][j]);
          dpt[i][j] = fmaf(a[i].w, c[j].w, dpt[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = tx + kTX * j, query = r0 + c;
      const float lse = lse_s[c], dl = dl_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * ty + i;
        const bool ok = kok[i] && query < p.tq && (!p.causal || key <= query);
        const float pr = ok ? expf(st[i][j] * p.scale - lse) : 0.f;
        pt_s[(4 * ty + i) * kLdS + c] = pr;
        dst_s[(4 * ty + i) * kLdS + c] = pr * (dpt[i][j] - dl) * p.scale;
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
    for (int r = 0; r < kQ; r += 4) {
      float4 wp[4], ws[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = (4 * ty + i) * kLdS + r;
        wp[i] = *reinterpret_cast<const float4*>(pt_s + at);
        ws[i] = *reinterpret_cast<const float4*>(dst_s + at);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cg = 0; cg < C::kCols; ++cg) {
          const float4 md = *reinterpret_cast<const float4*>(
              dot + (r + u) * kLdW + 4 * tx + 4 * kTX * cg);
          const float4 mq = *reinterpret_cast<const float4*>(
              qt + (r + u) * kLdW + 4 * tx + 4 * kTX * cg);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = u == 0 ? wp[i].x : u == 1 ? wp[i].y
                                     : u == 2 ? wp[i].z : wp[i].w;
            const float sv = u == 0 ? ws[i].x : u == 1 ? ws[i].y
                                     : u == 2 ? ws[i].z : ws[i].w;
            dv[i][4 * cg + 0] = fmaf(pv, md.x, dv[i][4 * cg + 0]);
            dv[i][4 * cg + 1] = fmaf(pv, md.y, dv[i][4 * cg + 1]);
            dv[i][4 * cg + 2] = fmaf(pv, md.z, dv[i][4 * cg + 2]);
            dv[i][4 * cg + 3] = fmaf(pv, md.w, dv[i][4 * cg + 3]);
            dk[i][4 * cg + 0] = fmaf(sv, mq.x, dk[i][4 * cg + 0]);
            dk[i][4 * cg + 1] = fmaf(sv, mq.y, dk[i][4 * cg + 1]);
            dk[i][4 * cg + 2] = fmaf(sv, mq.z, dk[i][4 * cg + 2]);
            dk[i][4 * cg + 3] = fmaf(sv, mq.w, dk[i][4 * cg + 3]);
          }
        }
      }
    }
  }
  PROBE(14);
  cp_async_wait<0>();

  float* dk_out = static_cast<float*>(p.out0);
  float* dv_out = static_cast<float*>(p.out1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= p.tk) continue;
    const long long off = (((long long)b * p.tk + key) * p.heads + h) * D;
#pragma unroll
    for (int cg = 0; cg < C::kCols; ++cg) {
      const int col = 4 * tx + 4 * kTX * cg;
      *reinterpret_cast<float4*>(dk_out + off + col) =
          make_float4(dk[i][4 * cg], dk[i][4 * cg + 1], dk[i][4 * cg + 2],
                      dk[i][4 * cg + 3]);
      *reinterpret_cast<float4*>(dv_out + off + col) =
          make_float4(dv[i][4 * cg], dv[i][4 * cg + 1], dv[i][4 * cg + 2],
                      dv[i][4 * cg + 3]);
    }
  }
  PROBE(15);
}

// ------------------------------------------------------------- forward
// One block per (64-row query tile, batch*head), longest causal tiles
// first. The walk over key tiles stops at the causal end and at the last
// key the mask lets through (key_end, shared with the dQ kernels), so a
// query tile whose every key is masked walks nothing and writes o = 0,
// lse = +inf. The online softmax runs in f32 with one exp2 a score
// (scale * log2(e) folded into an FMA) and keeps the reference's
// m_safe / corr rules (no NaN from -inf). Only a tile that holds a key
// past the mask's first hole, or the causal diagonal, checks each score;
// the others skip the mask.

// 2^x by the special function unit alone (relative error ~2^-22; -inf
// gives 0): p and the rescales of the online softmax
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------- forward, bf16 wgmma (D = 64 and 128)
// One warpgroup owns the 64 query rows. Q is staged once; K and V tiles
// of 64 keys stream through cp.async rings of two stages; all in the
// 128-byte swizzle layout (a 128-wide head as two 64-column panels). S =
// Q K^T runs on wgmma with both operands read from shared memory
// (K-major). P is computed in the accumulator registers and split into
// two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), packed as the A
// fragments of O += P_hi V + P_lo V (V read MN-major), so it never
// touches shared memory and keeps 16 significant bits: one bf16 rounding
// of p puts o past one bf16 ulp of the unrounded forward at T=2048
// (tests/test_torch_flash_forward.py). The row sums take the unrounded
// p. The tensor cores work across the softmax (FA3's order): step i
// issues S_i and then tile i-1's O += P V, waits for S_i alone (depth 1)
// and computes tile i's softmax while O += P V runs; only the rescale of
// O and the packing of P_i wait for it. Step i reads K_i and V_{i-1}
// while K_{i+1}, tile i+1's key mask and V_i land. Registers: S (32),
// O (32 or 64), P's two parts (32).
template <int D>
struct FwdWg {
  static constexpr int kPanels = D / 64;
  static constexpr int kTileB = 64 * 2 * D;  // bytes of a 64-row tile
  static constexpr int kStages = 2;          // of K (with the mask) and V
  static constexpr int kMinBlocks = D == 64 ? 4 : 2;
  static_assert(kStages >= 2, "step i reads K_i and V_{i-1} together");
  static constexpr size_t smem() {  // 1 KB of it aligns the tiles
    return 1024 + (1 + 2 * kStages) * kTileB + kStages * 64 * 4;
  }
};

// s += Q K^T (64 x 64 f32) over D / 16 k-steps, both operands from
// shared memory
template <int D>
__device__ __forceinline__ void fwd_scores(float* s, const unsigned char* q_s,
                                           const unsigned char* k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = (kk >> 2) * 64 * 128;
    wgmma_m64n64k16_ss<0>(s, desc_sw128(q_s + panel) + 2 * (kk & 3),
                          desc_sw128(k_s + panel) + 2 * (kk & 3));
  }
}

// x0, x1 as two bf16 parts each, hi = bf16(x) and lo = bf16(x - hi)
// (x - hi is exact in f32), packed in pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// o += (P_hi + P_lo) V for one 64-key tile: P's parts as the A fragments
// of 4 k-steps of 16 keys, V read MN-major, one 64-column panel of o a
// wgmma
template <int D>
__device__ __forceinline__ void fwd_mix(float* o, unsigned (&ph)[4][4],
                                        unsigned (&pl)[4][4],
                                        const unsigned char* v_s) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const unsigned long long desc =
          desc_sw128(v_s + j * 64 * 128) + 128 * ks;
      wgmma_m64n64k16<1>(o + 32 * j, ph[ks], desc);
      wgmma_m64n64k16<1>(o + 32 * j, pl[ks], desc);
    }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, FwdWg<D>::kMinBlocks)
    flash_fwd_wgmma_kernel(const Params p) {
  PROBE_T0
  using W = FwdWg<D>;
  constexpr int kP = W::kPanels, kS = W::kStages, kN = kMmaThreads;
  extern __shared__ __align__(16) unsigned char dsmem[];
  // the tensor cores need the swizzled tiles 1024-byte aligned
  unsigned char* q_s = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  unsigned char* k_ring = q_s + W::kTileB;
  unsigned char* v_ring = k_ring + kS * W::kTileB;
  float* mask_ring = reinterpret_cast<float*>(v_ring + kS * W::kTileB);

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  // under causal the last query tiles have the most keys: start them first
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* mrow = p.mask == nullptr ? nullptr : p.mask + b * p.mask_sb;

  auto copy_k = [&](int t) {  // K and the key mask of tile t
    issue_rows_sw128<kN, D>(k_ring + (t % kS) * W::kTileB, kb, p.sk.t,
                            t * 64, 64, p.tk);
    if (mrow != nullptr)
      issue_floats<kN>(mask_ring + (t % kS) * 64, mrow, t * 64, p.tk, 64);
  };
  // Q and tile 0 land while the mask is scanned for the walk's end
  issue_rows_sw128<kN, D>(q_s, qb, p.sq.t, q0, 64, p.tq);
  copy_k(0);
  cp_async_commit();
  int full_end;
  const int k_end = min(p.causal ? min(p.tk, q0 + 64) : p.tk,
                        key_end<kN, true>(mrow, p.tk, &full_end));
  const int n_tiles = (max(k_end, 0) + 63) / 64;
  auto issue_k = [&](int t) {
    if (t < n_tiles) copy_k(t);
  };
  auto issue_v = [&](int t) {
    if (t < n_tiles)
      issue_rows_sw128<kN, D>(v_ring + (t % kS) * W::kTileB, vb, p.sv.t,
                              t * 64, 64, p.tk);
  };
  // group j >= 1 holds what step j reads: K_j, its mask, and V_{j-1}
  auto issue_group = [&](int j) {
    issue_k(j);
    issue_v(j - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 1; j < kS; ++j) issue_group(j);

  // this lane's rows: warp * 16 + g and + 8 of the tile
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float sc2 = p.scale * kLog2e;
  float m2[2] = {-INFINITY, -INFINITY};  // running max of s * scale * log2e
  float l[2] = {0.f, 0.f};               // this lane's share of the row sums
  float o[32 * kP], s[32];
  unsigned ph[4][4], pl[4][4];  // P's parts, read by O += P V
#pragma unroll
  for (int e = 0; e < 32 * kP; ++e) o[e] = 0.f;

  // S_i into s (from K_i's slot), committed as one group; the fence also
  // covers registers of other products written (and pinned) before it
  auto issue_scores = [&](int i) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_pin<32>(s);
    wgmma_fence();
    fwd_scores<D>(s, q_s, k_ring + (i % kS) * W::kTileB);
    wgmma_commit();
  };
  // tile i's softmax in s: masked scores -inf, p = exp2(s sc2 - m); the
  // running max and this lane's sums move on; returns each row's
  // rescale of o in corr
  auto softmax = [&](int i, float* corr) {
    const int k0 = i * 64;
    float mx[2] = {-INFINITY, -INFINITY};
    if (k0 + 64 <= full_end && (!p.causal || k0 + 63 <= q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    } else {
      const float* mk = mask_ring + (i % kS) * 64;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * qd, key = k0 + c;
        const float2 mm = mrow == nullptr
                              ? make_float2(1.f, 1.f)
                              : *reinterpret_cast<const float2*>(mk + c);
        const bool ok0 = key < p.tk && mm.x > 0.f;
        const bool ok1 = key + 1 < p.tk && mm.y > 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kj = key + (e & 1);
          const bool ok =
              ((e & 1) ? ok1 : ok0) && (!p.causal || kj <= qrow[r]);
          s[4 * n + e] = ok ? s[4 * n + e] : -INFINITY;
          mx[r] = fmaxf(mx[r], s[4 * n + e]);
        }
      }
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m2[r], mx[r] * sc2);
      ms[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = m2[r] == -INFINITY ? 0.f : ex2(m2[r] - ms[r]);
      m2[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float pr = ex2(fmaf(s[e], sc2, -ms[(e >> 1) & 1]));
      s[e] = pr;
      l[(e >> 1) & 1] += pr;
    }
  };
  // P_i's parts from s
  auto pack = [&]() {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1], ph[ks][j],
                   pl[ks][j]);
  };
  // the oldest group in flight has landed, for every thread and for the
  // tensor cores
  auto landed = [&]() {
    cp_async_wait<kS - 2>();
    fence_proxy_async();
    __syncthreads();
  };

  float corr[2];
  if (n_tiles > 0) {
    cp_async_wait<kS - 1>();  // group 0: Q, K_0 and tile 0's mask
    fence_proxy_async();
    __syncthreads();
    issue_scores(0);
    wgmma_wait<0>();
    wgmma_pin<32>(s);
    softmax(0, corr);
    pack();
  }
  PROBE(16);
  for (int i = 1; i < n_tiles; ++i) {
    PROBE(18);
    landed();  // group i; K_{i-1}'s and V_{i-2}'s slots are free
    issue_group(i + kS - 1);
    PROBE(17);
    wgmma_pin<32 * kP>(o);  // written before issue_scores' fence
    wgmma_pin<16>(&ph[0][0]);
    wgmma_pin<16>(&pl[0][0]);
    issue_scores(i);
    fwd_mix<D>(o, ph, pl, v_ring + ((i - 1) % kS) * W::kTileB);
    wgmma_commit();
    wgmma_wait<1>();  // S_i; tile i-1's O += P V runs on
    wgmma_pin<32>(s);
    softmax(i, corr);
    wgmma_wait<0>();
    wgmma_pin<32 * kP>(o);
    wgmma_pin<16>(&ph[0][0]);
    wgmma_pin<16>(&pl[0][0]);
#pragma unroll
    for (int e = 0; e < 32 * kP; ++e) o[e] *= corr[(e >> 1) & 1];
    pack();
  }
  if (n_tiles > 0) {  // the last tile's O += P V
    PROBE(18);
    landed();
    PROBE(17);
    wgmma_pin<32 * kP>(o);
    wgmma_pin<16>(&ph[0][0]);
    wgmma_pin<16>(&pl[0][0]);
    wgmma_fence();
    fwd_mix<D>(o, ph, pl, v_ring + ((n_tiles - 1) % kS) * W::kTileB);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin<32 * kP>(o);
    wgmma_pin<16>(&ph[0][0]);
    wgmma_pin<16>(&pl[0][0]);
  }
  PROBE(18);
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(p.out0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qrow[r] >= p.tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = out + (((long long)b * p.tq + qrow[r]) * p.heads + h) * D;
#pragma unroll
    for (int j = 0; j < kP; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * j + 8 * n + 2 * qd) =
            __floats2bfloat162_rn(o[32 * j + 4 * n + 2 * r] * inv,
                                  o[32 * j + 4 * n + 2 * r + 1] * inv);
    if (qd == 0)
      p.lse[(long long)bh * p.tq + qrow[r]] =
          l[r] > 0.f ? m2[r] * (1.f / kLog2e) + logf(l[r]) : INFINITY;
  }
  PROBE(19);
}

// --------------------------------------------------------- forward, f32
// No tensor cores (TF32 would break the f32 tolerance of 1e-4): scalar
// FMAs in 4x4 register micro-tiles fed by float4 loads, as in the f32
// backward kernels. 128 threads; thread (tx, ty) owns rows 4 ty .. 4 ty
// + 3, score columns tx + 8 j of each 32-key tile and head-dim columns
// 4 tx .. 4 tx + 3 (+ 32, 64, 96). K and V tiles stream through a
// cp.async ring of two stages (tile i+1 lands while tile i is computed);
// P goes through one padded shared tile. 61,696 bytes a block at D = 64
// (three blocks an SM), 110,848 at D = 128 (two).
constexpr int kFwdF32Stages = 2;
template <int D>
constexpr size_t fwd_f32_smem() {
  return F32<D>::kTile + 64 * F32<D>::kLdS * 4 +
         kFwdF32Stages * (2 * F32<D>::kK * F32<D>::kLd + F32<D>::kK * 4);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, D == 64 ? 3 : 2)
    flash_fwd_f32_kernel(const Params p) {
  PROBE_T0
  using C = F32<D>;
  constexpr int kS = kFwdF32Stages;
  constexpr int kK = C::kK, kJ = kK / kTX;
  constexpr int kLdW = C::kLdW, kLdS = C::kLdS;
  constexpr int kKTile = kK * C::kLd;
  constexpr int kStage = 2 * kKTile + kK * 4;
  extern __shared__ __align__(16) unsigned char dsmem[];
  const float* q_s = reinterpret_cast<const float*>(dsmem);
  float* p_s = reinterpret_cast<float*>(dsmem + C::kTile);
  unsigned char* ring = reinterpret_cast<unsigned char*>(p_s + 64 * kLdS);

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 64;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const float* qb = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kb = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* mrow = p.mask == nullptr ? nullptr : p.mask + b * p.mask_sb;

  auto copy = [&](int it) {  // key tile `it` into its stage
    unsigned char* st = ring + (it % kS) * kStage;
    issue_rows<float, D, kF32Threads>(st, C::kLd, kb, p.sk.t, it * kK, kK,
                                      p.tk);
    issue_rows<float, D, kF32Threads>(st + kKTile, C::kLd, vb, p.sv.t,
                                      it * kK, kK, p.tk);
    if (mrow != nullptr)
      issue_floats<kF32Threads>(reinterpret_cast<float*>(st + 2 * kKTile),
                                mrow, it * kK, p.tk, kK);
  };
  // Q and tile 0 land while the mask is scanned for the walk's end
  issue_rows<float, D, kF32Threads>(dsmem, C::kLd, qb, p.sq.t, q0, 64,
                                    p.tq);
  copy(0);
  cp_async_commit();
  int full_end;
  const int k_end = min(p.causal ? min(p.tk, q0 + 64) : p.tk,
                        key_end<kF32Threads, true>(mrow, p.tk, &full_end));
  const int n_tiles = (max(k_end, 0) + kK - 1) / kK;
  auto issue = [&](int it) {  // key tile `it`, if any
    if (it < n_tiles) copy(it);
    cp_async_commit();
  };

  const float sc2 = p.scale * kLog2e;
  float m2[4], l[4], o[4][4 * C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m2[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * C::kCols; ++j) o[i][j] = 0.f;
  }

  PROBE(20);
  for (int it = 0; it < n_tiles; ++it) {
    PROBE(22);
    cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; every thread is done with the
                      // other stage and with the P tile
    issue(it + 1);
    PROBE(21);
    const float* kt =
        reinterpret_cast<const float*>(ring + (it % kS) * kStage);
    const float* vt = kt + kK * kLdW;
    const float* mk = vt + kK * kLdW;
    const int k0 = it * kK;

    float s[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_s + (4 * ty + i) * kLdW + d);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        c[j] = *reinterpret_cast<const float4*>(kt + (tx + kTX * j) * kLdW + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }
    // softmax: masked scores are -inf; p = exp2(s sc2 - m) to the P tile
    if (k0 + kK > full_end || (p.causal && k0 + kK - 1 > q0)) {
      bool key_ok[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = tx + kTX * j, key = k0 + c;
        key_ok[j] = key < p.tk && (mrow == nullptr || mk[c] > 0.f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const bool ok = key_ok[j] &&
                          (!p.causal || k0 + tx + kTX * j <= q0 + 4 * ty + i);
          s[i][j] = ok ? s[i][j] : -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1)  // the 8 lanes of a row group
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m2[i], mx * sc2);
      const float ms = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m2[i] == -INFINITY ? 0.f : ex2(m2[i] - ms);
      m2[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float pr = ex2(fmaf(s[i][j], sc2, -ms));
        l[i] += pr;
        p_s[(4 * ty + i) * kLdS + tx + kTX * j] = pr;
      }
#pragma unroll
      for (int j = 0; j < 4 * C::kCols; ++j) o[i][j] *= corr;
    }
    __syncthreads();
    // O += P V
#pragma unroll 2
    for (int r = 0; r < kK; r += 4) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const float4*>(p_s + (4 * ty + i) * kLdS + r);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cg = 0; cg < C::kCols; ++cg) {
          const float4 m = *reinterpret_cast<const float4*>(
              vt + (r + u) * kLdW + 4 * tx + 4 * kTX * cg);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = u == 0 ? w[i].x : u == 1 ? w[i].y
                                     : u == 2 ? w[i].z : w[i].w;
            o[i][4 * cg + 0] = fmaf(wv, m.x, o[i][4 * cg + 0]);
            o[i][4 * cg + 1] = fmaf(wv, m.y, o[i][4 * cg + 1]);
            o[i][4 * cg + 2] = fmaf(wv, m.z, o[i][4 * cg + 2]);
            o[i][4 * cg + 3] = fmaf(wv, m.w, o[i][4 * cg + 3]);
          }
        }
      }
    }
  }
  PROBE(22);
  cp_async_wait<0>();

  float* out = static_cast<float*>(p.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int w = 1; w < kTX; w <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const int row = q0 + 4 * ty + i;
    if (row >= p.tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = out + (((long long)b * p.tq + row) * p.heads + h) * D;
#pragma unroll
    for (int cg = 0; cg < C::kCols; ++cg)
      *reinterpret_cast<float4*>(orow + 4 * tx + 4 * kTX * cg) =
          make_float4(o[i][4 * cg] * inv, o[i][4 * cg + 1] * inv,
                      o[i][4 * cg + 2] * inv, o[i][4 * cg + 3] * inv);
    if (tx == 0)
      p.lse[(long long)bh * p.tq + row] =
          l[i] > 0.f ? m2[i] * (1.f / kLog2e) + logf(l[i]) : INFINITY;
  }
  PROBE(23);
}

// ---------------------------------------------------------------- host

// Lets a kernel use `smem` bytes of dynamic shared memory a block.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// What the host does with a kernel, its shared bytes and threads a
// block: launch it on `grid` (returns cudaGetLastError(), 0 = launched)
// ...
struct Launch {
  dim3 grid;
  const Params& p;
  void* stream;
  template <typename Kernel>
  int operator()(Kernel kernel, size_t smem, int threads) const {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  }
};

// ... or count the blocks an SM holds at once (-1 on an error)
struct BlocksPerSm {
  template <typename Kernel>
  int operator()(Kernel kernel, size_t smem, int threads) const {
    int n = 0;
    if (allow_smem(kernel, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem) != cudaSuccess)
      return -1;
    return n;
  }
};

// forward: the wgmma kernel for bf16 (both head dims), FMAs for f32
template <int D, typename Op>
int fwd_d(bool bf16_route, const Op& op) {
  if (bf16_route)
    return op(flash_fwd_wgmma_kernel<D>, FwdWg<D>::smem(), kMmaThreads);
  return op(flash_fwd_f32_kernel<D>, fwd_f32_smem<D>(), kF32Threads);
}

// backward: bf16 at D=64 the wgmma kernels, at D=128 the mma.sync
// kernels (the wgmma accumulators of a 128-wide head would not fit);
// f32: FMAs
template <int D, typename Op>
int bwd_dq_d(bool bf16_route, const Op& op) {
  if (!bf16_route)
    return op(flash_bwd_dq_f32_kernel<D>, dq_f32_smem<D>(), kF32Threads);
  if constexpr (D == 64)
    return op(flash_bwd_dq_wgmma_kernel, dq_wgmma_smem(), kMmaThreads);
  else
    return op(flash_bwd_dq_mma_kernel, dq_mma_smem(), kMmaThreads);
}

template <int D, typename Op>
int bwd_dkv_d(bool bf16_route, const Op& op) {
  if (!bf16_route)
    return op(flash_bwd_dkv_f32_kernel<D>, dkv_f32_smem<D>(), kF32Threads);
  if constexpr (D == 64)
    return op(flash_bwd_dkv_wgmma_kernel, dkv_wgmma_smem(), kMmaThreads);
  else
    return op(flash_bwd_dkv_mma_kernel, dkv_mma_smem(), kMmaThreads);
}

// kind 0 forward, 1 dQ, 2 dK/dV
template <int D, typename Op>
int by_kind(int kind, bool bf16_route, const Op& op) {
  if (kind == 0) return fwd_d<D>(bf16_route, op);
  if (kind == 1) return bwd_dq_d<D>(bf16_route, op);
  return bwd_dkv_d<D>(bf16_route, op);
}

template <typename Op>
int dispatch(int kind, int d, bool bf16_route, const Op& op) {
  if (d == 64) return by_kind<64>(kind, bf16_route, op);
  if (d == 128) return by_kind<128>(kind, bf16_route, op);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(int kind, const Params& p, int batch, int d, void* stream) {
  const int t = kind == 2 ? p.tk : p.tq;  // the length the blocks tile
  const dim3 grid(batch * p.heads, (t + kTile - 1) / kTile);
  return dispatch(kind, d, sizeof(T) == 2, Launch{grid, p, stream});
}

Params make_params(int heads, int tq, int tk, long long mask_sb, int causal,
                   float scale) {
  Params p = {};
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.mask_sb = mask_sb;
  p.causal = causal;
  p.scale = scale;
  return p;
}

template <int D>
size_t smem_bytes(int kind, bool bf16_route) {
  if (kind == 0) return bf16_route ? FwdWg<D>::smem() : fwd_f32_smem<D>();
  if (!bf16_route) return kind == 1 ? dq_f32_smem<D>() : dkv_f32_smem<D>();
  if constexpr (D == 64)
    return kind == 1 ? dq_wgmma_smem() : dkv_wgmma_smem();
  else
    return kind == 1 ? dq_mma_smem() : dkv_mma_smem();
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one block: kind 0 forward, 1 dQ, 2
// dK/dV; is_bf16 != 0 for the bfloat16 kernels.
size_t flash_smem_bytes(int kind, int d, int is_bf16) {
  if (d == 64) return smem_bytes<64>(kind, is_bf16 != 0);
  if (d == 128) return smem_bytes<128>(kind, is_bf16 != 0);
  return 0;
}

// Blocks of that kernel one SM holds at once (the card's occupancy
// calculator: registers, shared memory, threads); -1 on an error.
int flash_blocks_per_sm(int kind, int d, int is_bf16) {
  if (d != 64 && d != 128) return -1;
  return dispatch(kind, d, is_bf16 != 0, BlocksPerSm{});
}

// Each launches on `stream` of the calling thread's current device (the
// wrapper makes it the tensors' device) and returns cudaGetLastError()
// after the launch (0 = launched). Strides are in elements, (batch, time,
// head) of a [B, T, H, D] tensor whose head dim is contiguous; outputs
// are contiguous [B, T, H, D] (lse and delta [B, H, Tq] f32).
#define FLASH_FWD_ARGS                                                     \
  const void *q, const void *k, const void *v, const float *mask, void *o, \
      float *lse, int batch, int heads, int tq, int tk, int d,             \
      long long q_sb, long long q_st, long long q_sh, long long k_sb,      \
      long long k_st, long long k_sh, long long v_sb, long long v_st,      \
      long long v_sh, long long mask_sb, int causal, float scale,          \
      void *stream

#define FLASH_FWD_BODY(T)                                          \
  Params p = make_params(heads, tq, tk, mask_sb, causal, scale);   \
  p.q = q;                                                         \
  p.k = k;                                                         \
  p.v = v;                                                         \
  p.mask = mask;                                                   \
  p.lse = lse;                                                     \
  p.out0 = o;                                                      \
  p.sq = {q_sb, q_st, q_sh};                                       \
  p.sk = {k_sb, k_st, k_sh};                                       \
  p.sv = {v_sb, v_st, v_sh};                                       \
  return run<T>(0, p, batch, d, stream);

int flash_fwd_f32(FLASH_FWD_ARGS) { FLASH_FWD_BODY(float) }
int flash_fwd_bf16(FLASH_FWD_ARGS) { FLASH_FWD_BODY(__nv_bfloat16) }

#define FLASH_DQ_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *d_o,              \
      const void *o, const float *mask, const float *lse, float *delta,      \
      void *dq, int batch, int heads, int tq, int tk, int d, long long q_sb, \
      long long q_st, long long q_sh, long long k_sb, long long k_st,        \
      long long k_sh, long long v_sb, long long v_st, long long v_sh,        \
      long long do_sb, long long do_st, long long do_sh, long long o_sb,     \
      long long o_st, long long o_sh, long long mask_sb, int causal,         \
      float scale, void *stream

#define FLASH_DQ_BODY(T)                                           \
  Params p = make_params(heads, tq, tk, mask_sb, causal, scale);   \
  p.q = q;                                                         \
  p.k = k;                                                         \
  p.v = v;                                                         \
  p.d_o = d_o;                                                     \
  p.o = o;                                                         \
  p.mask = mask;                                                   \
  p.lse = const_cast<float*>(lse);                                 \
  p.delta = delta;                                                 \
  p.out0 = dq;                                                     \
  p.sq = {q_sb, q_st, q_sh};                                       \
  p.sk = {k_sb, k_st, k_sh};                                       \
  p.sv = {v_sb, v_st, v_sh};                                       \
  p.sdo = {do_sb, do_st, do_sh};                                   \
  p.so = {o_sb, o_st, o_sh};                                       \
  return run<T>(1, p, batch, d, stream);

int flash_bwd_dq_f32(FLASH_DQ_ARGS) { FLASH_DQ_BODY(float) }
int flash_bwd_dq_bf16(FLASH_DQ_ARGS) { FLASH_DQ_BODY(__nv_bfloat16) }

#define FLASH_DKV_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *d_o,             \
      const float *mask, const float *lse, const float *delta, void *dk,    \
      void *dv, int batch, int heads, int tq, int tk, int d, long long q_sb, \
      long long q_st, long long q_sh, long long k_sb, long long k_st,       \
      long long k_sh, long long v_sb, long long v_st, long long v_sh,       \
      long long do_sb, long long do_st, long long do_sh, long long mask_sb, \
      int causal, float scale, void *stream

#define FLASH_DKV_BODY(T)                                          \
  Params p = make_params(heads, tq, tk, mask_sb, causal, scale);   \
  p.q = q;                                                         \
  p.k = k;                                                         \
  p.v = v;                                                         \
  p.d_o = d_o;                                                     \
  p.mask = mask;                                                   \
  p.lse = const_cast<float*>(lse);                                 \
  p.delta = const_cast<float*>(delta);                             \
  p.out0 = dk;                                                     \
  p.out1 = dv;                                                     \
  p.sq = {q_sb, q_st, q_sh};                                       \
  p.sk = {k_sb, k_st, k_sh};                                       \
  p.sv = {v_sb, v_st, v_sh};                                       \
  p.sdo = {do_sb, do_st, do_sh};                                   \
  return run<T>(2, p, batch, d, stream);

int flash_bwd_dkv_f32(FLASH_DKV_ARGS) { FLASH_DKV_BODY(float) }
int flash_bwd_dkv_bf16(FLASH_DKV_ARGS) { FLASH_DKV_BODY(__nv_bfloat16) }

#ifdef FLASH_PROBE
// The phase sums (kProbeSlots = 24 counters) into `out`, then zero them.
int flash_probe_take(unsigned long long* out) {
  const unsigned long long zero[kProbeSlots] = {};
  const cudaError_t err = cudaMemcpyFromSymbol(out, flash_probe_cycles,
                                               sizeof(zero));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(flash_probe_cycles, zero, sizeof(zero));
}
#endif

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
