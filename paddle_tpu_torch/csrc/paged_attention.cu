// Paged window attention for Hopper (sm_90a), with a plain C interface
// for ctypes (paddle_tpu_torch/ops/paged_attention.py binds it and picks
// the route; paddle_tpu_torch/ops/_cuda.py builds it with nvcc).
//
// Replaces paddle_tpu/ops/paged_attention.py:paged_window_attention
// (Pallas kernel body `kernel`): f32/bf16 pools, and int8 pools with
// per-slot f32 scales (the dequantize-on-gather variant, `_dequant_window`
// per page and the scale block specs of the Pallas call).
//
// Computes, for each sequence b, query row t and head h:
//   out[b, t, h, :] = softmax_w(q[b,t,h,:] . K[w,h,:] / sqrt(Dk)) @ V[w,h,:]
// over window positions w whose block-table page is valid
// (tables[b, w / bs] >= 0) and which satisfy w <= cached_lens[b] + t.
// K/V row w of sequence b lives at pool slot tables[b, w / bs] * bs + w % bs.
// With int8 pools, K[w,h,d] = (float)code * k_scale[slot], rounded to q's
// type (the plain version dequantizes as (codes.f32 * scale).to(q.dtype)).
// Max, sums and softmax are kept in f32 whatever the storage type; a row
// with no valid key writes zeros.
//
// Bounds on an H100 (3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores,
// 989 bf16 on them), at the serving shapes (H=8, D=64, 32 pages of 16):
// - decode (T <= 8) is bound by bytes at any type: each valid K/V row is
//   read once per head at 1-2 flops per byte (B=16, T=1, f32 pools:
//   ~9.5 MB, 2.8 us; int8 pools a quarter of that);
// - a long f32 window is bound by operations (B=16, T=512: 0.060 ms of
//   FMAs against 0.004 ms of bytes); in bf16 or int8 it is bound by bytes
//   again (0.0074 ms), since the tensor cores run ~15x the f32 rate.
//
// Three routes, chosen by the wrapper from the shapes alone
// (ops/paged_attention.py:plan_route):
// 1. split (T <= 8): bytes bound, and at decode sizes bound in practice by
//    the latency of each block's chain of loads, so the design puts many
//    short chains in flight. The key axis is split across blocks (grid
//    head x sequence x split, 8 waves of the 132 SMs where the window has
//    the tiles: 16 splits of 32 keys at B=16); the host never reads
//    cached_lens, and splits past the last visible key exit at once.
//    Each block streams its split in 32-key tiles through a cp.async ring
//    of up to three stages (two tiles in flight while one is scored, one
//    barrier a tile), 16 bytes a thread (4 f32, 8 bf16 or 16 int8 codes);
//    the block-table row is staged in shared memory and int8 scales are
//    copied with their tile, so no thread waits on a global load inside
//    the walk. Lanes own (key, quarter of the head dim) and score from
//    padded rows without bank conflicts; int8 codes are dequantized in
//    registers. Partial (m, l, acc) go to f32 scratch; a second kernel,
//    launched by the same C call, merges them (a split with no key has
//    m = -inf and weight zero).
// 2. query tile (T > 8): operations bound in f32, so the design is about
//    FMA density. A block per (head, sequence, 64-row query tile), longest
//    tiles first, walks 64-key tiles (cp.async ring) up to its tile's
//    last visible key; each of 256 threads owns a 4x4 micro-tile of the
//    scores and of the accumulator, the online softmax stays in
//    registers. With bf16 queries (bf16 pools, or int8 pools dequantized
//    to bf16 once per tile) both products run as mma.sync m16n8k16 on the
//    tensor cores fed by ldmatrix, in 128-row tiles past T = 64 (half the
//    K/V reads, twice the warps per SM); that leaves the route bound by
//    bytes. f32 queries stay on f32 FMAs (TF32 would break the 1e-4
//    tolerance the f32 path is held to). A grid under two waves also
//    splits its keys and merges like the split route.
// 3. generic: the first design, one block per (head, sequence, query tile),
//    scalar loads, warp-per-pair scores. It takes only shapes the two
//    routes above do not (head dims not multiples of 8 or above 128, int8
//    rows not a whole number of 16 bytes, block tables over 2048 pages),
//    and serves as the A/B yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerTile = 64;
constexpr int kQTile = 64;  // query rows per block (the grid's third axis)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// a dequantized value rounded to the query's type, back in f32
__device__ __forceinline__ float round_as(const float*, float v) { return v; }
__device__ __forceinline__ float round_as(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One K or V element of pool slot `slot`: the stored value, or for int8
// pools the code times the slot's scale, rounded to the query type T.
template <typename T>
__device__ __forceinline__ float load_kv(const T* pool, size_t i, const float*,
                                         int) {
  return load_f32(pool + i);
}
template <typename T>
__device__ __forceinline__ float load_kv(const signed char* pool, size_t i,
                                         const float* scale, int slot) {
  return round_as(static_cast<const T*>(nullptr),
                  (float)pool[i] * scale[slot]);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory, in 4-byte words, for a window of n_q query
// rows (a block holds at most kQTile of them).
size_t smem_words(int n_q, int dk, int dv) {
  n_q = n_q < kQTile ? n_q : kQTile;
  return (size_t)n_q * dk            // q
         + (size_t)kKeysPerTile * dk  // K tile
         + (size_t)kKeysPerTile * dv  // V tile
         + (size_t)n_q * kKeysPerTile  // scores, then probabilities
         + (size_t)n_q * dv           // accumulator
         + 3 * (size_t)n_q            // running max, running sum, rescale
         + kKeysPerTile;              // pool slot of each tile row
}

// grid (n_heads, batch, ceil(T / kQTile)), block kThreads. P is T for
// f32/bf16 pools and signed char for int8 pools (then k_scale/v_scale
// are the [n_blocks * block_size] f32 scale pools).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_window_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ cached_lens, T* __restrict__ out, int seq_q,
    int n_heads, int dk, int dv, int n_blocks, int block_size,
    int max_blocks, float sqrt_dk) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * kQTile;  // first query row of this block
  const int n_q = min(kQTile, seq_q - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;
  float* k_s = q_s + n_q * dk;
  float* v_s = k_s + kKeysPerTile * dk;
  float* p_s = v_s + kKeysPerTile * dv;
  float* acc_s = p_s + n_q * kKeysPerTile;
  float* m_s = acc_s + n_q * dv;
  float* l_s = m_s + n_q;
  float* c_s = l_s + n_q;
  int* slot_s = reinterpret_cast<int*>(c_s + n_q);

  // a pool row holds all heads: [n_heads, d]
  const size_t k_row = (size_t)n_heads * dk;
  const size_t v_row = (size_t)n_heads * dv;

  for (int i = tid; i < n_q * dk; i += kThreads) {
    const int t = i / dk, d = i - t * dk;
    q_s[i] =
        load_f32(q + (((size_t)b * seq_q + t0 + t) * n_heads + h) * dk + d);
  }
  for (int i = tid; i < n_q * dv; i += kThreads) acc_s[i] = 0.f;
  for (int t = tid; t < n_q; t += kThreads) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  const int cached = cached_lens[b];
  // positions past cached + t0 + n_q - 1 are masked for every query row
  // of the tile
  const int n_keys =
      min(max_blocks * block_size, max(cached + t0 + n_q, 0));
  __syncthreads();

  for (int w0 = 0; w0 < n_keys; w0 += kKeysPerTile) {
    const int rows = min(kKeysPerTile, n_keys - w0);
    for (int r = tid; r < rows; r += kThreads) {
      const int w = w0 + r;
      const int blk = tables[(size_t)b * max_blocks + w / block_size];
      slot_s[r] = (blk >= 0 && blk < n_blocks)
                      ? blk * block_size + w % block_size
                      : -1;
    }
    __syncthreads();
    for (int i = tid; i < rows * dk; i += kThreads) {
      const int r = i / dk, d = i - r * dk;
      const int slot = slot_s[r];
      k_s[i] = slot >= 0 ? load_kv<T>(k_pool, slot * k_row + (size_t)h * dk + d,
                                      k_scale, slot)
                         : 0.f;
    }
    for (int i = tid; i < rows * dv; i += kThreads) {
      const int r = i / dv, d = i - r * dv;
      const int slot = slot_s[r];
      v_s[i] = slot >= 0 ? load_kv<T>(v_pool, slot * v_row + (size_t)h * dv + d,
                                      v_scale, slot)
                         : 0.f;
    }
    __syncthreads();

    // scores: one warp per (query row, key row), lanes over the head dim
    for (int pr = warp; pr < n_q * rows; pr += kWarps) {
      const int t = pr / rows, r = pr - t * rows;
      float s = 0.f;
      for (int d = lane; d < dk; d += 32) s += q_s[t * dk + d] * k_s[r * dk + d];
      s = warp_sum(s);
      if (lane == 0) {
        const bool ok = slot_s[r] >= 0 && w0 + r <= cached + t0 + t;
        p_s[t * kKeysPerTile + r] = ok ? s / sqrt_dk : -INFINITY;
      }
    }
    __syncthreads();

    // running softmax: one warp per query row
    for (int t = warp; t < n_q; t += kWarps) {
      float* p = p_s + t * kKeysPerTile;
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p[r]);
      mx = warp_max(mx);
      const float m_old = m_s[t];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = m_new == -INFINITY ? 0.f : expf(p[r] - m_new);
        p[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        c_s[t] = corr;
        l_s[t] = l_s[t] * corr + sum;
        m_s[t] = m_new;
      }
    }
    __syncthreads();

    // accumulator: one thread per (query row, value dim)
    for (int i = tid; i < n_q * dv; i += kThreads) {
      const int t = i / dv, d = i - t * dv;
      const float* p = p_s + t * kKeysPerTile;
      float a = acc_s[i] * c_s[t];
      for (int r = 0; r < rows; ++r) a += p[r] * v_s[r * dv + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // a row with no valid key (an inactive slot) writes zeros
  for (int i = tid; i < n_q * dv; i += kThreads) {
    const int t = i / dv, d = i - t * dv;
    const float l = l_s[t];
    store_f32(out + (((size_t)b * seq_q + t0 + t) * n_heads + h) * dv + d,
              l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* cached_lens, void* out, int batch, int n_q,
           int n_heads, int dk, int dv, int n_blocks, int block_size,
           int max_blocks, float sqrt_dk, void* stream) {
  const size_t smem = smem_words(n_q, dk, dv) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_window_attention_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_heads, batch, (n_q + kQTile - 1) / kQTile);
  paged_window_attention_kernel<T, P>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const P*>(k_pool),
          static_cast<const P*>(v_pool), static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale), static_cast<const int*>(tables),
          static_cast<const int*>(cached_lens), static_cast<T*>(out), n_q,
          n_heads, dk, dv, n_blocks, block_size, max_blocks, sqrt_dk);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------- fast routes

constexpr int kVecBytes = 16;     // one cp.async / one pool vector
constexpr int kRowPad = 16;       // bytes after each staged tile row
constexpr int kSplitThreads = 128;
constexpr int kSplitTile = 32;    // keys per tile: 4 warps x 8 keys
constexpr int kMaxT = 8;          // query rows of the split route
constexpr int kSplitStages = 3;   // cp.async ring depth of the split route
constexpr int kTileThreads = 256; // f32 query-tile route
constexpr int kMmaWideT = 64;     // tensor-core tiles: 128 rows past it
constexpr int kKeyTile = 64;      // keys per tile of the query-tile routes
constexpr int kTileStages = 2;    // cp.async ring depth, f32 query tiles
constexpr int kMmaStages = 3;     // cp.async ring depth, tensor-core tiles

// q's type for a dequantized value or for sqrt(Dk): f32 keeps it, bf16
// rounds it
template <typename T>
__host__ __device__ __forceinline__ float rq(float v) { return v; }
template <>
__host__ __device__ __forceinline__ float rq<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One 16-byte pool vector in shared memory, as f32 values: 4 f32, 8
// bf16, or 16 int8 codes dequantized with the slot's scale and rounded
// to q's type T (the plain version's (codes.f32 * scale).to(q.dtype)).
template <typename T>
__device__ __forceinline__ void vec_f32(const float* p, float, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
template <typename T>
__device__ __forceinline__ void vec_f32(const __nv_bfloat16* p, float,
                                        float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void vec_f32(const signed char* p, float s,
                                        float* o) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const signed char* c = reinterpret_cast<const signed char*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = rq<T>((float)c[i] * s);
}

// one element of a staged row, as f32 (int8: dequantized)
template <typename T>
__device__ __forceinline__ float elem_f32(const float* p, float) {
  return *p;
}
template <typename T>
__device__ __forceinline__ float elem_f32(const __nv_bfloat16* p, float) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ float elem_f32(const signed char* p, float s) {
  return rq<T>((float)*p * s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Pool slot of window position w of a sequence (its block-table row),
// or -1 past w_end or on a -1 (or out-of-range) page.
__device__ __forceinline__ int slot_of(const int* table_row, int w,
                                       int w_end, int block_size,
                                       int n_blocks) {
  if (w >= w_end) return -1;
  const int blk = table_row[w / block_size];
  return (blk >= 0 && blk < n_blocks) ? blk * block_size + w % block_size
                                      : -1;
}

// Start the copies of one tile of n_keys window rows [w0, w0 + n_keys)
// of head h into shared memory: K rows at kdst (kstride bytes apart), V
// rows at vdst, 16 bytes a thread a copy; rows past w_end or on masked
// pages are zero-filled (V must be finite: p = 0 times it). Writes each
// row's validity (a plain store, visible after the next __syncthreads)
// and, for int8 pools, copies its K and V scales with the tile.
// table_row is the sequence's block-table row staged in shared memory,
// so no thread waits on a global load here.
template <typename P>
__device__ __forceinline__ void issue_tile(
    unsigned char* kdst, unsigned char* vdst, int kstride, int vstride,
    int* valid, float* ksc, float* vsc, const P* k_pool, const P* v_pool,
    const float* k_scale, const float* v_scale, const int* table_row,
    int w0, int n_keys, int w_end, int n_heads, int h, int dk, int dv,
    int n_blocks, int block_size, int n_threads) {
  const int kvec = dk * (int)sizeof(P) / kVecBytes;
  const int vvec = dv * (int)sizeof(P) / kVecBytes;
  const int per_row = kvec + vvec;
  for (int c = threadIdx.x; c < n_keys * per_row; c += n_threads) {
    const int r = c / per_row;
    int v = c - r * per_row;
    const int slot = slot_of(table_row, w0 + r, w_end, block_size, n_blocks);
    const bool is_k = v < kvec;
    if (!is_k) v -= kvec;
    const int d = is_k ? dk : dv;
    const P* pool = is_k ? k_pool : v_pool;
    const P* src = pool + ((size_t)(slot < 0 ? 0 : slot) * n_heads + h) * d +
                   v * (kVecBytes / (int)sizeof(P));
    unsigned char* dst = is_k ? kdst + r * kstride + v * kVecBytes
                              : vdst + r * vstride + v * kVecBytes;
    cp_async16(dst, src, slot >= 0);
  }
  for (int r = threadIdx.x; r < n_keys; r += n_threads) {
    const int slot = slot_of(table_row, w0 + r, w_end, block_size, n_blocks);
    valid[r] = slot >= 0;
    if (k_scale != nullptr) {  // scales land with the tile
      const int sl = slot < 0 ? 0 : slot;
      cp_async4(ksc + r, k_scale + sl, slot >= 0);
      cp_async4(vsc + r, v_scale + sl, slot >= 0);
    }
  }
}

// ------------------------------------------------------- split route

// Stages a split's ring needs: kSplitStages, or fewer when the split has
// fewer tiles (a one-tile split then takes a third of the shared memory,
// and three times the blocks fit on an SM).
__host__ __device__ __forceinline__ int split_ring_stages(int split_len) {
  const int tiles = (split_len + kSplitTile - 1) / kSplitTile;
  return tiles < kSplitStages ? tiles : kSplitStages;
}

// Shared memory of a split-route block, in bytes: q rows in f32, then a
// ring of K/V tiles in the pool's type (later reused for the warps'
// partials), then scales and row validity per stage, then the table row.
size_t split_smem_bytes(int seq_q, int dk, int dv, int item,
                        int max_blocks, int split_len) {
  const size_t q = (size_t)seq_q * dk * 4;
  const size_t ring = split_ring_stages(split_len) * (size_t)kSplitTile *
                      (dk * item + kRowPad + dv * item + kRowPad);
  const size_t red = 4 * (size_t)seq_q * (dv + 2) * 4;
  return q + (ring > red ? ring : red) +
         kSplitStages * kSplitTile * (2 * 4 + 4) + max_blocks * 4;
}

// grid (n_heads, batch, n_splits), block kSplitThreads, seq_q <= kT
// query rows, Dv <= 32 kC. Split s covers window keys [s * split_len,
// (s + 1) * split_len) cut at the last visible one; it writes its
// partial max and sum to part_ml [B, H, n_splits, T, 2] and its
// unnormalized accumulator to part_acc [B, H, n_splits, T, Dv]. A split
// with no key writes m = -inf, l = 0 and leaves its accumulator
// unwritten (the merge skips it).
//
// Each warp owns 8 keys of every 32-key tile: lane = key (low 3 bits)
// x quarter of the head dim (high 2 bits), so the 8 lanes of one 16-byte
// shared-memory phase read 8 different rows (row stride = 16 mod 128
// bytes: no bank conflict). A warp keeps its own running softmax per
// query row; the four warps merge at the end. Tiles stream through a
// ring of kSplitStages stages (cp.async, kSplitStages - 1 tiles in
// flight while one is scored; one barrier a tile).
template <typename T, typename P, int kT, int kC>
__global__ void __launch_bounds__(kSplitThreads)
    paged_window_attention_split_kernel(
        const T* __restrict__ q, const P* __restrict__ k_pool,
        const P* __restrict__ v_pool, const float* __restrict__ k_scale,
        const float* __restrict__ v_scale, const int* __restrict__ tables,
        const int* __restrict__ cached_lens, float* __restrict__ part_ml,
        float* __restrict__ part_acc, int seq_q, int n_heads, int dk,
        int dv, int n_blocks, int block_size, int max_blocks, int n_splits,
        int split_len, float scale) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  constexpr int kVec = kVecBytes / (int)sizeof(P);
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cached = cached_lens[b];
  const int n_keys = min(max_blocks * block_size, max(cached + seq_q, 0));
  const int k0 = s * split_len;
  const int k1 = min(k0 + split_len, n_keys);
  const size_t part = ((size_t)(b * n_heads + h) * n_splits + s) * seq_q;
  if (k0 >= k1) {  // starts past the last visible position
    for (int t = tid; t < seq_q; t += kSplitThreads) {
      part_ml[(part + t) * 2] = -INFINITY;
      part_ml[(part + t) * 2 + 1] = 0.f;
    }
    return;
  }
  const int kstride = dk * (int)sizeof(P) + kRowPad;
  const int vstride = dv * (int)sizeof(P) + kRowPad;
  const size_t stage = (size_t)kSplitTile * (kstride + vstride);
  float* q_s = reinterpret_cast<float*>(dsmem);
  unsigned char* ring = dsmem + (size_t)seq_q * dk * 4;
  const size_t ring_bytes = split_ring_stages(split_len) * stage;
  const size_t red_bytes = 4 * (size_t)seq_q * (dv + 2) * 4;
  float* sc_s = reinterpret_cast<float*>(
      ring + (ring_bytes > red_bytes ? ring_bytes : red_bytes));
  int* valid_s = reinterpret_cast<int*>(sc_s + kSplitStages * 2 * kSplitTile);
  int* tab_s = valid_s + kSplitStages * kSplitTile;  // the sequence's block-table row
  const int* table_row = tab_s;
  const bool quant = k_scale != nullptr;

  for (int i = tid; i < seq_q * dk; i += kSplitThreads) {
    const int t = i / dk, d = i - t * dk;
    q_s[i] = to_f32(q[(((size_t)b * seq_q + t) * n_heads + h) * dk + d]);
  }
  const int n_tiles = (k1 - k0 + kSplitTile - 1) / kSplitTile;
  auto issue = [=](int it) {  // tile `it` into its stage, if it exists
    if (it < n_tiles) {
      const int st = it % kSplitStages;
      unsigned char* kd = ring + st * stage;
      issue_tile<P>(kd, kd + kSplitTile * kstride, kstride, vstride,
                    valid_s + st * kSplitTile, sc_s + st * 2 * kSplitTile,
                    sc_s + st * 2 * kSplitTile + kSplitTile, k_pool, v_pool,
                    k_scale, v_scale, table_row, k0 + it * kSplitTile,
                    kSplitTile, k1, n_heads, h, dk, dv, n_blocks, block_size,
                    kSplitThreads);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  const int kl = lane & 7, quarter = lane >> 3;
  const int r = warp * 8 + kl;  // this lane's key row in a tile
  const int kvec = dk / kVec;
  float m[kT], l[kT], acc[kT][kC];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    m[t] = -INFINITY;
    l[t] = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) acc[t][i] = 0.f;
  }

  for (int i = tid; i < max_blocks; i += kSplitThreads)
    tab_s[i] = tables[(size_t)b * max_blocks + i];
  __syncthreads();  // q and the table row
#pragma unroll
  for (int it = 0; it < kSplitStages - 1; ++it) issue(it);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kSplitStages - 2>();
    __syncthreads();  // tile `it` landed; tile it-1's stage is free
    issue(it + kSplitStages - 1);
    const int st = it % kSplitStages;
    const int w0 = k0 + it * kSplitTile;
    const unsigned char* ks = ring + st * stage;
    const unsigned char* vs = ks + kSplitTile * kstride;
    const float* ksc = sc_s + st * 2 * kSplitTile;
    const float* vsc = ksc + kSplitTile;

    // scores: this lane's quarter of the head dim of key r, all rows
    float sc[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) sc[t] = 0.f;
    const P* krow = reinterpret_cast<const P*>(ks + r * kstride);
    const float kscale = quant ? ksc[r] : 1.f;
    for (int v = quarter; v < kvec; v += 4) {
      float kf[kVec];
      vec_f32<T>(krow + v * kVec, kscale, kf);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < seq_q) {
          const float* qr = q_s + t * dk + v * kVec;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qr + e);
            sc[t] = fmaf(qq.x, kf[e], sc[t]);
            sc[t] = fmaf(qq.y, kf[e + 1], sc[t]);
            sc[t] = fmaf(qq.z, kf[e + 2], sc[t]);
            sc[t] = fmaf(qq.w, kf[e + 3], sc[t]);
          }
        }
      }
    }
    const int w = w0 + r;
    const bool key_ok = valid_s[st * kSplitTile + r] != 0;
    float p[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      p[t] = 0.f;
      if (t < seq_q) {
        float x = sc[t];
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        x = (key_ok && w <= cached + t) ? x * scale : -INFINITY;
        float mx = x;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[t], mx);
        const float corr = m[t] == -INFINITY ? 0.f : expf(m[t] - m_new);
        const float e = x == -INFINITY ? 0.f : expf(x - m_new);
        float sum = e;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        l[t] = l[t] * corr + sum;
        m[t] = m_new;
#pragma unroll
        for (int i = 0; i < kC; ++i) acc[t][i] *= corr;
        p[t] = e;
      }
    }
    // values: lane owns columns lane + 32 i of the warp's 8 keys
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int rr = warp * 8 + kk;
      const P* vrow = reinterpret_cast<const P*>(vs + rr * vstride);
      const float vscale = quant ? vsc[rr] : 1.f;
      float vv[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < dv ? elem_f32<T>(vrow + d, vscale) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < seq_q) {
          const float pk = __shfl_sync(0xffffffffu, p[t], kk);
#pragma unroll
          for (int i = 0; i < kC; ++i) acc[t][i] = fmaf(pk, vv[i], acc[t][i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // merge the four warps' partials (the ring is free now)
  float* red_acc = reinterpret_cast<float*>(ring);
  float* red_m = red_acc + 4 * seq_q * dv;
  float* red_l = red_m + 4 * seq_q;
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    if (t < seq_q) {
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int d = lane + 32 * i;
        if (d < dv) red_acc[(warp * seq_q + t) * dv + d] = acc[t][i];
      }
      if (lane == 0) {
        red_m[warp * seq_q + t] = m[t];
        red_l[warp * seq_q + t] = l[t];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < seq_q * dv; i += kSplitThreads) {
    const int t = i / dv, d = i - t * dv;
    float mx = -INFINITY;
    for (int wp = 0; wp < 4; ++wp) mx = fmaxf(mx, red_m[wp * seq_q + t]);
    float sum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int wp = 0; wp < 4; ++wp) {
        const float mw = red_m[wp * seq_q + t];
        if (mw == -INFINITY) continue;  // zero weight, never NaN
        const float e = expf(mw - mx);
        sum += e * red_l[wp * seq_q + t];
        a += e * red_acc[(wp * seq_q + t) * dv + d];
      }
    }
    part_acc[(part + t) * dv + d] = a;
    if (d == 0) {
      part_ml[(part + t) * 2] = mx;
      part_ml[(part + t) * 2 + 1] = sum;
    }
  }
}

// One thread per output element [B, T, H, Dv]: the splits' partials
// weighed by exp(m_s - M), skipping splits with m_s = -inf; a row no
// split saw a key for writes zeros.
template <typename T>
__global__ void paged_window_attention_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out, int batch, int seq_q, int n_heads, int dv,
    int n_splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)batch * seq_q * n_heads * dv;
  if (i >= total) return;
  const int d = (int)(i % dv);
  size_t rest = i / dv;
  const int h = (int)(rest % n_heads);
  rest /= n_heads;
  const int t = (int)(rest % seq_q);
  const int b = (int)(rest / seq_q);
  const size_t base = (size_t)(b * n_heads + h) * n_splits * seq_q + t;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_ml[(base + (size_t)s * seq_q) * 2]);
  float sum = 0.f, a = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < n_splits; ++s) {
      const size_t j = base + (size_t)s * seq_q;
      const float ms = part_ml[j * 2];
      if (ms == -INFINITY) continue;
      const float e = expf(ms - mx);
      sum += e * part_ml[j * 2 + 1];
      a += e * part_acc[j * dv + d];
    }
  }
  store_f32(out + i, sum > 0.f ? a / sum : 0.f);
}

// ------------------------------------------------- query-tile route, f32

// Shared memory of an f32 query-tile block, in bytes: the q tile in f32,
// a two-stage ring of 64-key K/V tiles in the pool's type, the f32
// copies of the current tile (pools that are not f32: converted once
// per tile, not once per read), the probability tile, scales, validity.
size_t tile_smem_bytes(int dk, int dv, int item, int max_blocks) {
  const size_t q = (size_t)kQTile * (dk + 4) * 4;
  const size_t ring = kTileStages * (size_t)kKeyTile *
                      (dk * item + kRowPad + dv * item + kRowPad);
  const size_t conv =
      item == 4 ? 0 : (size_t)kKeyTile * ((dk + 4) + (dv + 4)) * 4;
  const size_t p = (size_t)kQTile * (kKeyTile + 16) * 4;
  return q + ring + conv + p + kTileStages * kKeyTile * (2 * 4 + 4) +
         max_blocks * 4;
}

// grid (n_heads, batch, ceil(T / 64)), block kTileThreads. Register
// tiling: thread (rg = tid / 16, kg = tid % 16) owns query rows rg + 16 i
// (i < 4) and keys kg + 16 j (j < 4) of the 64x64 score tile, then the
// same rows and columns 4 kg + 64 c .. +3 of the 64 x Dv accumulator.
// The running max and sum stay in registers (the 16 lanes of a row
// group reduce by shuffles); probabilities go through a per-warp slice
// of shared memory to the accumulator product. The key walk stops at
// the tile's last visible position.
template <typename T, typename P>
__global__ void __launch_bounds__(kTileThreads)
    paged_window_attention_tile_kernel(
        const T* __restrict__ q, const P* __restrict__ k_pool,
        const P* __restrict__ v_pool, const float* __restrict__ k_scale,
        const float* __restrict__ v_scale, const int* __restrict__ tables,
        const int* __restrict__ cached_lens, T* __restrict__ out,
        float* __restrict__ part_ml, float* __restrict__ part_acc, int seq_q,
        int n_heads, int dk, int dv, int n_blocks, int block_size,
        int max_blocks, int n_splits, int split_len, float scale) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  constexpr bool kF32Pool = sizeof(P) == 4;
  constexpr int kVec = kVecBytes / (int)sizeof(P);
  constexpr int kPStride = kKeyTile + 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z % n_splits;  // key split of this block
  // the longest tiles (the last rows see the most keys) start first
  const int q_tiles = (seq_q + kQTile - 1) / kQTile;
  const int t0 = (q_tiles - 1 - (int)blockIdx.z / n_splits) * kQTile;
  const int n_q = min(kQTile, seq_q - t0);
  const int tid = threadIdx.x;
  const int rg = tid >> 4, kg = tid & 15;
  const int qstride = dk + 4;  // floats
  const int kstride = dk * (int)sizeof(P) + kRowPad;
  const int vstride = dv * (int)sizeof(P) + kRowPad;
  const size_t stage = (size_t)kKeyTile * (kstride + vstride);
  float* q_s = reinterpret_cast<float*>(dsmem);
  unsigned char* ring = dsmem + (size_t)kQTile * qstride * 4;
  float* conv_k = reinterpret_cast<float*>(ring + kTileStages * stage);
  float* conv_v = conv_k + (kF32Pool ? 0 : kKeyTile * (dk + 4));
  float* p_s = conv_v + (kF32Pool ? 0 : kKeyTile * (dv + 4));
  float* sc_s = p_s + kQTile * kPStride;
  int* valid_s = reinterpret_cast<int*>(sc_s + kTileStages * 2 * kKeyTile);
  int* tab_s = valid_s + kTileStages * kKeyTile;  // the sequence's block-table row
  const int* table_row = tab_s;
  const bool quant = k_scale != nullptr;
  const int cached = cached_lens[b];
  const int n_keys =
      min(max_blocks * block_size, max(cached + t0 + n_q, 0));
  const int k0 = split * split_len;
  const int k1 = min(k0 + split_len, n_keys);
  // partials of (b, h, split) rows t0.. in [B, H, n_splits, T, *]
  const size_t part = ((size_t)(b * n_heads + h) * n_splits + split) *
                          seq_q + t0;
  if (n_splits > 1 && k0 >= k1) {  // past the tile's last visible key
    for (int t = threadIdx.x; t < n_q; t += blockDim.x) {
      part_ml[(part + t) * 2] = -INFINITY;
      part_ml[(part + t) * 2 + 1] = 0.f;
    }
    return;
  }

  for (int i = tid; i < kQTile * dk; i += kTileThreads) {
    const int t = i / dk, d = i - t * dk;
    q_s[t * qstride + d] =
        t < n_q ? to_f32(q[(((size_t)b * seq_q + t0 + t) * n_heads + h) * dk +
                           d])
                : 0.f;
  }
  const int n_tiles = (max(k1 - k0, 0) + kKeyTile - 1) / kKeyTile;
  auto issue = [=](int it) {  // tile `it` into its stage, if it exists
    if (it < n_tiles) {
      const int st = it % kTileStages;
      unsigned char* kd = ring + st * stage;
      issue_tile<P>(kd, kd + kKeyTile * kstride, kstride, vstride,
                    valid_s + st * kKeyTile, sc_s + st * 2 * kKeyTile,
                    sc_s + st * 2 * kKeyTile + kKeyTile, k_pool, v_pool,
                    k_scale, v_scale, table_row, k0 + it * kKeyTile,
                    kKeyTile, k1, n_heads, h, dk, dv, n_blocks, block_size,
                    kTileThreads);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float m[4], l[4], acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int i = tid; i < max_blocks; i += kTileThreads)
    tab_s[i] = tables[(size_t)b * max_blocks + i];
  __syncthreads();  // q and the table row
#pragma unroll
  for (int it = 0; it < kTileStages - 1; ++it) issue(it);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kTileStages - 2>();
    __syncthreads();  // tile `it` landed; tile it-1's stage is free
    issue(it + kTileStages - 1);
    const int st = it % kTileStages;
    const int w0 = k0 + it * kKeyTile;
    const unsigned char* ks = ring + st * stage;
    const unsigned char* vs = ks + kKeyTile * kstride;
    const float* ksc = sc_s + st * 2 * kKeyTile;
    const float* vsc = ksc + kKeyTile;
    const float* kt;
    const float* vt;
    int kts, vts;  // f32 row strides of the tile copies
    if (kF32Pool) {
      kt = reinterpret_cast<const float*>(ks);
      vt = reinterpret_cast<const float*>(vs);
      kts = kstride / 4;
      vts = vstride / 4;
    } else {
      // convert (dequantize) the tile to f32 once
      const int kvec = dk / kVec, vvec = dv / kVec;
      for (int c = tid; c < kKeyTile * (kvec + vvec); c += kTileThreads) {
        const bool is_k = c < kKeyTile * kvec;
        const int cc = is_k ? c : c - kKeyTile * kvec;
        const int nv = is_k ? kvec : vvec;
        const int r = cc / nv, v = cc - r * nv;
        float f[kVec];
        const P* src = reinterpret_cast<const P*>(
            (is_k ? ks + r * kstride : vs + r * vstride));
        vec_f32<T>(src + v * kVec, quant ? (is_k ? ksc[r] : vsc[r]) : 1.f,
                   f);
        float* dst = is_k ? conv_k + r * (dk + 4) + v * kVec
                          : conv_v + r * (dv + 4) + v * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
      __syncthreads();
      kt = conv_k;
      vt = conv_v;
      kts = dk + 4;
      vts = dv + 4;
    }

    // scores: 4 rows x 4 keys a thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dk; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (rg + 16 * i) * qstride +
                                                 d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(kt + (kg + 16 * j) * kts + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }
    // mask, online softmax per row (16 lanes of the row group)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg + 16 * i;
      const int last = cached + t0 + row;  // last visible position
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = kg + 16 * j;
        const bool ok = valid_s[st * kKeyTile + r] && w0 + r <= last;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        p_s[row * kPStride + kg + 16 * j] = e;
        sum += e;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncwarp();  // a warp reads only the probability rows it wrote
    // accumulator: 4 rows x (4 columns per 64) a thread
    for (int k = 0; k < kKeyTile; k += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(p_s + (rg + 16 * i) * kPStride +
                                                 k);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 4 * kg + 64 * c;
        if (col < dv) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vt + (k + kk) * vts + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pk = kk == 0   ? pr[i].x
                               : kk == 1 ? pr[i].y
                               : kk == 2 ? pr[i].z
                                         : pr[i].w;
              acc[i][c][0] = fmaf(pk, vv.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(pk, vv.y, acc[i][c][1]);
              acc[i][c][2] = fmaf(pk, vv.z, acc[i][c][2]);
              acc[i][c][3] = fmaf(pk, vv.w, acc[i][c][3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // a row with no valid key writes zeros
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int row = rg + 16 * i;
    if (row >= n_q) continue;
    if (n_splits > 1) {  // this split's partial, merged by the merge kernel
      if (kg == 0) {
        part_ml[(part + row) * 2] = m[i];
        part_ml[(part + row) * 2 + 1] = sum;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 4 * kg + 64 * c;
        if (col < dv)
          *reinterpret_cast<float4*>(part_acc + (part + row) * dv + col) =
              make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2],
                          acc[i][c][3]);
      }
      continue;
    }
    T* orow = out + (((size_t)b * seq_q + t0 + row) * n_heads + h) * dv;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 4 * kg + 64 * c;
      if (col < dv) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store_f32(orow + col + e, sum > 0.f ? acc[i][c][e] / sum : 0.f);
      }
    }
  }
}

// ---------------------------------- query-tile route, bf16 tensor cores

// Shared memory of a tensor-core block, in bytes: the q tile and a
// two-stage ring of K/V tiles, rows padded by 16 bytes (ldmatrix's
// eight 16-byte rows then fall in eight different bank groups), plus
// for int8 pools the bf16 tile the codes are dequantized into.
size_t mma_smem_bytes(int dk, int dv, int item, int max_blocks,
                      int q_rows) {
  const size_t q = (size_t)q_rows * (dk * 2 + kRowPad);
  const size_t ring = kMmaStages * (size_t)kKeyTile *
                      (dk * item + kRowPad + dv * item + kRowPad);
  const size_t conv =
      item == 1 ? (size_t)kKeyTile * (dk * 2 + kRowPad + dv * 2 + kRowPad)
                : 0;
  return q + ring + conv + kMmaStages * kKeyTile * (2 * 4 + 4) +
         max_blocks * 4;
}

// grid (n_heads, batch, ceil(T / (16 kWarps)) x splits), block 32 kWarps:
// warp w owns query rows 16 w .. 16 w + 15 of the tile (64 rows, or 128
// past T = 64: each K/V tile is then read by half as many blocks, and an
// SM holds twice the warps to hide the latency of its tile chain). Query
// tiles start longest first. Head dims up to 16 kMaxKSteps and
// 8 kMaxDvTiles size the fragment arrays. S = Q K^T and O += P V run
// as mma.sync m16n8k16 (bf16 in, f32 accumulate), fed by ldmatrix (V
// transposed); the score fragment is rescaled, exponentiated and packed
// to bf16 in registers as the A operand of P V (the plain version casts
// the probabilities to the values' type too). Row max and sum stay in
// registers: a row lives in the 4 lanes of a quad. P is __nv_bfloat16
// pools, or signed char codes dequantized to bf16 once per tile.
template <typename P, int kWarps, int kMaxKSteps, int kMaxDvTiles>
__global__ void __launch_bounds__(32 * kWarps)
    paged_window_attention_mma_kernel(
        const __nv_bfloat16* __restrict__ q, const P* __restrict__ k_pool,
        const P* __restrict__ v_pool, const float* __restrict__ k_scale,
        const float* __restrict__ v_scale, const int* __restrict__ tables,
        const int* __restrict__ cached_lens, __nv_bfloat16* __restrict__ out,
        float* __restrict__ part_ml, float* __restrict__ part_acc, int seq_q,
        int n_heads, int dk, int dv, int n_blocks, int block_size,
        int max_blocks, int n_splits, int split_len, float scale) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = 16 * kWarps;  // query rows of the tile
  const int h = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z % n_splits;  // key split of this block
  // the longest tiles (the last rows see the most keys) start first
  const int q_tiles = (seq_q + kRows - 1) / kRows;
  const int t0 = (q_tiles - 1 - (int)blockIdx.z / n_splits) * kRows;
  const int n_q = min(kRows, seq_q - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int qstride = dk * 2 + kRowPad;
  const int kstride = dk * (int)sizeof(P) + kRowPad;
  const int vstride = dv * (int)sizeof(P) + kRowPad;
  const int kbs = dk * 2 + kRowPad, vbs = dv * 2 + kRowPad;  // bf16 tiles
  const size_t stage = (size_t)kKeyTile * (kstride + vstride);
  unsigned char* q_s = dsmem;
  unsigned char* ring = dsmem + (size_t)kRows * qstride;
  unsigned char* conv_k = ring + kMmaStages * stage;
  unsigned char* conv_v = conv_k + (kQuant ? kKeyTile * kbs : 0);
  float* sc_s = reinterpret_cast<float*>(conv_v + (kQuant ? kKeyTile * vbs : 0));
  int* valid_s = reinterpret_cast<int*>(sc_s + kMmaStages * 2 * kKeyTile);
  int* tab_s = valid_s + kMmaStages * kKeyTile;  // the sequence's block-table row
  const int* table_row = tab_s;
  const int cached = cached_lens[b];
  const int n_keys =
      min(max_blocks * block_size, max(cached + t0 + n_q, 0));
  const int k0 = split * split_len;
  const int k1 = min(k0 + split_len, n_keys);
  // partials of (b, h, split) rows t0.. in [B, H, n_splits, T, *]
  const size_t part = ((size_t)(b * n_heads + h) * n_splits + split) *
                          seq_q + t0;
  if (n_splits > 1 && k0 >= k1) {  // past the tile's last visible key
    for (int t = threadIdx.x; t < n_q; t += blockDim.x) {
      part_ml[(part + t) * 2] = -INFINITY;
      part_ml[(part + t) * 2 + 1] = 0.f;
    }
    return;
  }

  // q tile: 16-byte vectors, rows past the window zero
  const int qvec = dk / 8;
  for (int c = tid; c < kRows * qvec; c += kThreads) {
    const int t = c / qvec, v = c - t * qvec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < n_q)
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * seq_q + t0 + t) * n_heads + h) * dk + v * 8);
    *reinterpret_cast<uint4*>(q_s + t * qstride + v * 16) = val;
  }
  const int n_tiles = (max(k1 - k0, 0) + kKeyTile - 1) / kKeyTile;
  auto issue = [=](int it) {  // tile `it` into its stage, if it exists
    if (it < n_tiles) {
      const int st = it % kMmaStages;
      unsigned char* kd = ring + st * stage;
      issue_tile<P>(kd, kd + kKeyTile * kstride, kstride, vstride,
                    valid_s + st * kKeyTile, sc_s + st * 2 * kKeyTile,
                    sc_s + st * 2 * kKeyTile + kKeyTile, k_pool, v_pool,
                    k_scale, v_scale, table_row, k0 + it * kKeyTile,
                    kKeyTile, k1, n_heads, h, dk, dv, n_blocks, block_size,
                    kThreads);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int i = tid; i < max_blocks; i += kThreads)
    tab_s[i] = tables[(size_t)b * max_blocks + i];
  __syncthreads();  // q and the table row
#pragma unroll
  for (int it = 0; it < kMmaStages - 1; ++it) issue(it);

  // this warp's Q fragments, kept in registers for the whole walk
  const int ksteps = dk / 16;
  unsigned qa[kMaxKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk) {
    if (kk < ksteps) {
      const int row = warp * 16 + (lane & 15);
      const int col = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(smem_u32(q_s + row * qstride + col * 2), qa[kk]);
    }
  }

  const int dtiles = dv / 8;
  float o[kMaxDvTiles][4];
#pragma unroll
  for (int n = 0; n < kMaxDvTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int last0 = cached + t0 + row0, last1 = last0 + 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // tile `it` landed; tile it-1's stage is free
    issue(it + kMmaStages - 1);
    const int st = it % kMmaStages;
    const int w0 = k0 + it * kKeyTile;
    const unsigned char* kt = ring + st * stage;
    const unsigned char* vt = kt + kKeyTile * kstride;
    int kts = kstride, vts = vstride;
    if (kQuant) {
      // dequantize the tile to bf16 once: 16 codes a thread a step
      const float* ksc = sc_s + st * 2 * kKeyTile;
      const float* vsc = ksc + kKeyTile;
      const int kv = dk / 16, vv = dv / 16;
      for (int c = tid; c < kKeyTile * (kv + vv); c += kThreads) {
        const bool is_k = c < kKeyTile * kv;
        const int cc = is_k ? c : c - kKeyTile * kv;
        const int nv = is_k ? kv : vv;
        const int r = cc / nv, v = cc - r * nv;
        float f[16];
        vec_f32<__nv_bfloat16>(
            reinterpret_cast<const signed char*>(
                (is_k ? kt + r * kstride : vt + r * vstride)) + v * 16,
            is_k ? ksc[r] : vsc[r], f);
        uint4 u0, u1;
        u0.x = pack_bf16(f[0], f[1]);   u0.y = pack_bf16(f[2], f[3]);
        u0.z = pack_bf16(f[4], f[5]);   u0.w = pack_bf16(f[6], f[7]);
        u1.x = pack_bf16(f[8], f[9]);   u1.y = pack_bf16(f[10], f[11]);
        u1.z = pack_bf16(f[12], f[13]); u1.w = pack_bf16(f[14], f[15]);
        unsigned char* dst =
            is_k ? conv_k + r * kbs + v * 32 : conv_v + r * vbs + v * 32;
        *reinterpret_cast<uint4*>(dst) = u0;
        *reinterpret_cast<uint4*>(dst + 16) = u1;
      }
      __syncthreads();
      kt = conv_k;
      vt = conv_v;
      kts = kbs;
      vts = vbs;
    }

    // S = Q K^T: 8 n-tiles of 8 keys, two per ldmatrix.x4
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxKSteps; ++kk) {
      if (kk < ksteps) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          unsigned bfr[4];
          ldsm_x4(smem_u32(kt + key * kts + col * 2), bfr);
          mma_bf16(s[2 * np], qa[kk], bfr[0], bfr[1]);
          mma_bf16(s[2 * np + 1], qa[kk], bfr[2], bfr[3]);
        }
      }
    }
    // mask, scale, online softmax (rows row0 and row0 + 8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * qd + (e & 1);
        const bool ok = valid_s[st * kKeyTile + r] &&
                        w0 + r <= (e < 2 ? last0 : last1);
        s[n][e] = ok ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float e_ =
            s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - m[e >> 1]);
        s[n][e] = e_;
        l[e >> 1] += e_;
      }
#pragma unroll
    for (int n = 0; n < kMaxDvTiles; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // O += P V: 4 k-steps of 16 keys
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < kMaxDvTiles / 2; ++np) {
        if (2 * np < dtiles) {
          const int key = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = 16 * np + (lane >> 4) * 8;
          unsigned bfr[4];
          ldsm_x4_trans(smem_u32(vt + key * vts + col * 2), bfr);
          mma_bf16(o[2 * np], pa, bfr[0], bfr[1]);
          mma_bf16(o[2 * np + 1], pa, bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // row sums over the quad; a row with no valid key writes zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= n_q) continue;
    if (n_splits > 1) {  // this split's partial, merged by the merge kernel
      if (qd == 0) {
        part_ml[(part + row) * 2] = m[i];
        part_ml[(part + row) * 2 + 1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < kMaxDvTiles; ++n)
        if (n < dtiles)
          *reinterpret_cast<float2*>(part_acc + (part + row) * dv + 8 * n +
                                     2 * qd) =
              make_float2(o[n][2 * i], o[n][2 * i + 1]);
      continue;
    }
    __nv_bfloat16* orow =
        out + (((size_t)b * seq_q + t0 + row) * n_heads + h) * dv;
#pragma unroll
    for (int n = 0; n < kMaxDvTiles; ++n) {
      if (n < dtiles) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            l[i] > 0.f ? o[n][2 * i] / l[i] : 0.f,
            l[i] > 0.f ? o[n][2 * i + 1] / l[i] : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * qd) = v;
      }
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, typename P, int kT, int kC, typename... Args>
int launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                 Args... args) {
  const int err = allow_smem(
      paged_window_attention_split_kernel<T, P, kT, kC>, smem);
  if (err != 0) return err;
  paged_window_attention_split_kernel<T, P, kT, kC>
      <<<grid, kSplitThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename P, int kWarps, int kKS, int kDT, typename... Args>
int launch_mma(dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  const int err = allow_smem(
      paged_window_attention_mma_kernel<P, kWarps, kKS, kDT>, smem);
  if (err != 0) return err;
  paged_window_attention_mma_kernel<P, kWarps, kKS, kDT>
      <<<grid, 32 * kWarps, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// route: 0 generic (the first design), 1 split + merge, 2 f32 query tile,
// 3 bf16 tensor-core query tile (bf16 q only).
template <typename T, typename P>
int launch_route(int route, const void* q, const void* k_pool,
                 const void* v_pool, const void* k_scale,
                 const void* v_scale, const void* tables,
                 const void* cached_lens, void* out, void* part_ml,
                 void* part_acc, int batch, int n_q, int n_heads, int dk,
                 int dv, int n_blocks, int block_size, int max_blocks,
                 int n_splits, int split_len, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // sqrt(Dk) rounded to the query type, the divisor of the plain
  // version (and of the JAX package): 11.3125 for Dk=128 in bf16
  const float sqrt_dk = rq<T>(sqrtf((float)dk));
  const float scale = 1.f / sqrt_dk;  // fast routes multiply
  const T* qt = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pool);
  const P* vp = static_cast<const P*>(v_pool);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tab = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(cached_lens);
  T* o = static_cast<T*>(out);
  const int q_tiles = (n_q + kQTile - 1) / kQTile;
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (n_splits < 1) return (int)cudaErrorInvalidValue;
  int err = 0;
  switch (route) {
    case 0:
      return launch<T, P>(q, k_pool, v_pool, k_scale, v_scale, tables,
                          cached_lens, out, batch, n_q, n_heads, dk, dv,
                          n_blocks, block_size, max_blocks, sqrt_dk,
                          stream_ptr);
    case 1: {
      if (n_q > kMaxT) return (int)cudaErrorInvalidValue;
      const size_t smem = split_smem_bytes(n_q, dk, dv, (int)sizeof(P),
                                           max_blocks, split_len);
      const dim3 grid(n_heads, batch, n_splits);
      // instantiated for T <= 1, 2, 4, 8 rows and Dv <= 64, 128
      const int rows = n_q <= 1 ? 1 : n_q <= 2 ? 2 : n_q <= 4 ? 4 : 8;
      const int key = rows * 2 + (dv <= 64 ? 0 : 1);
#define PWA_SPLIT(KT, KC)                                                   \
  launch_split<T, P, KT, KC>(grid, smem, stream, qt, kp, vp, ks, vs, tab, \
                             cl, ml, acc, n_q, n_heads, dk, dv, n_blocks,  \
                             block_size, max_blocks, n_splits, split_len,  \
                             scale)
      switch (key) {
        case 2: err = PWA_SPLIT(1, 2); break;
        case 3: err = PWA_SPLIT(1, 4); break;
        case 4: err = PWA_SPLIT(2, 2); break;
        case 5: err = PWA_SPLIT(2, 4); break;
        case 8: err = PWA_SPLIT(4, 2); break;
        case 9: err = PWA_SPLIT(4, 4); break;
        case 16: err = PWA_SPLIT(8, 2); break;
        default: err = PWA_SPLIT(8, 4); break;
      }
#undef PWA_SPLIT
      break;
    }
    case 2: {
      const size_t smem = tile_smem_bytes(dk, dv, (int)sizeof(P), max_blocks);
      err = allow_smem(paged_window_attention_tile_kernel<T, P>, smem);
      if (err != 0) return err;
      paged_window_attention_tile_kernel<T, P>
          <<<dim3(n_heads, batch, q_tiles * n_splits), kTileThreads, smem,
             stream>>>(qt, kp, vp, ks, vs, tab, cl, o, ml, acc, n_q, n_heads,
                       dk, dv, n_blocks, block_size, max_blocks, n_splits,
                       split_len, scale);
      err = (int)cudaGetLastError();
      break;
    }
    case 3: {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (dk % 16 != 0 || dv % 16 != 0) return (int)cudaErrorInvalidValue;
        const bool wide = n_q > kMmaWideT;  // 128-row query tiles
        const int rows = wide ? 128 : 64;
        const size_t smem =
            mma_smem_bytes(dk, dv, (int)sizeof(P), max_blocks, rows);
        const dim3 grid(n_heads, batch,
                        (n_q + rows - 1) / rows * n_splits);
        const int key = (wide ? 4 : 0) + (dk <= 64 ? 0 : 2) +
                        (dv <= 64 ? 0 : 1);
#define PWA_MMA(W, KS, DT)                                                  \
  launch_mma<P, W, KS, DT>(grid, smem, stream, qt, kp, vp, ks, vs, tab, cl, \
                           o, ml, acc, n_q, n_heads, dk, dv, n_blocks,      \
                           block_size, max_blocks, n_splits, split_len,     \
                           scale)
        switch (key) {
          case 0: err = PWA_MMA(4, 4, 8); break;
          case 1: err = PWA_MMA(4, 4, 16); break;
          case 2: err = PWA_MMA(4, 8, 8); break;
          case 3: err = PWA_MMA(4, 8, 16); break;
          case 4: err = PWA_MMA(8, 4, 8); break;
          case 5: err = PWA_MMA(8, 4, 16); break;
          case 6: err = PWA_MMA(8, 8, 8); break;
          default: err = PWA_MMA(8, 8, 16); break;
        }
#undef PWA_MMA
        break;
      }
      return (int)cudaErrorInvalidValue;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || (route != 1 && n_splits == 1)) return err;
  // merge the key splits' partials into `out`
  const size_t total = (size_t)batch * n_q * n_heads * dv;
  paged_window_attention_merge_kernel<T>
      <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
          ml, acc, o, batch, n_q, n_heads, dv, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one generic-route launch over a window of n_q
// query rows needs (the wrapper refuses shapes past the card's 227 KB
// per block; the fast routes take head dims up to 128, which fit).
size_t paged_window_attention_smem_bytes(int n_q, int dk, int dv) {
  return smem_words(n_q, dk, dv) * sizeof(float);
}

// Each launches on `stream` of the calling thread's current device (the
// wrapper makes it the tensors' device) and returns cudaGetLastError()
// after the launch (0 = launched). `route` as in launch_route; part_ml
// and part_acc are the split route's f32 scratch ([B, H, n_splits, T,
// 2] and [B, H, n_splits, T, Dv]), unread by the other routes.
int paged_window_attention_f32(const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* cached_lens, void* out,
                               void* part_ml, void* part_acc, int batch,
                               int n_q, int n_heads, int dk, int dv,
                               int n_blocks, int block_size, int max_blocks,
                               int route, int n_splits, int split_len,
                               void* stream) {
  return launch_route<float, float>(
      route, q, k_pool, v_pool, nullptr, nullptr, tables, cached_lens, out,
      part_ml, part_acc, batch, n_q, n_heads, dk, dv, n_blocks, block_size,
      max_blocks, n_splits, split_len, stream);
}

int paged_window_attention_bf16(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* cached_lens, void* out,
                                void* part_ml, void* part_acc, int batch,
                                int n_q, int n_heads, int dk, int dv,
                                int n_blocks, int block_size,
                                int max_blocks, int route, int n_splits,
                                int split_len, void* stream) {
  return launch_route<__nv_bfloat16, __nv_bfloat16>(
      route, q, k_pool, v_pool, nullptr, nullptr, tables, cached_lens, out,
      part_ml, part_acc, batch, n_q, n_heads, dk, dv, n_blocks, block_size,
      max_blocks, n_splits, split_len, stream);
}

// int8 pools (codes) with [n_blocks, block_size] f32 scale pools; q and
// out f32 or bf16.
int paged_window_attention_q8_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* cached_lens, void* out, void* part_ml, void* part_acc,
    int batch, int n_q, int n_heads, int dk, int dv, int n_blocks,
    int block_size, int max_blocks, int route, int n_splits, int split_len,
    void* stream) {
  return launch_route<float, signed char>(
      route, q, k_pool, v_pool, k_scale, v_scale, tables, cached_lens, out,
      part_ml, part_acc, batch, n_q, n_heads, dk, dv, n_blocks, block_size,
      max_blocks, n_splits, split_len, stream);
}

int paged_window_attention_q8_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* cached_lens, void* out, void* part_ml, void* part_acc,
    int batch, int n_q, int n_heads, int dk, int dv, int n_blocks,
    int block_size, int max_blocks, int route, int n_splits, int split_len,
    void* stream) {
  return launch_route<__nv_bfloat16, signed char>(
      route, q, k_pool, v_pool, k_scale, v_scale, tables, cached_lens, out,
      part_ml, part_acc, batch, n_q, n_heads, dk, dv, n_blocks, block_size,
      max_blocks, n_splits, split_len, stream);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
