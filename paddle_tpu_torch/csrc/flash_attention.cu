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
// Bound: operations. Per (batch, head) the forward does 4*Tq*Tk*D flops,
// dQ 6*Tq*Tk*D and dK/dV 8*Tq*Tk*D (half of each under causal) on inputs
// of O(T*D) bytes, so at T=256, D=64 the forward does ~64 flops per byte
// moved, far above the ~20 flops per byte at which an H100's 67 TFLOP/s
// of f32 outside the tensor cores overtakes its 3.35 TB/s. What the
// design does about it: the [Tq, Tk] scores never go to device memory;
// each block stages 64-row tiles of its operands in shared memory and
// every thread computes a register tile of scores (8 or 4 rows x 4 keys)
// and of outputs from them, so each shared-memory load feeds several
// FMAs; the causal loop stops at the diagonal. There is no cross-block
// reduction and no atomics: the forward and dQ run one block per
// (64-row query tile, batch*head) looping over key tiles, dK/dV one block
// per (64-row key tile, batch*head) looping over query tiles from the
// causal start, so blocks may run in any order. f32 has no exact tensor
// core route (TF32 would change the numbers), so this first design uses
// scalar FMAs, single-buffered tiles and no TMA; mma/wgmma in bf16 and
// pipelined loads are later work (see PERF.md for its times beside the
// bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;   // query rows and key rows per tile
constexpr int kLanesX = 16; // threads sharing one row group
constexpr int kKeys = kTile / kLanesX;  // score columns per thread: 4
constexpr int kLdP = kTile + 1;         // padded row of a score tile

template <int D>
struct Cfg {
  static constexpr int kRowLanes = D / 8;                // 8 or 16
  static constexpr int kThreads = kLanesX * kRowLanes;   // 128 or 256
  static constexpr int kRows = kTile / kRowLanes;        // rows per thread
  static constexpr int kCols = D / kLanesX;              // head-dim columns
  static constexpr int kLd = D + 1;  // padded row: no bank conflicts
};

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// max / sum over the 16 lanes that share one row group (a half warp)
__device__ __forceinline__ float group_max(float v) {
  for (int o = kLanesX / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int o = kLanesX / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + kTile) of (b, h) of a [B, T, H, D] tensor into a
// padded f32 tile; rows past n_rows read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          const Strides& s, int b, int h,
                                          int row0, int n_rows) {
  const T* base = static_cast<const T*>(src) + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < kTile * D; i += Cfg<D>::kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    dst[r * Cfg<D>::kLd + d] =
        row < n_rows ? to_f32(base[(long long)row * s.t + d]) : 0.f;
  }
}

// 1 where key k0 + c exists and the key mask lets it through
__device__ __forceinline__ void load_key_ok(float* ok, const Params& p,
                                            int b, int k0, int n_threads) {
  for (int c = threadIdx.x; c < kTile; c += n_threads) {
    const int key = k0 + c;
    ok[c] = (key < p.tk &&
             (p.mask == nullptr || p.mask[b * p.mask_sb + key] > 0.f))
                ? 1.f
                : 0.f;
  }
}

// acc[i][j] += a[row(i)] . b[col(j)] over D, rows ty + i * kRowLanes of
// tile a, columns tx + j * kLanesX of tile b (both padded [64][D+1])
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[Cfg<D>::kRows][kKeys],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  using C = Cfg<D>;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[C::kRows], bv[kKeys];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
      av[i] = a[(ty + i * C::kRowLanes) * C::kLd + d];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) bv[j] = b[(tx + j * kLanesX) * C::kLd + d];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][j] += sum_r w[row(i)][r] * m[r][col(j)]: w a padded [64][65]
// weight tile, m a padded [64][D+1] tile, columns tx + j * kLanesX of D
template <int D>
__device__ __forceinline__ void tile_mix(float (&out)[Cfg<D>::kRows][Cfg<D>::kCols],
                                         const float* w, const float* m,
                                         int ty, int tx) {
  using C = Cfg<D>;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float wv[C::kRows], mv[C::kCols];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
      wv[i] = w[(ty + i * C::kRowLanes) * kLdP + r];
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) mv[j] = m[r * C::kLd + tx + j * kLanesX];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) out[i][j] = fmaf(wv[i], mv[j], out[i][j]);
  }
}

// ------------------------------------------------------------- forward
// grid (B*H, query tiles), block Cfg<D>::kThreads. Shared memory:
// q, k, v tiles [64][D+1], probabilities [64][65], key mask [64].
template <int D>
constexpr size_t fwd_smem_words() {
  return 3 * kTile * Cfg<D>::kLd + kTile * kLdP + kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
    flash_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * C::kLd;
  float* v_s = k_s + kTile * C::kLd;
  float* p_s = v_s + kTile * C::kLd;
  float* ok_s = p_s + kTile * kLdP;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  // under causal the last query tiles have the most keys: start them first
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % kLanesX, ty = threadIdx.x / kLanesX;

  load_tile<T, D>(q_s, p.q, p.sq, b, h, q0, p.tq);

  float m[C::kRows], l[C::kRows], acc[C::kRows][C::kCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) acc[i][j] = 0.f;
  }

  // keys past the tile's last row are masked for all its rows
  const int k_end = p.causal ? min(p.tk, q0 + kTile) : p.tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, p.k, p.sk, b, h, k0, p.tk);
    load_tile<T, D>(v_s, p.v, p.sv, b, h, k0, p.tk);
    load_key_ok(ok_s, p, b, k0, C::kThreads);
    __syncthreads();

    float s[C::kRows][kKeys];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    tile_dot<D>(s, q_s, k_s, ty, tx);

    // online softmax; the m_safe / corr rules keep -inf from making NaN
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
      const int r = ty + i * C::kRowLanes;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int c = tx + j * kLanesX;
        const bool ok = ok_s[c] != 0.f && (!p.causal || k0 + c <= q0 + r);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float e = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        p_s[r * kLdP + tx + j * kLanesX] = e;
        sum += e;
      }
      sum = group_sum(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_mix<D>(acc, p_s, v_s, ty, tx);
  }

  T* o = static_cast<T*>(p.out0);
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const int row = q0 + ty + i * C::kRowLanes;
    if (row >= p.tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * p.tq + row) * p.heads + h) * D;
#pragma unroll
    for (int j = 0; j < C::kCols; ++j)
      store(orow + tx + j * kLanesX, acc[i][j] / den);
    if (tx == 0)
      p.lse[(long long)bh * p.tq + row] =
          l[i] > 0.f ? m[i] + logf(den) : INFINITY;
  }
}

// ------------------------------------------------------------------ dQ
// grid (B*H, query tiles). Also writes delta = rowsum(dO * O) for the
// dK/dV kernel. Shared memory: q, dO, k, v tiles [64][D+1], dS [64][65],
// key mask, lse and delta of the tile's rows [64] each.
template <int D>
constexpr size_t dq_smem_words() {
  return 4 * kTile * Cfg<D>::kLd + kTile * kLdP + 3 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
    flash_bwd_dq_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * C::kLd;
  float* k_s = do_s + kTile * C::kLd;
  float* v_s = k_s + kTile * C::kLd;
  float* ds_s = v_s + kTile * C::kLd;
  float* ok_s = ds_s + kTile * kLdP;
  float* lse_s = ok_s + kTile;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % kLanesX, ty = threadIdx.x / kLanesX;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  load_tile<T, D>(q_s, p.q, p.sq, b, h, q0, p.tq);
  load_tile<T, D>(do_s, p.d_o, p.sdo, b, h, q0, p.tq);
  __syncthreads();
  // delta of each row: one warp per row, lanes over the head dim
  const T* obase = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h;
  for (int r = warp; r < kTile; r += C::kThreads / 32) {
    const int row = q0 + r;
    float dsum = 0.f;
    if (row < p.tq)
      for (int d = lane; d < D; d += 32)
        dsum += do_s[r * C::kLd + d] * to_f32(obase[(long long)row * p.so.t + d]);
    for (int o = 16; o > 0; o >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (lane == 0) {
      delta_s[r] = dsum;
      // rows past Tq: p = exp(s - inf) = 0
      lse_s[r] = row < p.tq ? p.lse[(long long)bh * p.tq + row] : INFINITY;
      if (row < p.tq) p.delta[(long long)bh * p.tq + row] = dsum;
    }
  }

  float dq[C::kRows][C::kCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) dq[i][j] = 0.f;

  const int k_end = p.causal ? min(p.tk, q0 + kTile) : p.tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(k_s, p.k, p.sk, b, h, k0, p.tk);
    load_tile<T, D>(v_s, p.v, p.sv, b, h, k0, p.tk);
    load_key_ok(ok_s, p, b, k0, C::kThreads);
    __syncthreads();

    float s[C::kRows][kKeys], dp[C::kRows][kKeys];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
      const int r = ty + i * C::kRowLanes;
      const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int c = tx + j * kLanesX;
        const bool ok = ok_s[c] != 0.f && (!p.causal || k0 + c <= q0 + r);
        const float pr = ok ? expf(s[i][j] * p.scale - lse) : 0.f;
        ds_s[r * kLdP + c] = pr * (dp[i][j] - delta) * p.scale;
      }
    }
    __syncthreads();
    tile_mix<D>(dq, ds_s, k_s, ty, tx);
  }

  T* out = static_cast<T*>(p.out0);
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const int row = q0 + ty + i * C::kRowLanes;
    if (row >= p.tq) continue;
    T* orow = out + (((long long)b * p.tq + row) * p.heads + h) * D;
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) store(orow + tx + j * kLanesX, dq[i][j]);
  }
}

// --------------------------------------------------------------- dK/dV
// grid (B*H, key tiles). Scores are computed transposed (key rows,
// query columns). Shared memory: k, v, q, dO tiles [64][D+1], P^T and
// dS^T [64][65], key mask, lse and delta of the query tile [64] each.
template <int D>
constexpr size_t dkv_smem_words() {
  return 4 * kTile * Cfg<D>::kLd + 2 * kTile * kLdP + 3 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * C::kLd;
  float* q_s = v_s + kTile * C::kLd;
  float* do_s = q_s + kTile * C::kLd;
  float* pt_s = do_s + kTile * C::kLd;
  float* dst_s = pt_s + kTile * kLdP;
  float* ok_s = dst_s + kTile * kLdP;
  float* lse_s = ok_s + kTile;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % kLanesX, ty = threadIdx.x / kLanesX;

  load_tile<T, D>(k_s, p.k, p.sk, b, h, k0, p.tk);
  load_tile<T, D>(v_s, p.v, p.sv, b, h, k0, p.tk);
  load_key_ok(ok_s, p, b, k0, C::kThreads);

  float dk[C::kRows][C::kCols], dv[C::kRows][C::kCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) dk[i][j] = dv[i][j] = 0.f;

  // the first query tile holding a row >= k0 (causal start)
  const int q_start = p.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_start; q0 < p.tq; q0 += kTile) {
    __syncthreads();
    load_tile<T, D>(q_s, p.q, p.sq, b, h, q0, p.tq);
    load_tile<T, D>(do_s, p.d_o, p.sdo, b, h, q0, p.tq);
    for (int r = threadIdx.x; r < kTile; r += C::kThreads) {
      const int row = q0 + r;
      lse_s[r] = row < p.tq ? p.lse[(long long)bh * p.tq + row] : INFINITY;
      delta_s[r] = row < p.tq ? p.delta[(long long)bh * p.tq + row] : 0.f;
    }
    __syncthreads();

    // s^T[c][r] = k[c] . q[r], dp^T[c][r] = v[c] . dO[r]
    float st[C::kRows][kKeys], dpt[C::kRows][kKeys];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_dot<D>(st, k_s, q_s, ty, tx);
    tile_dot<D>(dpt, v_s, do_s, ty, tx);
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
      const int c = ty + i * C::kRowLanes;
      const bool key_ok = ok_s[c] != 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int r = tx + j * kLanesX;
        const bool ok = key_ok && (!p.causal || k0 + c <= q0 + r);
        const float pr = ok ? expf(st[i][j] * p.scale - lse_s[r]) : 0.f;
        pt_s[c * kLdP + r] = pr;
        dst_s[c * kLdP + r] = pr * (dpt[i][j] - delta_s[r]) * p.scale;
      }
    }
    __syncthreads();
    tile_mix<D>(dv, pt_s, do_s, ty, tx);
    tile_mix<D>(dk, dst_s, q_s, ty, tx);
  }

  T* dk_out = static_cast<T*>(p.out0);
  T* dv_out = static_cast<T*>(p.out1);
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const int key = k0 + ty + i * C::kRowLanes;
    if (key >= p.tk) continue;
    const long long off = (((long long)b * p.tk + key) * p.heads + h) * D;
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) {
      store(dk_out + off + tx + j * kLanesX, dk[i][j]);
      store(dv_out + off + tx + j * kLanesX, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------- host

template <typename Kernel>
int launch(Kernel kernel, size_t smem_words, int threads, dim3 grid,
           const Params& p, void* stream) {
  const size_t smem = smem_words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T>
int fwd(const Params& p, int batch, int d, void* stream) {
  const dim3 grid(batch * p.heads, tiles(p.tq));
  if (d == 64)
    return launch(flash_fwd_kernel<T, 64>, fwd_smem_words<64>(),
                  Cfg<64>::kThreads, grid, p, stream);
  if (d == 128)
    return launch(flash_fwd_kernel<T, 128>, fwd_smem_words<128>(),
                  Cfg<128>::kThreads, grid, p, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_dq(const Params& p, int batch, int d, void* stream) {
  const dim3 grid(batch * p.heads, tiles(p.tq));
  if (d == 64)
    return launch(flash_bwd_dq_kernel<T, 64>, dq_smem_words<64>(),
                  Cfg<64>::kThreads, grid, p, stream);
  if (d == 128)
    return launch(flash_bwd_dq_kernel<T, 128>, dq_smem_words<128>(),
                  Cfg<128>::kThreads, grid, p, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_dkv(const Params& p, int batch, int d, void* stream) {
  const dim3 grid(batch * p.heads, tiles(p.tk));
  if (d == 64)
    return launch(flash_bwd_dkv_kernel<T, 64>, dkv_smem_words<64>(),
                  Cfg<64>::kThreads, grid, p, stream);
  if (d == 128)
    return launch(flash_bwd_dkv_kernel<T, 128>, dkv_smem_words<128>(),
                  Cfg<128>::kThreads, grid, p, stream);
  return (int)cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// Shared-memory bytes of one block: kind 0 forward, 1 dQ, 2 dK/dV.
size_t flash_smem_bytes(int kind, int d) {
  size_t w = 0;
  if (d == 64)
    w = kind == 0 ? fwd_smem_words<64>()
                  : kind == 1 ? dq_smem_words<64>() : dkv_smem_words<64>();
  else if (d == 128)
    w = kind == 0 ? fwd_smem_words<128>()
                  : kind == 1 ? dq_smem_words<128>() : dkv_smem_words<128>();
  return w * sizeof(float);
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
  return fwd<T>(p, batch, d, stream);

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
  return bwd_dq<T>(p, batch, d, stream);

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
  return bwd_dkv<T>(p, batch, d, stream);

int flash_bwd_dkv_f32(FLASH_DKV_ARGS) { FLASH_DKV_BODY(float) }
int flash_bwd_dkv_bf16(FLASH_DKV_ARGS) { FLASH_DKV_BODY(__nv_bfloat16) }

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
