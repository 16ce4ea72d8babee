// Paged window attention for Hopper (sm_90a), with a plain C interface
// for ctypes (paddle_tpu_torch/ops/paged_attention.py binds and
// launches it; paddle_tpu_torch/ops/_cuda.py builds it with nvcc).
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
// Sums, max and softmax are kept in f32 whatever the storage type.
//
// Bound: memory bytes. Each valid K/V row is read once per head, plus q
// and out, at ~1-2 flops per byte — far below the ~20 (f32) or ~295
// (bf16) flops per byte at which an H100 stops being limited by its
// 3.35 TB/s of device memory; int8 pools halve or quarter the bytes of
// a row. The design therefore reads each key row once per query tile
// and never writes the gathered window back: one thread block per
// (head, sequence, tile of up to 64 query rows) walks the block table
// itself (the TPU grid's sequential page axis becomes a loop inside the
// block), stages a tile of 64 key rows of K and V in shared memory,
// dequantized to f32, and folds it into a flash-style running max / sum
// / accumulator per query row. The walk stops at the last position any
// query row of the tile may see, so unreached and padding pages cost no
// bytes. Shared memory depends on the tile, not on T, so any window up
// to max_context fits. A simple first design: it is not yet
// double-buffered and uses no tensor cores (see PERF.md for its time
// beside the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
           int max_blocks, void* stream) {
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
          n_heads, dk, dv, n_blocks, block_size, max_blocks,
          sqrtf((float)dk));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one launch over a window of n_q query rows needs
// (the wrapper refuses shapes past the card's 227 KB per block).
size_t paged_window_attention_smem_bytes(int n_q, int dk, int dv) {
  return smem_words(n_q, dk, dv) * sizeof(float);
}

// Each launches on `stream` of the calling thread's current device (the
// wrapper makes it the tensors' device) and returns cudaGetLastError()
// after the launch (0 = launched).
int paged_window_attention_f32(const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* cached_lens, void* out, int batch,
                               int n_q, int n_heads, int dk, int dv,
                               int n_blocks, int block_size, int max_blocks,
                               void* stream) {
  return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, tables,
                              cached_lens, out, batch, n_q, n_heads, dk, dv,
                              n_blocks, block_size, max_blocks, stream);
}

int paged_window_attention_bf16(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* cached_lens, void* out, int batch,
                                int n_q, int n_heads, int dk, int dv,
                                int n_blocks, int block_size, int max_blocks,
                                void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, tables, cached_lens, out, batch,
      n_q, n_heads, dk, dv, n_blocks, block_size, max_blocks, stream);
}

// int8 pools (codes) with [n_blocks, block_size] f32 scale pools; q and
// out f32 or bf16.
int paged_window_attention_q8_f32(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* tables,
                                  const void* cached_lens, void* out,
                                  int batch, int n_q, int n_heads, int dk,
                                  int dv, int n_blocks, int block_size,
                                  int max_blocks, void* stream) {
  return launch<float, signed char>(q, k_pool, v_pool, k_scale, v_scale,
                                    tables, cached_lens, out, batch, n_q,
                                    n_heads, dk, dv, n_blocks, block_size,
                                    max_blocks, stream);
}

int paged_window_attention_q8_bf16(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* cached_lens, void* out,
                                   int batch, int n_q, int n_heads, int dk,
                                   int dv, int n_blocks, int block_size,
                                   int max_blocks, void* stream) {
  return launch<__nv_bfloat16, signed char>(
      q, k_pool, v_pool, k_scale, v_scale, tables, cached_lens, out, batch,
      n_q, n_heads, dk, dv, n_blocks, block_size, max_blocks, stream);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
