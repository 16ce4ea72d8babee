// Training dropout's mask, drawn and applied in one pass, hand-written
// for Hopper (sm_90a).
//
// Computes the training branch of the JAX package's dropout op
// (paddle_tpu/layers/nn.py, dropout's fn):
//   key  = fold_in(PRNGKey(base_seed), uint32(counter))
//   keep = uniform_f32(key, x.shape) < f32(keep_prob)
//   out  = x * keep.astype(x.dtype)
// with jax.random's threefry-2x32 on its partitionable path: element i
// (row-major) draws the counter pair (i >> 32, i & 0xffffffff) under
// the key, and its 32 bits are the two output words xor-ed. There is no
// Pallas kernel behind it: on the TPU XLA fuses jax.random.bernoulli
// into the surrounding work. In plain torch the threefry is ~170 int64
// elementwise ops over 8-byte words (core/prng.py), which would cost
// hundreds of milliseconds a training step; here every word stays in a
// register.
//
// Bound: integer operations. An element moves 4 (bf16) or 8 (f32) bytes
// and takes 75 integer operations (72 for the cipher's 20 rounds and
// key injections, 3 to form the uniform's bits), so on an H100 the rate
// at which an SM issues them (128 a clock: 4 schedulers of one 32-lane
// instruction; integer adds also run on the FMA pipe), not the 3.35 TB/s
// of device memory, bounds it. Design: a
// grid-stride loop, each thread on one 16-byte vector (8 bf16 or 4 f32
// values) per iteration, neighbouring threads on neighbouring vectors,
// the ragged tail element by element; rotations as funnel shifts.
//
// The key is derived on the card: the counter is read from device
// memory, once per block, by one thread, so a captured CUDA graph's
// replays draw fresh masks as the counter advances, and no host value
// is read. A second entry, dropout_apply_keyed, takes the key's two
// words themselves from device memory instead (a key some other fold
// derived on the card: the pipelined encoder's per-layer, per-site
// keys), and draws the same mask the counter-keyed launch draws under
// that key. Block 0 also writes counter + 1 (the op's SeedOut) when
// asked, so the op needs no separate increment kernel. The backward
// pass is this kernel on the incoming gradient, under the same saved
// counter: d(x * m)/dx = g * m, the mask drawn again, none stored.
//
// Numbers: bit-equal to plain_dropout (ops/dropout.py) on the card. The
// uniform is formed exactly as jax forms it ((bits >> 9) | 0x3f800000
// as a float, minus 1, exact) and compared with the f32 keep
// probability. The output is x times 1.0f or 0.0f, never a select, so
// -x * 0 = -0.0 and inf * 0 = NaN as in x * mask; bf16 is widened
// exactly, multiplied in f32 and rounded to nearest even, as torch
// multiplies two bf16 tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

#define TF_ROUND(r)  \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;

// Threefry-2x32, 20 rounds, of (x0, x1) under the key (k0, k1); k2 is
// k0 ^ k1 ^ parity (core/prng.py:threefry2x32, in the same order).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t k2, uint32_t& x0,
                                         uint32_t& x1) {
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef TF_ROUND

struct Key {
  uint32_t k0, k1, k2;
};

// 1.0f where element i is kept, else 0.0f
__device__ __forceinline__ float keep_factor(const Key& k, long long i,
                                             float keep_prob) {
  uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry(k.k0, k.k1, k.k2, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float u = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return u < keep_prob ? 1.0f : 0.0f;
}

// Element storage: float, or a bfloat16's 16 bits (a plain integer, so
// 16-byte vectors are unions of trivial types).
struct F32 {
  using Raw = float;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};
struct BF16 {
  using Raw = unsigned short;
  // exact: a bfloat16 is the high half of the float with its bits
  static __device__ __forceinline__ float widen(unsigned short v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ unsigned short narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// out[i] = x[i] * keep(i) for i < n. VEC values make one 16-byte
// vector; vec is 0 when a pointer is not 16-byte aligned (every element
// then takes the tail loop).
template <typename E>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const typename E::Raw* __restrict__ x,
                   typename E::Raw* __restrict__ out, long long n,
                   uint32_t seed, const int* __restrict__ counter,
                   int* counter_out, const uint32_t* __restrict__ key_in,
                   float keep_prob, long long offset, int vec) {
  using Raw = typename E::Raw;
  constexpr int VEC = 16 / sizeof(Raw);
  __shared__ Key key;
  if (threadIdx.x == 0) {
    uint32_t a, b;
    if (key_in != nullptr) {
      a = key_in[0];
      b = key_in[1];
    } else {
      // fold_in(PRNGKey(seed), counter): threefry of (0, counter) under
      // the key words (0, seed)
      const int c = *counter;
      a = 0u;
      b = static_cast<uint32_t>(c);
      threefry(0u, seed, kParity ^ seed, a, b);
      if (blockIdx.x == 0 && counter_out != nullptr) *counter_out = c + 1;
    }
    key.k0 = a;
    key.k1 = b;
    key.k2 = a ^ b ^ kParity;
  }
  __syncthreads();
  const Key k = key;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_vec = vec ? n / VEC : 0;
  for (long long v = tid; v < n_vec; v += stride) {
    union {
      uint4 u;
      Raw e[VEC];
    } in, res;
    in.u = reinterpret_cast<const uint4*>(x)[v];
    const long long base = v * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      res.e[j] = E::narrow(__fmul_rn(E::widen(in.e[j]),
                                     keep_factor(k, offset + base + j,
                                                 keep_prob)));
    reinterpret_cast<uint4*>(out)[v] = res.u;
  }
  for (long long i = n_vec * VEC + tid; i < n; i += stride)
    out[i] = E::narrow(
        __fmul_rn(E::widen(x[i]), keep_factor(k, offset + i, keep_prob)));
}

template <typename E>
cudaError_t launch(const void* x, void* out, long long n, uint32_t seed,
                   const int* counter, int* counter_out,
                   const uint32_t* key_in, float keep_prob,
                   long long offset, int vec, int sms, cudaStream_t stream) {
  using Raw = typename E::Raw;
  constexpr int VEC = 16 / sizeof(Raw);
  const long long items = vec ? (n + VEC - 1) / VEC : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  // enough blocks to fill the card several times over; a grid-stride
  // loop covers the rest
  const long long cap = static_cast<long long>(sms) * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  dropout_kernel<E><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Raw*>(x), static_cast<Raw*>(out), n, seed, counter,
      counter_out, key_in, keep_prob, offset, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = x * mask for n elements of float (bf16 = 0) or bfloat16
// (bf16 = 1); counter is one int32 on the card, counter_out one int32
// that receives counter + 1, or null. Element i draws the mask's
// element offset + i: a rank holding a block of a tensor draws its
// block of the whole tensor's mask. Returns the launch's CUDA error
// code (0 on success).
int dropout_apply(int bf16, const void* x, void* out, long long n,
                  unsigned int seed, const int* counter, int* counter_out,
                  float keep_prob, long long offset, int vec,
                  void* stream) {
  if (n < 0 || offset < 0 || counter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<BF16>(x, out, n, seed, counter, counter_out, nullptr,
                            keep_prob, offset, vec, sms, s)
             : launch<F32>(x, out, n, seed, counter, counter_out, nullptr,
                           keep_prob, offset, vec, sms, s);
  return static_cast<int>(err);
}

// The same mask under a key given as its two 32-bit words on the card
// (key[0], key[1]): the mask of jax.random.bernoulli(key, keep_prob,
// shape), elements offset .. offset + n - 1.
int dropout_apply_keyed(int bf16, const void* x, void* out, long long n,
                        const unsigned int* key, float keep_prob,
                        long long offset, int vec, void* stream) {
  if (n < 0 || offset < 0 || key == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<BF16>(x, out, n, 0u, nullptr, nullptr, key, keep_prob,
                            offset, vec, sms, s)
             : launch<F32>(x, out, n, 0u, nullptr, nullptr, key, keep_prob,
                           offset, vec, sms, s);
  return static_cast<int>(err);
}

// The card's SM count and SM clock (kHz), from cudaDeviceProp's
// attributes: the integer rate the kernel's bound takes is SMs x 128
// lanes x clock.
int dropout_device_rates(int dev, int* sms, int* clock_khz) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev);
  return static_cast<int>(err);
}

const char* dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
