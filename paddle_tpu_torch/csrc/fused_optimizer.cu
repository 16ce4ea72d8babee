// The optimizers' dense update over one flat parameter group
// (fuse_optimizer_state), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/ops/fused_optimizer.py
// (fused_flat_update, kernel body _kernel): one launch per group op
// applies SGD, Adagrad or Adam to the flat [N] parameter buffer, its
// flat gradient and its flat moments (float32, or bfloat16 under
// bf16_moments).
//
// Bound: bytes. Each element is read once and written once and takes a
// few dozen flops, far below the card's ~20 flops per byte, so the
// least time is the bytes over 3.35 TB/s (Adam with f32 moments: 16
// bytes read, 12 written per element). Design: a grid-stride loop over
// the flat buffers, one element per thread and iteration, neighbouring
// threads on neighbouring addresses (coalesced); the ragged tail is the
// loop's bound, so nothing is padded; p and the moments are updated in
// place, each element read and written by one thread. The TPU kernel's
// [block_rows, 128] tiles were for VMEM and are not carried over.
//
// Numbers: bit-equal to plain_flat_update (ops/fused_optimizer.py) on
// the card. Each step uses the _rn intrinsics in the plain version's op
// order, so nvcc cannot contract a*b+c into an FMA; the constants come
// in as Python computes them (in double, then rounded to float, as
// torch's scalar operands are); bf16 moments are widened exactly and
// stored with round-to-nearest-even, as Tensor.to(torch.bfloat16).
// Adam's shared beta powers are read in every block at their
// step-start value; the owning group's advance goes to separate outputs
// (b1p_out, b2p_out), written by one thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Kind { kSgd = 0, kAdagrad = 1, kAdam = 2 };

struct Params {
  float* p;
  const float* g;
  const float* lr;
  void* m1;
  void* m2;
  const float* b1p;
  const float* b2p;
  float* b1p_out;
  float* b2p_out;
  long long n;
  float scale, b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ float load(const float* m, long long i) {
  return m[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* m, long long i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ void store(float* m, long long i, float v) {
  m[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* m, long long i,
                                      float v) {
  m[i] = __float2bfloat16_rn(v);
}

template <int KIND, typename MT>
__global__ void fused_update_kernel(Params a) {
  MT* m1 = static_cast<MT*>(a.m1);
  MT* m2 = static_cast<MT*>(a.m2);
  // the scalar prelude, in the plain version's op order
  const float lr = __fmul_rn(a.lr[0], a.scale);
  float lr_t = 0.f;
  if (KIND == kAdam) {
    const float b1p = a.b1p[0], b2p = a.b2p[0];
    lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                     __fsub_rn(1.f, b1p));
    if (a.b1p_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      a.b1p_out[0] = __fmul_rn(b1p, a.b1);
      a.b2p_out[0] = __fmul_rn(b2p, a.b2);
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    const float p = a.p[i], g = a.g[i];
    if (KIND == kSgd) {
      // p - (lr * scale) * g
      a.p[i] = __fsub_rn(p, __fmul_rn(lr, g));
    } else if (KIND == kAdagrad) {
      // m + g * g;  p - (lr * scale) * g / (sqrt(m) + eps)
      const float m = __fadd_rn(load(m1, i), __fmul_rn(g, g));
      a.p[i] = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g),
                                      __fadd_rn(__fsqrt_rn(m), a.eps)));
      store(m1, i, m);
    } else {
      // b1 * m1 + (1 - b1) * g;  b2 * m2 + (1 - b2) * g * g;
      // p - lr_t * m1 / (sqrt(m2) + eps)
      const float n1 = __fadd_rn(__fmul_rn(a.b1, load(m1, i)),
                                 __fmul_rn(a.c1, g));
      const float n2 = __fadd_rn(__fmul_rn(a.b2, load(m2, i)),
                                 __fmul_rn(__fmul_rn(a.c2, g), g));
      a.p[i] = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, n1),
                                      __fadd_rn(__fsqrt_rn(n2), a.eps)));
      store(m1, i, n1);
      store(m2, i, n2);
    }
  }
}

template <int KIND, typename MT>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  constexpr int kThreads = 256;
  // enough blocks to fill 132 SMs several times over; the grid-stride
  // loop covers the rest. A group of zero elements still launches one
  // block, which writes the owner's advanced scalars.
  long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  if (blocks < 1) blocks = 1;
  fused_update_kernel<KIND, MT><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error code (0 on success). m1/m2 point at
// float or __nv_bfloat16 by moment_bf16; unused pointers may be null;
// b1p_out/b2p_out are null unless the group owns the beta-pow advance.
int fused_flat_update(int kind, int moment_bf16, float* p, const float* g,
                      const float* lr, void* m1, void* m2, const float* b1p,
                      const float* b2p, float* b1p_out, float* b2p_out,
                      long long n, float scale, float b1, float c1, float b2,
                      float c2, float eps, void* stream) {
  Params a{p, g, lr, m1, m2, b1p, b2p, b1p_out, b2p_out, n,
           scale, b1, c1, b2, c2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == kSgd) {
    err = launch<kSgd, float>(a, s);
  } else if (kind == kAdagrad) {
    err = moment_bf16 ? launch<kAdagrad, __nv_bfloat16>(a, s)
                      : launch<kAdagrad, float>(a, s);
  } else if (kind == kAdam) {
    err = moment_bf16 ? launch<kAdam, __nv_bfloat16>(a, s)
                      : launch<kAdam, float>(a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* fused_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
