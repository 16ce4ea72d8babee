// The optimizers' dense update over one flat parameter group
// (fuse_optimizer_state), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/ops/fused_optimizer.py
// (fused_flat_update, kernel body _kernel), which applies whatever
// update function (_make_update_fn) the optimizer hands it. Here one
// launch per group op applies one of the eleven update functions of
// paddle_tpu/optimizer.py — SGD, Adagrad, Adam, Momentum (plain and
// Nesterov), Adamax, DecayedAdagrad, Adadelta, RMSProp (plain and
// centered), Ftrl (lr_power -0.5 and any other), ProximalGD and
// ProximalAdagrad — to the flat [N] parameter buffer, its flat gradient
// and up to three flat moments (float32, or bfloat16 under
// bf16_moments).
//
// Bound: bytes. Each element is read once and written once and takes a
// few dozen flops, far below the card's ~20 flops per byte, so the
// least time is the bytes over 3.35 TB/s (Momentum with a bf16
// velocity: 16 bytes an element). Design: a grid-stride loop over the
// flat buffers, one element per thread and iteration, neighbouring
// threads on neighbouring addresses (coalesced); the ragged tail is the
// loop's bound, so nothing is padded; p and the moments are updated in
// place, each element read and written by one thread. The kind and its
// branch are template parameters, so each instantiation carries only
// its own arithmetic. The TPU kernel's [block_rows, 128] tiles were for
// VMEM and are not carried over.
//
// Numbers: bit-equal to plain_flat_update (ops/fused_optimizer.py) on
// the card. Each step uses the _rn intrinsics in the plain version's op
// order, so nvcc cannot contract a*b+c into an FMA; the constants come
// in as Python computes them (in double, then rounded to float, as
// torch's scalar operands are); bf16 moments are widened exactly and
// stored with round-to-nearest-even, as Tensor.to(torch.bfloat16); Ftrl
// takes sqrt/pow of its widened moment, the exponent of a bf16 moment
// rounded to bf16 (consts[4]), as the JAX package's jitted step does. The
// shared scalars (Adam's beta powers, Adamax's beta1 power) are read in
// every block at their step-start value; the owning group's advance
// goes to separate outputs, written by one thread.
//
// The gate (the JAX package's mask_update_op, optimizer.py:35: amp's
// overflow skip, GradientAccumulation's k-th step): an optional device
// flag, a bool the caller's step computed on the card. The JAX package
// selects between each output and its input with where(); here the
// update is in place, so the input is gone once written, and the flag
// is read before any write instead: each block reads it once, into
// shared memory, before its grid-stride loop, and a false flag writes
// nothing to p or the moments (a skipped step reads one byte). The
// owning group's shared_out, which the wrapper allocates fresh each
// step, then receives the step-start scalars. Gated and ungated
// launches are separate instantiations (template GATED): the host
// checks the flag pointer for null once, and an ungated launch runs
// the kernel as it was before the gate existed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the order of ops/fused_optimizer.py's KINDS
enum Kind {
  kSgd = 0, kAdagrad, kAdam, kMomentum, kAdamax, kDecayedAdagrad,
  kAdadelta, kRmsprop, kFtrl, kProximalGd, kProximalAdagrad, kNumKinds
};
// moments and shared scalars of each kind
constexpr int kMoments[kNumKinds] = {0, 1, 2, 1, 2, 1, 2, 3, 2, 0, 1};
constexpr int kShared[kNumKinds] = {0, 0, 2, 0, 1, 0, 0, 0, 0, 0, 0};
constexpr int kMaxMoments = 4, kMaxShared = 2, kMaxConsts = 8;

struct Params {
  float* p;
  const float* g;
  const float* lr;
  void* m[kMaxMoments];
  const float* shared[kMaxShared];
  float* shared_out[kMaxShared];  // null unless the group owns them
  long long n;
  float c[kMaxConsts];  // ops/fused_optimizer.py:kernel_consts
  const bool* apply;    // the gate; null for an ungated launch
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

// torch.sign: (0 < x) - (x < 0)
__device__ __forceinline__ float sign(float x) {
  return (float)((0.f < x) - (x < 0.f));
}

// torch.pow(x, e) of a float tensor on the card: its special cases of
// the exponent, else powf (e = 0.5 is Ftrl's sqrt branch, not a power)
__device__ __forceinline__ float pow_t(float x, float e) {
  if (e == 0.f) return 1.f;
  if (e == 1.f) return x;
  if (e == 2.f) return __fmul_rn(x, x);
  if (e == 3.f) return __fmul_rn(__fmul_rn(x, x), x);
  return powf(x, e);
}

// sign(prox) * max(|prox| - lr*l1, 0) / (1 + lr*l2)
__device__ __forceinline__ float prox_step(float prox, float lr, float l1,
                                           float l2) {
  const float shrunk = fmaxf(__fsub_rn(fabsf(prox), __fmul_rn(lr, l1)), 0.f);
  return __fdiv_rn(__fmul_rn(sign(prox), shrunk),
                   __fadd_rn(1.f, __fmul_rn(lr, l2)));
}

template <int KIND, int VARIANT, typename MT, bool GATED>
__global__ void fused_update_kernel(Params a) {
  if constexpr (GATED) {
    __shared__ bool apply;
    if (threadIdx.x == 0) apply = *a.apply;
    __syncthreads();
    if (!apply) {
      // skipped: the owner's outputs get the step-start scalars
      if (a.shared_out[0] != nullptr && blockIdx.x == 0 &&
          threadIdx.x == 0) {
        a.shared_out[0][0] = a.shared[0][0];
        if (KIND == kAdam) a.shared_out[1][0] = a.shared[1][0];
      }
      return;
    }
  }
  MT* m0 = static_cast<MT*>(a.m[0]);
  MT* m1 = static_cast<MT*>(a.m[1]);
  MT* m2 = static_cast<MT*>(a.m[2]);
  const float* c = a.c;
  // the scalar prelude, in the plain version's op order: lr * scale,
  // and the bias corrections of the shared powers
  const float lr = __fmul_rn(a.lr[0], c[0]);
  float lr_t = 0.f;
  if (KIND == kAdam) {
    const float b1p = a.shared[0][0], b2p = a.shared[1][0];
    lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                     __fsub_rn(1.f, b1p));
    if (a.shared_out[0] != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      a.shared_out[0][0] = __fmul_rn(b1p, c[1]);
      a.shared_out[1][0] = __fmul_rn(b2p, c[3]);
    }
  } else if (KIND == kAdamax) {
    const float b1p = a.shared[0][0];
    lr_t = __fdiv_rn(lr, __fsub_rn(1.f, b1p));
    if (a.shared_out[0] != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      a.shared_out[0][0] = __fmul_rn(b1p, c[1]);
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    const float p = a.p[i], g = a.g[i];
    float pn;
    if (KIND == kSgd) {
      // p - lr * g
      pn = __fsub_rn(p, __fmul_rn(lr, g));
    } else if (KIND == kAdagrad) {
      // m + g*g;  p - lr*g / (sqrt(m) + eps)    (c: scale, eps)
      const float m = __fadd_rn(load(m0, i), __fmul_rn(g, g));
      pn = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g),
                                  __fadd_rn(__fsqrt_rn(m), c[1])));
      store(m0, i, m);
    } else if (KIND == kAdam) {
      // b1*m1 + (1-b1)*g;  b2*m2 + (1-b2)*g*g;
      // p - lr_t*m1 / (sqrt(m2) + eps)    (c: scale, b1, 1-b1, b2, 1-b2,
      // eps)
      const float n1 = __fadd_rn(__fmul_rn(c[1], load(m0, i)),
                                 __fmul_rn(c[2], g));
      const float n2 = __fadd_rn(__fmul_rn(c[3], load(m1, i)),
                                 __fmul_rn(__fmul_rn(c[4], g), g));
      pn = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, n1),
                                  __fadd_rn(__fsqrt_rn(n2), c[5])));
      store(m0, i, n1);
      store(m1, i, n2);
    } else if (KIND == kMomentum) {
      // v = mu*v + g;  p - (g + mu*v)*lr (Nesterov) or p - lr*v
      // (c: scale, mu)
      const float v = __fadd_rn(__fmul_rn(c[1], load(m0, i)), g);
      pn = VARIANT ? __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(c[1], v)),
                                            lr))
                   : __fsub_rn(p, __fmul_rn(lr, v));
      store(m0, i, v);
    } else if (KIND == kAdamax) {
      // b1*m + (1-b1)*g;  max(b2*inf, |g| + eps);  p - lr_t*m / inf
      // (c: scale, b1, 1-b1, b2, eps)
      const float m = __fadd_rn(__fmul_rn(c[1], load(m0, i)),
                                __fmul_rn(c[2], g));
      const float inf = fmaxf(__fmul_rn(c[3], load(m1, i)),
                              __fadd_rn(fabsf(g), c[4]));
      pn = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, m), inf));
      store(m0, i, m);
      store(m1, i, inf);
    } else if (KIND == kDecayedAdagrad) {
      // decay*m + (1-decay)*g*g;  p - lr*g / (sqrt(m) + eps)
      // (c: scale, decay, 1-decay, eps)
      const float m = __fadd_rn(__fmul_rn(c[1], load(m0, i)),
                                __fmul_rn(__fmul_rn(c[2], g), g));
      pn = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g),
                                  __fadd_rn(__fsqrt_rn(m), c[3])));
      store(m0, i, m);
    } else if (KIND == kAdadelta) {
      // asg = rho*asg + (1-rho)*g*g;
      // u = -sqrt((asu + eps) / (asg + eps)) * g;
      // asu = rho*asu + (1-rho)*u*u;  p + lr*u   (c: scale, rho, 1-rho,
      // eps)
      const float asu = load(m1, i);
      const float asg = __fadd_rn(__fmul_rn(c[1], load(m0, i)),
                                  __fmul_rn(__fmul_rn(c[2], g), g));
      const float u = __fmul_rn(
          -__fsqrt_rn(__fdiv_rn(__fadd_rn(asu, c[3]), __fadd_rn(asg, c[3]))),
          g);
      const float asu_n = __fadd_rn(__fmul_rn(c[1], asu),
                                    __fmul_rn(__fmul_rn(c[2], u), u));
      pn = __fadd_rn(p, __fmul_rn(lr, u));
      store(m0, i, asg);
      store(m1, i, asu_n);
    } else if (KIND == kRmsprop) {
      // ms = rho*ms + (1-rho)*g*g;  centered: mg = rho*mg + (1-rho)*g,
      // d = sqrt(ms - mg*mg + eps), else mg unchanged, d = sqrt(ms + eps);
      // mom = mu*mom + lr*g / d;  p - mom
      // (c: scale, rho, 1-rho, eps, mu)
      const float ms = __fadd_rn(__fmul_rn(c[1], load(m1, i)),
                                 __fmul_rn(__fmul_rn(c[2], g), g));
      float d;
      if (VARIANT) {
        const float mg = __fadd_rn(__fmul_rn(c[1], load(m2, i)),
                                   __fmul_rn(c[2], g));
        d = __fsqrt_rn(__fadd_rn(__fsub_rn(ms, __fmul_rn(mg, mg)), c[3]));
        store(m2, i, mg);
      } else {
        // mg is neither read nor written: in place, it stays as it was
        d = __fsqrt_rn(__fadd_rn(ms, c[3]));
      }
      const float mom = __fadd_rn(__fmul_rn(c[4], load(m0, i)),
                                  __fdiv_rn(__fmul_rn(lr, g), d));
      pn = __fsub_rn(p, mom);
      store(m0, i, mom);
      store(m1, i, ms);
    } else if (KIND == kFtrl) {
      // sq' = sq + g*g;  sigma = (sq'^e - sq^e) / lr, e = -lr_power
      // (sqrt when lr_power = -0.5; sq widened, its exponent rounded to
      // bf16 when sq is stored in bf16);
      // lin' = lin + g - sigma*p;  x = l1*sign(lin') - lin';
      // y = sq'^e / lr + 2*l2;  p = |lin'| > l1 ? x / y : 0
      // (c: scale, l1, 2*l2, e, e rounded to bf16)
      const float sq = load(m0, i);
      const float sq_n = __fadd_rn(sq, __fmul_rn(g, g));
      const float pw_n = VARIANT ? __fsqrt_rn(sq_n) : pow_t(sq_n, c[3]);
      const float pw = VARIANT ? __fsqrt_rn(sq)
                               : pow_t(sq, sizeof(MT) == 2 ? c[4] : c[3]);
      const float sigma = __fdiv_rn(__fsub_rn(pw_n, pw), lr);
      const float lin = __fsub_rn(__fadd_rn(load(m1, i), g),
                                  __fmul_rn(sigma, p));
      const float x = __fsub_rn(__fmul_rn(c[1], sign(lin)), lin);
      const float y = __fadd_rn(__fdiv_rn(pw_n, lr), c[2]);
      pn = fabsf(lin) > c[1] ? __fdiv_rn(x, y) : 0.f;
      store(m0, i, sq_n);
      store(m1, i, lin);
    } else if (KIND == kProximalGd) {
      // prox = p - lr*g, then the proximal step   (c: scale, l1, l2)
      pn = prox_step(__fsub_rn(p, __fmul_rn(lr, g)), lr, c[1], c[2]);
    } else {  // kProximalAdagrad
      // m + g*g;  eff = lr / sqrt(m + 1e-12);  prox = p - eff*g, then
      // the proximal step at eff   (c: scale, l1, l2, 1e-12)
      const float m = __fadd_rn(load(m0, i), __fmul_rn(g, g));
      const float eff = __fdiv_rn(lr, __fsqrt_rn(__fadd_rn(m, c[3])));
      pn = prox_step(__fsub_rn(p, __fmul_rn(eff, g)), eff, c[1], c[2]);
      store(m0, i, m);
    }
    a.p[i] = pn;
  }
}

template <int KIND, int VARIANT, typename MT>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  constexpr int kThreads = 256;
  // enough blocks to fill 132 SMs several times over; the grid-stride
  // loop covers the rest. A group of zero elements still launches one
  // block, which writes the owner's advanced scalars.
  long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  if (blocks < 1) blocks = 1;
  if (a.apply != nullptr)
    fused_update_kernel<KIND, VARIANT, MT, true>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  else
    fused_update_kernel<KIND, VARIANT, MT, false>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, int VARIANT>
cudaError_t launch_moments(const Params& a, int bf16, cudaStream_t s) {
  if (kMoments[KIND] == 0 || !bf16) return launch<KIND, VARIANT, float>(a, s);
  return launch<KIND, VARIANT, __nv_bfloat16>(a, s);
}

template <int KIND>
cudaError_t launch_variant(const Params& a, int variant, int bf16,
                           cudaStream_t s) {
  return variant ? launch_moments<KIND, 1>(a, bf16, s)
                 : launch_moments<KIND, 0>(a, bf16, s);
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error code (0 on success); a kind, moment,
// shared-scalar or constant count the kind does not take returns
// cudaErrorInvalidValue. moments[i] point at float or __nv_bfloat16 by
// moment_bf16; shared_out is all null unless the group owns the
// shared scalars' advance (n_shared_out = 0). consts come from
// ops/fused_optimizer.py:kernel_consts. apply is the gate's device flag,
// null for an ungated launch.
int fused_flat_update(int kind, int variant, int moment_bf16, float* p,
                      const float* g, const float* lr,
                      void* const* moments, int n_moments,
                      const float* const* shared, float* const* shared_out,
                      int n_shared_out, long long n, const float* consts,
                      int n_consts, const bool* apply, void* stream) {
  if (kind < 0 || kind >= kNumKinds || n_moments != kMoments[kind] ||
      (n_shared_out != 0 && n_shared_out != kShared[kind]) ||
      n_consts < 1 || n_consts > kMaxConsts)
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{};
  a.p = p;
  a.g = g;
  a.lr = lr;
  for (int i = 0; i < n_moments; ++i) a.m[i] = moments[i];
  for (int i = 0; i < kShared[kind]; ++i) {
    a.shared[i] = shared[i];
    a.shared_out[i] = n_shared_out ? shared_out[i] : nullptr;
  }
  a.n = n;
  for (int i = 0; i < n_consts; ++i) a.c[i] = consts[i];
  a.apply = apply;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kSgd: err = launch_variant<kSgd>(a, 0, 0, s); break;
    case kAdagrad: err = launch_variant<kAdagrad>(a, 0, moment_bf16, s); break;
    case kAdam: err = launch_variant<kAdam>(a, 0, moment_bf16, s); break;
    case kMomentum:
      err = launch_variant<kMomentum>(a, variant, moment_bf16, s);
      break;
    case kAdamax: err = launch_variant<kAdamax>(a, 0, moment_bf16, s); break;
    case kDecayedAdagrad:
      err = launch_variant<kDecayedAdagrad>(a, 0, moment_bf16, s);
      break;
    case kAdadelta:
      err = launch_variant<kAdadelta>(a, 0, moment_bf16, s);
      break;
    case kRmsprop:
      err = launch_variant<kRmsprop>(a, variant, moment_bf16, s);
      break;
    case kFtrl: err = launch_variant<kFtrl>(a, variant, moment_bf16, s); break;
    case kProximalGd: err = launch_variant<kProximalGd>(a, 0, 0, s); break;
    default:
      err = launch_variant<kProximalAdagrad>(a, 0, moment_bf16, s);
      break;
  }
  return static_cast<int>(err);
}

const char* fused_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
