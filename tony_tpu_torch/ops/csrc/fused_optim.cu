// Fused bucket optimizer update, hand-written for Hopper.
//
// Replaces the TPU kernel `_update_kernel` (tony_tpu/ops/fused_optim.py:123,
// launched by `fused_bucket_update` :167 with its math in `_rule_math`
// :85). One launch updates one gradient bucket: flat 1-D buffers g and p
// (float32 or bfloat16), f32 moment slots, and the f32 scalar vector
// scal = [-lr, bc1, bc2, 0] read from device memory. Rules:
//   adamw     mu = (1-b1)*g + b1*mu;  nu = (1-b2)*(g*g) + b2*nu;
//             u = (mu/bc1) / (sqrt(nu/bc2) + eps)
//   sgd       tr = g + momentum*tr;   u = tr
//   adafactor nu = (1-b2)*(g*g) + b2*nu;  u = g / (sqrt(nu) + eps)
// then u += wd*p when wd != 0, and p = p + (-lr)*u.
//
// Bound: memory. AdamW over f32 reads g, p, mu, nu and writes p, mu, nu:
// 28 bytes per element against ~12 flops, far below the H100's ridge, so
// the floor is 28*n bytes over 3.35 TB/s (bf16 p/g: 20 bytes).
//
// Design (simple and right first; one launch for all buckets, folding the
// mean scale and the grad norm in, and CUDA graphs come later):
//  * Grid-stride loop over 16-byte vectors: a thread loads 16 bytes of g
//    and of p (4 f32 or 8 bf16 elements) and the matching float4s of each
//    slot, so every operand is read once and written once with 16-byte
//    accesses, neighbouring threads on neighbouring addresses. The ragged
//    edge (n not a multiple of the vector) is a masked scalar tail: no
//    padding copies.
//  * Every product, sum, quotient and root is written with its
//    round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
//    __fsqrt_rn), so nvcc contracts nothing into an FMA and the kernel
//    gives the bits of the plain PyTorch version, whose ops each round.
//    bf16 p is written back with round-to-nearest-even.
//  * The rule is a template parameter; hyperparameters arrive rounded to
//    f32 (1-b1 and 1-b2 computed in double on the host, then rounded, as
//    JAX's weak-typed constants), -lr and the bias corrections come from
//    device memory, so an lr schedule rebuilds and synchronises nothing.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): fused_optim_launch returns cudaGetLastError() after the
// launch; the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ADAMW = 0, SGD = 1, ADAFACTOR = 2;
constexpr int THREADS = 256;

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd, momentum;
  int has_wd;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One element of the rule, in f32, in the plain version's order.
template <int RULE>
__device__ __forceinline__ float update(float g, float p, float& s0,
                                        float& s1, const Hyper& h,
                                        float neg_lr, float bc1, float bc2) {
  float u;
  if (RULE == ADAMW) {
    s0 = __fadd_rn(__fmul_rn(h.omb1, g), __fmul_rn(h.b1, s0));
    s1 = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g, g)), __fmul_rn(h.b2, s1));
    u = __fdiv_rn(__fdiv_rn(s0, bc1),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(s1, bc2)), h.eps));
  } else if (RULE == SGD) {
    s0 = __fadd_rn(g, __fmul_rn(h.momentum, s0));
    u = s0;
  } else {
    s0 = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g, g)), __fmul_rn(h.b2, s0));
    u = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(s0), h.eps));
  }
  if (h.has_wd) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  return __fadd_rn(p, __fmul_rn(neg_lr, u));
}

template <int RULE, typename T>
__global__ void __launch_bounds__(THREADS)
fused_bucket_update_kernel(const T* __restrict__ g, T* __restrict__ p,
                           float* __restrict__ s0, float* __restrict__ s1,
                           const float* __restrict__ scal, int64_t n,
                           Hyper h) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte access
  constexpr int NS = RULE == ADAMW ? 2 : 1;
  const float neg_lr = scal[0], bc1 = scal[1], bc2 = scal[2];
  const int64_t nvec = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t v = tid; v < nvec; v += stride) {
    const int64_t e = v * VEC;
    alignas(16) T gv[VEC];
    alignas(16) T pv[VEC];
    alignas(16) float a[VEC];
    alignas(16) float b[VEC];
    *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(g + e);
    *reinterpret_cast<uint4*>(pv) = *reinterpret_cast<const uint4*>(p + e);
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      *reinterpret_cast<float4*>(a + j) =
          *reinterpret_cast<const float4*>(s0 + e + j);
      if (NS == 2)
        *reinterpret_cast<float4*>(b + j) =
            *reinterpret_cast<const float4*>(s1 + e + j);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      pv[j] = from_f<T>(update<RULE>(to_f(gv[j]), to_f(pv[j]), a[j], b[j], h,
                                     neg_lr, bc1, bc2));
    *reinterpret_cast<uint4*>(p + e) = *reinterpret_cast<const uint4*>(pv);
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      *reinterpret_cast<float4*>(s0 + e + j) =
          *reinterpret_cast<const float4*>(a + j);
      if (NS == 2)
        *reinterpret_cast<float4*>(s1 + e + j) =
            *reinterpret_cast<const float4*>(b + j);
    }
  }
  // The ragged tail, one element per thread.
  const int64_t e = nvec * VEC + tid;
  if (e < n) {
    float a = s0[e], b = NS == 2 ? s1[e] : 0.0f;
    p[e] = from_f<T>(update<RULE>(to_f(g[e]), to_f(p[e]), a, b, h, neg_lr,
                                  bc1, bc2));
    s0[e] = a;
    if (NS == 2) s1[e] = b;
  }
}

int num_sms() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

template <int RULE, typename T>
int launch(const void* g, void* p, float* s0, float* s1, const float* scal,
           int64_t n, const Hyper& h, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  // One vector per thread up to 16 blocks per SM; the tail (< VEC
  // elements) fits in block 0.
  int64_t blocks = (n / VEC + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(num_sms()) * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  fused_bucket_update_kernel<RULE, T><<<static_cast<int>(blocks), THREADS,
                                        0, st>>>(
      static_cast<const T*>(g), static_cast<T*>(p), s0, s1, scal, n, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rule(int rule, const void* g, void* p, float* s0, float* s1,
                const float* scal, int64_t n, const Hyper& h,
                cudaStream_t st) {
  if (rule == ADAMW) return launch<ADAMW, T>(g, p, s0, s1, scal, n, h, st);
  if (rule == SGD) return launch<SGD, T>(g, p, s0, s1, scal, n, h, st);
  if (rule == ADAFACTOR)
    return launch<ADAFACTOR, T>(g, p, s0, s1, scal, n, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// rule: 0 = adamw (slots mu, nu), 1 = sgd (trace), 2 = adafactor (nu);
// dtype of g and p: 0 = float32, 1 = bfloat16. Slots and scal are f32;
// s1 is null for the one-slot rules. Every buffer is contiguous,
// 16-byte aligned and n elements long (the wrapper checks).
int fused_optim_launch(int rule, int dtype, const void* g, void* p, void* s0,
                       void* s1, const void* scal, int64_t n, float b1,
                       float b2, float omb1, float omb2, float eps, float wd,
                       float momentum, int has_wd, void* stream) {
  const Hyper h{b1, b2, omb1, omb2, eps, wd, momentum, has_wd};
  float* f0 = static_cast<float*>(s0);
  float* f1 = static_cast<float*>(s1);
  const float* sc = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_rule<float>(rule, g, p, f0, f1, sc, n, h, st);
  if (dtype == 1)
    return launch_rule<__nv_bfloat16>(rule, g, p, f0, f1, sc, n, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_optim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
