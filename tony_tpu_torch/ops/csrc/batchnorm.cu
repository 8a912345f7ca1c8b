// Fused train-mode BatchNorm(+residual add)(+ReLU), hand-written for Hopper.
//
// Replaces the TPU kernels of tony_tpu/ops/batchnorm.py, over the [M, C]
// view of an NHWC activation (M = N*H*W rows, channels contiguous):
//   row 10  `_stats_kernel` :58 (launched by `_bn_sums` :76)
//           -> bn_reduce_kernel<STATS>: per-channel [sum x, sum x*x] in f32;
//   row 11  `_apply_kernel` :98 / `_apply_res_kernel` :105
//           -> bn_apply_kernel: relu?((x-mean)*rsqrt(var+eps)*gamma+beta
//              [+res]) in f32, stored in x's type;
//   row 12  `_bwd_reduce_kernel` :114 + `_bwd_dx_kernel` :157
//           -> bn_reduce_kernel<BWD> ([sum g, sum g*xhat] = [dbeta, dgamma],
//              g = dy masked by the recomputed ReLU) and bn_dx_kernel
//              (dx = gamma*inv*(g - dbeta*minv - xhat*dgamma*minv));
//   row 13  `_bwd_reduce_res_kernel` :135 + `_bwd_dx_res_kernel` :168
//           -> the same with the residual inside the ReLU mask, and
//              dres = g.
// The ReLU mask is recomputed from x (and the residual), never stored.
//
// Bound: memory. Every pass does a handful of f32 operations per element
// it reads, far below the H100's ~295 flop/byte ridge, so the floor is the
// bytes over 3.35 TB/s: the stats pass reads M*C elements, apply reads 2
// (3 with the residual) and writes 1, the backward reduce reads 2 (3), dx
// reads 2 (3) and writes 1 (2).
//
// Design (simple and right first):
//  * One 2-D layout for every pass. A block of 256 threads is TX threads
//    along C by TY = 256/TX along M; a thread owns VEC adjacent channels
//    (VEC = 8 bf16 or 4 f32 through one 16-byte access when C and every
//    pointer allow it, else 1) for its whole life and walks rows with
//    stride TY. So loads are coalesced along C, and the per-channel terms
//    (mean, inv, gamma, beta, the reduction terms) live in registers,
//    read once per thread. Ragged M is a loop bound and any C is masked
//    by the channel index; nothing is padded on the host.
//  * Reductions are deterministic: no float atomics. Each block sums its
//    rows in a fixed order, folds its TY row lanes through shared memory
//    in a fixed order, and writes one partial per chunk of rows to a
//    [chunks, 2, C] workspace; a second launch sums the chunks in a fixed
//    order. The wrapper sizes the chunk count to fill the card.
//  * Elementwise passes round like their plain PyTorch versions, which
//    each round every product and sum on its own: every product and sum is
//    written with its round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
//    __fsub_rn), so nvcc contracts nothing into an FMA, and inv is
//    rsqrtf(var + eps), as torch.rsqrt computes it on the card. bf16 is
//    stored with round-to-nearest-even.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): each *_launch returns cudaGetLastError() after its launches;
// the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STATS = 0, BWD = 1, BWD_RES = 2;
constexpr int FIN_X = 32, FIN_Y = 32;   // finalize block: outputs x chunks

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

// VEC elements of one row at p, widened to f32 (one 16-byte access when
// VEC * sizeof(T) == 16).
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T buf[VEC];
    *reinterpret_cast<uint4*>(buf) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f(buf[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ p, const float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T buf[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) buf[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(buf);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f<T>(v[j]);
  }
}

// Per-channel terms of one thread's VEC channels.
template <int VEC>
struct Chan {
  float mean[VEC], inv[VEC], gamma[VEC], beta[VEC];

  __device__ __forceinline__ void read(const float* __restrict__ mean_p,
                                       const float* __restrict__ var_p,
                                       const float* __restrict__ gamma_p,
                                       const float* __restrict__ beta_p,
                                       int c0, float eps) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mean[j] = mean_p[c0 + j];
      inv[j] = rsqrtf(__fadd_rn(var_p[c0 + j], eps));
      gamma[j] = gamma_p[c0 + j];
      beta[j] = beta_p[c0 + j];
    }
  }

  // xhat = (x - mean) * inv; pre = xhat * gamma + beta (the JAX
  // `_pre_act`), each operation rounded on its own.
  __device__ __forceinline__ void pre_act(int j, float x, float& xhat,
                                          float& pre) const {
    xhat = __fmul_rn(__fsub_rn(x, mean[j]), inv[j]);
    pre = __fadd_rn(__fmul_rn(xhat, gamma[j]), beta[j]);
  }
};

// Channel-vector index and row lane of this thread.
struct Lane {
  int tx, ty, ty_n, c0;
  __device__ __forceinline__ Lane(int tx_n, int vec) {
    tx = threadIdx.x % tx_n;
    ty = threadIdx.x / tx_n;
    ty_n = THREADS / tx_n;
    c0 = (blockIdx.y * tx_n + tx) * vec;
  }
};

// Rows [chunk * rows, min(m, (chunk + 1) * rows)) of VEC channels per
// thread: per-block partial sums into ws[chunk, 2, C].
//   STATS:   [sum x, sum x*x]
//   BWD(_RES): [sum g, sum g*xhat], g = dy masked by pre (+ res) > 0.
template <int MODE, bool RELU, typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const T* __restrict__ res, const float* __restrict__ mean_p,
                 const float* __restrict__ var_p,
                 const float* __restrict__ gamma_p,
                 const float* __restrict__ beta_p, float eps, int64_t m,
                 int c, int tx_n, int64_t rows, float* __restrict__ ws) {
  __shared__ float sh[2 * THREADS * 8];
  const Lane ln(tx_n, VEC);
  const bool active = ln.c0 < c;
  float s0[VEC], s1[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s0[j] = s1[j] = 0.0f;
  Chan<VEC> ch;
  if (MODE != STATS && active)
    ch.read(mean_p, var_p, gamma_p, beta_p, ln.c0, eps);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t r1 = r0 + rows < m ? r0 + rows : m;
  if (active) {
#pragma unroll 4
    for (int64_t r = r0 + ln.ty; r < r1; r += ln.ty_n) {
      const int64_t off = r * c + ln.c0;
      float xv[VEC];
      load<T, VEC>(x + off, xv);
      if (MODE == STATS) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s0[j] = __fadd_rn(s0[j], xv[j]);
          s1[j] = __fadd_rn(s1[j], __fmul_rn(xv[j], xv[j]));
        }
      } else {
        float gv[VEC], rv[VEC];
        load<T, VEC>(dy + off, gv);
        if (MODE == BWD_RES && RELU) load<T, VEC>(res + off, rv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float xhat, pre;
          ch.pre_act(j, xv[j], xhat, pre);
          if (MODE == BWD_RES && RELU) pre = __fadd_rn(pre, rv[j]);
          const float g = (!RELU || pre > 0.0f) ? gv[j] : 0.0f;
          s0[j] = __fadd_rn(s0[j], g);
          s1[j] = __fadd_rn(s1[j], __fmul_rn(g, xhat));
        }
      }
    }
  }
  // Fold the TY row lanes in order 0..TY-1.
  const int width = tx_n * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sh[ln.ty * width + ln.tx * VEC + j] = s0[j];
    sh[(ln.ty_n + ln.ty) * width + ln.tx * VEC + j] = s1[j];
  }
  __syncthreads();
  if (ln.ty == 0 && active) {
    float* out = ws + static_cast<int64_t>(blockIdx.x) * 2 * c;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float a = 0.0f, b = 0.0f;
      for (int y = 0; y < ln.ty_n; ++y) {
        a = __fadd_rn(a, sh[y * width + ln.tx * VEC + j]);
        b = __fadd_rn(b, sh[(ln.ty_n + y) * width + ln.tx * VEC + j]);
      }
      if (ln.c0 + j < c) {
        out[ln.c0 + j] = a;
        out[c + ln.c0 + j] = b;
      }
    }
  }
}

// out[i] = sum over chunks k of ws[k, i] (i < 2C), in a fixed order:
// FIN_Y lanes take every FIN_Y-th chunk, then lane 0 folds them in order.
__global__ void __launch_bounds__(FIN_X * FIN_Y)
bn_finalize_kernel(const float* __restrict__ ws, int chunks, int n,
                   float* __restrict__ out) {
  __shared__ float sh[FIN_Y][FIN_X];
  const int i = blockIdx.x * FIN_X + threadIdx.x;
  float acc = 0.0f;
  if (i < n)
    for (int k = threadIdx.y; k < chunks; k += FIN_Y)
      acc = __fadd_rn(acc, ws[static_cast<int64_t>(k) * n + i]);
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float s = 0.0f;
    for (int y = 0; y < FIN_Y; ++y) s = __fadd_rn(s, sh[y][threadIdx.x]);
    out[i] = s;
  }
}

// out = relu?(pre [+ res]) in x's type, rows [blockIdx.x * rows, ...).
template <bool RES, bool RELU, typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ mean_p,
                const float* __restrict__ var_p,
                const float* __restrict__ gamma_p,
                const float* __restrict__ beta_p, float eps, int64_t m, int c,
                int tx_n, int64_t rows, T* __restrict__ out) {
  const Lane ln(tx_n, VEC);
  if (ln.c0 >= c) return;
  Chan<VEC> ch;
  ch.read(mean_p, var_p, gamma_p, beta_p, ln.c0, eps);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t r1 = r0 + rows < m ? r0 + rows : m;
#pragma unroll 4
  for (int64_t r = r0 + ln.ty; r < r1; r += ln.ty_n) {
    const int64_t off = r * c + ln.c0;
    float xv[VEC], rv[VEC], ov[VEC];
    load<T, VEC>(x + off, xv);
    if (RES) load<T, VEC>(res + off, rv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float xhat, pre;
      ch.pre_act(j, xv[j], xhat, pre);
      if (RES) pre = __fadd_rn(pre, rv[j]);
      if (RELU) pre = pre < 0.0f ? 0.0f : pre;   // jnp.maximum(pre, 0)
      ov[j] = pre;
    }
    store<T, VEC>(out + off, ov);
  }
}

// dx = (gamma*inv) * ((g - dbeta*minv) - (xhat*dgamma)*minv), and
// dres = g for the residual variant; red = [dbeta; dgamma] ([2, C]).
template <bool RES, bool RELU, typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bn_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
             const T* __restrict__ res, const float* __restrict__ mean_p,
             const float* __restrict__ var_p,
             const float* __restrict__ gamma_p,
             const float* __restrict__ beta_p, const float* __restrict__ red,
             float eps, float minv, int64_t m, int c, int tx_n, int64_t rows,
             T* __restrict__ dx, T* __restrict__ dres) {
  const Lane ln(tx_n, VEC);
  if (ln.c0 >= c) return;
  Chan<VEC> ch;
  ch.read(mean_p, var_p, gamma_p, beta_p, ln.c0, eps);
  float scale[VEC], a[VEC], r1v[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    scale[j] = __fmul_rn(ch.gamma[j], ch.inv[j]);
    a[j] = __fmul_rn(red[ln.c0 + j], minv);
    r1v[j] = red[c + ln.c0 + j];
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t r1 = r0 + rows < m ? r0 + rows : m;
#pragma unroll 4
  for (int64_t r = r0 + ln.ty; r < r1; r += ln.ty_n) {
    const int64_t off = r * c + ln.c0;
    float xv[VEC], gv[VEC], rv[VEC], dv[VEC];
    load<T, VEC>(x + off, xv);
    load<T, VEC>(dy + off, gv);
    if (RES && RELU) load<T, VEC>(res + off, rv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float xhat, pre;
      ch.pre_act(j, xv[j], xhat, pre);
      if (RES && RELU) pre = __fadd_rn(pre, rv[j]);
      if (RELU && !(pre > 0.0f)) gv[j] = 0.0f;
      const float t = __fsub_rn(
          __fsub_rn(gv[j], a[j]),
          __fmul_rn(__fmul_rn(xhat, r1v[j]), minv));
      dv[j] = __fmul_rn(scale[j], t);
    }
    store<T, VEC>(dx + off, dv);
    if (RES) store<T, VEC>(dres + off, gv);
  }
}

struct Geo {
  int vec, tx_n, ctiles, blocks;
  int64_t rows;
};

template <typename T, int VEC, int MODE, bool RELU>
int reduce_t(const void* x, const void* dy, const void* res, const float* mean,
             const float* var, const float* gamma, const float* beta,
             float eps, int64_t m, int c, const Geo& g, float* ws,
             float* out, cudaStream_t st) {
  dim3 grid(g.blocks, g.ctiles);
  bn_reduce_kernel<MODE, RELU, T, VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), mean, var, gamma, beta, eps, m, c, g.tx_n,
      g.rows, ws);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n = 2 * c;
  bn_finalize_kernel<<<(n + FIN_X - 1) / FIN_X, dim3(FIN_X, FIN_Y), 0, st>>>(
      ws, g.blocks, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int reduce_mode(int mode, int relu, const void* x, const void* dy,
                const void* res, const float* mean, const float* var,
                const float* gamma, const float* beta, float eps, int64_t m,
                int c, const Geo& g, float* ws, float* out, cudaStream_t st) {
#define BN_REDUCE(M, R)                                                     \
  return reduce_t<T, VEC, M, R>(x, dy, res, mean, var, gamma, beta, eps, m, \
                                c, g, ws, out, st)
  if (mode == STATS) BN_REDUCE(STATS, false);
  if (mode == BWD) {
    if (relu) BN_REDUCE(BWD, true);
    BN_REDUCE(BWD, false);
  }
  if (mode == BWD_RES) {
    if (relu) BN_REDUCE(BWD_RES, true);
    BN_REDUCE(BWD_RES, false);
  }
#undef BN_REDUCE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC, bool RES, bool RELU>
int apply_t(const void* x, const void* res, const float* mean,
            const float* var, const float* gamma, const float* beta,
            float eps, int64_t m, int c, const Geo& g, void* out,
            cudaStream_t st) {
  dim3 grid(g.blocks, g.ctiles);
  bn_apply_kernel<RES, RELU, T, VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), mean, var, gamma,
      beta, eps, m, c, g.tx_n, g.rows, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool RES, bool RELU>
int dx_t(const void* dy, const void* x, const void* res, const float* mean,
         const float* var, const float* gamma, const float* beta,
         const float* red, float eps, float minv, int64_t m, int c,
         const Geo& g, void* dx, void* dres, cudaStream_t st) {
  dim3 grid(g.blocks, g.ctiles);
  bn_dx_kernel<RES, RELU, T, VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(res), mean, var, gamma, beta, red, eps, minv, m,
      c, g.tx_n, g.rows, static_cast<T*>(dx), static_cast<T*>(dres));
  return static_cast<int>(cudaGetLastError());
}

// Dispatch (dtype, vec) -> a functor templated on <T, VEC>.
template <template <typename, int> class F, typename... A>
int by_type(int dtype, int vec, A... args) {
  if (dtype == 0 && vec == 4) return F<float, 4>::run(args...);
  if (dtype == 0 && vec == 1) return F<float, 1>::run(args...);
  if (dtype == 1 && vec == 8) return F<__nv_bfloat16, 8>::run(args...);
  if (dtype == 1 && vec == 1) return F<__nv_bfloat16, 1>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC>
struct Reduce {
  static int run(int mode, int relu, const void* x, const void* dy,
                 const void* res, const float* mean, const float* var,
                 const float* gamma, const float* beta, float eps, int64_t m,
                 int c, Geo g, float* ws, float* out, cudaStream_t st) {
    return reduce_mode<T, VEC>(mode, relu, x, dy, res, mean, var, gamma, beta,
                               eps, m, c, g, ws, out, st);
  }
};

template <typename T, int VEC>
struct Apply {
  static int run(int has_res, int relu, const void* x, const void* res,
                 const float* mean, const float* var, const float* gamma,
                 const float* beta, float eps, int64_t m, int c, Geo g,
                 void* out, cudaStream_t st) {
#define BN_APPLY(S, R)                                                       \
  return apply_t<T, VEC, S, R>(x, res, mean, var, gamma, beta, eps, m, c, g, \
                               out, st)
    if (has_res) {
      if (relu) BN_APPLY(true, true);
      BN_APPLY(true, false);
    }
    if (relu) BN_APPLY(false, true);
    BN_APPLY(false, false);
#undef BN_APPLY
  }
};

template <typename T, int VEC>
struct Dx {
  static int run(int has_res, int relu, const void* dy, const void* x,
                 const void* res, const float* mean, const float* var,
                 const float* gamma, const float* beta, const float* red,
                 float eps, float minv, int64_t m, int c, Geo g, void* dx,
                 void* dres, cudaStream_t st) {
#define BN_DX(S, R)                                                         \
  return dx_t<T, VEC, S, R>(dy, x, res, mean, var, gamma, beta, red, eps,   \
                            minv, m, c, g, dx, dres, st)
    if (has_res) {
      if (relu) BN_DX(true, true);
      BN_DX(true, false);
    }
    if (relu) BN_DX(false, true);
    BN_DX(false, false);
#undef BN_DX
  }
};

bool geo_ok(int vec, int tx_n, int ctiles, int blocks, int64_t rows,
            int64_t m, int c) {
  if (m <= 0 || c <= 0 || rows <= 0 || blocks <= 0 || ctiles <= 0)
    return false;
  if (tx_n <= 0 || tx_n > 32 || THREADS % tx_n) return false;
  if (vec > 1 && c % vec) return false;
  if (static_cast<int64_t>(ctiles) * tx_n * vec < c) return false;
  return rows * blocks >= m;
}

}  // namespace

extern "C" {

// mode: 0 = stats (x only), 1 = backward reduce, 2 = backward reduce with
// the residual in the mask. dtype of x/dy/res: 0 = float32, 1 = bfloat16;
// vec: 4 (f32) or 8 (bf16) with 16-byte aligned rows, or 1. Channel
// vectors are f32 [C]; ws is f32 [blocks, 2, C]; out is f32 [2, C].
int bn_reduce_launch(int mode, int relu, int dtype, int vec, const void* x,
                     const void* dy, const void* res, const void* mean,
                     const void* var, const void* gamma, const void* beta,
                     float eps, int64_t m, int c, int tx_n, int ctiles,
                     int blocks, int64_t rows, void* ws, void* out,
                     void* stream) {
  if (!geo_ok(vec, tx_n, ctiles, blocks, rows, m, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{vec, tx_n, ctiles, blocks, rows};
  return by_type<Reduce>(
      dtype, vec, mode, relu, x, dy, res, static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, m, c, g, static_cast<float*>(ws),
      static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

int bn_apply_launch(int has_res, int relu, int dtype, int vec, const void* x,
                    const void* res, const void* mean, const void* var,
                    const void* gamma, const void* beta, float eps, int64_t m,
                    int c, int tx_n, int ctiles, int blocks, int64_t rows,
                    void* out, void* stream) {
  if (!geo_ok(vec, tx_n, ctiles, blocks, rows, m, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{vec, tx_n, ctiles, blocks, rows};
  return by_type<Apply>(dtype, vec, has_res, relu, x, res,
                        static_cast<const float*>(mean),
                        static_cast<const float*>(var),
                        static_cast<const float*>(gamma),
                        static_cast<const float*>(beta), eps, m, c, g, out,
                        static_cast<cudaStream_t>(stream));
}

int bn_dx_launch(int has_res, int relu, int dtype, int vec, const void* dy,
                 const void* x, const void* res, const void* mean,
                 const void* var, const void* gamma, const void* beta,
                 const void* red, float eps, float minv, int64_t m, int c,
                 int tx_n, int ctiles, int blocks, int64_t rows, void* dx,
                 void* dres, void* stream) {
  if (!geo_ok(vec, tx_n, ctiles, blocks, rows, m, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{vec, tx_n, ctiles, blocks, rows};
  return by_type<Dx>(dtype, vec, has_res, relu, dy, x, res,
                     static_cast<const float*>(mean),
                     static_cast<const float*>(var),
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(beta),
                     static_cast<const float*>(red), eps, minv, m, c, g, dx,
                     dres, static_cast<cudaStream_t>(stream));
}

const char* bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
