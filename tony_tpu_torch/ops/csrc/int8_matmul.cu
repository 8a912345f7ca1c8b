// int8 tensor-core GEMM with an f32 rescale, hand-written for Hopper.
//
// Replaces the TPU kernel `_dot_kernel` (tony_tpu/ops/quant.py:127,
// launched by `_int8_matmul` :143, epilogue `_rescale` :100). One launch
// computes, for int8 xq [M, K] and wq [N, K] (rows K-contiguous: torch's
// weight layout), an f32 scalar sx and f32 sw [N]:
//   out[m, n] = f32(sum_k xq[m, k] * wq[n, k]) * (sx * sw[n])   (f32 [M, N])
//
// Bound: at the decode shapes (M = 256 rows against a 7B projection) the
// int8 weight dominates the bytes (M*K + N*K + 4*M*N) and the floor is
// bytes over 3.35 TB/s; at the training shape (M = 4096) the 2*M*N*K
// integer operations over the 1979 TOP/s int8 peak bound it.
//
// Design (simple and right first; wgmma, TMA and a deeper pipeline come
// later):
//  * CTA tile BM x 128 over K steps of 64: 8 warps in a 2 x 4 grid, each
//    warp BM/2 x 32 of the output as (BM/32) x 4 tiles of
//    mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. xq rows are the
//    `row` operand and wq rows the `col` operand as they lie in memory,
//    so nothing is transposed. BM is 128, or 64 when 128-row tiles would
//    leave SMs without a block (decode against a 4096-wide projection).
//  * Tiles are staged through shared memory in two buffers: 16-byte
//    cp.async copies (zero-filled past M, N or K) overlap the next K step's
//    loads with this step's MMAs. Rows are padded to 80 bytes, so the
//    32-bit fragment reads of a warp hit 32 distinct banks.
//  * Ragged shapes are handled in the kernel: out-of-range rows, columns
//    and K are loaded as zero codes (inert in an integer product, as the
//    TPU kernel's zero padding) and stores are masked. When K, a row
//    stride or a base pointer breaks 16-byte alignment (K = 70, 4099), a
//    byte-wise load path fills the same shared tiles.
//  * Exact: the int32 accumulator cannot overflow (|acc| <= K * 127^2,
//    below 2^31 for K < 133,000), and integer sums are exact in any
//    order. The epilogue rounds as `_rescale` does, s = sx * sw[n] then
//    f32(acc) * s, each with its round-to-nearest intrinsic (no
//    contraction), so the kernel is bitwise its plain version.
//  * The scales stay on the device: sx and sw are read from device
//    memory; the host never reads them back.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): int8_matmul_launch returns cudaGetLastError() after the
// launch; the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 16;   // shared row stride in bytes
constexpr int NT = 4;          // n8 tiles per warp (32 columns)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; bytes past `src_bytes` are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [r0, r0 + ROWS) x K columns [k0, k0 + BK) of a row-major int8
// matrix with `nrows` rows, K columns and row stride `ld` into a shared
// tile with row stride LDS; zero outside the matrix.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(int8_t* dst,
                                          const int8_t* __restrict__ src,
                                          int64_t ld, int r0, int nrows,
                                          int k0, int K) {
  if (VEC) {
    // K % 16 == 0: a 16-byte chunk lies wholly inside or outside K.
    constexpr int CHUNKS = ROWS * (BK / 16);
#pragma unroll
    for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gr = r0 + r, gk = k0 + kc;
      const bool ok = gr < nrows && gk < K;
      const int8_t* p = ok ? src + gr * ld + gk : src;
      cp_async16(dst + r * LDS + kc, p, ok ? 16 : 0);
    }
  } else {
    constexpr int BYTES = ROWS * BK;
#pragma unroll 4
    for (int i = threadIdx.x; i < BYTES; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = r0 + r, gk = k0 + kk;
      dst[r * LDS + kk] =
          (gr < nrows && gk < K) ? src[gr * ld + gk] : static_cast<int8_t>(0);
    }
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int M, int N, int K, int64_t lda,
                   int64_t ldb, int64_t ldc) {
  constexpr int BM = 32 * MT;   // 2 warps along M, MT m16 tiles each
  __shared__ __align__(16) int8_t sa[2][BM * LDS];
  __shared__ __align__(16) int8_t sb[2][BN * LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    load_tile<BM, VEC>(sa[0], xq, lda, m0, M, 0, K);
    load_tile<BN, VEC>(sb[0], wq, ldb, n0, N, 0, K);
  }
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile<BM, VEC>(sa[s ^ 1], xq, lda, m0, M, (kt + 1) * BK, K);
      load_tile<BN, VEC>(sb[s ^ 1], wq, ldb, n0, N, (kt + 1) * BK, K);
    }
    cp_async_commit();
    cp_async_wait_one();   // step kt's tiles have landed
    __syncthreads();
    const int8_t* A = sa[s] + (wm * 16 * MT + g) * LDS + 4 * t;
    const int8_t* B = sb[s] + (wn * 32 + g) * LDS + 4 * t;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = A + i * 16 * LDS + kk;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = B + j * 8 * LDS + kk;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();   // all reads of buffer s done before it is refilled
  }

  // Epilogue: s = sx * sw[n], then f32(acc) * s, both rounded to nearest.
  const float sxv = *sx;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * t;   // even
    const float s0 = n < N ? __fmul_rn(sxv, sw[n]) : 0.0f;
    const float s1 = n + 1 < N ? __fmul_rn(sxv, sw[n + 1]) : 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 16 * MT + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const float y0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), s0);
        const float y1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s1);
        float* o = out + m * ldc + n;
        if (n + 1 < N && (ldc & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          if (n < N) o[0] = y0;
          if (n + 1 < N) o[1] = y1;
        }
      }
    }
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

template <int MT, bool VEC>
int launch(const int8_t* xq, const int8_t* wq, const float* sx,
           const float* sw, float* out, int M, int N, int K, int64_t lda,
           int64_t ldb, int64_t ldc, cudaStream_t st) {
  constexpr int BM = 32 * MT;
  const int64_t gy = (static_cast<int64_t>(M) + BM - 1) / BM;
  const int64_t gx = (static_cast<int64_t>(N) + BN - 1) / BN;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int8_matmul_kernel<MT, VEC>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), THREADS,
         0, st>>>(xq, wq, sx, sw, out, M, N, K, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_tiles(const int8_t* xq, const int8_t* wq, const float* sx,
                 const float* sw, float* out, int M, int N, int K,
                 int64_t lda, int64_t ldb, int64_t ldc, cudaStream_t st) {
  const int64_t tiles128 = ((static_cast<int64_t>(M) + 127) / 128) *
                           ((static_cast<int64_t>(N) + BN - 1) / BN);
  if (M <= 64 || tiles128 < num_sms())
    return launch<2, VEC>(xq, wq, sx, sw, out, M, N, K, lda, ldb, ldc, st);
  return launch<4, VEC>(xq, wq, sx, sw, out, M, N, K, lda, ldb, ldc, st);
}

}  // namespace

extern "C" {

// xq [M, K] and wq [N, K] int8 with unit K stride and row strides lda /
// ldb; sx an f32 scalar and sw [N] f32 in device memory; out [M, N] f32
// with row stride ldc. M, N >= 1 and K >= 0 (the wrapper checks).
int int8_matmul_launch(const void* xq, const void* wq, const void* sx,
                       const void* sw, void* out, int M, int N, int K,
                       int64_t lda, int64_t ldb, int64_t ldc, void* stream) {
  if (M <= 0 || N <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsw = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 16 == 0 && lda % 16 == 0 && ldb % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec)
    return launch_tiles<true>(a, b, fsx, fsw, o, M, N, K, lda, ldb, ldc, st);
  return launch_tiles<false>(a, b, fsx, fsw, o, M, N, K, lda, ldb, ldc, st);
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
