// int8 tensor-core GEMM with an f32 rescale, hand-written for Hopper.
//
// Replaces the TPU kernel `_dot_kernel` (tony_tpu/ops/quant.py:127,
// launched by `_int8_matmul` :143, epilogue `_rescale` :100). One call
// computes, for int8 xq [M, K] and wq [N, K] (rows K-contiguous: torch's
// weight layout), an f32 scalar sx and f32 sw [N]:
//   out[m, n] = f32(sum_k xq[m, k] * wq[n, k]) * (sx * sw[n])   (f32 [M, N])
//
// Bound: at the decode shapes (M <= 256 rows against a 7B projection)
// the int8 weight dominates the bytes (M*K + N*K + 4*M*N) and the floor
// is bytes over 3.35 TB/s; at the prefill and training shapes (M = 512,
// 4096) the 2*M*N*K integer operations over the 1979 TOP/s int8 peak
// bound it.
//
// Two kernels, chosen per call by the host plan (`_int8_plan` in
// ops/quant.py) from the shape, the row strides and the base pointers:
//
// int8_matmul_wgmma_kernel<BM, BN> (every operand TMA can take: K, both
// row strides and both base pointers multiples of 16 bytes):
//  * wgmma.mma_async m64nBNk32 s32.s8.s8, both operands K-major as they
//    lie in memory (xq rows the A side, wq rows the B side): nothing is
//    transposed or copied. One consumer warpgroup per m64 tile of the
//    block's BM x BN output (BM = 64 or 128; BN = 128, 176 or 256), its
//    int32 sums in registers.
//  * One producer warp keeps a ring of tiles of 128 bytes of K, as deep
//    as shared memory holds for the tile (Tile::STAGES, 4-9), full with
//    cp.async.bulk.tensor (TMA, 128-byte swizzle; the wgmma descriptors
//    read the matching B128 layout), each stage guarded by a
//    full and an empty mbarrier. The tensor maps are encoded per call on
//    the host (the serve path re-quantizes its weights every forward, so
//    the pointers change) and passed as __grid_constant__ parameters.
//    Rows past M or N and K past its end land as zeros (TMA's
//    out-of-bounds fill; zero codes are inert in an integer product) and
//    stores are masked.
//  * Work units are (n tile, m tile, K range); a persistent grid of at
//    most one block per SM walks them, so one unit's epilogue overlaps
//    the producer's loads for the next. The m tiles of one n tile are
//    neighbours: blocks of one wave share a weight tile, which crosses
//    DRAM once and reaches the others from L2.
//  * The host plan picks the tile whose units fill the grid's waves best.
//    A caller may ask for K to be split over blocks: each split writes
//    its int32 partial sum to a workspace [splits, M, N] and
//    int8_matmul_combine_kernel adds the partials and rescales. Integer
//    sums are exact in any order, so the split changes no bit.
//
// int8_matmul_kernel<MT, VEC> (the first port of the kernel, for ragged
// K, unaligned row strides or pointers, which TMA cannot address):
//  * CTA tile BM x 128 over K steps of 64: 8 warps in a 2 x 4 grid, each
//    warp BM/2 x 32 of the output as (BM/32) x 4 tiles of
//    mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, staged through
//    shared memory in two cp.async buffers (a byte-wise loader when K, a
//    row stride or a pointer breaks 16-byte alignment).
//
// Exact: the int32 accumulator cannot overflow (|acc| <= K * 127^2,
// below 2^31 for K < 133,000), and integer sums are exact in any order.
// Every epilogue rounds as `_rescale` does, s = sx * sw[n] then
// f32(acc) * s, each with its round-to-nearest intrinsic (no
// contraction), so both paths, at every split count, are bitwise the
// plain version. The scales stay on the device: sx and sw are read
// from device memory; the host never reads them back.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): each launcher returns cudaGetLastError() after its launches
// (or a CUDA error code for arguments it refuses); the Python wrapper
// raises when it is not 0. cuTensorMapEncodeTiled is looked up at run
// time (cudaGetDriverEntryPoint), so the library links only the CUDA
// runtime.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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


// ---------------------------------------------------------------------
// The wgmma + TMA kernel.
// ---------------------------------------------------------------------

constexpr int KT = 128;            // bytes of K in one ring stage
constexpr int SMEM_BYTES = 232448;  // the most a block may use (227 KB)

template <int BM, int BN>
struct Tile {
  static_assert(BM == 64 || BM == 128, "one m64 tile a warpgroup");
  static constexpr int CWG = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = CWG * 128 + 32;  // + one producer warp
  static constexpr int STAGE_BYTES = (BM + BN) * KT;
  // The deepest ring that fits beside the 1024-byte alignment slack and
  // two 8-byte mbarriers a stage.
  static constexpr int STAGES = (SMEM_BYTES - 1024) / (STAGE_BYTES + 16);
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 16 * STAGES;
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One box of `rows` x 128 bytes at (k0, row0) into shared memory; the
// bytes count against `bar`'s transaction.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle TMA writes: 8-row groups 1024 bytes apart (SBO),
// layout B128. `addr` advances by 32 bytes per k32 step inside the row.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 128] (s32) += A[64 x 32] (s8, K-major) * B[128 x 32]^T (s8,
// K-major), both read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 176] (s32) += A[64 x 32] (s8, K-major) * B[176 x 32]^T (s8,
// K-major), both read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_n176(int (&d)[88], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] (s32) += A[64 x 32] (s8, K-major) * B[256 x 32]^T (s8,
// K-major), both read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else if constexpr (BN == 176) {
    wgmma_n176(d, da, db);
  } else {
    static_assert(BN == 256, "BN is 128, 176 or 256");
    wgmma_n256(d, da, db);
  }
}

// Unit u of the persistent walk: its split, m tile and n tile. The splits
// of one tile are neighbours, then the m tiles of one n tile, so blocks
// running together share a weight tile.
struct Unit {
  int split, mt, nt;
};

__device__ __forceinline__ Unit unit_of(int u, int m_tiles, int splits) {
  const int tile = u / splits;
  return {u - tile * splits, tile % m_tiles, tile / m_tiles};
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const float* __restrict__ sx,
                         const float* __restrict__ sw,
                         float* out, int* ws,
                         int M, int N, int nk, int stages, int m_tiles,
                         int splits, int cps, int units) {
  using T = Tile<BM, BN>;
  // `stages` is T::STAGES, passed at run time: nvcc's code for the ring
  // with its depth a compile-time constant ran slower at every lane shape
  // on an H100.
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start there.
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + stages * T::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  auto tile_a = [&](int s) { return ring + s * T::STAGE_BYTES; };
  auto tile_b = [&](int s) { return ring + s * T::STAGE_BYTES + BM * KT; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), T::CWG * 4);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T::CWG * 4) {
    // Producer: one thread walks every unit's K range ahead of the
    // consumers, as far as the ring's free stages allow.
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, m_tiles, splits);
        const int k1 = min(nk, (w.split + 1) * cps);
        for (int kt = w.split * cps; kt < k1; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), T::STAGE_BYTES);
          tma_load(tile_a(stage), &tx, kt * KT, w.mt * BM, full(stage));
          tma_load(tile_b(stage), &tw, kt * KT, w.nt * BN, full(stage));
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup `wg` owns rows [64 * wg, 64 * wg + 64) of the
  // block's tile.
  const int wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2);   // + 8 for the odd pair
  const int c0 = 2 * (lane & 3);
  const float sxv = *sx;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, m_tiles, splits);
    const int k1 = min(nk, (w.split + 1) * cps);
    int acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
    int held = -1;   // the stage the last committed wgmma group reads
    for (int kt = w.split * cps; kt < k1; ++kt) {
      mbar_wait(full(stage), phase);
      wgmma_fence();
      const uint32_t a = tile_a(stage) + wg * 64 * KT;
#pragma unroll
      for (int kk = 0; kk < KT / 32; ++kk)
        wgmma<BN>(acc, desc_b128(a + 32 * kk),
                  desc_b128(tile_b(stage) + 32 * kk));
      wgmma_commit();
      // The group before this one has finished reading its stage.
      wgmma_wait<1>();
      if (held >= 0 && lane == 0) mbar_arrive(empty(held));
      held = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (held >= 0 && lane == 0) mbar_arrive(empty(held));

    // Epilogue: each thread holds columns c0, c0 + 1 of every n8 chunk
    // in rows r0 and r0 + 8 of its warpgroup's m64 tile.
    const int n_base = w.nt * BN + c0;
    const int m_base = w.mt * BM + wg * 64 + r0;
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n_base + 8 * j;
        const float s0 = n < N ? __fmul_rn(sxv, sw[n]) : 0.0f;
        const float s1 = n + 1 < N ? __fmul_rn(sxv, sw[n + 1]) : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_base + 8 * h;
          if (m >= M || n >= N) continue;
          const float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0);
          const float y1 =
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1);
          float* o = out + static_cast<int64_t>(m) * N + n;
          if (n + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
          } else {
            o[0] = y0;
            if (n + 1 < N) o[1] = y1;
          }
        }
      }
    } else {
      int* part = ws + static_cast<int64_t>(w.split) * M * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n_base + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_base + 8 * h;
          if (m >= M || n >= N) continue;
          int* p = part + static_cast<int64_t>(m) * N + n;
          if (n + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<int2*>(p) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
            p[0] = acc[4 * j + 2 * h];
            if (n + 1 < N) p[1] = acc[4 * j + 2 * h + 1];
          }
        }
      }
    }
  }
}

// out[m, n] = f32(sum_s ws[s, m, n]) * (sx * sw[n]) over the contiguous
// [M, N]: the integer partials are summed exactly, then rounded as the
// unsplit epilogue rounds. VEC: four columns a thread (N % 4 == 0). `out`
// may be ws[0] (the wrapper's one allocation): each thread reads its
// elements of every partial before it writes them.
template <bool VEC>
__global__ void __launch_bounds__(256)
int8_matmul_combine_kernel(const int* ws, const float* __restrict__ sx,
                           const float* __restrict__ sw, float* out, int N,
                           int64_t total, int splits) {
  const float sxv = *sx;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (VEC) {
    for (int64_t i = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x) * 4;
         i < total; i += 4 * step) {
      int4 a = *reinterpret_cast<const int4*>(ws + i);
      for (int s = 1; s < splits; ++s) {
        const int4 b = *reinterpret_cast<const int4*>(ws + s * total + i);
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      const int n = static_cast<int>(i % N);
      const float4 c = *reinterpret_cast<const float4*>(sw + n);
      *reinterpret_cast<float4*>(out + i) = make_float4(
          __fmul_rn(__int2float_rn(a.x), __fmul_rn(sxv, c.x)),
          __fmul_rn(__int2float_rn(a.y), __fmul_rn(sxv, c.y)),
          __fmul_rn(__int2float_rn(a.z), __fmul_rn(sxv, c.z)),
          __fmul_rn(__int2float_rn(a.w), __fmul_rn(sxv, c.w)));
    }
  } else {
    for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
         i < total; i += step) {
      int a = ws[i];
      for (int s = 1; s < splits; ++s) a += ws[s * total + i];
      out[i] = __fmul_rn(__int2float_rn(a), __fmul_rn(sxv, sw[i % N]));
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major int8 matrix [rows, K] with row stride `ld`
// bytes, read in boxes of `box_rows` x 128 bytes with the 128-byte
// swizzle; out-of-bounds elements read as zero.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
            int K, int64_t ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KT),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
int launch_wgmma(const int8_t* xq, const int8_t* wq, const float* sx,
                 const float* sw, float* out, int* ws, int M, int N, int K,
                 int64_t lda, int64_t ldb, int splits, int cps, int grid,
                 cudaStream_t st) {
  using T = Tile<BM, BN>;
  const int nk = (K + KT - 1) / KT;
  const int m_tiles = (M + BM - 1) / BM;
  const int64_t units =
      static_cast<int64_t>(m_tiles) * ((N + BN - 1) / BN) * splits;
  if (splits < 1 || cps < 1 || static_cast<int64_t>(cps) * splits < nk ||
      static_cast<int64_t>(cps) * (splits - 1) >= nk || grid < 1 ||
      units > (1 << 30) || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tx, tw;
  if (!encode(fn, &tx, xq, M, K, lda, BM) ||
      !encode(fn, &tw, wq, N, K, ldb, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr[64] = {false};   // per instantiation and card
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !attr[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_wgmma_kernel<BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) attr[dev] = true;
  }
  int8_matmul_wgmma_kernel<BM, BN>
      <<<static_cast<unsigned>(std::min<int64_t>(grid, units)), T::THREADS,
         T::SMEM, st>>>(tx, tw, sx, sw, out, ws, M, N, nk, T::STAGES, m_tiles,
                        splits, cps, static_cast<int>(units));
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t total = static_cast<int64_t>(M) * N;
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(sw) % 16 == 0;
    const int64_t per = vec ? total / 4 : total;
    const unsigned blocks = static_cast<unsigned>(
        std::min<int64_t>((per + 255) / 256, 8 * num_sms()));
    if (vec)
      int8_matmul_combine_kernel<true>
          <<<blocks, 256, 0, st>>>(ws, sx, sw, out, N, total, splits);
    else
      int8_matmul_combine_kernel<false>
          <<<blocks, 256, 0, st>>>(ws, sx, sw, out, N, total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The mma.sync kernel. xq [M, K] and wq [N, K] int8 with unit K stride
// and row strides lda / ldb; sx an f32 scalar and sw [N] f32 in device
// memory; out [M, N] f32 with row stride ldc. M, N >= 1 and K >= 0 (the
// wrapper checks).
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

// The wgmma kernel (+ the combine kernel when splits > 1). Operands as
// above with K, lda, ldb and both base pointers multiples of 16 bytes;
// out [M, N] f32 contiguous; ws an int32 workspace [splits, M, N] when
// splits > 1 (else unused), which `out` may alias at ws[0]. `tile` picks
// (BM, BN) by its code below, the index of `_TILES` in ops/quant.py; the
// K tiles of 128 bytes go to `splits` ranges of `cps` tiles; `grid`
// blocks walk the units.
int int8_matmul_wgmma_launch(const void* xq, const void* wq, const void* sx,
                             const void* sw, void* out, void* ws, int M,
                             int N, int K, int64_t lda, int64_t ldb,
                             int tile, int splits, int cps,
                             int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || lda % 16 || ldb % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(wq) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsw = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  int* w = static_cast<int*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_WGMMA_TILE(CODE, BM, BN)                                      \
  case CODE:                                                               \
    return launch_wgmma<BM, BN>(a, b, fsx, fsw, o, w, M, N, K, lda, ldb,  \
                                splits, cps, grid, st);
  switch (tile) {
    INT8_WGMMA_TILE(0, 64, 128)
    INT8_WGMMA_TILE(1, 128, 128)
    INT8_WGMMA_TILE(2, 128, 176)
    INT8_WGMMA_TILE(3, 128, 256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef INT8_WGMMA_TILE
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
