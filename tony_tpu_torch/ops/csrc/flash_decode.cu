// Flash-decoding attention for the serving path, hand-written for Hopper.
//
// Replaces the TPU kernel `_decode_kernel` (tony_tpu/ops/attention.py,
// launched by `_decode_pallas` through `flash_decode`). For each batch
// row b and query head h, the t query rows attend over the cached
// [ctx, d] keys/values of kv head h*hkv/h; key j counts for row i iff
// j <= q_positions[b, i]. Online softmax in f32 (running max m,
// normaliser l, accumulator acc), then acc / (l > 0 ? l : 1), cast to
// q's type. Forward only.
//
// Bound: memory. Each launch must read the K and V rows up to each
// sequence's largest position plus q and o; at decode shapes that is
// ~2*pos*hkv*d*2 bytes per sequence against 4*pos*h*d flops, far below
// the H100's ~295 flop/byte ridge, so the floor is those bytes over
// 3.35 TB/s.
//
// Design (simple and right first; wgmma, TMA and split-K come later):
//  * One thread block per (row tile, kv head, batch row). The rows of a
//    block are the g = h/hkv query heads of its kv head times t, as in
//    the plain version's [b, hkv, g*t, d] grouping, so each K/V tile is
//    read once per group instead of once per query head (the TPU grid
//    (b, h) reads it g times).
//  * K/V tiles of BK = 32 keys are staged in shared memory as f32 with
//    coalesced 16-byte loads; the key loop stops at the tile's largest
//    position. Blocks above every row's position would add p = 0 and
//    alpha = 1 exactly (keys are finite and block 0 always holds key
//    0), so skipping them changes no bit.
//  * Lane j of a warp scores key j for the warp's RPW rows with CUDA-core
//    FMAs; max and sum are butterfly shuffles (every lane ends with the
//    same bits); the P.V update gives each lane d/32 output columns.
//  * Row independence: a row's arithmetic depends only on its own q,
//    position and the K/V of its kv head, in one fixed order — never on
//    t, its tile, or the other rows of the launch.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): flash_decode_launch returns cudaGetLastError() after the
// launch; the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;      // keys per shared-memory tile (= warp size)
constexpr int WARPS = 4;    // warps per block
constexpr int RPW = 4;      // query rows per warp
constexpr int ROWS = WARPS * RPW;
constexpr int NC = 8;       // output columns per lane: d <= 32 * NC = 256
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

struct Strides4 { int64_t s0, s1, s2, s3; };

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ o, int h, int hkv, int t, int d,
                    int ctx, float scale, Strides4 sq, Strides4 sk,
                    Strides4 sv, int64_t sp0, int64_t sp1, Strides4 so) {
  extern __shared__ float smem[];
  float* ks = smem;                    // [BK][d + 1]: odd stride, no bank
  float* vs = ks + BK * (d + 1);       //   conflicts for lane-per-key reads
  float* qs = vs + BK * d;             // [BK][d], [ROWS][d]
  __shared__ int rpos[ROWS];

  const int g = h / hkv;
  const int n_rows = g * t;
  const int row0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Query rows of this tile (zeros and position 0 past the group's end:
  // computed like any row, never stored).
  for (int i = threadIdx.x; i < ROWS * d; i += blockDim.x) {
    const int lr = i / d, c = i % d, r = row0 + lr;
    float val = 0.f;
    if (r < n_rows) {
      const int hq = kvh * g + r / t, ti = r % t;
      val = to_f(q[bi * sq.s0 + hq * sq.s1 + ti * sq.s2 + c * sq.s3]);
    }
    qs[lr * d + c] = val;
  }
  if (threadIdx.x < ROWS) {
    const int r = row0 + threadIdx.x;
    rpos[threadIdx.x] = r < n_rows ? pos[bi * sp0 + (r % t) * sp1] : 0;
  }
  __syncthreads();

  int max_pos = 0;
  for (int i = 0; i < ROWS; ++i) max_pos = max(max_pos, rpos[i]);
  const int k_end = min(ctx, max_pos + 1);

  float m[RPW], l[RPW], acc[RPW][NC];
  int my_pos[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    my_pos[r] = rpos[warp * RPW + r];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[r][cc] = 0.f;
  }
  const float* qw = qs + warp * RPW * d;
  const T* kb = k + bi * sk.s0 + kvh * sk.s1;
  const T* vb = v + bi * sv.s0 + kvh * sv.s1;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < BK * d / VEC; i += blockDim.x) {
      const int j = (i * VEC) / d, c = (i * VEC) % d, key = k0 + j;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (key < ctx) {
        kx = *reinterpret_cast<const uint4*>(kb + key * sk.s2 + c);
        vx = *reinterpret_cast<const uint4*>(vb + key * sv.s2 + c);
      }
      const T* ke = reinterpret_cast<const T*>(&kx);
      const T* ve = reinterpret_cast<const T*>(&vx);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * (d + 1) + c + e] = to_f(ke[e]);
        vs[j * d + c + e] = to_f(ve[e]);
      }
    }
    __syncthreads();

    // Scores: lane = key within the tile.
    const int key = k0 + lane;
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* krow = ks + lane * (d + 1);
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = fmaf(qw[r * d + c], kc, s[r]);
    }
    // Online-softmax update; s[r] becomes this lane's p.
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float sr = s[r] * scale;
      if (!(key <= my_pos[r] && key < ctx)) sr = NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[r][cc] *= alpha;
    }
    // acc += P.V: lane owns columns lane, lane+32, ...
    for (int j = 0; j < BK; ++j) {
      float vj[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        vj[cc] = c < d ? vs[j * d + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          acc[r][cc] = fmaf(pj, vj[cc], acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + warp * RPW + r;
    if (row >= n_rows) continue;
    const int hq = kvh * g + row / t, ti = row % t;
    const float denom = l[r] > 0.f ? l[r] : 1.f;
    T* orow = o + bi * so.s0 + hq * so.s1 + ti * so.s2;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) orow[c * so.s3] = from_f<T>(acc[r][cc] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* o, int b, int h, int hkv, int t, int d, int ctx,
           float scale, Strides4 sq, Strides4 sk, Strides4 sv, int64_t sp0,
           int64_t sp1, Strides4 so, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BK * (d + 1) + BK * d + ROWS * d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_rows = (h / hkv) * t;
  const dim3 grid((n_rows + ROWS - 1) / ROWS, hkv, b);
  flash_decode_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(o), h, hkv, t, d, ctx, scale, sq, sk, sv, sp0, sp1,
      so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. k/v need a
// unit last stride, 16-byte-aligned rows and d % 8 == 0 (the wrapper
// checks); q, positions and o take any strides.
int flash_decode_launch(int dtype, const void* q, const void* k,
                        const void* v, const void* pos, void* o, int b,
                        int h, int hkv, int t, int d, int ctx, float scale,
                        int64_t sq0, int64_t sq1, int64_t sq2, int64_t sq3,
                        int64_t sk0, int64_t sk1, int64_t sk2, int64_t sk3,
                        int64_t sv0, int64_t sv1, int64_t sv2, int64_t sv3,
                        int64_t sp0, int64_t sp1, int64_t so0, int64_t so1,
                        int64_t so2, int64_t so3, void* stream) {
  const Strides4 sq{sq0, sq1, sq2, sq3}, sk{sk0, sk1, sk2, sk3},
      sv{sv0, sv1, sv2, sv3}, so{so0, so1, so2, so3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, pos, o, b, h, hkv, t, d, ctx, scale, sq,
                         sk, sv, sp0, sp1, so, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, pos, o, b, h, hkv, t, d, ctx,
                                 scale, sq, sk, sv, sp0, sp1, so, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
