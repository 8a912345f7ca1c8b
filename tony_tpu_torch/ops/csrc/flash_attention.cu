// Flash attention for training, forward and backward, hand-written for
// Hopper.
//
// Replaces the TPU kernels of tony_tpu/ops/attention.py:
//   forward   `_flash_kernel` :86 and `_flash_kernel_resident` :408, as
//             launched by `_flash_forward_streamed` :293,
//             `_flash_forward_resident` :575,
//             `_flash_forward_packed_resident` :712 and
//             `_flash_forward_packed_streamed` :825;
//   backward  `_flash_bwd_dq_kernel` :148 / `_flash_bwd_dq_kernel_resident`
//             :462 and `_flash_bwd_dkv_kernel` :192 /
//             `_flash_bwd_dkv_kernel_resident` :500, as launched by
//             `_flash_backward_streamed` :333, `_flash_backward_resident`
//             :611, `_flash_backward_packed_resident` :752 and
//             `_flash_backward_packed_streamed` :869.
// On the TPU the resident/streamed split follows VMEM capacity and the
// packed/classic split the lane tiling. Here a block always streams K/V
// (or Q/dO) tiles through shared memory, and every tensor is addressed
// through the strides it comes with, so the packed [B, T, H*D] and the
// classic [B, H, T, D] layouts are the same kernel with other strides and
// nothing is copied.
//
// Math (as the JAX kernels, in f32):
//   forward   S = (Q K^T) * scale, masked; online softmax (running max m,
//             normaliser l, accumulator acc); P rounded to V's type before
//             P V; O = acc / (l > 0 ? l : 1), LSE = m + log(l > 0 ? l : 1).
//   backward  P = exp(S - LSE), D = rowsum(dO o O), dS = P o (dO V^T - D)
//             rounded to the input type; dQ = scale * dS K,
//             dV = P^T dO (P rounded to dO's type), dK = scale * dS^T Q,
//             dK and dV summed over the query heads of their kv head.
// Masks: key j counts for query row i iff j < tk and, when causal,
// j <= i (aligned at the top left, as `_causal_mask`). Query rows at or
// past t are computed with zero inputs and never written, and the backward
// gives them P = 0, so nothing of them is read.
//
// Bound: operations. At the training shape (b=2, h=32, t=2048, d=128,
// causal, bf16) the forward does 4*d flops per admitted (row, key) pair,
// ~68.7 GFLOP, against ~67 MB of q/k/v/o: ~1000 flop/byte, far above the
// H100's ~295 flop/byte ridge, so the floor is the tensor-core rate.
//
// Design (simple and right first; mma/wgmma, TMA and a persistent
// schedule come later): CUDA-core f32 FMAs from shared memory in 64x64
// tiles, 256 threads, each thread a 2x8 micro-tile of the score tile
// (8 threads span a row, so row max/sum are 3 shuffles) and 2 rows x d/8
// columns of the output. The work does what it can about the bound by
// doing no work it need not do: the forward and dQ key loops stop at the
// causal diagonal (the streamed TPU kernel still schedules the blocks
// above it), the dK/dV q loop starts there, and D is computed once by the
// dQ kernel (written to a [B, H, T] buffer) instead of again per k tile.
// dK/dV accumulate in registers over all query heads of a kv head and all
// q tiles inside one block, so the sum is deterministic, with no atomics.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): each *_launch returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;
constexpr int TX = 8;             // threads across a 64-wide tile row
constexpr int RPT = 2;            // tile rows per thread (256 / 8 * 2 = 64)
constexpr int CPT = 8;            // tile columns per thread (64 / 8)
constexpr int NC = 16;            // output columns per thread
constexpr int DMAX = TX * NC;     // largest head_dim: 128
constexpr int PS = BK + 1;        // row stride of a 64x64 tile in smem
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
// x rounded to T and back: the JAX kernels' `.astype(dtype)` before a dot.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Reductions over the 8 consecutive lanes that share a tile row.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 1; o < TX; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 1; o < TX; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Element (b, h, t, c) of a [B, H, T, D] view lies at
// b*sb + h*sh + t*st + c*sc.
struct Strides4 { int64_t sb, sh, st, sc; };

struct Dims {
  int b, h, hkv, t, tk, d, causal;
  float scale;
};

// rows [row0, row0 + 64) of one (batch, head) slice into smem as f32 with
// row stride ld; rows at or past n_rows are zeros. Consecutive threads read
// consecutive columns (coalesced when sc == 1).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          Strides4 s, int row0, int n_rows,
                                          int d) {
  for (int i = threadIdx.x; i < 64 * d; i += THREADS) {
    const int r = i / d, c = i % d, row = row0 + r;
    dst[r * ld + c] = row < n_rows ? to_f(src[row * s.st + c * s.sc]) : 0.f;
  }
}

__device__ __forceinline__ bool admitted(int key, int row, const Dims& p) {
  return key < p.tk && (!p.causal || key <= row);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Dims p, Strides4 sq, Strides4 sk,
                 Strides4 sv, Strides4 so) {
  extern __shared__ float smem[];
  const int ld = p.d + 1;          // odd: conflict-free column walks
  float* qs = smem;                // [BQ][ld]
  float* ks = qs + BQ * ld;        // [BK][ld]
  float* vs = ks + BK * ld;        // [BK][d]
  float* ps = vs + BK * p.d;       // [BQ][PS]
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (p.h / p.hkv);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T* kb = k + bi * sk.sb + hk * sk.sh;
  const T* vb = v + bi * sv.sb + hk * sv.sh;
  load_tile(qs, ld, q + bi * sq.sb + hq * sq.sh, sq, q0, p.t, p.d);

  float m[RPT], l[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[i][cc] = 0.f;
  }
  const int last_row = min(p.t, q0 + BQ) - 1;
  const int k_end = p.causal ? min(p.tk, last_row + 1) : p.tk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();               // the previous tiles are consumed
    load_tile(ks, ld, kb, sk, k0, p.tk, p.d);
    load_tile(vs, p.d, vb, sv, k0, p.tk, p.d);
    __syncthreads();
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < p.d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * ld + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + TX * j) * ld + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float x = admitted(k0 + tx + TX * j, row, p)
                            ? s[i][j] * p.scale : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = expf(s[i][j] - m_new);
        sum += pj;
        ps[(ty * RPT + i) * PS + tx + TX * j] = round_to<T>(pj);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty * RPT + i) * PS + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = tx + TX * cc;
        if (c < p.d) {
          const float vv = vs[j * p.d + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= p.t) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    T* orow = o + bi * so.sb + hq * so.sh + row * so.st;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + TX * cc;
      if (c < p.d) orow[c * so.sc] = from_f<T>(acc[i][cc] / l_safe);
    }
    if (tx == 0)
      lse[(static_cast<int64_t>(bi) * p.h + hq) * p.t + row] =
          m[i] + logf(l_safe);
  }
}

// dQ for one (q tile, query head, batch); also writes D = rowsum(dO o O)
// of its rows for the dK/dV kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ dsum, Dims p, Strides4 sq,
                    Strides4 sk, Strides4 sv, Strides4 so, Strides4 sdo,
                    Strides4 sdq) {
  extern __shared__ float smem[];
  const int ld = p.d + 1;
  float* qs = smem;                // [BQ][ld]
  float* dos = qs + BQ * ld;       // [BQ][ld]
  float* ks = dos + BQ * ld;       // [BK][ld]
  float* vs = ks + BK * ld;        // [BK][ld]
  float* dss = vs + BK * ld;       // [BQ][PS]
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (p.h / p.hkv);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T* kb = k + bi * sk.sb + hk * sk.sh;
  const T* vb = v + bi * sv.sb + hk * sv.sh;
  load_tile(qs, ld, q + bi * sq.sb + hq * sq.sh, sq, q0, p.t, p.d);
  load_tile(dos, ld, dout + bi * sdo.sb + hq * sdo.sh, sdo, q0, p.t, p.d);
  __syncthreads();

  const int64_t rbase = (static_cast<int64_t>(bi) * p.h + hq) * p.t;
  float lse_r[RPT], d_r[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int lr = ty * RPT + i, row = q0 + lr;
    float part = 0.f;
    if (row < p.t) {
      const T* orow = o + bi * so.sb + hq * so.sh + row * so.st;
      for (int c = tx; c < p.d; c += TX)
        part += dos[lr * ld + c] * to_f(orow[c * so.sc]);
    }
    d_r[i] = row_sum(part);
    lse_r[i] = row < p.t ? lse[rbase + row] : 0.f;
    if (row < p.t && tx == 0) dsum[rbase + row] = d_r[i];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[i][cc] = 0.f;
  }
  const int last_row = min(p.t, q0 + BQ) - 1;
  const int k_end = p.causal ? min(p.tk, last_row + 1) : p.tk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile(ks, ld, kb, sk, k0, p.tk, p.d);
    load_tile(vs, ld, vb, sv, k0, p.tk, p.d);
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < p.d; ++c) {
      float qv[RPT], dov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = qs[(ty * RPT + i) * ld + c];
        dov[i] = dos[(ty * RPT + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = ks[(tx + TX * j) * ld + c];
        vv[j] = vs[(tx + TX * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = row < p.t && admitted(k0 + tx + TX * j, row, p)
                             ? expf(s[i][j] * p.scale - lse_r[i]) : 0.f;
        dss[(ty * RPT + i) * PS + tx + TX * j] =
            round_to<T>(pj * (dp[i][j] - d_r[i]));
      }
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dss[(ty * RPT + i) * PS + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = tx + TX * cc;
        if (c < p.d) {
          const float kk = ks[j * ld + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][cc] = fmaf(dsv[i], kk, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= p.t) continue;
    T* drow = dq + bi * sdq.sb + hq * sdq.sh + row * sdq.st;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + TX * cc;
      if (c < p.d) drow[c * sdq.sc] = from_f<T>(acc[i][cc] * p.scale);
    }
  }
}

// dK and dV for one (k tile, kv head, batch): loops over the query heads
// of the kv head and over the q tiles from the causal diagonal down.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, Dims p, Strides4 sq, Strides4 sk,
                     Strides4 sv, Strides4 sdo, Strides4 sdk,
                     Strides4 sdv) {
  extern __shared__ float smem[];
  const int ld = p.d + 1;
  float* ks = smem;                // [BK][ld]
  float* vs = ks + BK * ld;        // [BK][ld]
  float* qs = vs + BK * ld;        // [BQ][ld]
  float* dos = qs + BQ * ld;       // [BQ][ld]
  float* ts = dos + BQ * ld;       // [BK][PS]: P^T, then dS^T
  float* lse_s = ts + BK * PS;     // [BQ]
  float* d_s = lse_s + BQ;         // [BQ]
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, bi = blockIdx.z;
  const int reps = p.h / p.hkv;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  load_tile(ks, ld, k + bi * sk.sb + hk * sk.sh, sk, k0, p.tk, p.d);
  load_tile(vs, ld, v + bi * sv.sb + hk * sv.sh, sv, k0, p.tk, p.d);

  float dka[RPT][NC], dva[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dka[i][cc] = dva[i][cc] = 0.f;
  const int nqb = (p.t + BQ - 1) / BQ;
  const int qb0 = p.causal ? k0 / BQ : 0;

  for (int r = 0; r < reps; ++r) {
    const int hq = hk * reps + r;
    const int64_t rbase = (static_cast<int64_t>(bi) * p.h + hq) * p.t;
    for (int qb = qb0; qb < nqb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();
      load_tile(qs, ld, q + bi * sq.sb + hq * sq.sh, sq, q0, p.t, p.d);
      load_tile(dos, ld, dout + bi * sdo.sb + hq * sdo.sh, sdo, q0, p.t,
                p.d);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < p.t ? lse[rbase + row] : 0.f;
        d_s[threadIdx.x] = row < p.t ? dsum[rbase + row] : 0.f;
      }
      __syncthreads();
      // Tile rows are keys (ty), tile columns are query rows (tx).
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < p.d; ++c) {
        float kv[RPT], vv[RPT], qv[CPT], dov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = ks[(ty * RPT + i) * ld + c];
          vv[i] = vs[(ty * RPT + i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = qs[(tx + TX * j) * ld + c];
          dov[j] = dos[(tx + TX * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int key = k0 + ty * RPT + i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int lr = tx + TX * j, row = q0 + lr;
          const float pj = row < p.t && admitted(key, row, p)
                               ? expf(s[i][j] * p.scale - lse_s[lr]) : 0.f;
          ts[(ty * RPT + i) * PS + lr] = round_to<T>(pj);
          s[i][j] = round_to<T>(pj * (dp[i][j] - d_s[lr]));   // dS
        }
      }
      __syncthreads();
      for (int j = 0; j < BQ; ++j) {         // dV += P^T dO
        float pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = ts[(ty * RPT + i) * PS + j];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = tx + TX * cc;
          if (c < p.d) {
            const float x = dos[j * ld + c];
#pragma unroll
            for (int i = 0; i < RPT; ++i) dva[i][cc] = fmaf(pv[i], x, dva[i][cc]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          ts[(ty * RPT + i) * PS + tx + TX * j] = s[i][j];
      __syncthreads();
      for (int j = 0; j < BQ; ++j) {         // dK += dS^T Q
        float dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dsv[i] = ts[(ty * RPT + i) * PS + j];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = tx + TX * cc;
          if (c < p.d) {
            const float x = qs[j * ld + c];
#pragma unroll
            for (int i = 0; i < RPT; ++i) dka[i][cc] = fmaf(dsv[i], x, dka[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty * RPT + i;
    if (key >= p.tk) continue;
    T* krow = dk + bi * sdk.sb + hk * sdk.sh + key * sdk.st;
    T* vrow = dv + bi * sdv.sb + hk * sdv.sh + key * sdv.st;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + TX * cc;
      if (c < p.d) {
        krow[c * sdk.sc] = from_f<T>(dka[i][cc] * p.scale);
        vrow[c * sdv.sc] = from_f<T>(dva[i][cc]);
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

Dims make_dims(int b, int h, int hkv, int t, int tk, int d, int causal,
               float scale) {
  return Dims{b, h, hkv, t, tk, d, causal, scale};
}

Strides4 st4(const int64_t* s) { return Strides4{s[0], s[1], s[2], s[3]}; }

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        Dims p, const int64_t* s, cudaStream_t stream) {
  const int ld = p.d + 1;
  const size_t smem =
      sizeof(float) * ((BQ + BK) * ld + BK * p.d + BQ * PS);
  int err = set_smem(flash_fwd_kernel<T>, smem);
  if (err) return err;
  const dim3 grid((p.t + BQ - 1) / BQ, p.h, p.b);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), p, st4(s), st4(s + 4), st4(s + 8),
      st4(s + 12));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dsum, Dims p,
           const int64_t* s, cudaStream_t stream) {
  const int ld = p.d + 1;
  const size_t smem = sizeof(float) * ((2 * BQ + 2 * BK) * ld + BQ * PS);
  int err = set_smem(flash_bwd_dq_kernel<T>, smem);
  if (err) return err;
  const dim3 grid((p.t + BQ - 1) / BQ, p.h, p.b);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(dsum), p, st4(s), st4(s + 4),
      st4(s + 8), st4(s + 12), st4(s + 16), st4(s + 20));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* dsum, void* dk, void* dv, Dims p,
            const int64_t* s, cudaStream_t stream) {
  const int ld = p.d + 1;
  const size_t smem =
      sizeof(float) * ((2 * BQ + 2 * BK) * ld + BK * PS + 2 * BQ);
  int err = set_smem(flash_bwd_dkv_kernel<T>, smem);
  if (err) return err;
  const dim3 grid((p.tk + BK - 1) / BK, p.hkv, p.b);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), p, st4(s), st4(s + 4),
      st4(s + 8), st4(s + 12), st4(s + 16), st4(s + 20));
  return static_cast<int>(cudaGetLastError());
}

bool dims_ok(const Dims& p) {
  return p.d >= 1 && p.d <= DMAX && p.hkv >= 1 && p.h % p.hkv == 0 &&
         p.h <= 65535 && p.b <= 65535 && p.t >= 1 && p.tk >= 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, four per
// tensor in the order (batch, head, seq, feature) of its [B, H, T, D]
// view; any strides are taken. lse (and D below) are contiguous
// [B, H, T] float32.
//
// strides: q, k, v, o.
int flash_attention_fwd_launch(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int b,
                               int h, int hkv, int t, int tk, int d,
                               int causal, float scale,
                               const int64_t* strides, void* stream) {
  const Dims p = make_dims(b, h, hkv, t, tk, d, causal, scale);
  if (!dims_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(q, k, v, o, lse, p, strides, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(q, k, v, o, lse, p, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: q, k, v, o, dout, dq. Writes dq and dsum = rowsum(dout o o).
int flash_attention_bwd_dq_launch(int dtype, const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* dq, void* dsum, int b, int h,
                                  int hkv, int t, int tk, int d, int causal,
                                  float scale, const int64_t* strides,
                                  void* stream) {
  const Dims p = make_dims(b, h, hkv, t, tk, d, causal, scale);
  if (!dims_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dq<float>(q, k, v, o, dout, lse, dq, dsum, p, strides, st);
  if (dtype == 1)
    return bwd_dq<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dsum, p,
                                 strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: q, k, v, dout, dk, dv. Reads the dsum the dq launch wrote.
int flash_attention_bwd_dkv_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dsum,
                                   void* dk, void* dv, int b, int h,
                                   int hkv, int t, int tk, int d,
                                   int causal, float scale,
                                   const int64_t* strides, void* stream) {
  const Dims p = make_dims(b, h, hkv, t, tk, d, causal, scale);
  if (!dims_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dkv<float>(q, k, v, dout, lse, dsum, dk, dv, p, strides, st);
  if (dtype == 1)
    return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, dsum, dk, dv, p,
                                  strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
