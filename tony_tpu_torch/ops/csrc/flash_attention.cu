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
// H100's ~295 flop/byte ridge, so the floor is the tensor-core rate. The
// backward does 7 products of 2*d flops per admitted pair: S and dP twice
// (once in the dQ kernel, once in the dK/dV kernel), dS K, P^T dO and
// dS^T Q. FlashAttention-2 does 5, summing dQ with atomics; recomputing S
// and dP is the price of a deterministic dQ.
//
// Two designs live here.
//
// bf16 (the training path), on the tensor cores: the forward
// flash_fwd_mma_kernel and the backward pair flash_bwd_dq_mma_kernel and
// flash_bwd_dkv_mma_kernel.
//  * Tiles stay bf16 in shared memory, rows padded by 16 bytes (row
//    stride 2*HEAD_DIM + 16 bytes), so the 8 row addresses of each
//    ldmatrix phase land in 8 distinct 4-bank groups: no bank conflicts.
//    A head_dim d below the instantiated HEAD_DIM (16, 32, 64 or 128) is
//    zero-padded in shared memory.
//  * Products are mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with A and
//    B fragments from ldmatrix.x4 (.trans where the operand is needed
//    transposed: V in P V, K in dS K, dO in P^T dO, Q in dS^T Q). Each
//    warp owns 16 rows (forward and dQ: query rows; dK/dV: keys). The f32
//    accumulator fragments of S and dP become bf16 A fragments in
//    registers (the m16n8 C layout of two adjacent n-tiles is the
//    m16n8k16 A layout), so P and dS never touch shared memory. The
//    rounding points are the JAX kernels': P is rounded to V's type before
//    P V (the forward's normaliser l sums the unrounded P) and to dO's type
//    before P^T dO, dS to the input type before dS K and dS^T Q; in bf16
//    those rounded values are the mma operands, so only the order of the
//    f32 sums differs from the plain versions.
//  * The forward is FlashAttention-2's loop over 128-row q tiles: each of
//    the 4 warps owns 32 query rows (two m16 tiles) and uses every K and V
//    B fragment for both, so S = Q K^T takes 0.375 ldmatrix.x4 per mma (Q's
//    A fragments come from shared memory at each tile) and P V 0.25. The
//    online softmax runs in the C-fragment layout, each thread holding rows
//    g and g + 8 of each m-tile (row max over the 4 lanes of a quad: two
//    shuffles), in base 2 (exp2f, log2(e) folded into the scale; LSE is
//    written in base e). O leaves as acc / l_safe. A variant with 16 rows a
//    warp and Q's A fragments held in registers (0.5 ldmatrix.x4 per mma,
//    211 registers, no spills) was slower at every timed shape and was
//    dropped: 0.353 ms against 0.328 at the 7B train shape, 2.54 against
//    2.25 at t = 8192 (one H100 at 700 W, in turns; PERF.md). The kernel
//    needs acc (128 f32) and S (64 f32) at HEAD_DIM 128: ptxas gives it 255 registers and spills 132
//    bytes; two blocks of 4 warps share an SM. It reaches 210-245 TFLOP/s
//    over 4 * d flops per admitted pair, a quarter of the peak. The spill
//    is not what holds it back: running the softmax and P V over 32-key
//    halves of each tile spilled nothing (254 registers) and moved the
//    time by under 2% at d = 128 (8% slower at d = 64). The 4 warps of a
//    block run S, the softmax and P V between the same two barriers a
//    tile, so the tensor cores wait through each softmax unless the SM's
//    other block fills them; see also the backward's reasons below.
//  * Loads: tiles are filled by 16-byte cp.async.cg copies into a
//    two-stage ring, so the next tile's copy overlaps this tile's
//    products (commit_group / wait_group 1), and O, dQ, dK and dV leave in
//    16-byte stores. That needs every bf16 operand's feature stride 1,
//    d % 8 == 0, and its other strides and base pointer 16-byte aligned:
//    the packed [B, T, H*D] views and contiguous [B, H, T, D] are. The
//    Python wrapper (`_for_mma` in ops/attention.py) copies any other
//    operand (a zero-stride or transposed dO from autograd) and zero-pads
//    d to a multiple of 8; the launchers only refuse a layout that breaks
//    the rule (rows16 below), so a direct caller gets an error, not a
//    misaligned copy.
//  * Schedule: blocks are numbered tile-major over (tile, head, batch),
//    the longest tiles first under causal masking (forward and dQ: the
//    last q tiles, which see the most keys; dK/dV: the first k tiles,
//    which see the most q tiles), so the short ones fill the tail. Only
//    tiles on the diagonal or on a ragged edge evaluate the mask.
//  * Deterministic, with no atomics: a forward or dQ row block sums its
//    key tiles in order, and a dK/dV key block sums all q tiles of all
//    query heads of its kv head in order, in registers (128 f32 a thread
//    at d = 128; ptxas: 242-245 registers a thread at HEAD_DIM 128, no
//    spills, so two blocks of 4 warps share an SM).
//  * What bounds them: at the 7B train shape the kernels reach about a
//    quarter of the bf16 tensor-core peak. Each warp re-reads the whole
//    streamed tile from shared memory for its B fragments (about 0.6
//    ldmatrix.x4 per mma in the backward), and mma.sync itself cannot
//    reach the peak; wgmma (B read by the tensor cores from shared memory,
//    64-row warpgroup tiles) is the next step for both directions.
//
// f32 (flash_fwd_kernel and the f32 backward, flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel): CUDA-core f32 FMAs from shared memory in 64x64
// tiles, 256 threads, each thread a 2x8 micro-tile of the score tile (8
// threads span a row, so row max/sum are 3 shuffles) and 2 rows x d/8
// columns of the output. f32 is off the main path, and TF32 tensor cores
// would not hold the f32 limits (1e-5 of scale against the plain
// versions), so f32 stays on the CUDA cores; bf16 never falls back to
// it. In both designs the loops stop at the causal diagonal,
// D = rowsum(dO o O) is computed once by the dQ kernel (written to a
// [B, H, T] buffer) for the dK/dV kernel, and every sum runs in a fixed
// order in one block, with no atomics.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): each *_launch returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

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

// Reductions over the 8 consecutive lanes that share a tile row.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 1; o < TX; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 1; o < TX; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

struct Dims {
  int b, h, hkv, t, tk, d, causal;
  float scale;
};

// rows [row0, row0 + 64) of one (batch, head) slice into smem with row
// stride ld; rows at or past n_rows are zeros. Consecutive threads read
// consecutive columns (coalesced when sc == 1).
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, Strides4 s,
                                          int row0, int n_rows, int d) {
  for (int i = threadIdx.x; i < 64 * d; i += THREADS) {
    const int r = i / d, c = i % d, row = row0 + r;
    dst[r * ld + c] = row < n_rows ? src[row * s.st + c * s.sc] : 0.f;
  }
}

__device__ __forceinline__ bool admitted(int key, int row, const Dims& p) {
  return key < p.tk && (!p.causal || key <= row);
}

// f32 forward for one (q tile, query head, batch) on the CUDA cores.
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* kb = k + bi * sk.sb + hk * sk.sh;
  const float* vb = v + bi * sv.sb + hk * sv.sh;
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
        ps[(ty * RPT + i) * PS + tx + TX * j] = pj;
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
    float* orow = o + bi * so.sb + hq * so.sh + row * so.st;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + TX * cc;
      if (c < p.d) orow[c * so.sc] = acc[i][cc] / l_safe;
    }
    if (tx == 0)
      lse[(static_cast<int64_t>(bi) * p.h + hq) * p.t + row] =
          m[i] + logf(l_safe);
  }
}

// f32 dQ for one (q tile, query head, batch) on the CUDA cores; also
// writes D = rowsum(dO o O) of its rows for the dK/dV kernel.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
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
  const float* kb = k + bi * sk.sb + hk * sk.sh;
  const float* vb = v + bi * sv.sb + hk * sv.sh;
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
      const float* orow = o + bi * so.sb + hq * so.sh + row * so.st;
      for (int c = tx; c < p.d; c += TX)
        part += dos[lr * ld + c] * orow[c * so.sc];
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
        dss[(ty * RPT + i) * PS + tx + TX * j] = pj * (dp[i][j] - d_r[i]);
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
    float* drow = dq + bi * sdq.sb + hq * sdq.sh + row * sdq.st;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + TX * cc;
      if (c < p.d) drow[c * sdq.sc] = acc[i][cc] * p.scale;
    }
  }
}

// f32 dK and dV for one (k tile, kv head, batch) on the CUDA cores: loops
// over the query heads of the kv head and over the q tiles from the causal
// diagonal down.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk,
                     float* __restrict__ dv, Dims p, Strides4 sq, Strides4 sk,
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
          ts[(ty * RPT + i) * PS + lr] = pj;
          s[i][j] = pj * (dp[i][j] - d_s[lr]);   // dS
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
    float* krow = dk + bi * sdk.sb + hk * sdk.sh + key * sdk.st;
    float* vrow = dv + bi * sdv.sb + hk * sdv.sh + key * sdv.st;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = tx + TX * cc;
      if (c < p.d) {
        krow[c * sdk.sc] = dka[i][cc] * p.scale;
        vrow[c * sdv.sc] = dva[i][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------
// bf16 backward on the tensor cores.
// ---------------------------------------------------------------------

constexpr int MT = 64;            // rows of every tile (q rows or keys)
constexpr int MTHREADS = 128;     // 4 warps, 16 tile rows each
constexpr float LN2 = 0.6931471805599453f;

// Rows [row0, row0 + MT) of one (batch, head) slice (`src` points at its
// row 0) into a bf16 tile with row stride HD + 8 by 16-byte cp.async
// copies (feature stride 1, 16-byte aligned rows, d % 8 == 0, so a chunk
// lies wholly inside or outside d), committed by the caller; rows at or
// past n_rows and features at or past d are zeros.
template <int HD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst,
                                               const bf16* __restrict__ src,
                                               Strides4 s, int row0,
                                               int n_rows, int d) {
  constexpr int LD = HD + 8, CPR = HD / 8;   // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < MT * CPR; i += MTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, row = row0 + r;
    const bool ok = row < n_rows && c < d;
    cp_async16(dst + r * LD + c, ok ? src + row * s.st + c : src,
               ok ? 16 : 0);
  }
}

// A warp's 16 output rows, held as f32 C fragments acc[HD / 8][4], times
// `mul`, rounded to bf16 and stored to rows [row0, row0 + 16) of `dst`
// (rows at or past n_rows and features at or past d are not written).
// The warp stages them through `stage`, its own 16 rows of a tile with
// row stride HD + 8 that no other warp reads any more, then stores 16
// bytes a lane.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4],
                                           float mul, bf16* stage,
                                           bf16* __restrict__ dst,
                                           Strides4 s, int row0, int n_rows,
                                           int d) {
  constexpr int LD = HD + 8, CPR = HD / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = (i % CPR) * 8, row = row0 + r;
    if (row < n_rows && c < d)
      *reinterpret_cast<uint4*>(dst + row * s.st + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// Block index -> (tile, head, batch), tile-major: every head's first
// tile before any head's second. `reverse` starts from the last tile.
__device__ __forceinline__ void block_coords(int n_tiles, int heads,
                                             bool reverse, int& tile,
                                             int& head, int& batch) {
  const int per_tile = gridDim.x / n_tiles;   // heads * batch
  tile = blockIdx.x / per_tile;
  if (reverse) tile = n_tiles - 1 - tile;
  const int rest = blockIdx.x % per_tile;
  head = rest % heads;
  batch = rest / heads;
}

// The bf16 forward for one (q tile, query head, batch) on the tensor
// cores: MW = 2 m16 tiles a warp, so a block of 4 warps owns BM = 128
// query rows (warp w rows q0 + 32w onwards); K/V tiles of 64 keys stream
// through a two-stage ring. A warp reads Q's A fragments from shared
// memory at each tile and uses every K and V B fragment for both of its
// m-tiles.
constexpr int MW = 2;

template <int HD>
__global__ void __launch_bounds__(MTHREADS, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Dims p, Strides4 sq,
                     Strides4 sk, Strides4 sv, Strides4 so) {
  constexpr int LD = HD + 8, TILE = MT * LD, BM = MT * MW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BM][LD]
  bf16* ks = qs + MW * TILE;                      // [2][MT][LD]
  bf16* vs = ks + 2 * TILE;                       // [2][MT][LD]
  const int n_qt = (p.t + BM - 1) / BM;
  int qt, hq, bi;
  block_coords(n_qt, p.h, p.causal != 0, qt, hq, bi);
  const int q0 = qt * BM, hk = hq / (p.h / p.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16 * MW;              // the warp's first row in BM
  const bf16* kb = k + bi * sk.sb + hk * sk.sh;
  const bf16* vb = v + bi * sv.sb + hk * sv.sh;
  const int last_row = min(p.t, q0 + BM) - 1;
  const int k_end = p.causal ? min(p.tk, last_row + 1) : p.tk;
  const int n_kt = (k_end + MT - 1) / MT;

#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
    load_tile_bf16<HD>(qs + mi * TILE, q + bi * sq.sb + hq * sq.sh, sq,
                       q0 + mi * MT, p.t, p.d);
  load_tile_bf16<HD>(ks, kb, sk, 0, p.tk, p.d);
  load_tile_bf16<HD>(vs, vb, sv, 0, p.tk, p.d);
  cp_async_commit();

  // Rows g and g + 8 of each m-tile (the thread's C-fragment rows): the
  // running max m (base 2: scores are taken times scale * log2(e)), the
  // thread's part of the normaliser l over its columns, and acc.
  const float scale2 = p.scale * LOG2E;
  float m[MW][2], l[MW][2], acc[MW][HD / 8][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mi][i] = NEG_INF;
      l[mi][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  }

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * MT;
    if (it + 1 < n_kt) {
      const int nxt = (it + 1) & 1;
      load_tile_bf16<HD>(ks + nxt * TILE, kb, sk, k0 + MT, p.tk, p.d);
      load_tile_bf16<HD>(vs + nxt * TILE, vb, sv, k0 + MT, p.tk, p.d);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;
    // Under causal masking a warp whose rows all lie before the tile's
    // first key has nothing to add; no barrier lies inside.
    if (!(p.causal && k0 > q0 + wr + 16 * MW - 1)) {
      // S = Q K^T: 16 * MW rows x 64 keys per warp.
      float s[MW][8][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[MW][4];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
          ldsm_x4(a[mi], a_addr<LD>(qs, wr + mi * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, b_addr<LD>(kt, np * 16, kk * 16, lane));
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            mma_bf16(s[mi][2 * np], a[mi], bk[0], bk[1]);
            mma_bf16(s[mi][2 * np + 1], a[mi], bk[2], bk[3]);
          }
        }
      }

      // Online softmax over the tile, rows g and g + 8 (a row's 64 keys
      // are spread over the 4 lanes of a quad); P is rounded to bf16 and
      // packed as the A fragments of P V, while l sums the unrounded P.
      const bool edge =
          k0 + MT > p.tk || (p.causal && k0 + MT - 1 > q0 + wr);
      uint32_t ap[MW][4][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mi][j][e] * scale2;
            if (edge) {
              const int row = q0 + wr + mi * 16 + g + 8 * (e >> 1);
              const int key = k0 + j * 8 + 2 * t4 + (e & 1);
              if (!admitted(key, row, p)) x = NEG_INF;
            }
            s[mi][j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
          alpha[i] = exp2f(m[mi][i] - mx[i]);
          m[mi][i] = mx[i];
          l[mi][i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[e] = exp2f(s[mi][j][e] - mx[e >> 1]);
            l[mi][e >> 1] += pv[e];
          }
          ap[mi][j >> 1][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
          ap[mi][j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        }
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] *= alpha[e >> 1];
      }

      // acc += P V: the keys are the contraction, so V comes .trans.
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bv[4];
          ldsm_x4_t(bv, bt_addr<LD>(vt, kc * 16, np * 16, lane));
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            mma_bf16(acc[mi][2 * np], ap[mi][kc], bv[0], bv[1]);
            mma_bf16(acc[mi][2 * np + 1], ap[mi][kc], bv[2], bv[3]);
          }
        }
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }

  // O = acc / l_safe and LSE = m + log(l_safe) (m back in base e), with l
  // summed over the quad; O leaves through the warp's own rows of Q's
  // tile, which no other warp reads.
  cp_async_wait_all();
  __syncthreads();
  const int64_t rbase = (static_cast<int64_t>(bi) * p.h + hq) * p.t;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    float l_safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[mi][i];
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l_safe[i] = sum > 0.f ? sum : 1.f;
      const int row = q0 + wr + mi * 16 + g + 8 * i;
      if (t4 == 0 && row < p.t)
        lse[rbase + row] = m[mi][i] * LN2 + logf(l_safe[i]);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] /= l_safe[e >> 1];
    const int r0 = wr + mi * 16;
    store_rows<HD>(acc[mi], 1.f, qs + r0 * LD,
                   o + bi * so.sb + hq * so.sh, so, q0 + r0, p.t, p.d);
  }
}

// dQ for one (q tile, query head, batch) on the tensor cores; also
// writes D = rowsum(dO o O) of its rows for the dK/dV kernel. Warp w owns
// query rows q0 + 16w .. q0 + 16w + 15; K/V tiles of 64 keys stream
// through a two-stage ring.
template <int HD>
__global__ void __launch_bounds__(MTHREADS, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ dsum, Dims p, Strides4 sq,
                        Strides4 sk, Strides4 sv, Strides4 so, Strides4 sdo,
                        Strides4 sdq) {
  constexpr int LD = HD + 8, TILE = MT * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [MT][LD]
  bf16* dos = qs + TILE;                          // [MT][LD]
  bf16* ks = dos + TILE;                          // [2][MT][LD]
  bf16* vs = ks + 2 * TILE;                       // [2][MT][LD]
  const int n_qt = (p.t + MT - 1) / MT;
  int qt, hq, bi;
  block_coords(n_qt, p.h, p.causal != 0, qt, hq, bi);
  const int q0 = qt * MT, hk = hq / (p.h / p.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + bi * sq.sb + hq * sq.sh;
  const bf16* dob = dout + bi * sdo.sb + hq * sdo.sh;
  const bf16* kb = k + bi * sk.sb + hk * sk.sh;
  const bf16* vb = v + bi * sv.sb + hk * sv.sh;
  const int last_row = min(p.t, q0 + MT) - 1;
  const int k_end = p.causal ? min(p.tk, last_row + 1) : p.tk;
  const int n_kt = (k_end + MT - 1) / MT;

  load_tile_bf16<HD>(qs, qb, sq, q0, p.t, p.d);
  load_tile_bf16<HD>(dos, dob, sdo, q0, p.t, p.d);
  load_tile_bf16<HD>(ks, kb, sk, 0, p.tk, p.d);
  load_tile_bf16<HD>(vs, vb, sv, 0, p.tk, p.d);
  cp_async_commit();

  // D of the warp's 16 rows from global dO and O while the copies fly;
  // the thread keeps rows g and g + 8 (its C-fragment rows), with LSE.
  const int64_t rbase = (static_cast<int64_t>(bi) * p.h + hq) * p.t;
  const bf16* ob = o + bi * so.sb + hq * so.sh;
  float d_r[2] = {0.f, 0.f}, lse2[2];
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float part = 0.f;
    if (row < p.t)
      for (int c = lane; c < p.d; c += 32)
        part += __bfloat162float(dob[row * sdo.st + c * sdo.sc]) *
                __bfloat162float(ob[row * so.st + c * so.sc]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(FULL, part, off);
    if (row < p.t && lane == 0) dsum[rbase + row] = part;
    if (r == g) d_r[0] = part;
    if (r == g + 8) d_r[1] = part;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    lse2[i] = row < p.t ? lse[rbase + row] * LOG2E : 0.f;
  }
  const float scale2 = p.scale * LOG2E;

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * MT;
    if (it + 1 < n_kt) {
      const int nxt = (it + 1) & 1;
      load_tile_bf16<HD>(ks + nxt * TILE, kb, sk, k0 + MT, p.tk, p.d);
      load_tile_bf16<HD>(vs + nxt * TILE, vb, sv, k0 + MT, p.tk, p.d);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, a_addr<LD>(qs, warp * 16, kk * 16, lane));
      ldsm_x4(ado, a_addr<LD>(dos, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, b_addr<LD>(kt, np * 16, kk * 16, lane));
        ldsm_x4(bv, b_addr<LD>(vt, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ado, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }

    // P = exp(S * scale - LSE), 0 where masked; dS = P o (dP - D)
    // rounded to bf16 and packed as the A fragments of dS K.
    const bool edge = k0 + MT > p.tk || (p.causal && k0 + MT - 1 > q0);
    uint32_t ads[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(s[j][e] * scale2 - lse2[e >> 1]);
        if (edge) {
          const int row = q0 + warp * 16 + g + 8 * (e >> 1);
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          if (!admitted(key, row, p)) pv = 0.f;
        }
        ds[e] = pv * (dp[j][e] - d_r[e >> 1]);
      }
      ads[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      ads[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K: the keys are the contraction, so K comes .trans.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, bt_addr<LD>(kt, kc * 16, np * 16, lane));
        mma_bf16(acc[2 * np], ads[kc], bk[0], bk[1]);
        mma_bf16(acc[2 * np + 1], ads[kc], bk[2], bk[3]);
      }
    __syncthreads();   // the stage is consumed before it is refilled
  }

  cp_async_wait_all();
  __syncthreads();
  store_rows<HD>(acc, p.scale, qs + warp * 16 * LD,
                 dq + bi * sdq.sb + hq * sdq.sh, sdq, q0 + warp * 16, p.t,
                 p.d);
}

// dK and dV for one (k tile, kv head, batch) on the tensor cores: loops
// over the query heads of the kv head and over the q tiles from the
// causal diagonal down, with Q, dO, LSE and D streaming through a
// two-stage ring. Warp w owns keys k0 + 16w .. k0 + 16w + 15 and walks
// each q tile in two halves of 32 rows, which keeps S^T and dP^T at 32
// registers beside the 128 of the dK/dV accumulators (d = 128).
template <int HD>
__global__ void __launch_bounds__(MTHREADS, 2)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         Dims p, Strides4 sq, Strides4 sk, Strides4 sv,
                         Strides4 sdo, Strides4 sdk, Strides4 sdv) {
  constexpr int LD = HD + 8, TILE = MT * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [MT][LD]
  bf16* vs = ks + TILE;                           // [MT][LD]
  bf16* qs = vs + TILE;                           // [2][MT][LD]
  bf16* dos = qs + 2 * TILE;                      // [2][MT][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);   // [2][MT]
  float* d_s = lse_s + 2 * MT;                               // [2][MT]
  const int n_kt = (p.tk + MT - 1) / MT;
  int kt, hk, bi;
  block_coords(n_kt, p.hkv, false, kt, hk, bi);
  const int k0 = kt * MT, reps = p.h / p.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_qt = (p.t + MT - 1) / MT;
  const int qt0 = p.causal ? k0 / MT : 0;
  const int per_head = max(0, n_qt - qt0);
  const int n_it = reps * per_head;

  // Iteration i reads query head hk * reps + i / per_head, q tile
  // qt0 + i % per_head; its Q, dO, LSE and D go to stage i & 1.
  auto load_q_side = [&](int i) {
    const int hq = hk * reps + i / per_head;
    const int q0 = (qt0 + i % per_head) * MT, st = i & 1;
    load_tile_bf16<HD>(qs + st * TILE, q + bi * sq.sb + hq * sq.sh, sq,
                            q0, p.t, p.d);
    load_tile_bf16<HD>(dos + st * TILE,
                            dout + bi * sdo.sb + hq * sdo.sh, sdo, q0, p.t,
                            p.d);
    const int64_t rbase = (static_cast<int64_t>(bi) * p.h + hq) * p.t;
    for (int r = threadIdx.x; r < MT; r += MTHREADS) {
      const int row = q0 + r;
      const int64_t at = row < p.t ? rbase + row : rbase;
      cp_async4(lse_s + st * MT + r, lse + at, row < p.t ? 4 : 0);
      cp_async4(d_s + st * MT + r, dsum + at, row < p.t ? 4 : 0);
    }
  };

  load_tile_bf16<HD>(ks, k + bi * sk.sb + hk * sk.sh, sk, k0, p.tk,
                          p.d);
  load_tile_bf16<HD>(vs, v + bi * sv.sb + hk * sv.sh, sv, k0, p.tk,
                          p.d);
  if (n_it > 0) load_q_side(0);
  cp_async_commit();

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float scale2 = p.scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q_side(it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int st = it & 1;
    const int q0 = (qt0 + it % per_head) * MT;
    const bf16* qt = qs + st * TILE;
    const bf16* dot = dos + st * TILE;
    const float* lse_t = lse_s + st * MT;
    const float* d_t = d_s + st * MT;
    const bool edge = q0 + MT > p.t || (p.causal && k0 + MT - 1 > q0);

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;     // the half's first q row in the tile
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 q rows per warp.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, a_addr<LD>(ks, warp * 16, kk * 16, lane));
        ldsm_x4(av, a_addr<LD>(vs, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4], bdo[4];
          ldsm_x4(bq, b_addr<LD>(qt, c0 + np * 16, kk * 16, lane));
          ldsm_x4(bdo, b_addr<LD>(dot, c0 + np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], ak, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[2 * np], av, bdo[0], bdo[1]);
          mma_bf16(dp[2 * np + 1], av, bdo[2], bdo[3]);
        }
      }
      // P^T, rounded to bf16 for P^T dO, and dS^T = P^T o (dP^T - D),
      // rounded to bf16 for dS^T Q: A fragments over the q rows.
      uint32_t ap[2][4], ads[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = c0 + j * 8 + 2 * t4 + (e & 1);   // q row in tile
          pv[e] = exp2f(s[j][e] * scale2 - lse_t[lr] * LOG2E);
          if (edge) {
            const int key = k0 + warp * 16 + g + 8 * (e >> 1);
            const int row = q0 + lr;
            if (!(row < p.t && (!p.causal || key <= row))) pv[e] = 0.f;
          }
          ds[e] = pv[e] * (dp[j][e] - d_t[lr]);
        }
        ap[j >> 1][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
        ap[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        ads[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        ads[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += P^T dO and dK += dS^T Q: the q rows are the contraction,
      // so dO and Q come .trans.
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bdo[4], bq[4];
          ldsm_x4_t(bdo, bt_addr<LD>(dot, c0 + kc * 16, np * 16, lane));
          ldsm_x4_t(bq, bt_addr<LD>(qt, c0 + kc * 16, np * 16, lane));
          mma_bf16(dva[2 * np], ap[kc], bdo[0], bdo[1]);
          mma_bf16(dva[2 * np + 1], ap[kc], bdo[2], bdo[3]);
          mma_bf16(dka[2 * np], ads[kc], bq[0], bq[1]);
          mma_bf16(dka[2 * np + 1], ads[kc], bq[2], bq[3]);
        }
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }

  cp_async_wait_all();
  __syncthreads();
  store_rows<HD>(dka, p.scale, ks + warp * 16 * LD,
                 dk + bi * sdk.sb + hk * sdk.sh, sdk, k0 + warp * 16, p.tk,
                 p.d);
  store_rows<HD>(dva, 1.f, vs + warp * 16 * LD,
                 dv + bi * sdv.sb + hk * sdv.sh, sdv, k0 + warp * 16, p.tk,
                 p.d);
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

int fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
            Dims p, const int64_t* s, cudaStream_t stream) {
  const int ld = p.d + 1;
  const size_t smem =
      sizeof(float) * ((BQ + BK) * ld + BK * p.d + BQ * PS);
  int err = set_smem(flash_fwd_kernel, smem);
  if (err) return err;
  const dim3 grid((p.t + BQ - 1) / BQ, p.h, p.b);
  flash_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), p, st4(s), st4(s + 4), st4(s + 8),
      st4(s + 12));
  return static_cast<int>(cudaGetLastError());
}

int bwd_dq_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dq, void* dsum, Dims p,
               const int64_t* s, cudaStream_t stream) {
  const int ld = p.d + 1;
  const size_t smem = sizeof(float) * ((2 * BQ + 2 * BK) * ld + BQ * PS);
  int err = set_smem(flash_bwd_dq_kernel, smem);
  if (err) return err;
  const dim3 grid((p.t + BQ - 1) / BQ, p.h, p.b);
  flash_bwd_dq_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dq), static_cast<float*>(dsum), p, st4(s),
      st4(s + 4), st4(s + 8), st4(s + 12), st4(s + 16), st4(s + 20));
  return static_cast<int>(cudaGetLastError());
}

int bwd_dkv_f32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* dsum, void* dk,
                void* dv, Dims p, const int64_t* s, cudaStream_t stream) {
  const int ld = p.d + 1;
  const size_t smem =
      sizeof(float) * ((2 * BQ + 2 * BK) * ld + BK * PS + 2 * BQ);
  int err = set_smem(flash_bwd_dkv_kernel, smem);
  if (err) return err;
  const dim3 grid((p.tk + BK - 1) / BK, p.hkv, p.b);
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<float*>(dk), static_cast<float*>(dv), p, st4(s),
      st4(s + 4), st4(s + 8), st4(s + 12), st4(s + 16), st4(s + 20));
  return static_cast<int>(cudaGetLastError());
}

// f(HEAD_DIM) as a std::integral_constant tag: the instantiation of the
// mma kernels for head_dim d.
template <typename F>
int by_head_dim(int d, F&& f) {
  using std::integral_constant;
  if (d <= 16) return f(integral_constant<int, 16>());
  if (d <= 32) return f(integral_constant<int, 32>());
  if (d <= 64) return f(integral_constant<int, 64>());
  return f(integral_constant<int, 128>());
}

int fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
            Dims p, const int64_t* s, cudaStream_t stream) {
  const Strides4 sq = st4(s), sk = st4(s + 4), sv = st4(s + 8),
                 so = st4(s + 12);
  if (!(rows16(q, sq, p.b, p.h, p.t, p.d) &&
        rows16(k, sk, p.b, p.hkv, p.tk, p.d) &&
        rows16(v, sv, p.b, p.hkv, p.tk, p.d) &&
        rows16(o, so, p.b, p.h, p.t, p.d)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      static_cast<int64_t>((p.t + MW * MT - 1) / (MW * MT)) * p.h * p.b;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(p.d, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem = sizeof(bf16) * (MW + 4) * MT * (HD + 8);
    auto kernel = flash_fwd_mma_kernel<HD>;
    int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<static_cast<unsigned>(blocks), MTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), p, sq, sk, sv, so);
    return static_cast<int>(cudaGetLastError());
  });
}

int bwd_dq_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dq, void* dsum,
               Dims p, const int64_t* s, cudaStream_t stream) {
  const Strides4 sq = st4(s), sk = st4(s + 4), sv = st4(s + 8),
                 so = st4(s + 12), sdo = st4(s + 16), sdq = st4(s + 20);
  if (!(rows16(q, sq, p.b, p.h, p.t, p.d) &&
        rows16(k, sk, p.b, p.hkv, p.tk, p.d) &&
        rows16(v, sv, p.b, p.hkv, p.tk, p.d) &&
        rows16(dout, sdo, p.b, p.h, p.t, p.d) &&
        rows16(dq, sdq, p.b, p.h, p.t, p.d)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      static_cast<int64_t>((p.t + MT - 1) / MT) * p.h * p.b;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(p.d, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem = sizeof(bf16) * 6 * MT * (HD + 8);
    auto kernel = flash_bwd_dq_mma_kernel<HD>;
    int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<static_cast<unsigned>(blocks), MTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<bf16*>(dq), static_cast<float*>(dsum), p, sq, sk, sv, so,
        sdo, sdq);
    return static_cast<int>(cudaGetLastError());
  });
}

int bwd_dkv_mma(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* dsum, void* dk,
                void* dv, Dims p, const int64_t* s, cudaStream_t stream) {
  const Strides4 sq = st4(s), sk = st4(s + 4), sv = st4(s + 8),
                 sdo = st4(s + 12), sdk = st4(s + 16), sdv = st4(s + 20);
  if (!(rows16(q, sq, p.b, p.h, p.t, p.d) &&
        rows16(k, sk, p.b, p.hkv, p.tk, p.d) &&
        rows16(v, sv, p.b, p.hkv, p.tk, p.d) &&
        rows16(dout, sdo, p.b, p.h, p.t, p.d) &&
        rows16(dk, sdk, p.b, p.hkv, p.tk, p.d) &&
        rows16(dv, sdv, p.b, p.hkv, p.tk, p.d)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      static_cast<int64_t>((p.tk + MT - 1) / MT) * p.hkv * p.b;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(p.d, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    constexpr size_t smem =
        sizeof(bf16) * 6 * MT * (HD + 8) + sizeof(float) * 4 * MT;
    auto kernel = flash_bwd_dkv_mma_kernel<HD>;
    int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<static_cast<unsigned>(blocks), MTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), p, sq, sk, sv, sdo,
        sdk, sdv);
    return static_cast<int>(cudaGetLastError());
  });
}

bool dims_ok(const Dims& p) {
  return p.d >= 1 && p.d <= DMAX && p.hkv >= 1 && p.h % p.hkv == 0 &&
         p.h <= 65535 && p.b <= 65535 && p.t >= 1 && p.tk >= 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, four per
// tensor in the order (batch, head, seq, feature) of its [B, H, T, D]
// view. float32 takes any strides; every bfloat16 kernel (the forward and
// the backward pair, on the tensor cores) returns cudaErrorInvalidValue
// where one of its bf16 operands breaks rows16 (16-byte rows). lse (and
// D below) are contiguous [B, H, T] float32.
//
// strides: q, k, v, o. Writes o and lse. float32 runs flash_fwd_kernel
// (CUDA cores), bfloat16 flash_fwd_mma_kernel (tensor cores, two m16
// tiles a warp; rows16 for q, k, v and o).
int flash_attention_fwd_launch(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int b,
                               int h, int hkv, int t, int tk, int d,
                               int causal, float scale,
                               const int64_t* strides, void* stream) {
  const Dims p = make_dims(b, h, hkv, t, tk, d, causal, scale);
  if (!dims_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_f32(q, k, v, o, lse, p, strides, st);
  if (dtype == 1) return fwd_mma(q, k, v, o, lse, p, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: q, k, v, o, dout, dq. Writes dq and dsum = rowsum(dout o o).
// float32 runs flash_bwd_dq_kernel (CUDA cores), bfloat16
// flash_bwd_dq_mma_kernel (tensor cores), which returns
// cudaErrorInvalidValue where q, k, v, dout or dq breaks rows16.
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
    return bwd_dq_f32(q, k, v, o, dout, lse, dq, dsum, p, strides, st);
  if (dtype == 1)
    return bwd_dq_mma(q, k, v, o, dout, lse, dq, dsum, p, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: q, k, v, dout, dk, dv. Reads the dsum the dq launch wrote.
// float32 runs flash_bwd_dkv_kernel, bfloat16 flash_bwd_dkv_mma_kernel
// (the same rows16 rule for q, k, v, dout, dk and dv).
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
    return bwd_dkv_f32(q, k, v, dout, lse, dsum, dk, dv, p, strides, st);
  if (dtype == 1)
    return bwd_dkv_mma(q, k, v, dout, lse, dsum, dk, dv, p, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
