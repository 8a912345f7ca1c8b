// Flash-decoding attention for the serving path, hand-written for Hopper.
//
// Replaces the TPU kernel `_decode_kernel` (tony_tpu/ops/attention.py:1231,
// launched by `_decode_pallas` :1265 through `flash_decode` :1294). For
// each batch row b and query head h, the t query rows attend over the
// cached [ctx, d] keys/values of kv head h*hkv/h; key j counts for row i
// iff j <= q_positions[b, i]. Scores (q.k) * scale in f32, an f32 online
// softmax, then acc / (l > 0 ? l : 1), cast to q's type. Forward only.
// The rows of a kv head are grouped [g*t, d] as in the plain version's
// [b, hkv, g*t, d] view (g = h / hkv), so each K/V tile is read once per
// group, not once per query head.
//
// Bound: bytes. A launch must read the K/V rows up to each sequence's
// largest position, plus q and o: ~2*pos*hkv*d*2 bytes a sequence against
// 4*pos*h*d flops, far below the H100's ~295 flop/byte ridge, so the floor
// is those bytes over 3.35 TB/s.
//
// bf16 (the serving path): flash_decode_mma_kernel<HEAD_DIM, RT> on the
// tensor cores, with a split over the cache that changes no bit.
//  * The fold. The key axis is cut at fixed multiples of CHUNK = 256
//    positions. Each chunk's partial state (m_c, l_c, acc_c) is computed
//    from a fresh state (m = -1e30, l = 0, acc = 0) by the online softmax
//    over its 32-key tiles, and a row's result is the left fold, in
//    ascending chunk order, of those partials by one merge (merge_coef /
//    merge_val, base 2, rounding pinned by _rn intrinsics). A chunk whose
//    start lies above the row's position is left out of the fold by
//    position, never by value: with the finite -1e30 mask it would hold
//    p = exp(0) = 1 for every key, junk rather than zeros. So a row's bits
//    depend only on its q, its position and its kv head's K/V: not on t,
//    its row tile, its neighbours, b, or how the launch splits the cache.
//  * The split. The host (`_decode_plan` in ops/attention.py) cuts each
//    row block's chunks into `splits` ranges of `cps` chunks, one block
//    each, when the row blocks alone would fill under half of the blocks
//    the card holds at once (flash_decode_blocks_per_sm below). The block
//    of range 0 folds its chunks itself; with splits == 1 it writes o,
//    else it writes that prefix state to slot 0 of an f32 workspace, and
//    every other block writes each chunk's partial to the chunk's slot.
//    The combine kernel then folds slot 0 and the slots from cps on, in
//    order, and writes o. merge(fresh, x) == x exactly (exp2(-1e30 - m) =
//    0), so the fold gives the same bits at every split count.
//  * Warps. A block holds RT m16 tiles of a kv head's g*t rows: RT = 1
//    where they fit one tile (MHA decode, t = 16), with four warps that
//    share the tile's rows and split its output columns; else RT = 4, one
//    warp a tile. Every warp computes its tile's whole S and softmax, so a
//    row's bits do not depend on RT. The warps share one two-stage ring of
//    32-key K/V tiles filled by 16-byte cp.async copies (keys at or past
//    ctx zero-filled and masked), so the next tile's bytes are in flight
//    during this tile's products. Tiles stay bf16 in shared memory, rows
//    padded by 16 bytes (conflict-free ldmatrix); d is zero-padded to
//    HEAD_DIM (16/32/64/128/256). At HEAD_DIM 128 an RT = 1 block takes
//    49 KB, so four share an SM (16 warps).
//  * Products: mma.sync.m16n8k16 with f32 accumulation. S = Q K^T takes
//    Q's A fragments (ldmatrix.x4) and K as the non-transposed B; P V takes
//    V through ldmatrix.x4.trans. P keeps the reference's precision (P is
//    f32 in the JAX kernel's P.V): it is split into hi = bf16(p) and lo =
//    bf16(p - hi), two products per k16 step, about 16 significant bits of
//    P; l sums the unrounded p. Decode is bound by bytes, so the second
//    product costs no bytes.
//  * Each warp stops at the last tile any of its rows admits, and each row
//    at its last chunk; a tile above every row of the warp would add p = 0
//    with alpha = 1 exactly, so skipping it changes no bit (nor does
//    skipping the rescale by alpha = 1). The running state of the block's
//    fold lives in shared memory, private to each thread, so only a
//    chunk's state and S are held in registers.
//  * What bounds it (one H100, PERF.md): the decode cell reads its K/V at
//    about 2 TB/s, two thirds of the bound's 3.35; more stages, 64-key
//    tiles and an L2::256B prefetch hint moved nothing. Unsplit, the
//    longest sequence's block is also a chain of 64 tiles. TMA bulk copies
//    (fewer load instructions, one barrier a stage) are the next step.
//
// f32: flash_decode_kernel on the CUDA cores (the first design, f32 only):
// K/V tiles of 32 keys widened in shared memory, lane j scores key j for
// its warp's RPW rows, max and sum by butterfly shuffles, each lane d/32
// output columns of P V. Its blocks above every row's position are
// skipped (they would add p = 0 and alpha = 1 exactly). Row independent
// too, in one fixed order.
//
// Plain C interface (built by nvcc into a shared library, called through
// ctypes): flash_decode_launch returns cudaGetLastError() after its
// launches; the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------
// f32 on the CUDA cores.
// ---------------------------------------------------------------------

constexpr int BK = 32;      // keys per shared-memory tile (= warp size)
constexpr int WARPS = 4;    // warps per block
constexpr int RPW = 4;      // query rows per warp
constexpr int ROWS = WARPS * RPW;
constexpr int NC = 8;       // output columns per lane: d <= 32 * NC = 256

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ o, int h, int hkv, int t, int d,
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
      val = q[bi * sq.sb + hq * sq.sh + ti * sq.st + c * sq.sc];
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
  const float* kb = k + bi * sk.sb + kvh * sk.sh;
  const float* vb = v + bi * sv.sb + kvh * sv.sh;
  constexpr int VEC = 4;  // floats per 16-byte load

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < BK * d / VEC; i += blockDim.x) {
      const int j = (i * VEC) / d, c = (i * VEC) % d, key = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < ctx) {
        kx = *reinterpret_cast<const float4*>(kb + key * sk.st + c);
        vx = *reinterpret_cast<const float4*>(vb + key * sv.st + c);
      }
      const float* ke = reinterpret_cast<const float*>(&kx);
      const float* ve = reinterpret_cast<const float*>(&vx);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * (d + 1) + c + e] = ke[e];
        vs[j * d + c + e] = ve[e];
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
    float* orow = o + bi * so.sb + hq * so.sh + ti * so.st;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) orow[c * so.sc] = acc[r][cc] / denom;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* pos,
               void* o, int b, int h, int hkv, int t, int d, int ctx,
               float scale, Strides4 sq, Strides4 sk, Strides4 sv,
               int64_t sp0, int64_t sp1, Strides4 so, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BK * (d + 1) + BK * d + ROWS * d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_rows = (h / hkv) * t;
  const dim3 grid((n_rows + ROWS - 1) / ROWS, hkv, b);
  flash_decode_kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pos),
      static_cast<float*>(o), h, hkv, t, d, ctx, scale, sq, sk, sv, sp0, sp1,
      so);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------

constexpr int CHUNK = 256;   // keys per fold unit: the split's granularity

// Keys per K/V tile of the two-stage ring: a divisor of CHUNK, and one
// size for every instantiation (the tiles are the steps of a chunk's
// online softmax, so a row's bits must not depend on the launch's shape).
// 32 keys timed fastest on the H100 against 16 to 64 keys and 2 to 4
// stages (PERF.md).
constexpr int DK = 32;
static_assert(CHUNK % DK == 0 && DK % 16 == 0, "tiles");

// The work of flash_decode_mma_kernel<HD, RT>'s warps: RT m16 row tiles a
// block, each held by CW warps that share its rows and split its output
// columns (NPW 16-column pairs each). RT = 1 (one row tile a group) takes
// CW = 4 where HD has the columns, so four warps issue the loads and the
// products of P V; RT = 4 takes one warp a row tile. Every warp computes
// its tile's whole S and softmax, so the bits of a row are the same for
// either RT. RUN floats a thread hold the running state of the block's
// fold: its acc columns, then m and l of its two rows.
template <int HD, int RT>
struct Shape {
  static constexpr int CW = RT == 1 ? (HD / 16 < 4 ? HD / 16 : 4) : 1;
  static constexpr int THREADS = RT * CW * 32;
  static constexpr int NPW = HD / 16 / CW;
  static constexpr int RUN = NPW * 8 + 4;
  // Q's RT m16 tiles, the two-stage K and V ring, the running states.
  static constexpr size_t SMEM =
      sizeof(bf16) * (RT * 16 + 4 * DK) * (HD + 8) +
      sizeof(float) * THREADS * RUN;
};

struct DecodeParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* pos;
  bf16* o;
  float* ws;     // [b * hkv * g * t rows][n_chunks][d + 2]: acc, m, l
  int h, hkv, t, d, ctx;
  int n_chunks;  // ceil(ctx / CHUNK)
  int cps;       // chunks per split
  int splits;
  float scale2;  // scale * log2(e): scores in base 2
  Strides4 sq, sk, sv, so;
  int64_t sp0, sp1;
};

// The merge of a running state (m, l, acc) with a chunk's (mc, lc, accc),
// base 2: m' = max(m, mc), x' = x * 2^(m - m') + xc * 2^(mc - m') for x in
// l and each column of acc. Every fold of the bf16 path goes through these
// two functions; the _rn intrinsics keep the compiler from contracting
// them differently at different call sites, so a fold has the same bits in
// the main kernel and in the combine kernel.
struct MergeCoef { float m, a, ac; };

__device__ __forceinline__ MergeCoef merge_coef(float m, float mc) {
  const float mn = fmaxf(m, mc);
  return {mn, exp2f(__fsub_rn(m, mn)), exp2f(__fsub_rn(mc, mn))};
}

__device__ __forceinline__ float merge_val(float x, float xc,
                                           const MergeCoef& c) {
  return __fmaf_rn(x, c.a, __fmul_rn(xc, c.ac));
}

// p as two bf16 pairs: hi = bf16(p) and lo = bf16(p - hi) (p - hi is exact
// in f32), so hi + lo carries about 16 significant bits of p.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

// Keys [k0, k0 + DK) of one (batch, kv head) slice into a bf16 tile with
// row stride HD + 8 by 16-byte cp.async copies, committed by the caller;
// keys at or past ctx and features at or past d are zeros. Each thread
// copies one 16-byte column of every STEP-th row (threads past the tile's
// rows, where STEP > DK, copy nothing).
template <int HD, int THREADS>
__device__ __forceinline__ void load_keys(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int64_t stride, int k0, int ctx,
                                          int d) {
  constexpr int LD = HD + 8, CPR = HD / 8, STEP = THREADS / CPR;
  static_assert(THREADS % CPR == 0 && (DK % STEP == 0 || STEP > DK),
                "copy layout");
  const int c = (threadIdx.x % CPR) * 8, r0 = threadIdx.x / CPR;
  if (STEP > DK && r0 >= DK) return;
  const bf16* s = src + (k0 + r0) * stride + c;
  bf16* t = dst + r0 * LD + c;
#pragma unroll
  for (int j = 0; j < (DK + STEP - 1) / STEP; ++j) {
    const bool ok = c < d && k0 + r0 + j * STEP < ctx;
    cp_async16(t + j * STEP * LD, ok ? s + j * STEP * stride : src,
               ok ? 16 : 0);
  }
}

// One block: RT m16 tiles of the rows of kv head blockIdx.y of batch row
// blockIdx.z / splits, over the chunks of split blockIdx.z % splits.
template <int HD, int RT>
__global__ void __launch_bounds__(Shape<HD, RT>::THREADS)
flash_decode_mma_kernel(const DecodeParams p) {
  using S_ = Shape<HD, RT>;
  constexpr int LD = HD + 8, TILE = DK * LD, CPR = HD / 8;
  constexpr int CW = S_::CW, THREADS = S_::THREADS, NPW = S_::NPW;
  constexpr int RUN = S_::RUN, NA = 2 * NPW;   // acc n8 tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [RT * 16][LD]
  bf16* ks = qs + RT * 16 * LD;                   // [2][DK][LD]
  bf16* vs = ks + 2 * TILE;                       // [2][DK][LD]
  float* run = reinterpret_cast<float*>(vs + 2 * TILE);  // [RUN][THREADS]
  __shared__ int rpos[RT * 16];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp / CW, cw = warp % CW;   // row tile, column part
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = p.h / p.hkv, gt = grp * p.t;
  const int row0 = blockIdx.x * RT * 16, kvh = blockIdx.y;
  const int bi = blockIdx.z / p.splits, split = blockIdx.z % p.splits;

  // Positions of the block's rows; -1 past the group's end (such rows
  // admit nothing and are never stored).
  for (int i = threadIdx.x; i < RT * 16; i += THREADS) {
    const int r = row0 + i;
    rpos[i] = r < gt ? p.pos[bi * p.sp0 + (r % p.t) * p.sp1] : -1;
  }
  __syncthreads();
  int maxp = -1;
  for (int i = 0; i < RT * 16; ++i) maxp = max(maxp, rpos[i]);
  // This block's chunks, cut at the last one any of its rows admits (an
  // unsplit block with none still writes its rows' o, zeros).
  const int c_lo = split * p.cps;
  const int c_hi = min(min(c_lo + p.cps, p.n_chunks),
                       maxp < 0 ? 0 : maxp / CHUNK + 1);
  if (c_lo >= c_hi && p.splits > 1) return;
  const int k_lo = c_lo * CHUNK;
  int k_hi = min(c_hi * CHUNK, p.ctx);
  if (maxp < k_hi) k_hi = maxp + 1;
  const int n_tiles = (k_hi - k_lo + DK - 1) / DK;

  const bf16* kb = p.k + bi * p.sk.sb + kvh * p.sk.sh;
  const bf16* vb = p.v + bi * p.sv.sb + kvh * p.sv.sh;
  for (int i = threadIdx.x; i < RT * 16 * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, gr = row0 + r;
    const bool ok = gr < gt && c < p.d;
    const bf16* src = p.q;
    if (ok)
      src += bi * p.sq.sb + (kvh * grp + gr / p.t) * p.sq.sh +
             (gr % p.t) * p.sq.st + c;
    cp_async16(qs + r * LD + c, src, ok ? 16 : 0);
  }
  if (n_tiles > 0) {
    load_keys<HD, THREADS>(ks, kb, p.sk.st, k_lo, p.ctx, p.d);
    load_keys<HD, THREADS>(vs, vb, p.sv.st, k_lo, p.ctx, p.d);
  }
  cp_async_commit();

  // The warp's rows: positions of this thread's rows g and g + 8, and the
  // tile's largest position and smallest admitting one.
  const int wr = mt * 16, col0 = cw * NPW * 16;
  const int pr[2] = {rpos[wr + g], rpos[wr + g + 8]};
  int wmax = -1, wmin = INT_MAX;
  for (int i = 0; i < 16; ++i) {
    const int x = rpos[wr + i];
    wmax = max(wmax, x);
    if (x >= 0) wmin = min(wmin, x);
  }
  // This thread's running state: acc element (j, e) at [j * 4 + e], m and
  // l of row i at [NA * 4 + i] and [NA * 4 + 2 + i]; stride THREADS.
  const bool fold_here = split == 0;
  float* my_run = run + threadIdx.x;
  if (fold_here) {
    for (int e = 0; e < NA * 4; ++e) my_run[e * THREADS] = 0.f;
    my_run[(NA * 4) * THREADS] = my_run[(NA * 4 + 1) * THREADS] = NEG_INF;
    my_run[(NA * 4 + 2) * THREADS] = my_run[(NA * 4 + 3) * THREADS] = 0.f;
  }

  // The current chunk's state: rows g and g + 8, base 2 (made fresh at
  // each chunk's first tile, the block's first tile among them).
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NA][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * DK;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      load_keys<HD, THREADS>(ks + nxt * TILE, kb, p.sk.st, k0 + DK, p.ctx,
                             p.d);
      load_keys<HD, THREADS>(vs + nxt * TILE, vb, p.sv.st, k0 + DK, p.ctx,
                             p.d);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (k0 % CHUNK == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;
    if (k0 <= wmax) {
      // S = Q K^T: 16 rows x DK keys.
      float s[DK / 8][4];
#pragma unroll
      for (int j = 0; j < DK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_addr<LD>(qs, wr, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < DK / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, b_addr<LD>(kt, np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      // Online softmax over the tile (a row's keys are spread over the 4
      // lanes of a quad); only a tile past some row's position or past
      // ctx evaluates the mask.
      const bool edge = k0 + DK - 1 > wmin || k0 + DK > p.ctx;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < DK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], p.scale2);
          if (edge) {
            const int key = k0 + j * 8 + 2 * t4 + (e & 1);
            if (!(key <= pr[e >> 1] && key < p.ctx)) x = NEG_INF;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        alpha[i] = exp2f(__fsub_rn(m[i], mx[i]));
        m[i] = mx[i];
        l[i] = __fmul_rn(l[i], alpha[i]);
      }
      // P as the A fragments of P V, hi and lo parts.
      uint32_t ph[DK / 16][4], pl[DK / 16][4];
#pragma unroll
      for (int j = 0; j < DK / 8; ++j) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[e] = exp2f(__fsub_rn(s[j][e], mx[e >> 1]));
          l[e >> 1] = __fadd_rn(l[e >> 1], pv[e]);
        }
        const int kc = j >> 1, f = (j & 1) * 2;
        split_bf16(pv[0], pv[1], ph[kc][f], pl[kc][f]);
        split_bf16(pv[2], pv[3], ph[kc][f + 1], pl[kc][f + 1]);
      }
      // (Scaling by alpha = 1 changes no bit: skipped when no row of the
      // warp moved its max.)
      if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < NA; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = __fmul_rn(acc[j][e], alpha[e >> 1]);
      }
      // acc += P V over the warp's columns: the keys are the contraction,
      // so V comes .trans.
#pragma unroll
      for (int kc = 0; kc < DK / 16; ++kc)
#pragma unroll
        for (int np = 0; np < NPW; ++np) {
          uint32_t bv[4];
          ldsm_x4_t(bv, bt_addr<LD>(vt, kc * 16, col0 + np * 16, lane));
          mma_bf16(acc[2 * np], ph[kc], bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], ph[kc], bv[2], bv[3]);
          mma_bf16(acc[2 * np], pl[kc], bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], pl[kc], bv[2], bv[3]);
        }
    }
    __syncthreads();   // the stage is consumed before it is refilled

    // End of a chunk (or of the block's keys, the rest of the chunk lying
    // above every row's position): fold it, or hand it to the combine.
    const int c = k0 / CHUNK;
    if (((k0 + DK) % CHUNK == 0 || it + 1 == n_tiles) &&
        c * CHUNK <= wmax) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = __fadd_rn(l[i], __shfl_xor_sync(FULL, l[i], 1));
        l[i] = __fadd_rn(l[i], __shfl_xor_sync(FULL, l[i], 2));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (c * CHUNK > pr[i]) continue;   // the row stops before c
        if (fold_here) {
          float* rm = my_run + (NA * 4 + i) * THREADS;
          float* rl = my_run + (NA * 4 + 2 + i) * THREADS;
          const MergeCoef cf = merge_coef(*rm, m[i]);
          *rm = cf.m;
          *rl = merge_val(*rl, l[i], cf);
#pragma unroll
          for (int j = 0; j < NA; ++j)
#pragma unroll
            for (int e = 2 * i; e < 2 * i + 2; ++e)
              my_run[(j * 4 + e) * THREADS] =
                  merge_val(my_run[(j * 4 + e) * THREADS], acc[j][e], cf);
        } else {
          const int gr = row0 + wr + g + 8 * i;
          float* slot = p.ws + ((static_cast<int64_t>(bi) * p.hkv + kvh) *
                                    gt + gr) * p.n_chunks * (p.d + 2) +
                        static_cast<int64_t>(c) * (p.d + 2);
#pragma unroll
          for (int j = 0; j < NA; ++j) {
            const int col = col0 + j * 8 + 2 * t4;
            if (col < p.d)
              *reinterpret_cast<float2*>(slot + col) =
                  make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
          }
          if (cw == 0 && t4 == 0) {
            slot[p.d] = m[i];
            slot[p.d + 1] = l[i];
          }
        }
      }
    }
  }
  cp_async_wait_all();
  if (!fold_here) return;

  // Split 0: o = acc / l_safe when the block holds every chunk, else the
  // prefix state to slot 0 for the combine kernel. A row with a negative
  // position admits no key: its o is 0 (acc 0 over l_safe 1), and the
  // combine kernel reads no slot of it.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = row0 + wr + g + 8 * i;
    if (gr >= gt || (pr[i] < 0 && p.splits > 1)) continue;
    const float mr = my_run[(NA * 4 + i) * THREADS];
    const float lr = my_run[(NA * 4 + 2 + i) * THREADS];
    if (p.splits == 1) {
      const float ls = lr > 0.f ? lr : 1.f;
      bf16* orow = p.o + bi * p.so.sb + (kvh * grp + gr / p.t) * p.so.sh +
                   (gr % p.t) * p.so.st;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int col = col0 + j * 8 + 2 * t4;
        if (col < p.d)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(
              __fdiv_rn(my_run[(j * 4 + 2 * i) * THREADS], ls),
              __fdiv_rn(my_run[(j * 4 + 2 * i + 1) * THREADS], ls));
      }
    } else {
      float* slot = p.ws + ((static_cast<int64_t>(bi) * p.hkv + kvh) * gt +
                            gr) * p.n_chunks * (p.d + 2);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int col = col0 + j * 8 + 2 * t4;
        if (col < p.d)
          *reinterpret_cast<float2*>(slot + col) =
              make_float2(my_run[(j * 4 + 2 * i) * THREADS],
                          my_run[(j * 4 + 2 * i + 1) * THREADS]);
      }
      if (cw == 0 && t4 == 0) {
        slot[p.d] = mr;
        slot[p.d + 1] = lr;
      }
    }
  }
}

// The combine step of a split launch: one warp a row folds slot 0 (the
// prefix state of split 0) and then the chunk partials from slot cps up
// to the row's last chunk, in order, through the same merge, and writes
// o = acc / l_safe. Lane l owns columns 2l + 64j.
__global__ void __launch_bounds__(128)
flash_decode_combine_kernel(const DecodeParams p, int n_rows) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int grp = p.h / p.hkv, gt = grp * p.t;
  const int bi = row / (p.hkv * gt), kvh = row / gt % p.hkv, gr = row % gt;
  const int ti = gr % p.t;
  const int pos = p.pos[bi * p.sp0 + ti * p.sp1];
  const int n = pos < 0 ? 0 : min(p.n_chunks, pos / CHUNK + 1);
  const float* base =
      p.ws + static_cast<int64_t>(row) * p.n_chunks * (p.d + 2);
  float m = NEG_INF, l = 0.f, acc[4][2] = {};
  for (int c = 0; c < n; c = c == 0 ? p.cps : c + 1) {
    const float* slot = base + static_cast<int64_t>(c) * (p.d + 2);
    const MergeCoef cf = merge_coef(m, slot[p.d]);
    m = cf.m;
    l = merge_val(l, slot[p.d + 1], cf);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 2 * lane + 64 * j;
      if (col < p.d) {
        const float2 x = *reinterpret_cast<const float2*>(slot + col);
        acc[j][0] = merge_val(acc[j][0], x.x, cf);
        acc[j][1] = merge_val(acc[j][1], x.y, cf);
      }
    }
  }
  const float ls = l > 0.f ? l : 1.f;
  bf16* orow = p.o + bi * p.so.sb + (kvh * grp + gr / p.t) * p.so.sh +
               ti * p.so.st;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 2 * lane + 64 * j;
    if (col < p.d)
      *reinterpret_cast<uint32_t*>(orow + col) =
          pack_bf16(__fdiv_rn(acc[j][0], ls), __fdiv_rn(acc[j][1], ls));
  }
}

// f(HEAD_DIM) as a std::integral_constant tag.
template <typename F>
int by_head_dim(int d, F&& f) {
  using std::integral_constant;
  if (d <= 16) return f(integral_constant<int, 16>());
  if (d <= 32) return f(integral_constant<int, 32>());
  if (d <= 64) return f(integral_constant<int, 64>());
  if (d <= 128) return f(integral_constant<int, 128>());
  return f(integral_constant<int, 256>());
}

// Lets flash_decode_mma_kernel<HD, RT> take its shared memory on the
// current device: once per device (the attribute stays set on that
// device's module, and setting it costs a launch host time). The caller
// makes the tensors' device current.
template <int HD, int RT>
int set_smem() {
  if (Shape<HD, RT>::SMEM <= 48 * 1024) return 0;
  constexpr int kDevices = 64;
  static std::atomic<bool> set[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kDevices && set[dev].load(std::memory_order_acquire)) return 0;
  err = cudaFuncSetAttribute(flash_decode_mma_kernel<HD, RT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Shape<HD, RT>::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kDevices) set[dev].store(true, std::memory_order_release);
  return 0;
}

template <int HD, int RT>
int launch_mma_rt(const DecodeParams& p, int b, cudaStream_t stream) {
  constexpr size_t smem = Shape<HD, RT>::SMEM;
  auto kernel = flash_decode_mma_kernel<HD, RT>;
  if (int err = set_smem<HD, RT>()) return err;
  const int gt = (p.h / p.hkv) * p.t, n_mt = (gt + 15) / 16;
  const dim3 grid((n_mt + RT - 1) / RT, p.hkv, b * p.splits);
  kernel<<<grid, Shape<HD, RT>::THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const int n_rows = b * p.hkv * gt;
  flash_decode_combine_kernel<<<(n_rows + 3) / 4, 128, 0, stream>>>(p,
                                                                    n_rows);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const DecodeParams& p, int b, int rt, cudaStream_t stream) {
  const int gt = (p.h / p.hkv) * p.t;
  const bool plan_ok =
      (rt == 1 || rt == 4) && p.splits >= 1 && p.cps >= 1 &&
      static_cast<int64_t>(p.splits) * p.cps >= p.n_chunks &&
      static_cast<int64_t>(p.splits - 1) * p.cps < p.n_chunks &&
      static_cast<int64_t>(b) * p.splits <= 65535 &&
      (p.splits == 1 || p.ws != nullptr);
  if (!plan_ok || !rows16(p.q, p.sq, b, p.h, p.t, p.d) ||
      !rows16(p.k, p.sk, b, p.hkv, p.ctx, p.d) ||
      !rows16(p.v, p.sv, b, p.hkv, p.ctx, p.d) ||
      !rows16(p.o, p.so, b, p.h, p.t, p.d) ||
      static_cast<int64_t>(b) * p.hkv * gt > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(p.d, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return rt == 1 ? launch_mma_rt<HD, 1>(p, b, stream)
                   : launch_mma_rt<HD, 4>(p, b, stream);
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (flash_decode_kernel, CUDA cores), 1 = bfloat16
// (flash_decode_mma_kernel, tensor cores). strides: 18 int64 in elements,
// q, k, v (4 each, as [b, h|hkv, t|ctx, d]), positions (2) and o (4).
// k/v need a unit feature stride, 16-byte aligned rows and d % 8 == 0 (the
// wrapper checks); float32 takes q, positions and o with any strides,
// bfloat16 needs q and o laid out as k and v (rows16) and returns
// cudaErrorInvalidValue otherwise. chunk must be CHUNK (the caller's
// workspace follows it). The plan (rt: 1 or 4 m16 row tiles a block;
// splits and cps, chunks per split; ws, the f32 workspace
// [b*hkv*(h/hkv)*t][ceil(ctx/chunk)][d + 2] when splits > 1) is read for
// bfloat16 only.
int flash_decode_launch(int dtype, const void* q, const void* k,
                        const void* v, const void* pos, void* o, void* ws,
                        int b, int h, int hkv, int t, int d, int ctx,
                        float scale, int chunk, int rt, int splits, int cps,
                        const int64_t* strides, void* stream) {
  if (b < 1 || b > 65535 || hkv < 1 || hkv > 65535 || h % hkv || t < 1 ||
      ctx < 1 || d < 8 || d > 256 || d % 8 || chunk != CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides4 sq = st4(strides), sk = st4(strides + 4),
                 sv = st4(strides + 8), so = st4(strides + 14);
  if (dtype == 0)
    return launch_f32(q, k, v, pos, o, b, h, hkv, t, d, ctx, scale, sq, sk,
                      sv, strides[12], strides[13], so, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeParams p{static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const int*>(pos),
                       static_cast<bf16*>(o),
                       static_cast<float*>(ws),
                       h, hkv, t, d, ctx,
                       (ctx + CHUNK - 1) / CHUNK, cps, splits,
                       scale * LOG2E,
                       sq, sk, sv, so, strides[12], strides[13]};
  return launch_mma(p, b, rt, st);
}

// How many blocks of the bf16 kernel for head_dim d and rt (1 or 4) one
// SM holds at once (the planner's unit of a wave), or minus a CUDA error.
int flash_decode_blocks_per_sm(int d, int rt) {
  if (d < 8 || d > 256 || d % 8 || (rt != 1 && rt != 4))
    return -static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(d, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    auto occupancy = [](auto kernel, int threads, size_t smem, int err) {
      int n = 0;
      if (!err)
        err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, threads, smem));
      return err ? -err : n;
    };
    return rt == 1 ? occupancy(flash_decode_mma_kernel<HD, 1>,
                               Shape<HD, 1>::THREADS, Shape<HD, 1>::SMEM,
                               set_smem<HD, 1>())
                   : occupancy(flash_decode_mma_kernel<HD, 4>,
                               Shape<HD, 4>::THREADS, Shape<HD, 4>::SMEM,
                               set_smem<HD, 4>());
  });
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
