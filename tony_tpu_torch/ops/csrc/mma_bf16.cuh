// bf16 tensor-core building blocks shared by the hand-written Hopper
// kernels of this directory (flash_attention.cu, flash_decode.cu): the
// strides of a [B, H, T, D] view and the 16-byte row rule, 16-byte
// cp.async copies into shared memory, ldmatrix fragment loads,
// mma.sync.m16n8k16 with f32 accumulation, and the fragment address maps
// of the PTX tables. Included by each .cu; ops/_build.py hashes every
// header of this directory into each library's name, so an edit here
// rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;   // the finite mask value of the JAX kernels
constexpr unsigned FULL = 0xffffffffu;

// Element (b, h, t, c) of a [B, H, T, D] view lies at
// b*sb + h*sh + t*st + c*sc.
struct Strides4 { int64_t sb, sh, st, sc; };

inline Strides4 st4(const int64_t* s) {
  return Strides4{s[0], s[1], s[2], s[3]};
}

// Whether a bf16 tensor of n_b x n_h x n_t rows of d features has the
// layout the mma kernels' 16-byte copies and stores need: feature stride
// 1, the stride of every other dimension longer than 1 a multiple of 8
// elements (16 bytes), a 16-byte aligned base, and d % 8 == 0.
inline bool rows16(const void* ptr, Strides4 s, int n_b, int n_h, int n_t,
                   int d) {
  auto ok = [](int64_t stride, int n) { return n == 1 || stride % 8 == 0; };
  return d % 8 == 0 && s.sc == 1 && ok(s.sb, n_b) && ok(s.sh, n_h) &&
         ok(s.st, n_t) && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; bytes past `src_bytes` are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// 4-byte async copy (an f32 of LSE or D); zero when `src_bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every group of this thread but the newest has landed.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (to nearest even), packed low | high.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addresses inside a bf16 tile with row stride LD (elements),
// for lane l (the PTX fragment tables' g = l / 4 and t = l % 4):
//  A, the 16x16 block at rows r0 (M), columns c0 (K):
//    row r0 + l % 16, column c0 + (l / 16) * 8;
//  B, two n8 tiles from a tile whose rows are N and columns K (no
//    .trans): row n0 + l % 8 + (l / 16) * 8, column k0 + (l / 8 % 2) * 8,
//    giving {b0, b1} of n-tile n0, then {b0, b1} of n-tile n0 + 8;
//  B, two n8 tiles from a tile whose rows are K and columns N (.trans):
//    row k0 + l % 8 + (l / 8 % 2) * 8, column n0 + (l / 16) * 8.
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int r0,
                                              int c0, int lane) {
  return tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int n0,
                                              int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
         ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int k0,
                                               int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
         (lane >> 4) * 8;
}

}  // namespace
