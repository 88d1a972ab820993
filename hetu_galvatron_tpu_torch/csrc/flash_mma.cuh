// Tensor-core building blocks of the 16-bit flash kernels (flash_fwd.cu,
// flash_bwd.cu, flash_bwd_dq.cu): warp-level mma.sync m16n8k16 (bf16/fp16
// in, fp32 accumulate), ldmatrix loads of 8x8 16-bit tiles from shared
// memory, and cp.async copies from global to shared memory.
//
// Fragment layouts of mma.m16n8k16 (lane = 32 threads, g = lane / 4,
// t = lane % 4):
//   A 16x16 (row-major M x K): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
//                              a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B 16x8  (K x N):           b0 = (2t..2t+1, g), b1 = (2t+8.., g)
//   C 16x8  (fp32):            c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..)
// Two neighbouring C tiles (n8 tiles 2j, 2j+1) of a row block are therefore
// the A fragment of k-step j of the next product, once rounded to 16 bits:
// P and dS never leave registers (pack_a below).
//
// Shared-memory tiles are [rows][DP + 8] elements: DP, the head dimension
// rounded up to 16, plus a 16-byte pad. A row stride of 16 m + 16 bytes puts
// the 8 rows an ldmatrix reads in 8 distinct 4-bank groups, so every
// ldmatrix (plain or .trans) is free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace galv {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 16-bit matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float c[4],
                                                 const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to the 16-bit type, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x);

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// A fragment of k-step j from the C tiles 2j and 2j+1 of one row block
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// the same fragment as a sum of two 16-bit ones, hi + lo: hi is the value
// rounded to T and lo the rounding error rounded to T, so hi + lo carries
// about twice T's mantissa bits
template <typename T>
__device__ __forceinline__ void pack_a_split(uint32_t hi[4], uint32_t lo[4],
                                             const float c0[4],
                                             const float c1[4]) {
  pack_a<T>(hi, c0, c1);
  float2 h = unpack2<T>(hi[0]);
  lo[0] = pack2<T>(c0[0] - h.x, c0[1] - h.y);
  h = unpack2<T>(hi[1]);
  lo[1] = pack2<T>(c0[2] - h.x, c0[3] - h.y);
  h = unpack2<T>(hi[2]);
  lo[2] = pack2<T>(c1[0] - h.x, c1[1] - h.y);
  h = unpack2<T>(hi[3]);
  lo[3] = pack2<T>(c1[2] - h.x, c1[3] - h.y);
}

// Lane offsets (row, column) into a [rows][ld] tile for the three ways the
// kernels read it with one x4 ldmatrix:
//   a_rows:  A fragment of the 16x16 block at (m0, k0), rows = M (plain)
//   b_rows:  B fragments of two n8 tiles, tile stored [n][k] (plain):
//            r0, r1 = b0, b1 of n-tile n0; r2, r3 of n-tile n0 + 8
//   b_trans: B fragments of two n8 tiles, tile stored [k][n] (.trans):
//            r0, r1 = b0, b1 of n-tile n0; r2, r3 of n-tile n0 + 8
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_col(int lane) {
  return ((lane >> 3) & 1) << 3;
}
__device__ __forceinline__ int bt_row(int lane) {
  return (lane & 7) + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma
}  // namespace galv
