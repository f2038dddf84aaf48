// Warp-level tensor-core and staging instructions for NVIDIA Hopper
// (sm_90a), wrapped one to a function: the `mma.sync` products (m16n8k16
// bf16 and m16n8k8 tf32 with fp32 accumulators, m16n8k32 s8 with int32
// ones), `ldmatrix` operand loads, `cp.async` staging, a named barrier, the
// 3xTF32 split and two exact conversions. The attention tiles (attention_mma.cuh), the int8
// tiles (int8_tiles.cuh) and the int8 executor (block_ell_spmm_int8.cu)
// build on them.
//
// Fragment layout of m16n8k16 bf16 (row.col), lane = 4 g + t:
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//                           a[2] = (g, 2t+8..),   a[3] = (g+8, 2t+8..);
//   B (16 x 8, k by n):     b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g);
//   C (16 x 8, fp32):       c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..).
// Each 32-bit register holds two bf16, the lower column (or k) in the low
// half. So a C fragment of one product, rounded to bf16 pair by pair, is the
// A fragment of the next one: the flash-attention P tile never leaves the
// registers.
//
// Fragment layout of m16n8k8 tf32 (row.col), one fp32 value a register:
//   A (16 x 8): a[0] = (g, t), a[1] = (g+8, t), a[2] = (g, t+4), a[3] = (g+8, t+4);
//   B (8 x 8):  b[0] = (k t, n g), b[1] = (k t+4, n g);
//   C: as m16n8k16's. An 8 x 4 fp32 block is an 8 x 8 b16 matrix to
// `ldmatrix`, and lane (g, t) receives its element (g, t): the A fragment
// and the K-major B fragment load with ldsm_x4 as the bf16 ones do.
//
// Fragment layout of m16n8k32 s8 (row.col): as m16n8k16's with four int8 a
// register where bf16 has two (a[0] = (g, k 4t..4t+3), ...; C int32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and register j receives its piece of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores: bf16 operands, products exact in fp32,
// fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores, tf32 operands (the top 19 bits of each
// fp32 register), fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the s8 tensor cores: m16n8k32, exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi = tf32(x) rounded to nearest (ties away), as an fp32 bit
// pattern, and lo = x - hi, exact in fp32; the tensor cores read lo's top
// 19 bits, within 2^-10 of lo, so a product a.b taken as three tf32 mma,
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, is within ~2^-21 of a.b (3xTF32).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(x)));
  hi = r & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// Two fp32 rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four int8 (one 32-bit word, byte i = element i) as two bf16 pairs,
// exactly: each byte biased to x + 128 is placed in the mantissa of 2^23,
// 2^23 + 128 is subtracted in fp32, and the top half of the (integer,
// |x| <= 128) result is its bf16. Eleven integer and fp32 operations for
// four values, where the conversion units would take four I2F and two F2F.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float magic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - magic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - magic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - magic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - magic;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// 16 bytes global -> shared without passing through registers; src_bytes
// 0 fills the destination with zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads') over the first `n` threads to
// reach it (a multiple of 32): a team of warps waits for its own members
// only, and their shared-memory writes before it are visible after it.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace mma16
