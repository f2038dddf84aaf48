// Tile helpers of the int8 block-ELL executor's first design
// (block_ell_spmm_int8.cu, blocksizes off its pipelined executor) for NVIDIA
// Hopper (sm_90a).
//
// One thread block of NT = 256 threads (8 warps) computes a TM x TN = 64 x
// 128 tile of C = A @ B for int8 A (row-major, k contiguous) and int8 B
// (row-major (k, n)). The k axis is walked in chunks of KC = 32, one
// mma.sync.m16n8k32.s32.s8.s8.s32 deep: the s8 x s8 products and their
// int32 sums are exact. Warp w owns the 32 x 32 piece of C at rows
// 32 (w / 4), columns 32 (w % 4): 2 x 4 mma tiles, 4 int32 a thread each,
// in mma.sync's C-fragment layout (see `for_each`).
//
// Staging. mma.sync takes A as 4 consecutive k values of one row packed in
// a 32-bit word and B as 4 consecutive k values of one column. A is staged
// as it is stored (As[row][k]); B is staged transposed (Bs[col][k]): each
// thread reads a 4 (k) x 4 (n) piece of B as four words and transposes it
// in registers with byte permutes. Rows of both are LDW = 12 words (8 words
// of data and 4 of padding), so the fragment loads of a warp hit 32
// different banks. The ragged m, n and k edges, and any k or n that is not
// a multiple of 4, are zero-filled here; nothing is padded in device
// memory.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace i8 {

constexpr int TM = 64;   // rows of C per thread block
constexpr int TN = 128;  // columns of C per thread block
constexpr int KC = 32;   // k-chunk staged in shared memory: one mma deep
constexpr int NT = 256;  // threads per block: 8 warps, 2 (rows) x 4 (columns)
constexpr int LDW = 12;  // words per staged row: 8 of data, 4 of padding

// int32 accumulators of one thread: [m16 tile][n8 tile][fragment element]
using Acc = int[2][4][4];

// The 4 int8 at p packed little-endian into a word; the bytes at or past
// `n` are 0 (n <= 0 reads nothing).
__device__ __forceinline__ uint32_t load4(const int8_t* p, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < n) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * i);
  }
  return w;
}

// A chunk into As: rows [0, TM) of `a` (row stride lda), columns
// [k0, k0 + KC); rows at or past `rows` and columns at or past `kmax` are 0.
__device__ __forceinline__ void stage_a(uint32_t* As, const int8_t* __restrict__ a,
                                        size_t lda, int rows, int kmax, int k0) {
  for (int e = threadIdx.x; e < TM * (KC / 4); e += NT) {
    const int r = e / (KC / 4), w = e % (KC / 4);
    const int col = k0 + 4 * w;
    As[r * LDW + w] = load4(a + r * lda + col, r < rows ? kmax - col : 0);
  }
}

// B chunk into Bs, transposed: Bs[j][w] packs B[k0 + 4w .. k0 + 4w + 3][n0 + j].
// `b` is row 0 of the k range (row stride ldb); rows at or past `krows` and
// columns at or past `ncols` are 0.
__device__ __forceinline__ void stage_b(uint32_t* Bs, const int8_t* __restrict__ b,
                                        size_t ldb, int krows, int ncols, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  const int kg = lane % 8;                        // k rows 4 kg .. 4 kg + 3
  const int ng = (threadIdx.x / 32) * 4 + lane / 8;  // columns 4 ng .. 4 ng + 3
  const int col = n0 + 4 * ng;
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kr = k0 + 4 * kg + j;
    r[j] = load4(b + kr * ldb + col, kr < krows ? ncols - col : 0);
  }
  // 4 x 4 byte transpose: word c of the result holds column c's 4 k values
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  uint32_t* dst = Bs + 4 * ng * LDW + kg;
  dst[0 * LDW] = __byte_perm(t0, t2, 0x5410);
  dst[1 * LDW] = __byte_perm(t0, t2, 0x7632);
  dst[2 * LDW] = __byte_perm(t1, t3, 0x5410);
  dst[3 * LDW] = __byte_perm(t1, t3, 0x7632);
}

// acc += this warp's 32 x 32 piece of As (TM x KC) @ Bs^T (TN x KC).
__device__ __forceinline__ void mma_chunk(Acc& acc, const uint32_t* As, const uint32_t* Bs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma.sync's groupID, threadID_in_group
  uint32_t a[2][4], b[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t* p = As + (32 * (warp / 4) + 16 * i + g) * LDW + t;
    a[i][0] = p[0];            // row g,     k 4t .. 4t + 3
    a[i][1] = p[8 * LDW];      // row g + 8, k 4t .. 4t + 3
    a[i][2] = p[4];            // row g,     k 16 + 4t ..
    a[i][3] = p[8 * LDW + 4];  // row g + 8, k 16 + 4t ..
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t* p = Bs + (32 * (warp % 4) + 8 * j + g) * LDW + t;
    b[j][0] = p[0];  // column g, k 4t .. 4t + 3
    b[j][1] = p[4];  // column g, k 16 + 4t ..
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma16::mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
}

// FN(i, j, e, row, col) for each accumulator element of this thread, with
// its row and column inside the block's TM x TN tile (C-fragment layout:
// elements 0, 1 on row g, 2, 3 on row g + 8; columns 2t, 2t + 1).
template <typename Fn>
__device__ __forceinline__ void for_each(Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(i, j, e, 32 * (warp / 4) + 16 * i + g + 8 * (e / 2),
           32 * (warp % 4) + 8 * j + 2 * t + e % 2);
}

}  // namespace i8
