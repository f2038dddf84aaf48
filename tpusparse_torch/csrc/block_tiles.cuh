// The FFMA tile shared by the float block-SpMM executors for NVIDIA Hopper
// (sm_90a) that keep one chain of roundings: block_ell_spmm_batched.cu (a
// 3-D B under one plan), block_ell_spmm_compact.cu (the padding-free plan)
// and, for its conversions, tiers and dtype dispatch, window_tiles.cuh (the
// register tile of block_ell_spmm_grouped.cu and block_ell_spmm_footprint.cu,
// which keep the same chain). block_ell_spmm.cu, the 2-D executor of the
// ELL plan, runs on the tensor cores (wgmma_tiles.cuh) and sums in another
// order: the four FFMA executors are bitwise equal to each other and within
// the tier of it.
//
// One thread block of NT = 256 threads owns a 64-row slice of a row-block
// and a 64-column n-tile of C. Each thread keeps a 4x4 register tile of the
// slice. One slot (an A block times the B rows of its block-column) is added
// by `accumulate_slot`: k in ascending 16-wide chunks, the A chunk staged
// transposed and the B chunk row-major in shared memory, both in fp32, then
// 16 FFMAs per thread per k step, `acc = fmaf(a, b, acc)` in ascending k.
// Every executor that adds a row-block's slots in ascending column order
// through this function (or window_tiles.cuh's copy of its chain)
// therefore gives each output element the same chain of roundings, and so
// the same bits.
//
// Precision tiers: fp32 FFMA ('high'/'highest', never TF32); with ROUND_BF16
// ('default') both operands are rounded to bf16 (RTN) as they are staged,
// their products are exact in fp32, and the sums are fp32. The ragged m, k
// and n edges and a block's k edge are masked with zeros here; B is never
// padded or copied.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace tiles {

constexpr int BM_T = 64;  // output rows per thread block (slice of a row-block)
constexpr int BN_T = 64;  // output columns per thread block
constexpr int BK_T = 16;  // k-chunk staged in shared memory
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int NT = (BM_T / TM) * (BN_T / TN);  // 256 threads
constexpr int A_LD = BM_T + 4;  // padded row of the transposed A chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool ROUND_BF16>
__device__ __forceinline__ float tier(float x) {
  if constexpr (ROUND_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct alignas(16) Staging {
  float As[BK_T][A_LD];  // A chunk, k-major
  float Bs[BK_T][BN_T];  // B chunk, row-major
};

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[a][j] = 0.f;
}

// acc += A_blk[r0 : r0 + rows, :] @ B[kb : kb + bk, n0 : n0 + BN_T] for one
// slot. a_blk points at row r0 of the (bm, bk) block, row stride bk; b at
// the (k, n) row-major operand. All NT threads of the block must call it.
template <typename TA, typename TB, bool ROUND_BF16>
__device__ __forceinline__ void accumulate_slot(
    float (&acc)[TM][TN], Staging& st, const TA* __restrict__ a_blk, int rows,
    int bk, const TB* __restrict__ b, int kb, int k, int n, int n0) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN_T / TN);
  const int ty = tid / (BN_T / TN);
  for (int k0 = 0; k0 < bk; k0 += BK_T) {
    for (int e = tid; e < BM_T * BK_T; e += NT) {
      const int r = e / BK_T, q = e % BK_T;
      float v = 0.f;
      if (r < rows && k0 + q < bk) {
        v = tier<ROUND_BF16>(to_f32(a_blk[static_cast<size_t>(r) * bk + k0 + q]));
      }
      st.As[q][r] = v;
    }
    for (int e = tid; e < BK_T * BN_T; e += NT) {
      const int q = e / BN_T, col = e % BN_T;
      const int kr = kb + k0 + q, cn = n0 + col;
      float v = 0.f;
      if (k0 + q < bk && kr < k && cn < n) {
        v = tier<ROUND_BF16>(to_f32(b[static_cast<size_t>(kr) * n + cn]));
      }
      st.Bs[q][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BK_T; ++q) {
      const float4 av = *reinterpret_cast<const float4*>(&st.As[q][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&st.Bs[q][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[a][j] = fmaf(ar[a], br[j], acc[a][j]);
    }
    __syncthreads();
  }
}

// C[row0 + r, n0 + col] = acc for the thread's elements with r < rows,
// row0 + r < m and n0 + col < n. c points at the (m, n) row-major output.
template <typename TC>
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN], TC* __restrict__ c,
                                           int row0, int rows, int m, int n, int n0) {
  const int tx = threadIdx.x % (BN_T / TN);
  const int ty = threadIdx.x / (BN_T / TN);
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = ty * TM + a;
    const int grow = row0 + r;
    if (r >= rows || grow >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cn = n0 + tx * TN + j;
      if (cn < n) store(&c[static_cast<size_t>(grow) * n + cn], acc[a][j]);
    }
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<TA>, Tag<TB>, Tag<TC>, std::bool_constant<ROUND_BF16>) for the
// dtype codes (0 = float32, 1 = bfloat16) of the values, B and C; returns
// cudaErrorInvalidValue for an unknown code and 0 otherwise.
template <typename F>
int dispatch(int vals_dtype, int b_dtype, int c_dtype, int round_bf16, F&& f) {
  auto on_round = [&](auto ta, auto tb, auto tc) -> int {
    if (round_bf16) {
      f(ta, tb, tc, std::true_type{});
    } else {
      f(ta, tb, tc, std::false_type{});
    }
    return 0;
  };
  auto on_c = [&](auto ta, auto tb) -> int {
    if (c_dtype == 0) return on_round(ta, tb, Tag<float>{});
    if (c_dtype == 1) return on_round(ta, tb, Tag<__nv_bfloat16>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  auto on_b = [&](auto ta) -> int {
    if (b_dtype == 0) return on_c(ta, Tag<float>{});
    if (b_dtype == 1) return on_c(ta, Tag<__nv_bfloat16>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (vals_dtype == 0) return on_b(Tag<float>{});
  if (vals_dtype == 1) return on_b(Tag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tiles
