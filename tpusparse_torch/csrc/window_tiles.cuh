// The register-tile executor shared by the footprint and grouped block-SpMM
// kernels for NVIDIA Hopper (sm_90a): block_ell_spmm_footprint.cu and
// block_ell_spmm_grouped.cu.
//
// A thread block of NTH threads owns a window of WR rows of C and a
// WN-column n-tile. Each thread keeps its TR x 8 piece of the WR x WN tile
// in registers for the block's whole walk: rows TR * ty + i and columns
// 4 tx + j, WN / 2 + 4 tx + j (tx = t % (WN / 8), ty = t / (WN / 8)), so
// the A loads of a warp are broadcasts and the B loads are conflict-free
// float4s.
//
// The block walks steps, each an A chunk (WR rows x BK_T = 16 deep, staged
// k-major) times a B chunk (16 x WN, row-major), and adds them with
// `acc = fmaf(a, b, acc)` in ascending k, slots in the base plan's order.
// Both executors keep that one chain of roundings, so they are bitwise equal
// to each other on the same plan; the other block executors
// (block_ell_spmm.cuh) sum on the tensor cores, within the tier of it.
// Precision tiers: fp32 FFMA ('high'/'highest', never TF32); in 'default'
// both operands are rounded to bf16 (RTN) as they are staged, their
// products exact in fp32, the sums fp32. The walk is double-buffered
// through registers: the next step's operands are
// loaded into registers before the current step's FFMAs and stored into the
// other half of the buffer after them, one barrier a step, the loads
// in flight during the arithmetic. The staging goes through registers (not
// cp.async) because it rounds to bf16 in the 'default' tier, widens bf16
// inputs and transposes A on the way. Which steps there are, and what rows
// of A and which B rows each reads, is the kernel's walker's business
// (`run_steps`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace tiles {

constexpr int BK_T = 16;  // k of a step's chunks

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

template <int WR_, int WN_, int TR_, int NTH_>
struct WTile {
  static constexpr int WR = WR_;    // rows of the window
  static constexpr int WN = WN_;    // columns of the n-tile
  static constexpr int TR = TR_;    // rows a thread holds (8 columns each)
  static constexpr int NTH = NTH_;  // threads of the block
  static constexpr int CX = WN / 8;                      // threads across the columns
  static_assert((WR / TR) * CX == NTH, "the tile's threads must cover the window");
  static_assert(TR == 1 || TR == 2 || TR == 4, "a thread's rows are one aligned vector");
  static constexpr int AL = WR + 4;                      // padded row of the A chunk
  static constexpr int PA = (WR * BK_T + NTH - 1) / NTH;  // A values a thread stages
  static constexpr int PB = BK_T * WN / NTH;              // B values a thread stages
  static constexpr int A_FLOATS = BK_T * AL;
  static constexpr int B_FLOATS = BK_T * WN;
  static constexpr bool A_EVEN = WR * BK_T % NTH == 0;  // every thread stages PA values

  __device__ static int tid() { return static_cast<int>(threadIdx.x); }

  // The window row behind the thread's A value p (element e = tid + NTH p of
  // the WR x 16 chunk: row e / 16, k e % 16), or -1 past the chunk.
  __device__ static int a_row(int p) {
    const int e = tid() + NTH * p;
    return A_EVEN || e < WR * BK_T ? e / BK_T : -1;
  }

  // The thread's A values: row arow[p] of `base` (row stride bk), k = k0 +
  // tid % 16; -1 rows and k past bk are 0.
  template <typename TA, bool RND>
  __device__ static void load_a(float (&ra)[PA], const TA* __restrict__ base,
                                const int (&arow)[PA], int bk, int k0) {
    const int q = tid() % BK_T;
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      float v = 0.f;
      if (arow[p] >= 0 && k0 + q < bk) {
        v = tier<RND>(to_f32(base[static_cast<size_t>(arow[p]) * bk + k0 + q]));
      }
      ra[p] = v;
    }
  }

  __device__ static void store_a(float* as, const float (&ra)[PA]) {
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int e = tid() + NTH * p;
      if (A_EVEN || e < WR * BK_T) as[(e % BK_T) * AL + e / BK_T] = ra[p];
    }
  }

  // The thread's B values of the 16 x WN chunk at B row kb + k0: element e =
  // tid + NTH p, k row e / WN, column e % WN; k past bk or past the matrix
  // and columns past n are 0.
  template <typename TB, bool RND>
  __device__ static void load_b(float (&rb)[PB], const TB* __restrict__ b, int kb, int k0,
                                int bk, int k, int n, int n0) {
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const int e = tid() + NTH * p;
      const int q = e / WN, kr = kb + k0 + q, cn = n0 + e % WN;
      float v = 0.f;
      if (k0 + q < bk && kr < k && cn < n) v = tier<RND>(to_f32(b[static_cast<size_t>(kr) * n + cn]));
      rb[p] = v;
    }
  }

  __device__ static void store_b(float* bs, const float (&rb)[PB]) {
#pragma unroll
    for (int p = 0; p < PB; ++p) bs[tid() + NTH * p] = rb[p];
  }

  // acc += A chunk . B chunk in ascending k, for the thread's rows that
  // `act` marks (all of them when FULL).
  template <bool FULL>
  __device__ static void fma_chunk(float (&acc)[TR][8], const float* as, const float* bs,
                                   const bool (&act)[TR]) {
    const int tx = tid() % CX, ty = tid() / CX;
#pragma unroll
    for (int q = 0; q < BK_T; ++q) {
      float ar[TR];
      if constexpr (TR == 4) {
        const float4 v = *reinterpret_cast<const float4*>(&as[q * AL + 4 * ty]);
        ar[0] = v.x, ar[1] = v.y, ar[2] = v.z, ar[3] = v.w;
      } else if constexpr (TR == 2) {
        const float2 v = *reinterpret_cast<const float2*>(&as[q * AL + 2 * ty]);
        ar[0] = v.x, ar[1] = v.y;
      } else {
        ar[0] = as[q * AL + ty];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[q * WN + 4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[q * WN + WN / 2 + 4 * tx]);
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        if (!FULL && !act[i]) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
  }

  __device__ static void zero(float (&acc)[TR][8]) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // C[row0 + lr, n0 + col] = acc for the thread's rows lr = R0 + TR ty + i
  // with lr < rows and row0 + lr < m, and its columns < n.
  template <typename TC>
  __device__ static void store_window(const float (&acc)[TR][8], TC* __restrict__ c,
                                      size_t row0, int R0, int rows, int m, int n, int n0) {
    const int tx = tid() % CX, ty = tid() / CX;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int lr = R0 + TR * ty + i;
      const size_t grow = row0 + lr;
      if (lr >= rows || grow >= static_cast<size_t>(m)) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cn = n0 + (j < 4 ? 4 * tx + j : WN / 2 + 4 * tx + j - 4);
        if (cn < n) store(&c[grow * n + cn], acc[i][j]);
      }
    }
  }
};

// Runs a walker's steps through the tile's double buffer (two A chunks at
// as, as + A_FLOATS; two B chunks at bs, bs + B_FLOATS) and adds them into
// acc. The walker W gives:
//   bool first(Step&)                     the first step; false if none
//   bool next(const Step& cur, Step& nxt)  the step after cur; false at the end
//   void load(const Step&, float (&ra)[T::PA], float (&rb)[T::PB])
//   void fma(float (&acc)[T::TR][8], const float* as, const float* bs, const Step&)
// Every thread of the block must call it.
template <class T, class W>
__device__ __forceinline__ void run_steps(float (&acc)[T::TR][8], float* as, float* bs, W& w) {
  typename W::Step cur, nxt;
  if (!w.first(cur)) return;
  float ra[T::PA], rb[T::PB];
  w.load(cur, ra, rb);
  T::store_a(as, ra);
  T::store_b(bs, rb);
  __syncthreads();
  for (int buf = 0;; buf ^= 1) {
    const bool more = w.next(cur, nxt);
    if (more) w.load(nxt, ra, rb);  // in flight during this step's FFMAs
    w.fma(acc, as + buf * T::A_FLOATS, bs + buf * T::B_FLOATS, cur);
    if (!more) break;
    // into the other half, whose last readers passed the previous barrier
    T::store_a(as + (buf ^ 1) * T::A_FLOATS, ra);
    T::store_b(bs + (buf ^ 1) * T::B_FLOATS, rb);
    __syncthreads();
    cur = nxt;
  }
}

}  // namespace tiles
