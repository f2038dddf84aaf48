// Tile helpers shared by the fused attention kernels (flash_attention.cu,
// flash_attention_q8.cu, block_flash_attention.cu) for NVIDIA Hopper
// (sm_90a): the FFMA tiles of the block kernels' WIDE backward (head dims
// above 128; every forward, the flash backward and the block backward at
// d <= 128 run on the tensor cores, attention_mma.cuh) and what all of them
// share (the masked score, type conversions, the dispatch over dtype, tier
// and d).
//
// One thread block of NT = 256 threads works on a 64-row tile of queries (or
// keys) against a 64-row tile of the other operand. Each thread owns a 4x4
// piece of the 64x64 score tile, rows ty + 16a and columns tx + 16j with
// (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16), so a row's reductions are
// shuffles inside one half-warp, and the 16-byte shared loads of both
// operands are free of bank conflicts. Operand tiles are staged row-major in
// shared memory as fp32, rows padded to DMAX + 4; probability tiles to
// LDP. Everything here is fp32 FFMA, never TF32.
//
// Head dims above 128. The instances that hold a whole row of d in a tile
// stop at DMAX = 128: a DMAX = 256 instance of this layout needs 283,648
// bytes of shared memory for dq and 301,568 for dk/dv, above the 232,448 a
// block may have, and its output accumulators alone would take 64 (dk/dv:
// 128) registers a thread. So a wider d runs the WIDE instances: DMAX = 128
// with an outer split of the output columns into 128-wide chunks, one chunk
// per blockIdx.z. Each block recomputes the scores and dP over the whole d,
// staging q, k, do and v 128 columns at a time (mma_nt_chunked), and keeps
// only its chunk's accumulators. That costs ceil(d / 128) times the score
// work, and keeps shared memory and registers at the 128 instance's for any
// d; the probabilities are computed the same way by every chunk, so they
// agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int LDP = BK + 4;   // padded row of a p / dS tile
constexpr float NEG = -1e30f;  // the TPU kernels' masked score

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool ROUND>
__device__ __forceinline__ float tier(float x) {
  if constexpr (ROUND) {
    return rnd_bf16(x);
  } else {
    return x;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Causal masking on global positions, as the dense flash kernels take it:
// the number of k-tiles a q-tile starting at row q0 visits (all of them, or
// under causal masking those up to the last key its last row can see), and
// whether key kp is visible from query qp (both inside s and, if causal,
// kv_off + kp <= q_off + qp).
__device__ __forceinline__ int visited_k_tiles(int s, int q0, int causal, int q_off,
                                               int kv_off) {
  const int nk = (s + BK - 1) / BK;
  if (!causal) return nk;
  const long long kmax = static_cast<long long>(q_off) + q0 + BQ - 1 - kv_off;
  if (kmax < 0) return 0;
  return static_cast<int>(min(static_cast<long long>(nk), kmax / BK + 1));
}

__device__ __forceinline__ bool causal_visible(int qp, int kp, int s, int causal, int q_off,
                                               int kv_off) {
  return qp < s && kp < s &&
         (!causal || static_cast<long long>(kv_off) + kp <= static_cast<long long>(q_off) + qp);
}

// Rows [r0, r0 + 64) and columns [c0, c0 + DMAX) of a (s, d) row-major
// matrix into a (64, DMAX + 4) shared tile, each value times `scale` and then
// rounded by the tier; rows at or past `s` (the caller's row bound) and
// columns at or past d are 0.
template <int DMAX, bool ROUND, typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* __restrict__ src, int r0,
                                           int s, int d, int c0, float scale) {
  constexpr int LD = DMAX + 4;
  for (int e = threadIdx.x; e < 64 * DMAX; e += NT) {
    const int r = e / DMAX, c = e % DMAX;
    float x = 0.f;
    if (r0 + r < s && c0 + c < d)
      x = tier<ROUND>(to_f32(src[static_cast<size_t>(r0 + r) * d + c0 + c]) * scale);
    dst[r * LD + c] = x;
  }
}

// acc[a][j] += sum_k A[ty + 16a][k] * B[tx + 16j][k] over k < kd (a multiple
// of 4): both operands row-major, contracted along their rows.
template <int LD>
__device__ __forceinline__ void mma_nt(float (&acc)[4][4], const float* A, const float* B,
                                       int kd, int ty, int tx) {
  for (int k = 0; k < kd; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + k]);
      b[i] = *reinterpret_cast<const float4*>(&B[(tx + 16 * i) * LD + k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[a][4g + c] += sum_j P[ty + 16a][j] * B[j][64g + 4tx + c] over j < 64:
// P a (64, 64) tile with rows of LDP, B a (64, DMAX) tile with rows of
// DMAX + 4.
template <int DMAX>
__device__ __forceinline__ void mma_nn(float (&acc)[4][DMAX / 16], const float* P,
                                       const float* B, int ty, int tx) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  for (int j = 0; j < BK; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(&P[(ty + 16 * i) * LDP + j]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(&B[(j + jj) * LD + 64 * g + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = comp(p[i], jj);
          acc[i][4 * g + 0] = fmaf(pv, b.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv, b.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv, b.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv, b.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// acc[a][j] += sum over all d of A[a0 + ty + 16a][:] * B[b0 + tx + 16j][:]
// for two (., d) row-major matrices whose rows are bounded by a_end and b_end
// and scaled by a_scale and b_scale on load (rounded by RA and RB): the
// score product of a head dim wider than one tile, staged DC columns at a
// time through As and Bs, each a (64, DC + 4) tile. It starts with a
// barrier, so the caller's earlier readers of As and Bs are done, and ends
// after the last chunk's product without one.
template <int DC, bool RA, bool RB, typename TA, typename TB>
__device__ __forceinline__ void mma_nt_chunked(float (&acc)[4][4], float* As, float* Bs,
                                               const TA* __restrict__ A, int a0, int a_end,
                                               float a_scale, const TB* __restrict__ B, int b0,
                                               int b_end, float b_scale, int d, int ty, int tx) {
  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();
    load_chunk<DC, RA>(As, A, a0, a_end, d, c0, a_scale);
    load_chunk<DC, RB>(Bs, B, b0, b_end, d, c0, b_scale);
    __syncthreads();
    mma_nt<DC + 4>(acc, As, Bs, min(DC, (d - c0 + 3) & ~3), ty, tx);
  }
}

// The kernel instance with its dynamic shared memory allowed above 48 KB,
// launched on `stream`; returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NT, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Output chunks of DMAX columns a launch spreads over gridDim.z: one for
// the instances that hold the whole head dim, ceil(d / DMAX) for WIDE.
template <int DMAX, bool WIDE>
constexpr unsigned out_chunks(int d) {
  return WIDE ? static_cast<unsigned>((d + DMAX - 1) / DMAX) : 1u;
}

// Calls FN<DMAX, ROUND, T, WIDE>(args...) for the instance that serves
// (dtype, d, round_bf16): bf16 inputs always round (their p and dS are
// rounded to bf16 in every tier, as on the TPU's non-3-pass tiers). A head
// dim up to 64 takes the 64 instance, up to 128 the 128 instance, and any
// wider one WIDE = true: the block backward's 128 instance, which loops
// over d in 128-wide chunks, or the wide tensor-core forwards and flash
// backward (their own instances).
#define ATTN_DISPATCH_ONE(FN, ROUND, T, ...)                                   \
  do {                                                                         \
    if (d <= 64) return FN<64, ROUND, T, false>(__VA_ARGS__);                  \
    if (d <= 128) return FN<128, ROUND, T, false>(__VA_ARGS__);                \
    return FN<128, ROUND, T, true>(__VA_ARGS__);                               \
  } while (0)

#define ATTN_DISPATCH(FN, ...)                                                   \
  do {                                                                           \
    if (dtype == 0 && !round_bf16) ATTN_DISPATCH_ONE(FN, false, float, __VA_ARGS__); \
    if (dtype == 0) ATTN_DISPATCH_ONE(FN, true, float, __VA_ARGS__);             \
    if (dtype == 1) ATTN_DISPATCH_ONE(FN, true, __nv_bfloat16, __VA_ARGS__);     \
    return static_cast<int>(cudaErrorInvalidValue);                              \
  } while (0)

}  // namespace attn
