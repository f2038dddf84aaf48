// Attention tiles on the tensor cores for NVIDIA Hopper (sm_90a), beside
// the FFMA tiles of attention_tiles.cuh: the pieces both tensor-core
// attention forwards share (flash_attention_q8.cu's flash_q8 and
// flash_attention.cu's flash_fwd): the 128-row q-tile of eight warps over
// 64-key k-tiles, the bf16 score and p.v products of a warp, and the online
// softmax of a warp's 16 rows in the log2 domain. The instruction wrappers
// they are built from (mma.sync, ldmatrix, cp.async) are in mma_sync.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tiles.cuh"
#include "mma_sync.cuh"

namespace mma16 {

constexpr int BQ = 128;      // query rows a block, 16 a warp
constexpr int BK = 64;       // keys a tile
constexpr int NTHR = 256;    // eight warps
constexpr float LOG2E = 1.4426950408889634f;

// k-tiles a q-tile starting at row q0 visits: all of them, or under causal
// masking those up to the last key its last row can see.
__device__ __forceinline__ int visited_k_tiles(int s, int q0, int causal, int q_off,
                                               int kv_off) {
  const int nk = (s + BK - 1) / BK;
  if (!causal) return nk;
  const long long kmax = static_cast<long long>(q_off) + q0 + BQ - 1 - kv_off;
  if (kmax < 0) return 0;
  return static_cast<int>(min(static_cast<long long>(nk), kmax / BK + 1));
}

// sacc[nt] += Q[warp rows] . K[keys 8 nt ..]^T over the first kd (a
// multiple of 16) columns of the staged bf16 tiles.
template <int DMAX, int LD>
__device__ __forceinline__ void score_tile(float (&sacc)[BK / 8][4], const __nv_bfloat16* Qs,
                                           const __nv_bfloat16* Kb, int kd, int wr0, int lane) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (16 * kk >= kd) break;
    uint32_t a[4];
    ldsm_x4(a, Qs + (wr0 + lane % 16) * LD + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Kb + (16 * np + lane % 8 + 8 * (lane / 16)) * LD + 16 * kk + 8 * ((lane / 8) % 2));
      mma_bf16(sacc[2 * np], a, b[0], b[1]);
      mma_bf16(sacc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// oacc[nt] += P . V[:, 8 nt ..] over the first kd (a multiple of 16) columns
// of the staged bf16 V; P is the warp's probabilities in sacc, rounded to
// bf16 here.
template <int DMAX, int LD>
__device__ __forceinline__ void pv_tile(float (&oacc)[DMAX / 8][4], const float (&p)[BK / 8][4],
                                        const __nv_bfloat16* Vb, int kd, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      if (16 * dp >= kd) break;
      uint32_t b[4];
      ldsm_x4_t(b, Vb + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 16 * dp +
                       8 * (lane / 16));
      mma_bf16(oacc[2 * dp], a, b[0], b[1]);
      mma_bf16(oacc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// 2^x on the MUFU unit, one instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keys visible to row qp (0 for a row past s): key j is visible when
// j < s and, under causal masking, kv_off + j <= q_off + qp.
__device__ __forceinline__ int key_limit(int qp, int s, int causal, int q_off, int kv_off) {
  if (qp >= s) return 0;
  if (!causal) return s;
  const long long lim = static_cast<long long>(q_off) + qp - kv_off + 1;
  return static_cast<int>(max(-(1LL << 30), min(static_cast<long long>(s), lim)));
}

// The online softmax of a warp's 16 rows over one k-tile: sacc holds q.k
// (rows g and g + 8, keys 8 nt + 2 t + c), and leaves with p = exp(s - m),
// s = q.k * scale_s, in fp32; m, l and oacc are brought up to date. MASK:
// keys at or past lim[h] (row g, g + 8) score -1e30 and take p = 0 exactly. exp(x - m) is taken as
// 2^(x log2e - m log2e), one FFMA and one MUFU op.
template <bool MASK, int NO>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 8][4], float (&oacc)[NO][4],
                                             float (&m)[2], float (&l)[2], float scale_s,
                                             int key0, const int (&lims)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lim = lims[h];
    float mx = attn::NEG;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = sacc[nt][2 * h + c] * scale_s;
        if (MASK && key0 + 8 * nt + c >= lim) x = attn::NEG;
        sacc[nt][2 * h + c] = x;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[h], quad_max(mx));
    const float mb = m_new * LOG2E;
    const float corr = ex2((m[h] - m_new) * LOG2E);  // 1 while both are -1e30
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p = ex2(fmaf(sacc[nt][2 * h + c], LOG2E, -mb));
        if (MASK && key0 + 8 * nt + c >= lim) p = 0.f;
        rs += p;
        sacc[nt][2 * h + c] = p;
      }
    l[h] = corr * l[h] + quad_sum(rs);
    m[h] = m_new;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      oacc[nt][2 * h] *= corr;
      oacc[nt][2 * h + 1] *= corr;
    }
  }
}

}  // namespace mma16
