// Attention tiles on the tensor cores for NVIDIA Hopper (sm_90a): the
// pieces the attention kernels share (flash_attention_q8.cu's flash_q8,
// flash_attention.cu's flash_fwd, flash_dq and flash_dkv, and
// block_flash_attention.cu's blk_flash_fwd, blk_flash_dq and
// blk_flash_dkv).
//
// A warp owns 16 rows of a staged A tile and walks tiles of NN x 8 rows of
// a streamed B operand (NN = 8: 64-row tiles, the forwards' k-tiles). Two
// products, each in the three tiers (bf16; 3xTF32 for fp32 'high'; bf16
// products of fp32 operands for 'default'):
//   - score: C[16, 8 NN] += A[warp rows] . B^T, both contracted along their
//     rows (q.k^T in the forwards; q.k^T and do.v^T in the dq kernels;
//     k.q^T and v.do^T in the dk/dv kernels, whose warp rows are keys);
//   - pv: O[16, d] += C . B, the score's C fragment taken as it stands as
//     the A fragment and B's rows read in the same order (p.v in the
//     forwards; dS.k in the dq kernels; p^T.do and dS^T.q in the dk/dv
//     kernels).
// The 3xTF32 products take B either raw (every fragment split into tf32 hi
// and lo as it is loaded) or split at staging (hi and lo tiles, PRE). Also:
// the online softmax of a warp's rows in the log2 domain, the backward's P
// and dS of one tile, the staging of A tiles and of streamed rows (and the
// backward's per-element pass over what a thread staged), the 3xTF32
// bank, and the backward's shared-memory layout and streamed lse and
// delta. The instruction wrappers they are built from
// (mma.sync, ldmatrix, cp.async) are in mma_sync.cuh.

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

// Tiles of TILE keys a q-tile of QT rows starting at row q0 visits: all of
// them, or under causal masking those up to the last key its last row can
// see.
template <int TILE = BK, int QT = BQ>
__device__ __forceinline__ int visited_k_tiles(int s, int q0, int causal, int q_off,
                                               int kv_off) {
  const int nk = (s + TILE - 1) / TILE;
  if (!causal) return nk;
  const long long kmax = static_cast<long long>(q_off) + q0 + QT - 1 - kv_off;
  if (kmax < 0) return 0;
  return static_cast<int>(min(static_cast<long long>(nk), kmax / TILE + 1));
}

// sacc[nt] += A[warp rows] . B[rows 8 nt ..]^T over the first kd (a
// multiple of 16) columns of the staged bf16 tiles (rows of LDA and LDB).
template <int DMAX, int LDA, int LDB = LDA, int NN>
__device__ __forceinline__ void score_tile(float (&sacc)[NN][4], const __nv_bfloat16* As,
                                           const __nv_bfloat16* Bb, int kd, int wr0, int lane) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (16 * kk >= kd) break;
    uint32_t a[4];
    ldsm_x4(a, As + (wr0 + lane % 16) * LDA + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Bb + (16 * np + lane % 8 + 8 * (lane / 16)) * LDB + 16 * kk +
                     8 * ((lane / 8) % 2));
      mma_bf16(sacc[2 * np], a, b[0], b[1]);
      mma_bf16(sacc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// oacc[nt] += P . B[:, 8 nt ..] over the first kd (a multiple of 16) columns
// of the staged bf16 B (8 NN rows of LD); P is the warp's C fragment (the
// probabilities, or dS), rounded to bf16 here.
template <int DMAX, int LD, int NN>
__device__ __forceinline__ void pv_tile(float (&oacc)[DMAX / 8][4], const float (&p)[NN][4],
                                        const __nv_bfloat16* Vb, int kd, int lane) {
#pragma unroll
  for (int kk = 0; kk < NN / 2; ++kk) {
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

// The online softmax of a warp's 16 rows over one k-tile of 8 NN keys: sacc
// holds q.k (rows g and g + 8, keys 8 nt + 2 t + c), and leaves with p =
// exp(s - m), s = q.k * scale_s, in fp32; m, l and oacc are brought up to
// date. MASK: a key for which visible(h, nt, c) is false (row g + 8h) scores
// -1e30 and takes p = 0 exactly, so a wholly masked tile leaves m, l and oacc as they
// were, even as a row's first (corr = 2^0 = 1 while m is -1e30). exp(x - m)
// is taken as 2^(x log2e - m log2e), one FFMA and one MUFU op.
template <bool MASK, int NN, int NO, typename Visible>
__device__ __forceinline__ void softmax_tile_if(float (&sacc)[NN][4], float (&oacc)[NO][4],
                                                float (&m)[2], float (&l)[2], float scale_s,
                                                Visible visible) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = attn::NEG;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = sacc[nt][2 * h + c] * scale_s;
        if (MASK && !visible(h, nt, c)) x = attn::NEG;
        sacc[nt][2 * h + c] = x;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[h], quad_max(mx));
    const float mb = m_new * LOG2E;
    const float corr = ex2((m[h] - m_new) * LOG2E);  // 1 while both are -1e30
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p = ex2(fmaf(sacc[nt][2 * h + c], LOG2E, -mb));
        if (MASK && !visible(h, nt, c)) p = 0.f;
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

// The same with the mask on key positions: key key0 + 8 nt + c (key0 =
// the tile's first key + 2t) is visible to row g + 8h when it lies below
// lims[h].
template <bool MASK, int NN, int NO>
__device__ __forceinline__ void softmax_tile(float (&sacc)[NN][4], float (&oacc)[NO][4],
                                             float (&m)[2], float (&l)[2], float scale_s,
                                             int key0, const int (&lims)[2]) {
  softmax_tile_if<MASK>(sacc, oacc, m, l, scale_s,
                        [&](int h, int nt, int c) { return key0 + 8 * nt + c < lims[h]; });
}

// -- the three tiers of the fp32 and bf16 forwards ---------------------------

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// sacc[nt] += A[warp rows] . B[rows 8 nt ..]^T in 3xTF32 over the first kd
// columns of fp32 tiles with rows of LD floats (4 x an odd number, so the
// eight rows an ldmatrix reads lie on distinct banks). Each k-step issues
// its three passes over all NN n-tiles in turn, so no mma waits on the
// one before it. PRE: B was split at staging, its hi at Bb and its lo at
// Bl (split_tf32's, so the sums are the same bits); else every fragment of
// B is split as it is loaded.
template <int DMAX, int LD, int NN, bool PRE = false>
__device__ __forceinline__ void score_3xtf32(float (&sacc)[NN][4], const float* As,
                                             const float* Bb, int kd, int wr0, int lane,
                                             const float* Bl = nullptr) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    if (8 * kk >= kd) break;
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, As + (wr0 + lane % 16) * LD + 8 * kk + 4 * (lane / 16));
    split_tf32(a, ah, al);
    uint32_t bh[NN / 2][4], bl[NN / 2][4];  // n-tile 2 np: [0..1], 2 np + 1: [2..3]
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      const int off = (16 * np + lane % 8 + 8 * (lane / 16)) * LD + 8 * kk + 4 * ((lane / 8) % 2);
      if constexpr (PRE) {
        ldsm_x4(bh[np], Bb + off);
        ldsm_x4(bl[np], Bl + off);
      } else {
        uint32_t b[4];
        ldsm_x4(b, Bb + off);
        split_tf32(b, bh[np], bl[np]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
      mma_tf32(sacc[nt], al, bh[nt / 2][2 * (nt % 2)], bh[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
      mma_tf32(sacc[nt], ah, bl[nt / 2][2 * (nt % 2)], bl[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
      mma_tf32(sacc[nt], ah, bh[nt / 2][2 * (nt % 2)], bh[nt / 2][2 * (nt % 2) + 1]);
  }
}

// oacc[dn] += P . B[:, 8 dn ..] in 3xTF32 over the first kd columns of B
// (fp32, 8 NN rows of LD floats, LD % 32 == 4). The k-step j takes B's rows
// 8j + 2t as k t and 8j + 2t + 1 as k t + 4, so the score C fragment p[j]
// is its A fragment as it stands, and B's rows are read in the same order.
// The output columns go in groups of GN = 8 n-tiles, each pass over a group
// in turn (groups of 4 or 2 spill at d = 64 under the 128-register cap).
// PRE: B was split at staging, its hi at Vb and its lo at Vl.
template <int DMAX, int LD, int NN, bool PRE = false>
__device__ __forceinline__ void pv_3xtf32(float (&oacc)[DMAX / 8][4], const float (&p)[NN][4],
                                          const float* Vb, int kd, int lane,
                                          const float* Vl = nullptr) {
  constexpr int GN = 8;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    const uint32_t a[4] = {bits(p[j][0]), bits(p[j][2]), bits(p[j][1]), bits(p[j][3])};
    uint32_t ah[4], al[4];
    split_tf32(a, ah, al);
    const float* v0 = Vb + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int d0 = 0; d0 < DMAX / 8; d0 += GN) {
      if (8 * d0 >= kd) break;
      uint32_t bh[GN][2], bl[GN][2];
#pragma unroll
      for (int dn = 0; dn < GN; ++dn) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = r * LD + 8 * (d0 + dn);
          if constexpr (PRE) {
            bh[dn][r] = bits(v0[off]);
            bl[dn][r] = bits(v0[off + (Vl - Vb)]);
          } else {
            split_tf32(bits(v0[off]), bh[dn][r], bl[dn][r]);
          }
        }
      }
#pragma unroll
      for (int dn = 0; dn < GN; ++dn)
        if (8 * (d0 + dn) < kd) mma_tf32(oacc[d0 + dn], al, bh[dn][0], bh[dn][1]);
#pragma unroll
      for (int dn = 0; dn < GN; ++dn)
        if (8 * (d0 + dn) < kd) mma_tf32(oacc[d0 + dn], ah, bl[dn][0], bl[dn][1]);
#pragma unroll
      for (int dn = 0; dn < GN; ++dn)
        if (8 * (d0 + dn) < kd) mma_tf32(oacc[d0 + dn], ah, bh[dn][0], bh[dn][1]);
    }
  }
}

// sacc[nt] += A . B^T on bf16 mma: A staged as bf16 (rows of LDQ), B as
// raw fp32 (rows of LDK, LDK % 32 == 8 so a warp's 8-byte loads hit 32
// banks), rounded to bf16 pairs as its fragments are loaded.
template <int DMAX, int LDQ, int LDK, int NN>
__device__ __forceinline__ void score_bf16_f32(float (&sacc)[NN][4], const __nv_bfloat16* Qs,
                                               const float* Kb, int kd, int wr0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (16 * kk >= kd) break;
    uint32_t a[4];
    ldsm_x4(a, Qs + (wr0 + lane % 16) * LDQ + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      const float* kr = Kb + (8 * nt + g) * LDK + 16 * kk + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(kr);
      const float2 x1 = *reinterpret_cast<const float2*>(kr + 8);
      mma_bf16(sacc[nt], a, pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y));
    }
  }
}

// oacc[dn] += P . B on bf16 mma, P rounded to bf16 in registers, B raw
// fp32 (8 NN rows of LD floats; LD % 32 == 4 keeps the warp's loads on 32
// banks, LD % 32 == 8 costs two-way conflicts) rounded to bf16 pairs as it
// is loaded.
template <int DMAX, int LD, int NN>
__device__ __forceinline__ void pv_bf16_f32(float (&oacc)[DMAX / 8][4], const float (&p)[NN][4],
                                            const float* Vb, int kd, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < NN / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const float* v0 = Vb + (16 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int dn = 0; dn < DMAX / 8; ++dn) {
      if (8 * dn >= kd) break;
      const float* vr = v0 + 8 * dn;
      mma_bf16(oacc[dn], a, pack_bf16(vr[0], vr[LD]), pack_bf16(vr[8 * LD], vr[9 * LD]));
    }
  }
}

// The three tiers: how an A tile is staged (type TQ, rows of LDQ: q in the
// forwards and flash_dq, also do there; k and v in flash_dkv), the rows of
// a streamed B tile (LDK elements of the operand type T for the score's B;
// LDV for the forwards' V, the pv's B), and a warp's two products over a
// B tile of 8 NN rows. The backward reads each streamed tile both as a
// score's B and as a pv's B, so it stages them all with LDK and calls
// pv<LDK>. Rows hold DMAX columns; the products run over DW of them (the
// wide forwards' warps each take a DW-wide slice, the tiles offset to it).
template <bool ROUND, typename T, int DMAX, int DW = DMAX>
struct Tier;

template <int DMAX, int DW>  // fp32 'high'/'highest': 3xTF32
struct Tier<false, float, DMAX, DW> {
  using TQ = float;
  static constexpr int LDQ = DMAX + 4, LDK = DMAX + 4, LDV = DMAX + 4;
  template <int NN>
  __device__ static void score(float (&sacc)[NN][4], const TQ* As, const float* Bb, int kd,
                               int wr0, int lane) {
    score_3xtf32<DW, LDQ>(sacc, As, Bb, kd, wr0, lane);
  }
  template <int LDB = LDV, int NN>
  __device__ static void pv(float (&oacc)[DW / 8][4], const float (&p)[NN][4],
                            const float* Bb, int kd, int lane) {
    pv_3xtf32<DW, LDB>(oacc, p, Bb, kd, lane);
  }
  // the same on a B tile split at staging (split_in_place): hi at Bb, lo at Bl
  template <int NN>
  __device__ static void score(float (&sacc)[NN][4], const TQ* As, const float* Bb,
                               const float* Bl, int kd, int wr0, int lane) {
    score_3xtf32<DW, LDQ, NN, true>(sacc, As, Bb, kd, wr0, lane, Bl);
  }
  template <int LDB = LDV, int NN>
  __device__ static void pv(float (&oacc)[DW / 8][4], const float (&p)[NN][4],
                            const float* Bb, const float* Bl, int kd, int lane) {
    pv_3xtf32<DW, LDB, NN, true>(oacc, p, Bb, kd, lane, Bl);
  }
};

template <int DMAX, int DW>  // fp32 'default': bf16 products
struct Tier<true, float, DMAX, DW> {
  using TQ = __nv_bfloat16;
  static constexpr int LDQ = DMAX + 8, LDK = DMAX + 8, LDV = DMAX + 4;
  template <int NN>
  __device__ static void score(float (&sacc)[NN][4], const TQ* As, const float* Bb, int kd,
                               int wr0, int lane) {
    score_bf16_f32<DW, LDQ, LDK>(sacc, As, Bb, kd, wr0, lane);
  }
  template <int LDB = LDV, int NN>
  __device__ static void pv(float (&oacc)[DW / 8][4], const float (&p)[NN][4],
                            const float* Bb, int kd, int lane) {
    pv_bf16_f32<DW, LDB>(oacc, p, Bb, kd, lane);
  }
};

template <int DMAX, int DW>  // bf16 operands, any tier
struct Tier<true, __nv_bfloat16, DMAX, DW> {
  using TQ = __nv_bfloat16;
  static constexpr int LDQ = DMAX + 8, LDK = DMAX + 8, LDV = DMAX + 8;
  template <int NN>
  __device__ static void score(float (&sacc)[NN][4], const TQ* As, const __nv_bfloat16* Bb,
                               int kd, int wr0, int lane) {
    score_tile<DW, LDQ, LDK>(sacc, As, Bb, kd, wr0, lane);
  }
  template <int LDB = LDV, int NN>
  __device__ static void pv(float (&oacc)[DW / 8][4], const float (&p)[NN][4],
                            const __nv_bfloat16* Bb, int kd, int lane) {
    pv_tile<DW, LDB>(oacc, p, Bb, kd, lane);
  }
};

// The backward's P and dS of one tile of a warp, in place: sp holds the
// product S (rows g + 8h, columns 8 nt + 2t + c of the C fragment) and
// leaves with P = exp(S scale - lse), taken as 2^((S scale) log2e - lse2)
// with lse2 = lse log2e (the forward's score is S scale: scale 1 where q
// was pre-scaled, sm_scale in the block kernels); dp holds dP and leaves
// with dS = P (dP - delta) ds_scale. stat(h, nt, c, lse2, delta) gives an
// element's statistics (a row's in the dq kernels, a column's in the dk/dv
// ones). MASK: an element for which visible(h, nt, c) is false takes P = 0
// exactly, so its dS is 0 (a row that sees no key, lse = -1e30, adds
// nothing anywhere).
template <bool MASK, int NN, typename Stat, typename Visible>
__device__ __forceinline__ void probs_ds(float (&sp)[NN][4], float (&dp)[NN][4], Stat stat,
                                         Visible visible, float scale = 1.f,
                                         float ds_scale = 1.f) {
#pragma unroll
  for (int nt = 0; nt < NN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lse2, dl;
      stat(e / 2, nt, e % 2, lse2, dl);
      float p = ex2(fmaf(sp[nt][e] * scale, LOG2E, -lse2));
      if (MASK && !visible(e / 2, nt, e % 2)) p = 0.f;
      sp[nt][e] = p;
      dp[nt][e] = p * (dp[nt][e] - dl) * ds_scale;
    }
}

// -- staging and the 3xTF32 bank -----------------------------------------------


// A q-tile (ROWS rows from r0, all DMAX columns) into Qs by NT threads:
// q * scale rounded to q's type, then to the tier's TQ; rows at or past s
// and columns at or past w are 0 (w: d, or the width of a column window
// whose first column src points at, the rows still d apart). Up to MAXB
// loads a thread are issued before their stores.
template <int ROWS, int NT, int DMAX, int LD, int MAXB = 32, typename TQ, typename T>
__device__ __forceinline__ void load_q(TQ* dst, const T* __restrict__ src, int r0, int s, int d,
                                       float scale, int w) {
  constexpr int PER = ROWS * DMAX / NT, BATCH = PER < MAXB ? PER : MAXB;
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = threadIdx.x + (i0 + j) * NT, r = e / DMAX, c = e % DMAX;
      x[j] = 0.f;
      if (r0 + r < s && c < w) {
        x[j] = attn::to_f32(from_f32<T>(attn::to_f32(src[static_cast<size_t>(r0 + r) * d + c]) *
                                        scale));
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = threadIdx.x + (i0 + j) * NT, r = e / DMAX, c = e % DMAX;
      dst[r * LD + c] = from_f32<TQ>(x[j]);
    }
  }
}

template <int ROWS, int NT, int DMAX, int LD, typename TQ, typename T>
__device__ __forceinline__ void load_q(TQ* dst, const T* __restrict__ src, int r0, int s, int d,
                                       float scale) {
  load_q<ROWS, NT, DMAX, LD>(dst, src, r0, s, d, scale, d);
}

// Rows [r0, r0 + ROWS) of a (s, d) row-major matrix, all DMAX columns, into
// a tile with rows of LD elements, by NT threads; rows at or past s (the
// caller's row bound) and columns at or past w are 0 (w: d, or the width of
// a column window whose first column src points at). async: 16-byte
// cp.async copies (d a whole number of 16-byte chunks, src 16-byte
// aligned); else one element a load.
template <int NT, int DMAX, int LD, int ROWS = BK, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int r0, int s,
                                           int d, bool async, int w) {
  if (async) {
    constexpr int E = 16 / sizeof(T), C = DMAX / E;
    for (int e = threadIdx.x; e < ROWS * C; e += NT) {
      const int r = e / C, c = e % C;
      const bool in = r0 + r < s && c * E < w;
      cp_async16(dst + r * LD + c * E,
                        in ? src + static_cast<size_t>(r0 + r) * d + c * E : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DMAX; e += NT) {
      const int r = e / DMAX, c = e % DMAX;
      dst[r * LD + c] =
          r0 + r < s && c < w ? src[static_cast<size_t>(r0 + r) * d + c] : from_f32<T>(0.f);
    }
  }
}

template <int NT, int DMAX, int LD, int ROWS = BK, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int r0, int s,
                                           int d, bool async) {
  stage_rows<NT, DMAX, LD, ROWS>(dst, src, r0, s, d, async, d);
}

// fn(o) for the offset o of every element of a tile that this thread
// staged with stage_rows (the same NT, DMAX, LD, ROWS, T and async): the
// backward's work on the tiles it streams, done by the thread that copied
// them once its copies have landed (flash_dkv's q scaled and rounded to
// q's type as the TPU kernel pre-scales it; the 3xTF32 tiles split into
// hi and lo once for every warp). The other threads see the result after
// the next barrier.
template <int NT, int DMAX, int LD, int ROWS, typename T, typename Fn>
__device__ __forceinline__ void each_staged(bool async, Fn fn) {
  if (async) {
    constexpr int E = 16 / sizeof(T), C = DMAX / E;
    for (int e = threadIdx.x; e < ROWS * C; e += NT) {
#pragma unroll
      for (int i = 0; i < E; ++i) fn((e / C) * LD + (e % C) * E + i);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DMAX; e += NT) fn((e / DMAX) * LD + e % DMAX);
  }
}

// x = hi + lo in place: x's slot takes hi = tf32(x) and lo_tile's the rest,
// as split_tf32 splits a fragment.
__device__ __forceinline__ void split_in_place(float* x, float* lo) {
  uint32_t h, l;
  split_tf32(bits(*x), h, l);
  *x = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

// The 3xTF32 path's bank. The tensor cores add an fp32 C with coarser
// rounding than IEEE's: summed through them over s = 4096 keys (192 adds an
// element a k-tile), o drifted 2.4e-5 of scale from the plain version on an
// H100, and a fresh sum a tile, added in IEEE, takes 32 registers more,
// which spill.
// So every FOLD k-tiles a warp adds its running sum, rescaled, into its
// rows of o itself (fp32 on this path, written by this thread alone) and
// restarts from 0: rows (row, row + 8) below `rows`, columns 8 nt + 2t + c.
// mb holds the softmax max the bank was last scaled to. s <= 512 never
// folds; folding every 4 tiles instead cost 9 % at s = 512 on an H100.
constexpr int FOLD = 8;

// The bank's store: rows row + 8h of ob take *p f[h] + acc (acc alone the
// first time), and acc restarts from 0. The warp's columns start at c0 (a
// wide forward's slice).
template <int NO>
__device__ __forceinline__ void bank_add(float* ob, float (&acc)[NO][4], const float (&f)[2],
                                         bool banked, int row, int rows, int d, int t,
                                         int c0 = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row + 8 * h;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c0 + 8 * nt + 2 * t + c;
        float* p = &ob[static_cast<size_t>(qp) * d + col];
        if (qp < rows && col < d) {
          *p = banked ? fmaf(*p, f[h], acc[nt][2 * h + c]) : acc[nt][2 * h + c];
        }
        acc[nt][2 * h + c] = 0.f;
      }
  }
}

// The forwards' bank: the sum rescaled to the running max.
template <int NO>
__device__ __forceinline__ void bank(float* ob, float (&oacc)[NO][4], const float (&m)[2],
                                     float (&mb)[2], bool banked, int row, int rows, int d,
                                     int t, int c0 = 0) {
  float f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f[h] = ex2((mb[h] - m[h]) * LOG2E);
    mb[h] = m[h];
  }
  bank_add(ob, oacc, f, banked, row, rows, d, t, c0);
}

// The backward's bank (flash_dq's dq, flash_dkv's dk and dv): a plain sum,
// *p + acc (fmaf by 1 is one exact add).
template <int NO>
__device__ __forceinline__ void bank(float* ob, float (&acc)[NO][4], bool banked, int row,
                                     int rows, int d, int t) {
  bank_add(ob, acc, {1.f, 1.f}, banked, row, rows, d, t);
}

// -- the forwards at head dims above 128 ----------------------------------------

// The tensor-core forward at d > 128 (flash_attention.cu's
// flash_fwd_wide_tc_kernel, block_flash_attention.cu's
// blk_fwd_wide_tc_kernel): a q-tile of QT = 16 NRG rows, each 16-row group
// served by a team of WPR warps. Warp h of a team owns the DW = DMAX / WPR
// output columns [c0 + DW h, c0 + DW h + DW) of the block's DMAX-wide chunk
// of o (c0 = 0 at d <= DMAX) and the same slice of S's contraction: per key
// tile of W keys it takes its partial S_h = q[:, slice] k[:, slice]^T,
// stores it in shared memory, and after the team's barrier every warp of
// the team sums S = S_0 + S_1 + ... in that order, so all of them hold the
// same bits, run the same online softmax and add P v[:, slice] into their
// own columns. At d <= DMAX the q-tile is staged once and K and V stream in
// two stages of W rows. A wider d (CHUNK) takes one DMAX-wide chunk of o a
// block (blockIdx.z) and S over all of d, DMAX columns at a time
// (score_chunked): ceil(d / DMAX) times one chunk's score work.
template <bool ROUND, typename T, int DMAX_, int WPR_, int NRG_, int W_>
struct WideFwd {
  static constexpr int DMAX = DMAX_, WPR = WPR_, NRG = NRG_, W = W_;
  static constexpr int DW = DMAX / WPR, NW = WPR * NRG, NT = 32 * NW, QT = 16 * NRG;
  static constexpr int NN = W / 8, NO = DW / 8;
  using TR = Tier<ROUND, T, DMAX, DW>;
  using TQ = typename TR::TQ;
  static constexpr size_t q_bytes = sizeof(TQ) * QT * TR::LDQ;
  static constexpr int stage = W * (TR::LDK + TR::LDV);  // elements of T: K, then V
  static constexpr size_t x_off = q_bytes + 2 * sizeof(T) * stage;
  // then the teams' partial scores, one C fragment a warp
  static constexpr size_t bytes = x_off + sizeof(float) * NW * 16 * W;
  // 3xTF32: a warp banks its sums every 512 keys, as the d <= 128 forward does
  static constexpr int FOLD = mma16::FOLD * BK / W;

  // The columns of slice h the products run over in a staged piece w wide:
  // w rounded up to 16, cut to the slice (0 for a slice past w; the staged
  // columns past w are 0).
  __device__ static int kd(int w, int h) { return max(0, min(DW, (w + 15) / 16 * 16 - DW * h)); }

  // The team's sum of its warps' partial scores, in every warp the same
  // bits. X: the teams' partials.
  __device__ static void team_sum(float (&sacc)[NN][4], float* X, int rg, int h, int lane) {
    float4* team = reinterpret_cast<float4*>(X) + rg * WPR * NN * 32;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      team[(h * NN + nt) * 32 + lane] =
          make_float4(sacc[nt][0], sacc[nt][1], sacc[nt][2], sacc[nt][3]);
    }
    bar_sync(1 + rg, 32 * WPR);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      float4 x = team[nt * 32 + lane];
#pragma unroll
      for (int w = 1; w < WPR; ++w) {
        const float4 y = team[(w * NN + nt) * 32 + lane];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      sacc[nt][0] = x.x;
      sacc[nt][1] = x.y;
      sacc[nt][2] = x.z;
      sacc[nt][3] = x.w;
    }
  }

  // S of the warp's 16 rows (team rg, slice h) against the staged K tile
  // at d <= DMAX.
  __device__ static void score(float (&sacc)[NN][4], const TQ* Qs, const T* Kb, float* X, int d,
                               int rg, int h, int wr0, int lane) {
    TR::score(sacc, Qs + DW * h, Kb + DW * h, kd(d, h), wr0, lane);
    team_sum(sacc, X, rg, h, lane);
  }

  // CHUNK: columns [0, w) of the q-tile's rows q0.. at qb (a piece of q,
  // rows d apart) into Qs as load_q stages them: q * scale rounded to q's
  // type, then to TQ; rows at or past s and columns past w 0. async: 16-byte
  // cp.async copies of q as it is (fp32 q on the bf16 tier into Y, the K/V
  // stage score_chunked leaves free), which convert_q turns into that by the
  // thread that copied them once they land, so a piece waits for one round
  // trip; else loads 8 elements a thread at a time, for o's sums are live.
  static constexpr bool RAW_IN_QS = sizeof(TQ) == sizeof(T);
  static constexpr int LY = RAW_IN_QS ? TR::LDQ : DMAX + 4;  // row pitch of the copies
  static_assert(RAW_IN_QS || QT * LY <= stage, "fp32 q's piece must fit in a K/V stage");

  __device__ static void stage_q(TQ* Qs, T* Y, const T* qb, int q0, int s, int d, int w,
                                 float scale, bool async) {
    if (!async) {
      load_q<QT, NT, DMAX, TR::LDQ, 8>(Qs, qb, q0, s, d, scale, w);
      return;
    }
    T* dst = RAW_IN_QS ? reinterpret_cast<T*>(Qs) : Y;
    stage_rows<NT, DMAX, LY, QT>(dst, qb, q0, s, d, true, w);
  }

  __device__ static void convert_q(TQ* Qs, const T* Y, float scale) {
    const T* src = RAW_IN_QS ? reinterpret_cast<const T*>(Qs) : Y;
    constexpr int E = 16 / sizeof(T), C = DMAX / E;
    for (int e = threadIdx.x; e < QT * C; e += NT) {
      const int r = e / C, c = (e % C) * E;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float x = attn::to_f32(from_f32<T>(attn::to_f32(src[r * LY + c + i]) * scale));
        Qs[r * TR::LDQ + c + i] = from_f32<TQ>(x);
      }
    }
  }

  // CHUNK: S of key rows [r0, r0 + W) (those at or past `end` 0) over all of
  // d, DMAX columns at a time: each piece's columns of the q-tile (stage_q)
  // and of the keys staged into Qs and Kb and the warp's partial taken, then
  // the team's sum. extra() stages what else the tile needs (V's chunk, the
  // mask rows) with the first piece; cp.async is awaited before each piece's
  // barrier. Every thread of the block calls it, for it holds the block's
  // barriers; a warp with `skip` set stages and takes no product.
  template <typename Extra>
  __device__ static void score_chunked(float (&sacc)[NN][4], TQ* Qs, T* Kb, T* Y, float* X,
                                       const T* qb, int q0, int s, float scale_q, const T* kb,
                                       int r0, int end, int d, bool async, bool skip, int rg,
                                       int h, int wr0, int lane, Extra extra) {
    for (int c = 0; c < d; c += DMAX) {
      const int w = min(DMAX, d - c);
      __syncthreads();  // every reader of the last piece, of V and of the mask is done
      stage_q(Qs, Y, qb + c, q0, s, d, w, scale_q, async);
      stage_rows<NT, DMAX, TR::LDK, W>(Kb, kb + c, r0, end, d, async, w);
      if (c == 0) extra();
      cp_async_commit();
      cp_async_wait_all();
      if (async) convert_q(Qs, Y, scale_q);
      __syncthreads();
      if (!skip) TR::score(sacc, Qs + DW * h, Kb + DW * h, kd(w, h), wr0, lane);
    }
    if (!skip) team_sum(sacc, X, rg, h, lane);
  }

  // o[:, slice h of the chunk] += P . V[:, slice h], V staged at the
  // chunk's w columns
  __device__ static void pv(float (&oacc)[NO][4], const float (&p)[NN][4], const T* Vb, int w,
                            int h, int lane) {
    TR::pv(oacc, p, Vb + DW * h, kd(w, h), lane);
  }

  // o's rows row, row + 8 below `rows`, the warp's columns from c0 below d:
  // the sum over l (the bank's sum added, rescaled to the final max); with
  // `first` (the team's first warp in the first chunk), lse = m + log(l), or
  // -1e30 for a row that saw no key.
  __device__ static void store(T* ob, float* lse, const float (&oacc)[NO][4], const float (&m)[2],
                               const float (&l)[2], const float (&mb)[2], bool banked, int row,
                               int rows, int d, int c0, bool first, int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qp = row + 8 * hh;
      if (qp >= rows) continue;
      const float den = l[hh] == 0.f ? 1.f : l[hh];
      const float f = ex2((mb[hh] - m[hh]) * LOG2E);  // the bank's factor
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * nt + 2 * t + c;
          if (col >= d) continue;
          T* p = &ob[static_cast<size_t>(qp) * d + col];
          float x = oacc[nt][2 * hh + c];
          if constexpr (!ROUND) {
            if (banked) x = fmaf(*p, f, x);
          }
          attn::store(p, x / den);
        }
      if (first && t == 0) lse[qp] = l[hh] > 0.f ? m[hh] + logf(l[hh]) : attn::NEG;
    }
  }
};

// The two instances. d <= 256: four teams of two warps on a 64-row q-tile,
// 32-key tiles (fp32: 216 KB of shared memory). d > 256: two teams of four
// on a 32-row q-tile, 16-key tiles (206 KB; a 64-row tile at 512 columns
// would not fit), above 512 in 512-wide chunks of o.
template <bool ROUND, typename T, int DMAX>
using WideFwdFor = WideFwd<ROUND, T, DMAX, DMAX <= 256 ? 2 : 4, DMAX <= 256 ? 4 : 2,
                           DMAX <= 256 ? 32 : 16>;

// -- the backward's shared memory and streamed statistics -----------------------

// Shared memory of a backward instance whose warps own ROWS rows: two
// staged A tiles (the dq kernels: q and do; the dk/dv kernels: k and v),
// then two stages of the two streamed B tiles of W rows each (the dq
// kernels: K then V; the dk/dv kernels: q then do), then two stages of the
// streamed rows' lse (log2 domain) and delta (the dk/dv kernels; RowStats).
// W = 64 at d <= 64; 32 at d <= 128, where two stages of 64 rows would not
// fit beside flash's 128-row A tiles (fp32: 270 KB).
//
// PRE (3xTF32 at d <= 64, where SPLIT allows it): the thread that copied a
// value of a streamed tile splits it into tf32 hi and lo once, as it lands
// (hi in place, lo 2W rows on), where otherwise every warp would split
// every fragment it loads. Same bits.
template <bool ROUND, typename T, int DMAX, int ROWS, bool SPLIT = true,
          int W_ = (DMAX <= 64 ? 64 : 32)>
struct BwdLayout {
  using TR = Tier<ROUND, T, DMAX>;
  static constexpr int W = W_;
  static constexpr bool PRE = SPLIT && !ROUND && DMAX <= 64;
  static constexpr int LDB = TR::LDK;  // one row pitch serves the score and the pv
  static constexpr int lo_off = 2 * W * LDB;
  static constexpr size_t a_bytes = sizeof(typename TR::TQ) * ROWS * TR::LDQ;
  static constexpr int stage = (PRE ? 4 : 2) * W * LDB;  // elements of T
  static constexpr size_t b_off = 2 * a_bytes;
  static constexpr size_t stat_off = b_off + 2 * sizeof(T) * stage;
  static constexpr size_t bytes = stat_off + 2 * 2 * W * sizeof(float);
  // 3xTF32: a warp banks its sums every 512 streamed rows (FOLD tiles), so
  // s <= 512 never folds, as in the forward
  static constexpr int FOLD = mma16::FOLD * BK / W;

  // A warp's products over a streamed tile at Bb, its lo at + lo_off where
  // split.
  template <int NN, typename TQ>
  __device__ static void score(float (&acc)[NN][4], const TQ* As, const T* Bb, int kd, int wr0,
                               int lane) {
    if constexpr (PRE) {
      TR::score(acc, As, Bb, Bb + lo_off, kd, wr0, lane);
    } else {
      TR::score(acc, As, Bb, kd, wr0, lane);
    }
  }
  template <int NN>
  __device__ static void pv(float (&acc)[DMAX / 8][4], const float (&p)[NN][4], const T* Bb,
                            int kd, int lane) {
    if constexpr (PRE) {
      TR::template pv<LDB>(acc, p, Bb, Bb + lo_off, kd, lane);
    } else {
      TR::template pv<LDB>(acc, p, Bb, kd, lane);
    }
  }
  // PRE: the thread that copied a value of the streamed tiles at B0 and B1
  // (stage_rows by NT threads) splits it once its copies have landed.
  template <int NT>
  __device__ static void split_staged(T* B0, T* B1, bool async) {
    if constexpr (PRE) {
      each_staged<NT, DMAX, LDB, W, T>(async, [&](int o) {
        split_in_place(B0 + o, B0 + lo_off + o);
        split_in_place(B1 + o, B1 + lo_off + o);
      });
    }
  }
};

// The lse and delta of a streamed tile's W rows: read from device memory
// into a register of thread i < 2W as the tile is staged (row r0 + i % W's
// lse for i < W, else its delta; 0 for rows at or past `rows`), and
// stored beside the tile (lse log2e at [0, W), delta at [W, 2W)) once
// every reader of that stage is done. NT >= 2W.
template <int W>
struct RowStats {
  float x = 0.f;
  __device__ __forceinline__ void load(const float* __restrict__ lse,
                                       const float* __restrict__ delta, int r0, int rows) {
    const int row = r0 + threadIdx.x % W;
    if (threadIdx.x < 2 * W) x = row < rows ? (threadIdx.x < W ? lse[row] : delta[row]) : 0.f;
  }
  __device__ __forceinline__ void store(float* dst) const {
    if (threadIdx.x < 2 * W) dst[threadIdx.x] = threadIdx.x < W ? x * LOG2E : x;
  }
};

// -- the backward at head dims above 128 ----------------------------------------

// The tensor-core backward at d > 128 (flash_attention.cu's
// flash_dq_wide_tc_kernel and flash_dkv_wide_tc_kernel,
// block_flash_attention.cu's blk_dq_wide_tc_kernel and
// blk_dkv_wide_tc_kernel) on WideFwd's teams: the block's RT = 16 NRG
// staged rows (dq: queries; dk/dv: keys) are served a 16-row group by a
// team of WPR warps, and warp h of a team owns the DW = DMAX / WPR output
// columns [DW h, DW h + DW) and the same slice of the two scores'
// contraction. Per streamed tile of W rows it takes its partial
// S_h and dP_h over its slice (dq: q k^T and do v^T; dk/dv: k q^T and
// v do^T), stores both, and after the team's one barrier every warp sums
// each in warp order, so all of them hold the same bits of S and dP, take
// the same P and dS, and add their products into their own columns (dq:
// dS k[:, slice]; dk/dv: P^T do[:, slice] and dS^T q[:, slice]).
//
// Shared memory: the two staged A tiles (dq: q and do; dk/dv: k and v),
// two stages of the two streamed tiles (dq: K then V; dk/dv: q then do),
// one row pitch for the score's B and the pv's B as the d <= 128 backward
// has, the teams' partials (S's, then dP's), and dk/dv's streamed lse and
// delta (RowStats).
template <bool ROUND, typename T, int DMAX_, int WPR_, int NRG_, int W_>
struct WideBwd {
  static constexpr int DMAX = DMAX_, WPR = WPR_, NRG = NRG_, W = W_;
  static constexpr int DW = DMAX / WPR, NW = WPR * NRG, NT = 32 * NW, RT = 16 * NRG;
  static constexpr int NN = W / 8, NO = DW / 8;
  using TR = Tier<ROUND, T, DMAX, DW>;
  using TQ = typename TR::TQ;
  static constexpr int LDB = TR::LDK;
  static constexpr size_t a_bytes = sizeof(TQ) * RT * TR::LDQ;
  static constexpr int stage = 2 * W * LDB;  // elements of T
  static constexpr size_t b_off = 2 * a_bytes;
  static constexpr size_t x_off = b_off + 2 * sizeof(T) * stage;
  static constexpr size_t stat_off = x_off + sizeof(float) * 2 * NW * 16 * W;
  static constexpr size_t bytes = stat_off + 2 * 2 * W * sizeof(float);
  // 3xTF32: a warp banks its sums every 256 streamed rows, half the d <=
  // 128 backward's 512. Summed through the tensor cores over 512 rows,
  // dq, dk and dv drifted 1.01e-5 of scale from the plain version at d 384
  // and 640 on an H100, over FLASH_LIMIT_FP32 (compare_trees.py
  // flash_wide_backward).
  static constexpr int FOLD = mma16::FOLD * BK / (2 * W);
  static_assert(NN % 2 == 0 && NT >= 2 * W, "W: a multiple of 16, at most NT / 2");

  // The columns of slice h the products run over: d rounded up to 16, cut
  // to the slice (0 for a slice past d; the staged columns past d are 0).
  __device__ static int kd(int d, int h) { return max(0, min(DW, (d + 15) / 16 * 16 - DW * h)); }

  // The warp's partial S += A0 . B0^T and dP += A1 . B1^T over its slice
  // (team rg, slice h, cols: kd(w, h) of a staged piece w wide).
  template <typename TB>
  __device__ static void partials(float (&sp)[NN][4], float (&dp)[NN][4], const TQ* A0,
                                  const TQ* A1, const TB* B0, const TB* B1, int cols, int h,
                                  int wr0, int lane) {
    TR::score(sp, A0 + DW * h, B0 + DW * h, cols, wr0, lane);
    TR::score(dp, A1 + DW * h, B1 + DW * h, cols, wr0, lane);
  }

  // The team's sums of its warps' partial S and dP behind one barrier, in
  // every warp the same bits. X: the teams' partials.
  __device__ static void team_sum(float (&sp)[NN][4], float (&dp)[NN][4], float* X, int rg,
                                  int h, int lane) {
    float4* team = reinterpret_cast<float4*>(X) + rg * 2 * WPR * NN * 32;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      team[(h * NN + nt) * 32 + lane] = make_float4(sp[nt][0], sp[nt][1], sp[nt][2], sp[nt][3]);
      team[((WPR + h) * NN + nt) * 32 + lane] =
          make_float4(dp[nt][0], dp[nt][1], dp[nt][2], dp[nt][3]);
    }
    bar_sync(1 + rg, 32 * WPR);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      float4 x = team[nt * 32 + lane], y = team[(WPR * NN + nt) * 32 + lane];
#pragma unroll
      for (int w = 1; w < WPR; ++w) {
        const float4 a = team[(w * NN + nt) * 32 + lane];
        const float4 b = team[((WPR + w) * NN + nt) * 32 + lane];
        x.x += a.x;
        x.y += a.y;
        x.z += a.z;
        x.w += a.w;
        y.x += b.x;
        y.y += b.y;
        y.z += b.z;
        y.w += b.w;
      }
      sp[nt][0] = x.x;
      sp[nt][1] = x.y;
      sp[nt][2] = x.z;
      sp[nt][3] = x.w;
      dp[nt][0] = y.x;
      dp[nt][1] = y.y;
      dp[nt][2] = y.z;
      dp[nt][3] = y.w;
    }
  }

  // CHUNK (d > DMAX): S = A0 . B0^T and dP = A1 . B1^T over all of d, DMAX
  // columns at a time, then the team's sums. Each piece's columns of the
  // staged rows (RT rows from a_r0 of a0 and a1, into A0 and A1; rows at or
  // past s 0) and of the streamed ones (W rows from b_r0 of b0 and b1, into
  // Bs and Bs + W LDB; rows at or past b_end 0: s, or the end of a block
  // kernel's sub-tile) are staged, a0's times a_scale and b0's times
  // b_scale rounded to their type, as the tiles at d <= DMAX are taken.
  // extra() stages what else the tile needs with the first piece (the pv's
  // operands in the output chunk, the statistics, the mask rows) and fix()
  // runs once its copies have landed (it scales them). The A pieces come by
  // cp.async where TQ is T (scaled in place by the thread that copied them),
  // else by loads 8 elements at a time. Every thread of the block calls it,
  // for it holds the block's barriers; a team with `skip` set stages and
  // takes no product.
  template <typename Extra, typename Fix>
  __device__ static void scores_chunked(float (&sp)[NN][4], float (&dp)[NN][4], TQ* A0, TQ* A1,
                                        T* Bs, float* X, const T* a0, const T* a1, int a_r0,
                                        float a_scale, const T* b0, const T* b1, int b_r0,
                                        int b_end, float b_scale, int s, int d, bool async,
                                        bool skip, int rg, int h, int wr0, int lane, Extra extra,
                                        Fix fix) {
    constexpr bool RAW = sizeof(TQ) == sizeof(T);
    const bool async_a = async && RAW;
    auto stage_a = [&](TQ* dst, const T* src, float scale, int w) {
      if (async_a) {
        stage_rows<NT, DMAX, TR::LDQ, RT>(reinterpret_cast<T*>(dst), src, a_r0, s, d, true, w);
      } else {
        load_q<RT, NT, DMAX, TR::LDQ, 8>(dst, src, a_r0, s, d, scale, w);
      }
    };
    auto scale_in_place = [](T* x, float scale) { *x = from_f32<T>(attn::to_f32(*x) * scale); };
    for (int c = 0; c < d; c += DMAX) {
      const int w = min(DMAX, d - c);
      __syncthreads();  // every reader of the last piece and of extra()'s tiles is done
      stage_a(A0, a0 + c, a_scale, w);
      stage_a(A1, a1 + c, 1.f, w);
      stage_rows<NT, DMAX, LDB, W>(Bs, b0 + c, b_r0, b_end, d, async, w);
      stage_rows<NT, DMAX, LDB, W>(Bs + W * LDB, b1 + c, b_r0, b_end, d, async, w);
      if (c == 0) extra();
      cp_async_commit();
      cp_async_wait_all();
      if (async_a && a_scale != 1.f) {
        T* a = reinterpret_cast<T*>(A0);
        each_staged<NT, DMAX, TR::LDQ, RT, T>(true,
                                              [&](int o) { scale_in_place(a + o, a_scale); });
      }
      if (b_scale != 1.f) {
        each_staged<NT, DMAX, LDB, W, T>(async, [&](int o) { scale_in_place(Bs + o, b_scale); });
      }
      if (c == 0) fix();
      __syncthreads();
      if (!skip) partials(sp, dp, A0, A1, static_cast<const T*>(Bs), Bs + W * LDB, kd(w, h), h,
                          wr0, lane);
    }
    if (!skip) team_sum(sp, dp, X, rg, h, lane);
  }

  // acc[:, slice h] += C . B[:, slice h] over a streamed tile at Bb (cols:
  // kd(w, h) of a tile w wide)
  __device__ static void pv(float (&acc)[NO][4], const float (&c)[NN][4], const T* Bb, int cols,
                            int h, int lane) {
    TR::template pv<LDB>(acc, c, Bb + DW * h, cols, lane);
  }

  // The warp's rows row, row + 8 below `rows`, its columns from c0 (the
  // block's chunk) below d: the sum (the bank's added where it banked)
  // times `scale`.
  __device__ static void store(T* ob, const float (&acc)[NO][4], bool banked, int row, int rows,
                               int d, int c0, int h, int t, float scale) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rp = row + 8 * hh;
      if (rp >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + DW * h + 8 * nt + 2 * t + c;
          if (col >= d) continue;
          T* p = &ob[static_cast<size_t>(rp) * d + col];
          float x = acc[nt][2 * hh + c];
          if constexpr (!ROUND) {
            if (banked) x = fmaf(*p, 1.f, x);
          }
          attn::store(p, x * scale);
        }
    }
  }

  // The bank (3xTF32): the warp's sums added into its rows and columns of
  // the output, restarting from 0.
  __device__ static void bank(T* ob, float (&acc)[NO][4], bool banked, int row, int rows, int d,
                              int c0, int h, int t) {
    if constexpr (!ROUND) bank_add(ob, acc, {1.f, 1.f}, banked, row, rows, d, t, c0 + DW * h);
  }
};

// The instances, 256 threads, one block an SM: a warp owns 64 columns (dq's
// sums take 32 registers, dk's and dv's 2 x 32). d <= 256: two teams of
// four on 32 rows, dq's keys streamed 32 a tile, dk/dv's queries 16 (fp32
// 'high': 232,448 and 149,760 bytes of shared memory); d <= 512: one team
// of eight on 16 rows, 16 a tile (214,528 and 214,784 bytes), above 512 in
// 512-wide chunks of the output.
template <bool ROUND, typename T, int DMAX>
using WideDqFor = WideBwd<ROUND, T, DMAX, DMAX <= 256 ? 4 : 8, DMAX <= 256 ? 2 : 1,
                          DMAX <= 256 ? 32 : 16>;
template <bool ROUND, typename T, int DMAX>
using WideDkvFor = WideBwd<ROUND, T, DMAX, DMAX <= 256 ? 4 : 8, DMAX <= 256 ? 2 : 1, 16>;

}  // namespace mma16
