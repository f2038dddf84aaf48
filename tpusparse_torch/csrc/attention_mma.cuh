// Attention tiles on the tensor cores for NVIDIA Hopper (sm_90a), beside
// the FFMA tiles of attention_tiles.cuh: the pieces the three tensor-core
// attention forwards share (flash_attention_q8.cu's flash_q8,
// flash_attention.cu's flash_fwd and block_flash_attention.cu's
// blk_flash_fwd): a warp's 16 query rows over 64-key k-tiles, its score
// and p.v products in each tier (bf16; 3xTF32 for fp32 'high'; bf16
// products of fp32 operands for 'default'), the online softmax of its rows
// in the log2 domain, the staging of q and of K/V rows, and the 3xTF32
// bank. The instruction wrappers they are built from (mma.sync, ldmatrix,
// cp.async) are in mma_sync.cuh.

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
// a key for which visible(h, nt, c) is false (row g + 8h) scores -1e30 and
// takes p = 0 exactly, so a wholly masked tile leaves m, l and oacc as they
// were, even as a row's first (corr = 2^0 = 1 while m is -1e30). exp(x - m)
// is taken as 2^(x log2e - m log2e), one FFMA and one MUFU op.
template <bool MASK, int NO, typename Visible>
__device__ __forceinline__ void softmax_tile_if(float (&sacc)[BK / 8][4], float (&oacc)[NO][4],
                                                float (&m)[2], float (&l)[2], float scale_s,
                                                Visible visible) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = attn::NEG;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
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
    for (int nt = 0; nt < BK / 8; ++nt)
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
template <bool MASK, int NO>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 8][4], float (&oacc)[NO][4],
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

// sacc[nt] += Q[warp rows] . K[keys 8 nt ..]^T in 3xTF32 over the first kd
// columns of fp32 tiles with rows of LD floats (4 x an odd number, so the
// eight rows an ldmatrix reads lie on distinct banks). Each k-step issues
// its three passes over all eight n-tiles in turn, so no mma waits on the
// one before it.
template <int DMAX, int LD>
__device__ __forceinline__ void score_3xtf32(float (&sacc)[BK / 8][4], const float* Qs,
                                             const float* Kb, int kd, int wr0, int lane) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    if (8 * kk >= kd) break;
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, Qs + (wr0 + lane % 16) * LD + 8 * kk + 4 * (lane / 16));
    split_tf32(a, ah, al);
    uint32_t bh[BK / 16][4], bl[BK / 16][4];  // n-tile 2 np: [0..1], 2 np + 1: [2..3]
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Kb + (16 * np + lane % 8 + 8 * (lane / 16)) * LD + 8 * kk +
                     4 * ((lane / 8) % 2));
      split_tf32(b, bh[np], bl[np]);
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mma_tf32(sacc[nt], al, bh[nt / 2][2 * (nt % 2)], bh[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mma_tf32(sacc[nt], ah, bl[nt / 2][2 * (nt % 2)], bl[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mma_tf32(sacc[nt], ah, bh[nt / 2][2 * (nt % 2)], bh[nt / 2][2 * (nt % 2) + 1]);
  }
}

// oacc[dn] += P . V[:, 8 dn ..] in 3xTF32 over the first kd columns of V
// (fp32, rows of LD floats, LD % 32 == 4). The k-step j takes keys 8j + 2t
// as k t and 8j + 2t + 1 as k t + 4, so the score C fragment p[j] is its A
// fragment as it stands, and V's rows are read in the same order. The
// output columns go in groups of GN = 8 n-tiles, each pass over a group in
// turn (groups of 4 or 2 spill at d = 64 under the 128-register cap).
template <int DMAX, int LD>
__device__ __forceinline__ void pv_3xtf32(float (&oacc)[DMAX / 8][4],
                                          const float (&p)[BK / 8][4], const float* Vb, int kd,
                                          int lane) {
  constexpr int GN = 8;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
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
        split_tf32(bits(v0[8 * (d0 + dn)]), bh[dn][0], bl[dn][0]);
        split_tf32(bits(v0[LD + 8 * (d0 + dn)]), bh[dn][1], bl[dn][1]);
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

// sacc[nt] += Q . K^T on bf16 mma: Q staged as bf16 (rows of LDQ), K as
// raw fp32 (rows of LDK, LDK % 32 == 8 so a warp's 8-byte loads hit 32
// banks), rounded to bf16 pairs as its fragments are loaded.
template <int DMAX, int LDQ, int LDK>
__device__ __forceinline__ void score_bf16_f32(float (&sacc)[BK / 8][4],
                                               const __nv_bfloat16* Qs, const float* Kb, int kd,
                                               int wr0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (16 * kk >= kd) break;
    uint32_t a[4];
    ldsm_x4(a, Qs + (wr0 + lane % 16) * LDQ + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float* kr = Kb + (8 * nt + g) * LDK + 16 * kk + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(kr);
      const float2 x1 = *reinterpret_cast<const float2*>(kr + 8);
      mma_bf16(sacc[nt], a, pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y));
    }
  }
}

// oacc[dn] += P . V on bf16 mma, P rounded to bf16 in registers, V raw fp32
// (rows of LD floats, LD % 32 == 4) rounded to bf16 pairs as it is loaded.
template <int DMAX, int LD>
__device__ __forceinline__ void pv_bf16_f32(float (&oacc)[DMAX / 8][4],
                                            const float (&p)[BK / 8][4], const float* Vb, int kd,
                                            int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
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

// The three tiers: how q is staged (type TQ, rows of LDQ), K and V's rows
// (LDK, LDV elements of the operand type T), and a warp's two products.
template <bool ROUND, typename T, int DMAX>
struct Tier;

template <int DMAX>  // fp32 'high'/'highest': 3xTF32
struct Tier<false, float, DMAX> {
  using TQ = float;
  static constexpr int LDQ = DMAX + 4, LDK = DMAX + 4, LDV = DMAX + 4;
  __device__ static void score(float (&sacc)[BK / 8][4], const TQ* Qs, const float* Kb, int kd,
                               int wr0, int lane) {
    score_3xtf32<DMAX, LDQ>(sacc, Qs, Kb, kd, wr0, lane);
  }
  __device__ static void pv(float (&oacc)[DMAX / 8][4], const float (&p)[BK / 8][4],
                            const float* Vb, int kd, int lane) {
    pv_3xtf32<DMAX, LDV>(oacc, p, Vb, kd, lane);
  }
};

template <int DMAX>  // fp32 'default': bf16 products
struct Tier<true, float, DMAX> {
  using TQ = __nv_bfloat16;
  static constexpr int LDQ = DMAX + 8, LDK = DMAX + 8, LDV = DMAX + 4;
  __device__ static void score(float (&sacc)[BK / 8][4], const TQ* Qs, const float* Kb, int kd,
                               int wr0, int lane) {
    score_bf16_f32<DMAX, LDQ, LDK>(sacc, Qs, Kb, kd, wr0, lane);
  }
  __device__ static void pv(float (&oacc)[DMAX / 8][4], const float (&p)[BK / 8][4],
                            const float* Vb, int kd, int lane) {
    pv_bf16_f32<DMAX, LDV>(oacc, p, Vb, kd, lane);
  }
};

template <int DMAX>  // bf16 operands, any tier
struct Tier<true, __nv_bfloat16, DMAX> {
  using TQ = __nv_bfloat16;
  static constexpr int LDQ = DMAX + 8, LDK = DMAX + 8, LDV = DMAX + 8;
  __device__ static void score(float (&sacc)[BK / 8][4], const TQ* Qs, const __nv_bfloat16* Kb,
                               int kd, int wr0, int lane) {
    score_tile<DMAX, LDQ>(sacc, Qs, Kb, kd, wr0, lane);
  }
  __device__ static void pv(float (&oacc)[DMAX / 8][4], const float (&p)[BK / 8][4],
                            const __nv_bfloat16* Vb, int kd, int lane) {
    pv_tile<DMAX, LDV>(oacc, p, Vb, kd, lane);
  }
};

// -- staging and the 3xTF32 bank -----------------------------------------------


// A q-tile (ROWS rows from r0, all DMAX columns) into Qs by NT threads:
// q * scale rounded to q's type, then to the tier's TQ; rows at or past s
// and columns at or past d are 0. Up to 32 loads a thread are issued
// before their stores.
template <int ROWS, int NT, int DMAX, int LD, typename TQ, typename T>
__device__ __forceinline__ void load_q(TQ* dst, const T* __restrict__ src, int r0, int s, int d,
                                       float scale) {
  constexpr int PER = ROWS * DMAX / NT, BATCH = PER < 32 ? PER : 32;
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = threadIdx.x + (i0 + j) * NT, r = e / DMAX, c = e % DMAX;
      x[j] = 0.f;
      if (r0 + r < s && c < d) {
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

// Rows [r0, r0 + BK) of a (s, d) row-major matrix, all DMAX columns, into a
// tile with rows of LD elements, by NT threads; rows at or past s (the
// caller's row bound) and columns at or past d are 0. async: 16-byte
// cp.async copies (d a whole number of 16-byte chunks, src 16-byte
// aligned); else one element a load.
template <int NT, int DMAX, int LD, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int r0, int s,
                                           int d, bool async) {
  if (async) {
    constexpr int E = 16 / sizeof(T), C = DMAX / E;
    for (int e = threadIdx.x; e < BK * C; e += NT) {
      const int r = e / C, c = e % C;
      const bool in = r0 + r < s && c * E < d;
      cp_async16(dst + r * LD + c * E,
                        in ? src + static_cast<size_t>(r0 + r) * d + c * E : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * DMAX; e += NT) {
      const int r = e / DMAX, c = e % DMAX;
      dst[r * LD + c] =
          r0 + r < s && c < d ? src[static_cast<size_t>(r0 + r) * d + c] : from_f32<T>(0.f);
    }
  }
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

template <int NO>
__device__ __forceinline__ void bank(float* ob, float (&oacc)[NO][4], const float (&m)[2],
                                     float (&mb)[2], bool banked, int row, int rows, int d,
                                     int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row + 8 * h;
    const float f = ex2((mb[h] - m[h]) * LOG2E);
    mb[h] = m[h];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * t + c;
        float* p = &ob[static_cast<size_t>(qp) * d + col];
        if (qp < rows && col < d) {
          *p = banked ? fmaf(*p, f, oacc[nt][2 * h + c]) : oacc[nt][2 * h + c];
        }
        oacc[nt][2 * h + c] = 0.f;
      }
  }
}

}  // namespace mma16
