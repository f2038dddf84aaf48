// Fused attention for NVIDIA Hopper (sm_90a): the forward
// o = softmax(q k^T sm_scale) v with its per-row logsumexp, and the two
// backward kernels that recompute the probabilities from that logsumexp,
// dq and (dk, dv). The (s, s) score matrix never reaches device memory.
//
// Replaces three TPU kernels of tpusparse/kernels/flash_attention.py:
//   flash_fwd  <- :53  _flash_kernel      (pallas_call l.283)
//   flash_dq   <- :495 _flash_dq_kernel   (pallas_call l.684)
//   flash_dkv  <- :538 _flash_dkv_kernel  (pallas_call l.704)
// The TPU grids ran (bh, q-tile, k-tile) in order and carried the running
// max, denominator and accumulator from one k step to the next in VMEM
// scratch. Here one thread block owns one q-tile (flash_fwd, flash_dq) or
// one k-tile (flash_dkv) of one (batch, head) and runs the whole
// sequential loop over the other axis itself, keeping its accumulators in
// registers. Nothing carries between blocks and there are no atomics:
// every output element is summed in one fixed order, so runs repeat bit
// for bit.
//
// Contract. q, k, v, do: (bh, s, d) row-major, one type (fp32 or bf16);
// lse and delta: (bh, s) fp32. Any d; the ragged s and d edges are masked in
// the loads and stores (the TPU wrapper padded d to a multiple of 128 and s
// to its tile).
//   - q is pre-scaled on load: q * scale_q, where scale_q is sm_scale in
//     q's type, rounded to q's type (tpusparse l.239, l.662).
//   - ROUND ('default' tier, or bf16 inputs): q (pre-scaled), k, v and do
//     are rounded to bf16 on load, and so are p before p.v (forward), dS
//     before dS.k (dq) and p, dS before p^T.do, dS^T.q (dk, dv); products
//     of bf16 values are exact in fp32 and every sum is fp32. Without it
//     ('high', 'highest' on fp32 inputs) the products are fp32-class, never
//     one TF32 pass: 3xTF32 in the forward at d <= 128, fp32 FFMA elsewhere.
//   - Masking on global positions: key j of a row i is visible when
//     j < s and, if causal, kv_off + j <= q_off + i. Masked scores are
//     -1e30 and their probabilities exactly 0; whole tiles above the
//     diagonal are skipped. A row that sees no key gets o = 0,
//     lse = -1e30 and no gradient (the TPU kernel gives such a row the
//     mean of v over the tiles it visits: exp(-1e30 - (-1e30)) = 1).
//   - flash_fwd: o in q's type, lse = m + log(l) in fp32.
//   - flash_dq: dq = sm_scale * sum_k P o (dP - delta) . k, with
//     P = exp(q k^T - lse), dP = do v^T; dq in q's type.
//   - flash_dkv: dv = sum_q P^T do, dk = sum_q dS^T (scaled q); padded q
//     rows (i >= s) contribute nothing (tpusparse l.484).
//
// What bounds them. At BERT-base (bh = 96, s = 512, d = 64) the forward
// does 4 bh s^2 d = 6.4 GFLOP against ~50 MB of compulsory traffic (~0.015
// ms at 3.35 TB/s); dq does 6 bh s^2 d and dk/dv 8 bh s^2 d for about 1.4x
// and 1.7x that traffic. On the fp32-class yardstick of this card, 3xTF32
// at 495 TFLOP/s tf32, the forward's bound is 3 x 6.4 GFLOP = 0.039 ms;
// on FFMA (67 TFLOP/s) 0.096 ms.
//
// flash_fwd at d <= 128 (flash_fwd_tc_kernel) runs on the tensor cores with
// `mma.sync` (attention_mma.cuh), in the layout of flash_attention_q8.cu:
// eight warps own a 128-row q-tile, 16 rows a warp, and the block walks the
// 64-key k-tiles itself, the online-softmax state and the output
// accumulator in registers, exp taken as exp2 with log2(e) folded in, a
// mask-free softmax on tiles that every row of the warp sees whole, causal
// q-tiles started heaviest first. K and V are copied by cp.async in two
// stages, so tile kt + 1 streams in while tile kt computes, one barrier a
// tile (d a multiple of 16 bytes a row and 16-byte aligned operands; other
// d load synchronously). Per tier:
//   - fp32 'high'/'highest': 3xTF32 on `mma.sync.m16n8k8` tf32: each
//     operand x = hi + lo (hi = tf32(x), lo = x - hi), products
//     a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, fp32 sums. The tiles are staged
//     as raw fp32 and every warp splits the fragments it loads, in
//     registers (three ALU operations a value): splitting at staging would
//     double the shared memory, which two blocks an SM need under 113 KB,
//     and the bytes that ldmatrix reads. `mma.sync` and not `wgmma`:
//     tf32 wgmma reads both operands K-major, and V (keys x d, d
//     contiguous) is not, for p.v. P stays in registers: the m16n8k8 C
//     fragment holds keys (2t, 2t + 1) of a row where the A fragment wants
//     (t, t + 4), so the p.v k-step reads its eight keys in the order
//     2t -> t, 2t + 1 -> t + 4, and V's rows in the same order (scalar
//     shared loads, rows padded to d + 4 floats so the warp hits 32
//     banks); the sum over keys takes any order. Every FOLD k-tiles a warp
//     moves its running sum into o (the bank, below), so the tensor cores'
//     coarse fp32 accumulation never runs over more than FOLD tiles.
//   - 'default' on fp32 operands: bf16 `mma.sync.m16n8k16` with fp32 sums;
//     q is rounded to bf16 as it is staged, K and V are staged as raw fp32
//     and rounded to bf16 pairs as their fragments are loaded.
//   - bf16 operands: the same products, K and V staged as bf16 and read by
//     ldmatrix (V transposed on the way), as flash_q8 reads its widened
//     tiles.
// The softmax state of a row stays in one quad of lanes, P never touches
// shared memory, and no atomics are used: runs repeat bit for bit.
//
// flash_fwd at d > 128 and flash_dq, flash_dkv stay on the first FFMA
// design: one thread block owns one 64-row q-tile (flash_fwd, flash_dq) or
// one 64-row k-tile (flash_dkv) of one (batch, head) and runs the whole
// sequential loop over the other axis itself; each thread owns a 4x4 tile
// of the 64x64 score block (rows ty + 16a, columns tx + 16j, so the 16-byte
// shared loads of both operands are free of bank conflicts) and a 4 x d/16
// slice of the output accumulator on the same rows, so the row max and sum
// of the online softmax are four shuffles inside a half-warp and the rescale
// touches only registers. Tiles are staged row-major with padded rows; the
// score loop runs over d rounded up to 4. A head dim above 128 runs the WIDE
// instances (attention_tiles.cuh: 128-wide output chunks on blockIdx.z, the
// scores recomputed per chunk over d staged in 128-wide pieces). Every
// output element is summed by one thread in ascending tile order.

#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace {

// -- flash_fwd at d <= 128 on the tensor cores ------------------------------
namespace tcfwd {

using mma16::BK;
using mma16::BQ;
using mma16::NTHR;

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
    mma16::ldsm_x4(a, Qs + (wr0 + lane % 16) * LD + 8 * kk + 4 * (lane / 16));
    mma16::split_tf32(a, ah, al);
    uint32_t bh[BK / 16][4], bl[BK / 16][4];  // n-tile 2 np: [0..1], 2 np + 1: [2..3]
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      mma16::ldsm_x4(b, Kb + (16 * np + lane % 8 + 8 * (lane / 16)) * LD + 8 * kk +
                            4 * ((lane / 8) % 2));
      mma16::split_tf32(b, bh[np], bl[np]);
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mma16::mma_tf32(sacc[nt], al, bh[nt / 2][2 * (nt % 2)], bh[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mma16::mma_tf32(sacc[nt], ah, bl[nt / 2][2 * (nt % 2)], bl[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mma16::mma_tf32(sacc[nt], ah, bh[nt / 2][2 * (nt % 2)], bh[nt / 2][2 * (nt % 2) + 1]);
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
    mma16::split_tf32(a, ah, al);
    const float* v0 = Vb + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int d0 = 0; d0 < DMAX / 8; d0 += GN) {
      if (8 * d0 >= kd) break;
      uint32_t bh[GN][2], bl[GN][2];
#pragma unroll
      for (int dn = 0; dn < GN; ++dn) {
        mma16::split_tf32(bits(v0[8 * (d0 + dn)]), bh[dn][0], bl[dn][0]);
        mma16::split_tf32(bits(v0[LD + 8 * (d0 + dn)]), bh[dn][1], bl[dn][1]);
      }
#pragma unroll
      for (int dn = 0; dn < GN; ++dn)
        if (8 * (d0 + dn) < kd) mma16::mma_tf32(oacc[d0 + dn], al, bh[dn][0], bh[dn][1]);
#pragma unroll
      for (int dn = 0; dn < GN; ++dn)
        if (8 * (d0 + dn) < kd) mma16::mma_tf32(oacc[d0 + dn], ah, bl[dn][0], bl[dn][1]);
#pragma unroll
      for (int dn = 0; dn < GN; ++dn)
        if (8 * (d0 + dn) < kd) mma16::mma_tf32(oacc[d0 + dn], ah, bh[dn][0], bh[dn][1]);
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
    mma16::ldsm_x4(a, Qs + (wr0 + lane % 16) * LDQ + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float* kr = Kb + (8 * nt + g) * LDK + 16 * kk + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(kr);
      const float2 x1 = *reinterpret_cast<const float2*>(kr + 8);
      mma16::mma_bf16(sacc[nt], a, mma16::pack_bf16(x0.x, x0.y), mma16::pack_bf16(x1.x, x1.y));
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
    const uint32_t a[4] = {mma16::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           mma16::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           mma16::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           mma16::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const float* v0 = Vb + (16 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int dn = 0; dn < DMAX / 8; ++dn) {
      if (8 * dn >= kd) break;
      const float* vr = v0 + 8 * dn;
      mma16::mma_bf16(oacc[dn], a, mma16::pack_bf16(vr[0], vr[LD]),
                      mma16::pack_bf16(vr[8 * LD], vr[9 * LD]));
    }
  }
}

// The three tiers: how q is staged (type TQ, rows of LDQ), K and V's rows
// (LDK, LDV elements of the operand type T), and the two products.
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
    mma16::score_tile<DMAX, LDQ>(sacc, Qs, Kb, kd, wr0, lane);
  }
  __device__ static void pv(float (&oacc)[DMAX / 8][4], const float (&p)[BK / 8][4],
                            const __nv_bfloat16* Vb, int kd, int lane) {
    mma16::pv_tile<DMAX, LDV>(oacc, p, Vb, kd, lane);
  }
};

// Shared memory of an instance: the q-tile, then two stages of the K and V
// tiles (stage i: K at KV + i * stage, V after it).
template <bool ROUND, typename T, int DMAX>
struct Layout {
  using TR = Tier<ROUND, T, DMAX>;
  static constexpr size_t q_bytes = sizeof(typename TR::TQ) * BQ * TR::LDQ;
  static constexpr int stage = BK * (TR::LDK + TR::LDV);  // elements of T
  static constexpr size_t bytes = q_bytes + 2 * sizeof(T) * stage;
};

// The q-tile (rows q0.., all DMAX columns) into Qs: q * scale rounded to
// q's type, then to the tier's TQ; rows at or past s and columns at or past
// d are 0. Up to 32 loads a thread are issued before their stores.
template <int DMAX, int LD, typename TQ, typename T>
__device__ __forceinline__ void load_q(TQ* dst, const T* __restrict__ src, int r0, int s, int d,
                                       float scale) {
  constexpr int PER = BQ * DMAX / NTHR, BATCH = PER < 32 ? PER : 32;
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = threadIdx.x + (i0 + j) * NTHR, r = e / DMAX, c = e % DMAX;
      x[j] = 0.f;
      if (r0 + r < s && c < d) {
        x[j] = attn::to_f32(from_f32<T>(attn::to_f32(src[static_cast<size_t>(r0 + r) * d + c]) *
                                        scale));
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = threadIdx.x + (i0 + j) * NTHR, r = e / DMAX, c = e % DMAX;
      dst[r * LD + c] = from_f32<TQ>(x[j]);
    }
  }
}

// Rows [r0, r0 + BK) of a (s, d) row-major matrix, all DMAX columns, into a
// tile with rows of LD elements; rows at or past s and columns at or past d
// are 0. async: 16-byte cp.async copies (d a whole number of 16-byte chunks,
// src 16-byte aligned); else one element a load.
template <int DMAX, int LD, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int r0, int s,
                                           int d, bool async) {
  if (async) {
    constexpr int E = 16 / sizeof(T), C = DMAX / E;
    for (int e = threadIdx.x; e < BK * C; e += NTHR) {
      const int r = e / C, c = e % C;
      const bool in = r0 + r < s && c * E < d;
      mma16::cp_async16(dst + r * LD + c * E,
                        in ? src + static_cast<size_t>(r0 + r) * d + c * E : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * DMAX; e += NTHR) {
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
// restarts from 0: rows (row, row + 8), columns 8 nt + 2t + c. mb holds the
// softmax max the bank was last scaled to. s <= 512 never folds; folding
// every 4 tiles instead cost 9 % at s = 512 on an H100.
constexpr int FOLD = 8;

template <int NO>
__device__ __forceinline__ void bank(float* ob, float (&oacc)[NO][4], const float (&m)[2],
                                     float (&mb)[2], bool banked, int row, int s, int d,
                                     int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row + 8 * h;
    const float f = mma16::ex2((mb[h] - m[h]) * mma16::LOG2E);
    mb[h] = m[h];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * t + c;
        float* p = &ob[static_cast<size_t>(qp) * d + col];
        if (qp < s && col < d) *p = banked ? fmaf(*p, f, oacc[nt][2 * h + c]) : oacc[nt][2 * h + c];
        oacc[nt][2 * h + c] = 0.f;
      }
  }
}

template <int DMAX, bool ROUND, typename T>
__global__ void __launch_bounds__(NTHR, DMAX <= 64 ? 2 : 1) flash_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int d, float scale_q, int causal,
    int q_off, int kv_off, int async_kv) {
  using TR = Tier<ROUND, T, DMAX>;
  using L = Layout<ROUND, T, DMAX>;
  using TQ = typename TR::TQ;
  constexpr int NO = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  T* KV = reinterpret_cast<T*>(smem + L::q_bytes);

  // the (batch, head) on x, the q-tile on y in reverse: blocks start in the
  // order of their linear index, so every heavy causal q-tile starts first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = min(DMAX, (d + 15) / 16 * 16);  // columns the products run over
  const T* kb = k + base;
  const T* vb = v + base;

  const int nk = mma16::visited_k_tiles(s, q0, causal, q_off, kv_off);
  auto stage_kv = [&](int j) {
    T* dst = KV + (j % 2) * L::stage;
    stage_rows<DMAX, TR::LDK>(dst, kb, j * BK, s, d, async_kv);
    stage_rows<DMAX, TR::LDV>(dst + BK * TR::LDK, vb, j * BK, s, d, async_kv);
    if (async_kv) mma16::cp_async_commit();
  };
  if (nk > 0) stage_kv(0);  // in flight while q is loaded
  load_q<DMAX, TR::LDQ>(Qs, q + base, q0, s, d, scale_q);
  float m[2] = {attn::NEG, attn::NEG}, l[2] = {0.f, 0.f};
  float mb[2] = {attn::NEG, attn::NEG};  // the bank's max (3xTF32)
  int since = 0;                         // tiles summed since the last fold
  bool banked = false;
  T* ob = o + base;
  float oacc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[nt][c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (async_kv) mma16::cp_async_wait_all();
    // tile kt is staged and visible to every warp; every reader of the other
    // stage (tile kt - 1) is done, so tile kt + 1 may stream into it
    __syncthreads();
    if (kt + 1 < nk) stage_kv(kt + 1);
    // under causal masking, a tile whose keys all lie past the warp's last
    // row adds nothing to it (p = 0, corr = 1): the warp skips it
    if (causal && static_cast<long long>(kv_off) + k0 >
                      static_cast<long long>(q_off) + q0 + wr0 + 15) {
      continue;
    }
    const T* Kb = KV + (kt % 2) * L::stage;
    const T* Vb = Kb + BK * TR::LDK;
    float sacc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[nt][c] = 0.f;
    TR::score(sacc, Qs, Kb, kd, wr0, lane);
    // a tile whose every key is visible to every row of the warp skips the
    // mask (rows past s are never stored)
    const bool full = k0 + BK <= s &&
        (!causal || static_cast<long long>(kv_off) + k0 + BK - 1 <=
                        static_cast<long long>(q_off) + q0 + wr0);
    const int row = q0 + wr0 + g;
    const int lims[2] = {full ? s : mma16::key_limit(row, s, causal, q_off, kv_off),
                         full ? s : mma16::key_limit(row + 8, s, causal, q_off, kv_off)};
    if (full) {
      mma16::softmax_tile<false>(sacc, oacc, m, l, 1.f, 0, lims);
    } else {
      mma16::softmax_tile<true>(sacc, oacc, m, l, 1.f, k0 + 2 * t, lims);
    }
    TR::pv(oacc, sacc, Vb, kd, lane);
    // 3xTF32: every FOLD tiles the warp moves its sum into o (the bank, fp32),
    // so the tensor cores' own accumulation never adds more than FOLD tiles
    if constexpr (!ROUND) {
      if (++since == FOLD && kt + 1 < nk) {
        bank(ob, oacc, m, mb, banked, q0 + wr0 + g, s, d, t);
        since = 0;
        banked = true;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + wr0 + g + 8 * h;
    if (qp >= s) continue;
    const float den = l[h] == 0.f ? 1.f : l[h];
    const float f = mma16::ex2((mb[h] - m[h]) * mma16::LOG2E);  // the bank's factor
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * t + c;
        if (col >= d) continue;
        T* p = &ob[static_cast<size_t>(qp) * d + col];
        float x = oacc[nt][2 * h + c];
        if constexpr (!ROUND) {
          if (banked) x = fmaf(*p, f, x);
        }
        attn::store(p, x / den);
      }
    if (t == 0) lse[static_cast<size_t>(bh) * s + qp] = l[h] > 0.f ? m[h] + logf(l[h]) : attn::NEG;
  }
}

template <int DMAX, bool ROUND, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
           int d, float scale_q, int causal, int q_off, int kv_off, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool async_kv = d % E == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t smem = Layout<ROUND, T, DMAX>::bytes;
  auto* kern = flash_fwd_tc_kernel<DMAX, ROUND, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s + BQ - 1) / BQ);
  kern<<<grid, NTHR, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(o),
                                     static_cast<float*>(lse), s, d, scale_q, causal, q_off,
                                     kv_off, static_cast<int>(async_kv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcfwd

// -- the FFMA kernels ---------------------------------------------------------

using namespace attn;

// The forward at head dims above 128 on FFMA: the DMAX = 128 tiles, one
// 128-wide output chunk a blockIdx.z (the scores recomputed per chunk).
constexpr int WD = 128;
constexpr size_t fwd_wide_smem =
    sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (WD + 4) + BQ * LDP);

template <bool ROUND, typename T>
__global__ void __launch_bounds__(NT) flash_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int d, float scale_q, int causal,
    int q_off, int kv_off) {
  constexpr int G = WD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // (BQ, WD + 4) a chunk of pre-scaled q
  float* Ks = Qs + BQ * (WD + 4);  // (BK, WD + 4)
  float* Vs = Ks + BK * (WD + 4);  // (BK, WD + 4)
  float* Ps = Vs + BK * (WD + 4);  // (BQ, LDP) probabilities of this k-tile
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int c_out = blockIdx.z * WD;  // first output column

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int nk = visited_k_tiles(s, q0, causal, q_off, kv_off);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    mma_nt_chunked<WD, ROUND, ROUND>(sc, Qs, Ks, q + base, q0, s, scale_q, k + base, k0, s, 1.f,
                                     d, ty, tx);
    load_chunk<WD, ROUND>(Vs, v + base, k0, s, d, c_out, 1.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool vis[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = causal_visible(qp, k0 + tx + 16 * j, s, causal, q_off, kv_off);
        if (!vis[j]) sc[i][j] = NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = tier<ROUND>(p);
      }
      l[i] = corr * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    mma_nn<WD>(acc, Ps, Vs, ty, tx);
  }

  T* ob = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) store(&ob[static_cast<size_t>(qp) * d + col], acc[i][4 * g + c] / den);
      }
    if (tx == 0 && c_out == 0)
      lse[static_cast<size_t>(bh) * s + qp] = l[i] > 0.f ? m[i] + logf(l[i]) : NEG;
  }
}

template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BQ + 2 * BK) * (DMAX + 4) + BQ * LDP);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int s, int d, float scale_q,
    float sm_scale, int causal, int q_off, int kv_off) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // (BQ, LD) pre-scaled q
  float* dOs = Qs + BQ * LD;    // (BQ, LD)
  float* Ks = dOs + BQ * LD;    // (BK, LD)
  float* Vs = Ks + BK * LD;     // (BK, LD)
  float* dSs = Vs + BK * LD;    // (BQ, LDP)
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) {
    load_tile<DMAX, ROUND>(Qs, q + base, q0, s, d, scale_q);
    load_tile<DMAX, ROUND>(dOs, dout + base, q0, s, d, 1.f);
  }
  float lse_r[4], delta_r[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    lse_r[i] = qp < s ? lse[static_cast<size_t>(bh) * s + qp] : 0.f;
    delta_r[i] = qp < s ? delta[static_cast<size_t>(bh) * s + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int nk = visited_k_tiles(s, q0, causal, q_off, kv_off);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    if constexpr (WIDE) {
      mma_nt_chunked<DMAX, ROUND, ROUND>(sc, Qs, Ks, q + base, q0, s, scale_q, k + base, k0, s,
                                         1.f, d, ty, tx);
      mma_nt_chunked<DMAX, ROUND, ROUND>(dp, dOs, Vs, dout + base, q0, s, 1.f, v + base, k0, s,
                                         1.f, d, ty, tx);
      __syncthreads();  // the score product's readers of Ks are done
      load_chunk<DMAX, ROUND>(Ks, k + base, k0, s, d, c_out, 1.f);
    } else {
      __syncthreads();
      load_tile<DMAX, ROUND>(Ks, k + base, k0, s, d, 1.f);
      load_tile<DMAX, ROUND>(Vs, v + base, k0, s, d, 1.f);
      __syncthreads();
      mma_nt<LD>(sc, Qs, Ks, kd, ty, tx);
      mma_nt<LD>(dp, dOs, Vs, kd, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = causal_visible(qp, k0 + tx + 16 * j, s, causal, q_off, kv_off);
        const float p = vis ? expf(sc[i][j] - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = tier<ROUND>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();
    mma_nn<DMAX>(acc, dSs, Ks, ty, tx);
  }

  T* out = dq + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) store(&out[static_cast<size_t>(qp) * d + col], acc[i][4 * g + c] * sm_scale);
      }
  }
}

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (static_cast<size_t>(2 * BQ + 2 * BK) * (DMAX + 4) + 2 * BK * LDP + 2 * BQ);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s, int d,
    float scale_q, int causal, int q_off, int kv_off) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // (BK, LD)
  float* Vs = Ks + BK * LD;     // (BK, LD)
  float* Qs = Vs + BK * LD;     // (BQ, LD) pre-scaled q
  float* dOs = Qs + BQ * LD;    // (BQ, LD)
  float* Ps = dOs + BQ * LD;    // (BK, LDP): p^T of this q-tile, keys by queries
  float* dSs = Ps + BK * LDP;   // (BK, LDP): dS^T
  float* lse_s = dSs + BK * LDP;  // (BQ)
  float* delta_s = lse_s + BQ;    // (BQ)
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) {
    load_tile<DMAX, ROUND>(Ks, k + base, k0, s, d, 1.f);
    load_tile<DMAX, ROUND>(Vs, v + base, k0, s, d, 1.f);
  }
  float acc_k[4][4 * G], acc_v[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nq = (s + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    // q-tiles whose last row sees no key of this k-tile (uniform per block)
    if (causal && static_cast<long long>(q_off) + q0 + BQ - 1 < static_cast<long long>(kv_off) + k0)
      continue;
    float st[4][4], dpt[4][4];  // rows: keys ty + 16a; columns: queries tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    if constexpr (WIDE) {
      mma_nt_chunked<DMAX, ROUND, ROUND>(st, Ks, Qs, k + base, k0, s, 1.f, q + base, q0, s,
                                         scale_q, d, ty, tx);
      mma_nt_chunked<DMAX, ROUND, ROUND>(dpt, Vs, dOs, v + base, k0, s, 1.f, dout + base, q0, s,
                                         1.f, d, ty, tx);
      __syncthreads();  // the score products' readers of Qs, dOs are done
      load_chunk<DMAX, ROUND>(Qs, q + base, q0, s, d, c_out, scale_q);
      load_chunk<DMAX, ROUND>(dOs, dout + base, q0, s, d, c_out, 1.f);
    } else {
      __syncthreads();
      load_tile<DMAX, ROUND>(Qs, q + base, q0, s, d, scale_q);
      load_tile<DMAX, ROUND>(dOs, dout + base, q0, s, d, 1.f);
    }
    if (threadIdx.x < BQ) {
      const int qp = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qp < s ? lse[static_cast<size_t>(bh) * s + qp] : 0.f;
      delta_s[threadIdx.x] = qp < s ? delta[static_cast<size_t>(bh) * s + qp] : 0.f;
    }
    __syncthreads();
    if constexpr (!WIDE) {
      mma_nt<LD>(st, Ks, Qs, kd, ty, tx);
      mma_nt<LD>(dpt, Vs, dOs, kd, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j;
        const bool vis = causal_visible(q0 + qj, kp, s, causal, q_off, kv_off);
        const float p = vis ? expf(st[i][j] - lse_s[qj]) : 0.f;
        Ps[(ty + 16 * i) * LDP + qj] = tier<ROUND>(p);
        dSs[(ty + 16 * i) * LDP + qj] = tier<ROUND>(p * (dpt[i][j] - delta_s[qj]));
      }
    }
    __syncthreads();
    mma_nn<DMAX>(acc_v, Ps, dOs, ty, tx);
    mma_nn<DMAX>(acc_k, dSs, Qs, ty, tx);
  }

  T* dkb = dk + base;
  T* dvb = dv + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= s) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) {
          store(&dkb[static_cast<size_t>(kp) * d + col], acc_k[i][4 * g + c]);
          store(&dvb[static_cast<size_t>(kp) * d + col], acc_v[i][4 * g + c]);
        }
      }
  }
}

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || s <= 0 || d <= 0 || bh > 65535 ||
         static_cast<long long>(bh) * s * d > (1LL << 40);
}

// d <= 128: the tensor-core forward; wider d: the FFMA WIDE instance.
template <int DMAX, bool ROUND, typename T, bool WIDE>
int fwd_typed(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
              int d, float scale_q, int causal, int q_off, int kv_off, cudaStream_t stream) {
  if constexpr (!WIDE) {
    return tcfwd::launch<DMAX, ROUND, T>(q, k, v, o, lse, bh, s, d, scale_q, causal, q_off,
                                         kv_off, stream);
  } else {
    const dim3 grid((s + BQ - 1) / BQ, bh, out_chunks<WD, true>(d));
    return launch(flash_fwd_wide_kernel<ROUND, T>, fwd_wide_smem, grid, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), static_cast<float*>(lse), s, d, scale_q, causal, q_off,
                  kv_off);
  }
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dq_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int bh, int s, int d, float scale_q, float sm_scale,
             int causal, int q_off, int kv_off, cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, bh, out_chunks<DMAX, WIDE>(d));
  return launch(flash_dq_kernel<DMAX, ROUND, T, WIDE>, dq_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), s, d, scale_q, sm_scale,
                causal, q_off, kv_off);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int bh, int s, int d, float scale_q,
              int causal, int q_off, int kv_off, cudaStream_t stream) {
  const dim3 grid((s + BK - 1) / BK, bh, out_chunks<DMAX, WIDE>(d));
  return launch(flash_dkv_kernel<DMAX, ROUND, T, WIDE>, dkv_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s,
                d, scale_q, causal, q_off, kv_off);
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16 (q, k, v, do and the outputs o, dq, dk, dv share it); lse
// and delta are fp32. round_bf16 selects the 'default' tier for fp32
// inputs. Each launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int bh, int s, int d, float scale_q, int causal, int q_off,
                         int kv_off, int round_bf16, int device, void* stream) {
  // the tensor-core instances put the q-tiles on gridDim.y
  if (bad_shape(bh, s, d) || (s + tcfwd::BQ - 1) / tcfwd::BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(fwd_typed, q, k, v, o, lse, bh, s, d, scale_q, causal, q_off, kv_off, st);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int dtype, int bh, int s,
                        int d, float scale_q, float sm_scale, int causal, int q_off, int kv_off,
                        int round_bf16, int device, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(dq_typed, q, k, v, dout, lse, delta, dq, bh, s, d, scale_q, sm_scale, causal,
                 q_off, kv_off, st);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int dtype,
                         int bh, int s, int d, float scale_q, int causal, int q_off, int kv_off,
                         int round_bf16, int device, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(dkv_typed, q, k, v, dout, lse, delta, dk, dv, bh, s, d, scale_q, causal, q_off,
                 kv_off, st);
}
