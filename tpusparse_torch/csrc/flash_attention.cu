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
//     moves its running sum into o (the bank, attention_mma.cuh), so the
//     tensor cores' coarse fp32 accumulation never runs over more than FOLD
//     tiles.
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

// Shared memory of an instance: the q-tile, then two stages of the K and V
// tiles (stage i: K at KV + i * stage, V after it).
template <bool ROUND, typename T, int DMAX>
struct Layout {
  using TR = mma16::Tier<ROUND, T, DMAX>;
  static constexpr size_t q_bytes = sizeof(typename TR::TQ) * BQ * TR::LDQ;
  static constexpr int stage = BK * (TR::LDK + TR::LDV);  // elements of T
  static constexpr size_t bytes = q_bytes + 2 * sizeof(T) * stage;
};

template <int DMAX, bool ROUND, typename T>
__global__ void __launch_bounds__(NTHR, DMAX <= 64 ? 2 : 1) flash_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int d, float scale_q, int causal,
    int q_off, int kv_off, int async_kv) {
  using TR = mma16::Tier<ROUND, T, DMAX>;
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
    mma16::stage_rows<NTHR, DMAX, TR::LDK>(dst, kb, j * BK, s, d, async_kv);
    mma16::stage_rows<NTHR, DMAX, TR::LDV>(dst + BK * TR::LDK, vb, j * BK, s, d, async_kv);
    if (async_kv) mma16::cp_async_commit();
  };
  if (nk > 0) stage_kv(0);  // in flight while q is loaded
  mma16::load_q<BQ, NTHR, DMAX, TR::LDQ>(Qs, q + base, q0, s, d, scale_q);
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
      if (++since == mma16::FOLD && kt + 1 < nk) {
        mma16::bank(ob, oacc, m, mb, banked, q0 + wr0 + g, s, d, t);
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
