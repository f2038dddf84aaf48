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
//     one TF32 pass: 3xTF32.
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
// at 495 TFLOP/s tf32, the forward's bound is 3 x 6.4 GFLOP = 0.039 ms, dq's
// 0.059 and dk/dv's 0.078; on FFMA (67 TFLOP/s) 0.096, 0.144 and 0.192.
//
// At d <= 128 all three run on the tensor cores with `mma.sync`, on the
// tiles of attention_mma.cuh: eight warps own BQ = 128 rows of one (batch,
// head), 16 rows a warp, staged once in shared memory, and the block walks
// the tiles of the other axis itself, its sums in registers. The tiles of
// the other axis are copied by cp.async in two stages, so tile j + 1
// streams in while tile j computes, one barrier a tile (d a multiple of 16
// bytes a row and 16-byte aligned operands; other d load synchronously).
// Every product is a warp's `score` (C[16, 8 NN] += A . B^T) or `pv`
// (O[16, d] += C . B, the score's C fragment reused as its A fragment):
//   - flash_fwd (flash_fwd_tc_kernel): q-tiles, 64-key k-tiles. S = q k^T,
//     the online softmax in registers (exp taken as exp2 with log2(e)
//     folded in, a mask-free path for tiles every row of the warp sees
//     whole), then o += P v. Causal q-tiles start heaviest first.
//   - flash_dq (flash_dq_tc_kernel): q-tiles with q pre-scaled and do
//     staged; K and V stream in W-key tiles, both read as a score's B and
//     K again as the pv's B. S = q k^T and dP = do v^T, then P = exp2(S
//     log2e - lse log2e) and dS = P (dP - delta) in registers (lse and
//     delta of the warp's rows g, g + 8 in registers), then dq += dS k;
//     sm_scale multiplies once at the store. A tile wholly past the warp's
//     last row under causal masking is skipped; q-tiles heaviest first.
//   - flash_dkv (flash_dkv_tc_kernel): k-tiles (each warp's 16 rows are
//     keys) with k and v staged; q and do stream in W-query tiles with
//     their lse and delta (loaded into registers as the tile is staged,
//     stored beside it at the end of the step). The streamed q is scaled
//     and rounded to q's type in shared memory by the threads that copied
//     it, after their copies land. S^T = k q^T and dP^T = v do^T, P^T and
//     dS^T with lse and delta indexed by the C fragment's column (query),
//     then dv += P^T do and dk += dS^T q. The walk starts at the first
//     q-tile that sees a key of the block; a warp skips a q-tile whose
//     queries all lie before its first key.
//   W = 64 at d <= 64 and 32 at d <= 128, where two stages of 64 rows
//   would not fit beside the two staged tiles (fp32: 270 KB).
// Per tier:
//   - fp32 'high'/'highest': 3xTF32 on `mma.sync.m16n8k8` tf32: each
//     operand x = hi + lo (hi = tf32(x), lo = x - hi), products
//     a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, fp32 sums. The forward stages
//     its tiles as raw fp32 and every warp splits the fragments it loads,
//     in registers (three ALU operations a value): splitting at staging
//     would double the shared memory, which its two blocks an SM need, and
//     the bytes that ldmatrix reads. The backward at d <= 64 holds one
//     block an SM anyway and splits its streamed tiles once, as they land
//     (Layout::PRE below: the splits were a quarter of its time); the
//     staged A tiles and P, dS are split in registers.
//     `mma.sync` and not `wgmma`: tf32 wgmma reads both operands K-major,
//     and the pv's B (keys x d, d contiguous) is not. The pv's k-step reads
//     its eight C-fragment columns in the order 2t -> t, 2t + 1 -> t + 4,
//     and B's rows in the same order (scalar shared loads, rows padded to
//     d + 4 floats so the warp hits 32 banks); the sum takes any order.
//     Every FOLD tiles of 64 rows (512 rows) a warp moves its running sums
//     into the output (the bank, attention_mma.cuh), so the tensor cores'
//     coarse fp32 accumulation never runs over more; s <= 512 never folds.
//   - 'default' on fp32 operands: bf16 `mma.sync.m16n8k16` with fp32 sums;
//     the staged A tiles are rounded to bf16 as they are staged, the
//     streamed tiles are staged as raw fp32 and rounded to bf16 pairs as
//     their fragments are loaded (the backward's pv reads them with
//     two-way bank conflicts: one row pitch serves both of its products).
//   - bf16 operands: the same products, every tile staged as bf16 and read
//     by ldmatrix (the pv's B transposed on the way), as flash_q8 reads
//     its widened tiles.
// P and dS never touch shared memory, and no atomics are used: every
// output element is summed by one thread in one fixed order, so runs
// repeat bit for bit.
//
// Head dims above 128. The forward (flash_fwd_wide_tc_kernel) runs on the
// same tensor-core products and tiers, in attention_mma.cuh's WideFwd: each
// 16-row group of the q-tile is served by a team of warps, each warp owning
// a 128-wide slice of the output columns and the same slice of S's
// contraction. Per 32-key tile every warp takes its partial score over its
// slice, the team sums the partials through shared memory in one order
// after a barrier of its own, and each warp runs the same online softmax on
// the same bits and adds P v[:, slice] into its own 64 registers of o. So S
// is computed once and no warp holds more than a 128-wide accumulator. d <=
// 256: teams of two, 64-row q-tiles (eight warps), 32-key tiles in two
// cp.async stages (fp32: 216 KB of shared memory, one block an SM); d <=
// 512: teams of four, 32-row q-tiles, 16-key tiles; above 512 the same in
// 512-wide chunks of o on blockIdx.z, each block taking S over all of d in
// 512-wide pieces, q's and k's columns of each staged in turn.
// The backward at d > 128 (flash_dq_wide_tc_kernel, flash_dkv_wide_tc_kernel)
// runs on the same teams, attention_mma.cuh's WideBwd: per streamed tile
// each warp takes its partial S and dP (dq: q k^T and do v^T; dk/dv: k q^T
// and v do^T) over its slice of d, the team sums both behind one barrier,
// and every warp takes the same P and dS in registers and adds its
// products into its own slice of the output (dq: dS k; dk/dv: P^T do and
// dS^T q). Each warp owns 64 columns of the output. d <= 256: two teams of
// four on a 32-row tile, dq's keys streamed 32 a tile and dk/dv's queries
// 16; d <= 512: one team of eight on a 16-row tile, 16 a tile; the
// streamed tiles in two cp.async stages. Above 512 the same in 512-wide
// chunks of the output on blockIdx.z, each block taking S and dP over all
// of d in 512-wide pieces, both operands' pieces staged in turn. In
// 3xTF32 a warp banks its sums every 256 streamed rows, so s = 512 folds
// once.

#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace {

// -- flash_fwd at d <= 128 on the tensor cores ------------------------------
namespace tcfwd {

using mma16::BK;

// Shared memory of an instance whose q-tile has QT rows: the q-tile, then
// two stages of the K and V tiles (stage i: K at KV + i * stage, V after it).
template <bool ROUND, typename T, int DMAX, int QT>
struct Layout {
  using TR = mma16::Tier<ROUND, T, DMAX>;
  static constexpr size_t q_bytes = sizeof(typename TR::TQ) * QT * TR::LDQ;
  static constexpr int stage = BK * (TR::LDK + TR::LDV);  // elements of T
  static constexpr size_t bytes = q_bytes + 2 * sizeof(T) * stage;
};

// Blocks an SM an instance's launch bounds ask for, as the block kernel's
// forward (block_flash_attention.cu) asks: eight warps two at d <= 64, one
// above; four warps four at d <= 64 in the bf16 tiers, three in 3xTF32
// (~150 registers a thread), two at d <= 128.
template <int DMAX, bool ROUND, int NW>
__host__ __device__ constexpr int min_blocks() {
  if (DMAX > 64) return NW == 4 ? 2 : 1;
  if (NW == 8) return 2;
  return ROUND ? 4 : 3;
}

// A q-tile of QT = 16 NW rows, NW warps of 16 rows: eight warps own a
// 128-row tile (the default), four a 64-row tile. Every row is summed by
// one warp over the same k-tiles in the same order either way, so the two
// give the same bits (the grid, the staging and which warps share a block
// differ); `autotune_flash` (kernels/flash_attention.py) times them.
template <int DMAX, bool ROUND, typename T, int NW>
__global__ void __launch_bounds__(32 * NW, min_blocks<DMAX, ROUND, NW>()) flash_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int d, float scale_q, int causal,
    int q_off, int kv_off, int async_kv) {
  constexpr int NT = 32 * NW, QT = 16 * NW;
  using TR = mma16::Tier<ROUND, T, DMAX>;
  using L = Layout<ROUND, T, DMAX, QT>;
  using TQ = typename TR::TQ;
  constexpr int NO = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  T* KV = reinterpret_cast<T*>(smem + L::q_bytes);

  // the (batch, head) on x, the q-tile on y in reverse: blocks start in the
  // order of their linear index, so every heavy causal q-tile starts first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = min(DMAX, (d + 15) / 16 * 16);  // columns the products run over
  const T* kb = k + base;
  const T* vb = v + base;

  const int nk = mma16::visited_k_tiles<BK, QT>(s, q0, causal, q_off, kv_off);
  auto stage_kv = [&](int j) {
    T* dst = KV + (j % 2) * L::stage;
    mma16::stage_rows<NT, DMAX, TR::LDK>(dst, kb, j * BK, s, d, async_kv);
    mma16::stage_rows<NT, DMAX, TR::LDV>(dst + BK * TR::LDK, vb, j * BK, s, d, async_kv);
    if (async_kv) mma16::cp_async_commit();
  };
  if (nk > 0) stage_kv(0);  // in flight while q is loaded
  mma16::load_q<QT, NT, DMAX, TR::LDQ>(Qs, q + base, q0, s, d, scale_q);
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

template <int DMAX, bool ROUND, typename T, int NW>
int launch_nw(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
              int d, float scale_q, int causal, int q_off, int kv_off, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T), QT = 16 * NW;
  const bool async_kv = d % E == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t smem = Layout<ROUND, T, DMAX, QT>::bytes;
  auto* kern = flash_fwd_tc_kernel<DMAX, ROUND, T, NW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s + QT - 1) / QT);
  kern<<<grid, 32 * NW, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o),
                                        static_cast<float*>(lse), s, d, scale_q, causal, q_off,
                                        kv_off, static_cast<int>(async_kv));
  return static_cast<int>(cudaGetLastError());
}

// block_q: the q-tile's rows, 128 (eight warps) or 64 (four).
template <int DMAX, bool ROUND, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
           int d, float scale_q, int causal, int q_off, int kv_off, int block_q,
           cudaStream_t stream) {
  if (block_q == 64) {
    return launch_nw<DMAX, ROUND, T, 4>(q, k, v, o, lse, bh, s, d, scale_q, causal, q_off,
                                        kv_off, stream);
  }
  return launch_nw<DMAX, ROUND, T, 8>(q, k, v, o, lse, bh, s, d, scale_q, causal, q_off, kv_off,
                                      stream);
}

}  // namespace tcfwd

// -- flash_dq and flash_dkv at d <= 128 on the tensor cores ------------------
namespace tcbwd {

using mma16::BQ;
using mma16::LOG2E;
using mma16::NTHR;

// Shared memory of an instance (mma16::BwdLayout): the two staged A tiles
// of BQ rows, two stages of the two streamed tiles of W rows, and
// flash_dkv's streamed lse and delta. W = 64 at d <= 64, 32 at d <= 128.
//
// PRE (3xTF32 at d <= 64): the streamed tiles split into tf32 hi and lo
// once, as they land (209 KB in all). On an H100 at (96, 512, 64) 'high' it
// took flash_dkv 0.367 -> 0.288 ms and flash_dq 0.249 -> 0.241 (two blocks
// an SM of the unsplit flash_dq at W = 32). At d = 128 it fits only with W
// = 16, where flash_dq ran slower (0.385 -> 0.410 ms at (48, 512, 128));
// those instances split in registers.
template <bool ROUND, typename T, int DMAX>
using Layout = mma16::BwdLayout<ROUND, T, DMAX, BQ>;

// dq = sm_scale sum_k dS . k, dS = P (dP - delta), P = exp(q k^T - lse), dP
// = do v^T: eight warps own a BQ-row q-tile, 16 rows a warp, and walk the
// W-key tiles; the q-tiles in reverse, so the heaviest causal ones start
// first.
template <int DMAX, bool ROUND, typename T>
__global__ void __launch_bounds__(NTHR, 1) flash_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int s, int d, float scale_q,
    float sm_scale, int causal, int q_off, int kv_off, int async_kv) {
  using TR = mma16::Tier<ROUND, T, DMAX>;
  using L = Layout<ROUND, T, DMAX>;
  using TQ = typename TR::TQ;
  constexpr int W = L::W, NN = W / 8, NO = DMAX / 8, LDB = TR::LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  TQ* dOs = reinterpret_cast<TQ*>(smem + L::a_bytes);
  T* KV = reinterpret_cast<T*>(smem + L::b_off);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = min(DMAX, (d + 15) / 16 * 16);  // columns the products run over
  const T* kb = k + base;
  const T* vb = v + base;

  const int nk = mma16::visited_k_tiles<W>(s, q0, causal, q_off, kv_off);
  auto stage_kv = [&](int j) {
    T* dst = KV + (j % 2) * L::stage;
    mma16::stage_rows<NTHR, DMAX, LDB, W>(dst, kb, j * W, s, d, async_kv);
    mma16::stage_rows<NTHR, DMAX, LDB, W>(dst + W * LDB, vb, j * W, s, d, async_kv);
    if (async_kv) mma16::cp_async_commit();
  };
  if (nk > 0) stage_kv(0);  // in flight while q and do are loaded
  mma16::load_q<BQ, NTHR, DMAX, TR::LDQ>(Qs, q + base, q0, s, d, scale_q);
  mma16::load_q<BQ, NTHR, DMAX, TR::LDQ>(dOs, dout + base, q0, s, d, 1.f);
  // rows g and g + 8 of the warp: lse (log2 domain), delta, visible keys
  float lse2[2], dlt[2];
  int lims[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr0 + g + 8 * h;
    const size_t i = static_cast<size_t>(bh) * s + row;
    lse2[h] = row < s ? lse[i] * LOG2E : 0.f;
    dlt[h] = row < s ? delta[i] : 0.f;
    lims[h] = mma16::key_limit(row, s, causal, q_off, kv_off);
  }
  int since = 0;  // tiles summed since the last fold (3xTF32)
  bool banked = false;
  T* dqb = dq + base;
  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * W;
    T* Kb = KV + (kt % 2) * L::stage;
    T* Vb = Kb + W * LDB;
    if (async_kv) mma16::cp_async_wait_all();
    L::template split_staged<NTHR>(Kb, Vb, async_kv);
    // tile kt is staged and visible to every warp; every reader of the other
    // stage (tile kt - 1) is done, so tile kt + 1 may stream into it
    __syncthreads();
    if (kt + 1 < nk) stage_kv(kt + 1);
    // under causal masking, a tile whose keys all lie past the warp's last
    // row adds nothing to it: the warp skips it
    if (causal && static_cast<long long>(kv_off) + k0 >
                      static_cast<long long>(q_off) + q0 + wr0 + 15) {
      continue;
    }
    float sp[NN][4], dp[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
    L::score(sp, Qs, Kb, kd, wr0, lane);
    L::score(dp, dOs, Vb, kd, wr0, lane);
    auto stat = [&](int h, int, int, float& l2, float& dl) {
      l2 = lse2[h];
      dl = dlt[h];
    };
    // a tile whose every key is visible to every row of the warp skips the
    // mask (rows past s are never stored)
    const bool full = k0 + W <= s &&
        (!causal || static_cast<long long>(kv_off) + k0 + W - 1 <=
                        static_cast<long long>(q_off) + q0 + wr0);
    if (full) {
      mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; });
    } else {
      const int key0 = k0 + 2 * t;
      mma16::probs_ds<true>(sp, dp, stat,
                            [&](int h, int nt, int c) { return key0 + 8 * nt + c < lims[h]; });
    }
    L::pv(acc, dp, Kb, kd, lane);
    if constexpr (!ROUND) {
      if (++since == L::FOLD && kt + 1 < nk) {
        mma16::bank(dqb, acc, banked, q0 + wr0 + g, s, d, t);
        since = 0;
        banked = true;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + wr0 + g + 8 * h;
    if (qp >= s) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * t + c;
        if (col >= d) continue;
        T* p = &dqb[static_cast<size_t>(qp) * d + col];
        float x = acc[nt][2 * h + c];
        if constexpr (!ROUND) {
          if (banked) x = fmaf(*p, 1.f, x);
        }
        attn::store(p, x * sm_scale);
      }
  }
}

// dv = sum_q P^T do and dk = sum_q dS^T (scaled q): eight warps own a
// BQ-key k-tile, 16 keys a warp, and walk the W-row q-tiles from the first
// that sees one of its keys. The streamed q is scaled in shared memory by
// the threads that copied it; the tile's lse and delta are loaded into
// registers as it is staged and stored beside it at the end of the step.
template <int DMAX, bool ROUND, typename T>
__global__ void __launch_bounds__(NTHR, 1) flash_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s, int d,
    float scale_q, int causal, int q_off, int kv_off, int async_q) {
  using TR = mma16::Tier<ROUND, T, DMAX>;
  using L = Layout<ROUND, T, DMAX>;
  using TQ = typename TR::TQ;
  constexpr int W = L::W, NN = W / 8, NO = DMAX / 8, LDB = TR::LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Ks = reinterpret_cast<TQ*>(smem);
  TQ* Vs = reinterpret_cast<TQ*>(smem + L::a_bytes);
  T* QD = reinterpret_cast<T*>(smem + L::b_off);
  float* ST = reinterpret_cast<float*>(smem + L::stat_off);  // stage i: lse2 then delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BQ;  // causal: the heaviest k-tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = min(DMAX, (d + 15) / 16 * 16);
  const T* qb = q + base;
  const T* ob = dout + base;
  const float* lseb = lse + static_cast<size_t>(bh) * s;
  const float* dlb = delta + static_cast<size_t>(bh) * s;

  // the first q-tile that holds a query seeing key k0: causal q-tiles
  // before it see no key of this k-tile
  const int nq = (s + W - 1) / W;
  int qt0 = 0;
  if (causal) {
    const long long first = static_cast<long long>(kv_off) + k0 - q_off;
    qt0 = first <= 0 ? 0 : static_cast<int>(min(static_cast<long long>(nq), first / W));
  }
  mma16::RowStats<W> stat_next;  // the lse and delta of the tile being staged
  auto stage_q = [&](int qt) {
    T* dst = QD + ((qt - qt0) % 2) * L::stage;
    mma16::stage_rows<NTHR, DMAX, LDB, W>(dst, qb, qt * W, s, d, async_q);
    mma16::stage_rows<NTHR, DMAX, LDB, W>(dst + W * LDB, ob, qt * W, s, d, async_q);
    if (async_q) mma16::cp_async_commit();
    stat_next.load(lseb, dlb, qt * W, s);
  };
  auto store_stats = [&](int qt) { stat_next.store(ST + ((qt - qt0) % 2) * 2 * W); };
  if (qt0 < nq) {
    stage_q(qt0);
    store_stats(qt0);
  }
  mma16::load_q<BQ, NTHR, DMAX, TR::LDQ>(Ks, k + base, k0, s, d, 1.f);
  mma16::load_q<BQ, NTHR, DMAX, TR::LDQ>(Vs, v + base, k0, s, d, 1.f);
  // the first query each of the warp's keys g, g + 8 is visible to
  long long lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lo[h] = causal ? static_cast<long long>(kv_off) + k0 + wr0 + g + 8 * h - q_off : 0;
  }
  int since = 0;
  bool banked = false;
  T* dkb = dk + base;
  T* dvb = dv + base;
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[nt][c] = acc_v[nt][c] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * W;
    T* Qb = QD + ((qt - qt0) % 2) * L::stage;
    T* dOb = Qb + W * LDB;
    if (async_q) mma16::cp_async_wait_all();
    mma16::each_staged<NTHR, DMAX, LDB, W, T>(async_q, [&](int o) {
      Qb[o] = mma16::from_f32<T>(attn::to_f32(Qb[o]) * scale_q);
      if constexpr (L::PRE) {
        mma16::split_in_place(Qb + o, Qb + L::lo_off + o);
        mma16::split_in_place(dOb + o, dOb + L::lo_off + o);
      }
    });
    // tile qt is staged, scaled and visible to every warp with its lse and
    // delta; every reader of the other stage (tile qt - 1) is done
    __syncthreads();
    if (qt + 1 < nq) stage_q(qt + 1);
    // under causal masking, a tile whose queries all lie before the warp's
    // first key adds nothing to it: the warp skips it
    if (!causal || static_cast<long long>(q_off) + q0 + W - 1 >=
                       static_cast<long long>(kv_off) + k0 + wr0) {
      const float* st = ST + ((qt - qt0) % 2) * 2 * W;
      float sp[NN][4], dp[NN][4];
#pragma unroll
      for (int nt = 0; nt < NN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
      L::score(sp, Ks, Qb, kd, wr0, lane);
      L::score(dp, Vs, dOb, kd, wr0, lane);
      auto stat = [&](int, int nt, int c, float& l2, float& dl) {
        l2 = st[8 * nt + 2 * t + c];
        dl = st[W + 8 * nt + 2 * t + c];
      };
      // every query of the tile is inside s and sees every key of the warp
      const bool full = q0 + W <= s &&
          (!causal || static_cast<long long>(q_off) + q0 >=
                          static_cast<long long>(kv_off) + k0 + wr0 + 15);
      if (full) {
        mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; });
      } else {
        const int qj0 = q0 + 2 * t;
        mma16::probs_ds<true>(sp, dp, stat, [&](int h, int nt, int c) {
          const int qj = qj0 + 8 * nt + c;
          return qj < s && qj >= lo[h];
        });
      }
      L::pv(acc_v, sp, dOb, kd, lane);
      L::pv(acc_k, dp, Qb, kd, lane);
      if constexpr (!ROUND) {
        if (++since == L::FOLD && qt + 1 < nq) {
          mma16::bank(dkb, acc_k, banked, k0 + wr0 + g, s, d, t);
          mma16::bank(dvb, acc_v, banked, k0 + wr0 + g, s, d, t);
          since = 0;
          banked = true;
        }
      }
    }
    if (qt + 1 < nq) store_stats(qt + 1);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + wr0 + g + 8 * h;
    if (kp >= s) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * t + c;
        if (col >= d) continue;
        const size_t i = static_cast<size_t>(kp) * d + col;
        float xk = acc_k[nt][2 * h + c], xv = acc_v[nt][2 * h + c];
        if constexpr (!ROUND) {
          if (banked) {
            xk = fmaf(dkb[i], 1.f, xk);
            xv = fmaf(dvb[i], 1.f, xv);
          }
        }
        attn::store(&dkb[i], xk);
        attn::store(&dvb[i], xv);
      }
  }
}

// 16-byte copies need d a whole number of 16-byte chunks and 16-byte
// aligned operands
template <typename T>
bool async_ok(int d, const void* a, const void* b) {
  return d % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kern, size_t smem, dim3 grid, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NTHR, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX, bool ROUND, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int bh, int s, int d, float scale_q, float sm_scale,
              int causal, int q_off, int kv_off, cudaStream_t stream) {
  return launch(flash_dq_tc_kernel<DMAX, ROUND, T>, Layout<ROUND, T, DMAX>::bytes,
                dim3(bh, (s + BQ - 1) / BQ), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), s, d, scale_q, sm_scale,
                causal, q_off, kv_off, static_cast<int>(async_ok<T>(d, k, v)));
}

template <int DMAX, bool ROUND, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int s, int d, float scale_q,
               int causal, int q_off, int kv_off, cudaStream_t stream) {
  return launch(flash_dkv_tc_kernel<DMAX, ROUND, T>, Layout<ROUND, T, DMAX>::bytes,
                dim3(bh, (s + BQ - 1) / BQ), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), s, d, scale_q, causal, q_off, kv_off,
                static_cast<int>(async_ok<T>(d, q, dout)));
}

}  // namespace tcbwd

// -- flash_fwd at d > 128 on the tensor cores ----------------------------------
namespace widefwd {

// The forward of mma16::WideFwd's teams: the q-tiles of one (batch, head)
// on y in reverse (the heavy causal ones first). d <= DMAX: W-key tiles
// streamed in two stages, one barrier a tile, q pre-scaled as it is staged
// once. CHUNK (d > DMAX): the block's DMAX-wide chunk of o on z, and per key
// tile q's and k's columns staged a DMAX-wide piece at a time for S, V's
// chunk with the first piece.
template <bool ROUND, typename T, int DMAX, bool CHUNK>
__global__ void __launch_bounds__(mma16::WideFwdFor<ROUND, T, DMAX>::NT, 1)
    flash_fwd_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             float* __restrict__ lse, int s, int d, float scale_q, int causal,
                             int q_off, int kv_off, int async_kv) {
  using F = mma16::WideFwdFor<ROUND, T, DMAX>;
  using TR = typename F::TR;
  using TQ = typename F::TQ;
  constexpr int NT = F::NT, QT = F::QT, W = F::W, NN = F::NN, NO = F::NO;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  T* KV = reinterpret_cast<T*>(smem + F::q_bytes);
  float* X = reinterpret_cast<float*>(smem + F::x_off);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;
  const int c_out = CHUNK ? blockIdx.z * F::DMAX : 0;  // the block's chunk of o
  const int wv = min(F::DMAX, d - c_out);               // and its width
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % (QT / 16), h = warp / (QT / 16);  // the warp's team and slice
  const int g = lane / 4, t = lane % 4, wr0 = 16 * rg;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const T* kb = k + base;
  const T* vb = v + base;

  const int nk = mma16::visited_k_tiles<W, QT>(s, q0, causal, q_off, kv_off);
  auto stage_kv = [&](int j) {
    T* dst = KV + (j % 2) * F::stage;
    mma16::stage_rows<NT, F::DMAX, TR::LDK, W>(dst, kb, j * W, s, d, async_kv);
    mma16::stage_rows<NT, F::DMAX, TR::LDV, W>(dst + W * TR::LDK, vb, j * W, s, d, async_kv);
    if (async_kv) mma16::cp_async_commit();
  };
  if constexpr (!CHUNK) {
    if (nk > 0) stage_kv(0);  // in flight while q is loaded
    mma16::load_q<QT, NT, F::DMAX, TR::LDQ>(Qs, q + base, q0, s, d, scale_q);
  }
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
    const int k0 = kt * W;
    // under causal masking, a tile whose keys all lie past the team's last
    // row adds nothing to it: the whole team skips it
    const bool skip = causal && static_cast<long long>(kv_off) + k0 >
                                    static_cast<long long>(q_off) + q0 + wr0 + 15;
    float sacc[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[nt][c] = 0.f;
    const T* Vb;
    if constexpr (CHUNK) {
      Vb = KV + W * TR::LDK;
      F::score_chunked(sacc, Qs, KV, KV + F::stage, X, q + base, q0, s, scale_q, kb, k0, s, d,
                       async_kv, skip, rg, h, wr0, lane, [&] {
                         mma16::stage_rows<NT, F::DMAX, TR::LDV, W>(KV + W * TR::LDK, vb + c_out,
                                                                    k0, s, d, async_kv, wv);
                       });
      if (skip) continue;
    } else {
      if (async_kv) mma16::cp_async_wait_all();
      // tile kt is staged and visible to every warp; every reader of the
      // other stage (tile kt - 1) and of the teams' partials is done
      __syncthreads();
      if (kt + 1 < nk) stage_kv(kt + 1);
      if (skip) continue;
      const T* Kb = KV + (kt % 2) * F::stage;
      Vb = Kb + W * TR::LDK;
      F::score(sacc, Qs, Kb, X, d, rg, h, wr0, lane);
    }
    const bool full = k0 + W <= s &&
        (!causal || static_cast<long long>(kv_off) + k0 + W - 1 <=
                        static_cast<long long>(q_off) + q0 + wr0);
    const int row = q0 + wr0 + g;
    const int lims[2] = {full ? s : mma16::key_limit(row, s, causal, q_off, kv_off),
                         full ? s : mma16::key_limit(row + 8, s, causal, q_off, kv_off)};
    if (full) {
      mma16::softmax_tile<false>(sacc, oacc, m, l, 1.f, 0, lims);
    } else {
      mma16::softmax_tile<true>(sacc, oacc, m, l, 1.f, k0 + 2 * t, lims);
    }
    F::pv(oacc, sacc, Vb, wv, h, lane);
    if constexpr (!ROUND) {
      if (++since == F::FOLD && kt + 1 < nk) {
        mma16::bank(ob, oacc, m, mb, banked, row, s, d, t, c_out + F::DW * h);
        since = 0;
        banked = true;
      }
    }
  }
  F::store(ob, lse + static_cast<size_t>(bh) * s, oacc, m, l, mb, banked, q0 + wr0 + g, s, d,
           c_out + F::DW * h, h == 0 && c_out == 0, t);
}

// d <= 256: the 256 instance; wider d the 512 instance, above 512 in
// 512-wide chunks of o
template <bool ROUND, typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
           int d, float scale_q, int causal, int q_off, int kv_off, cudaStream_t stream) {
  using F = mma16::WideFwdFor<ROUND, T, DMAX>;
  const int chunks = (d + F::DMAX - 1) / F::DMAX;
  if ((s + F::QT - 1) / F::QT > 65535 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int E = 16 / sizeof(T);
  // the chunks also stage q by cp.async
  const bool async_kv = d % E == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                        (chunks == 1 || reinterpret_cast<uintptr_t>(q) % 16 == 0);
  constexpr bool CHUNKS = DMAX == 512;  // the 256 instance serves d <= 256 alone
  auto* kern = chunks > 1 ? flash_fwd_wide_tc_kernel<ROUND, T, DMAX, CHUNKS>
                          : flash_fwd_wide_tc_kernel<ROUND, T, DMAX, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(F::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s + F::QT - 1) / F::QT, chunks);
  kern<<<grid, F::NT, F::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, d, scale_q, causal, q_off, kv_off,
      static_cast<int>(async_kv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace widefwd

// -- flash_dq and flash_dkv at 128 < d <= 512 on the tensor cores ---------------
namespace widebwd {

using mma16::LOG2E;

// Blocks on x, one a (tile, batch-head): tile i of every head before tile
// i + 1, so the heaviest causal tiles start first, and any s the entry
// points take fits the grid.
__device__ __forceinline__ int tile_rank(int nbh) { return blockIdx.x / nbh; }

// dq = sm_scale sum_k dS . k on mma16::WideBwd's teams: a q-tile of RT rows
// (q pre-scaled and do staged once), K and V streamed in W-key tiles, two
// cp.async stages, one block barrier a tile. S = q k^T and dP = do v^T
// summed over the team's slices, then P and dS in registers as
// flash_dq_tc_kernel takes them, then dq[:, slice] += dS k[:, slice]. Under
// causal masking a team skips a tile wholly past its last row. CHUNK (d >
// DMAX): the block's DMAX-wide chunk of dq on z, and per key tile the
// pieces of q, do, K and V staged in turn for S and dP over all of d, K's
// chunk with the first piece (stage 1).
template <bool ROUND, typename T, int DMAX, bool CHUNK>
__global__ void __launch_bounds__(mma16::WideDqFor<ROUND, T, DMAX>::NT, 1)
    flash_dq_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dq, int nbh, int s, int d, float scale_q,
                            float sm_scale, int causal, int q_off, int kv_off, int async_kv) {
  using B = mma16::WideDqFor<ROUND, T, DMAX>;
  using TQ = typename B::TQ;
  using TR = typename B::TR;
  constexpr int NT = B::NT, QT = B::RT, W = B::W, NN = B::NN, NO = B::NO, LDB = B::LDB;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  TQ* dOs = reinterpret_cast<TQ*>(smem + B::a_bytes);
  T* KV = reinterpret_cast<T*>(smem + B::b_off);
  float* X = reinterpret_cast<float*>(smem + B::x_off);

  const int bh = blockIdx.x % nbh;
  const int q0 = ((gridDim.x / nbh) - 1 - tile_rank(nbh)) * QT;
  const int c_out = CHUNK ? blockIdx.z * DMAX : 0;  // the block's chunk of dq
  const int wv = min(DMAX, d - c_out);              // and its width
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % B::NRG, h = warp / B::NRG;  // the warp's team and slice
  const int g = lane / 4, t = lane % 4, wr0 = 16 * rg;
  const int kd = B::kd(wv, h);
  const size_t base = static_cast<size_t>(bh) * s * d;
  const T* kb = k + base;
  const T* vb = v + base;

  const int nk = mma16::visited_k_tiles<W, QT>(s, q0, causal, q_off, kv_off);
  auto stage_kv = [&](int j) {
    T* dst = KV + (j % 2) * B::stage;
    mma16::stage_rows<NT, DMAX, LDB, W>(dst, kb, j * W, s, d, async_kv);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst + W * LDB, vb, j * W, s, d, async_kv);
    if (async_kv) mma16::cp_async_commit();
  };
  if constexpr (!CHUNK) {
    if (nk > 0) stage_kv(0);  // in flight while q and do are loaded
    mma16::load_q<QT, NT, DMAX, TR::LDQ>(Qs, q + base, q0, s, d, scale_q);
    mma16::load_q<QT, NT, DMAX, TR::LDQ>(dOs, dout + base, q0, s, d, 1.f);
  }
  // rows g and g + 8 of the team: lse (log2 domain), delta, visible keys
  float lse2[2], dlt[2];
  int lims[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + wr0 + g + 8 * hh;
    const size_t i = static_cast<size_t>(bh) * s + row;
    lse2[hh] = row < s ? lse[i] * LOG2E : 0.f;
    dlt[hh] = row < s ? delta[i] : 0.f;
    lims[hh] = mma16::key_limit(row, s, causal, q_off, kv_off);
  }
  int since = 0;  // tiles summed since the last fold (3xTF32)
  bool banked = false;
  T* dqb = dq + base;
  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * W;
    // a tile whose keys all lie past the team's last row adds nothing to it:
    // the whole team skips it
    const bool skip = causal && static_cast<long long>(kv_off) + k0 >
                                    static_cast<long long>(q_off) + q0 + wr0 + 15;
    float sp[NN][4], dp[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
    const T* Kb;  // the tile's K in the block's columns: the pv's B
    if constexpr (CHUNK) {
      T* Kc = KV + B::stage;
      B::scores_chunked(
          sp, dp, Qs, dOs, KV, X, q + base, dout + base, q0, scale_q, kb, vb, k0, s, 1.f, s, d,
          async_kv, skip, rg, h, wr0, lane,
          [&] { mma16::stage_rows<NT, DMAX, LDB, W>(Kc, kb + c_out, k0, s, d, async_kv, wv); },
          [] {});
      if (skip) continue;
      Kb = Kc;
    } else {
      T* Kt = KV + (kt % 2) * B::stage;
      if (async_kv) mma16::cp_async_wait_all();
      // tile kt is staged and visible to every warp; every reader of the
      // other stage (tile kt - 1) and of the teams' partials is done
      __syncthreads();
      Kb = Kt;
      if (kt + 1 < nk) stage_kv(kt + 1);
      if (skip) continue;
      B::partials(sp, dp, Qs, dOs, Kb, Kb + W * LDB, kd, h, wr0, lane);
      B::team_sum(sp, dp, X, rg, h, lane);
    }
    auto stat = [&](int hh, int, int, float& l2, float& dl) {
      l2 = lse2[hh];
      dl = dlt[hh];
    };
    const bool full = k0 + W <= s &&
        (!causal || static_cast<long long>(kv_off) + k0 + W - 1 <=
                        static_cast<long long>(q_off) + q0 + wr0);
    if (full) {
      mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; });
    } else {
      const int key0 = k0 + 2 * t;
      mma16::probs_ds<true>(sp, dp, stat,
                            [&](int hh, int nt, int c) { return key0 + 8 * nt + c < lims[hh]; });
    }
    B::pv(acc, dp, Kb, kd, h, lane);
    if constexpr (!ROUND) {
      if (++since == B::FOLD && kt + 1 < nk) {
        B::bank(dqb, acc, banked, q0 + wr0 + g, s, d, c_out, h, t);
        since = 0;
        banked = true;
      }
    }
  }
  B::store(dqb, acc, banked, q0 + wr0 + g, s, d, c_out, h, t, sm_scale);
}

// dv = sum_q P^T do and dk = sum_q dS^T (scaled q) on mma16::WideBwd's
// teams: a k-tile of RT keys (k and v staged once), q and do streamed in
// W-row tiles with their lse and delta, q scaled and rounded to q's type by
// the threads that copied it, as flash_dkv_tc_kernel takes it. S^T = k q^T
// and dP^T = v do^T summed over the team's slices, P^T and dS^T, then
// dv[:, slice] += P^T do[:, slice] and dk[:, slice] += dS^T q[:, slice].
// The walk starts at the first q-tile that sees a key of the block; a team
// skips a tile whose queries all lie before its first key. CHUNK (d >
// DMAX): the block's DMAX-wide chunk of dk and dv on z, and per q-tile the
// pieces of k, v, q and do staged in turn for S^T and dP^T over all of d,
// q's and do's chunks and the statistics with the first piece (stage 1).
template <bool ROUND, typename T, int DMAX, bool CHUNK>
__global__ void __launch_bounds__(mma16::WideDkvFor<ROUND, T, DMAX>::NT, 1)
    flash_dkv_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int nbh, int s, int d,
                             float scale_q, int causal, int q_off, int kv_off, int async_q) {
  using B = mma16::WideDkvFor<ROUND, T, DMAX>;
  using TQ = typename B::TQ;
  using TR = typename B::TR;
  constexpr int NT = B::NT, KT = B::RT, W = B::W, NN = B::NN, NO = B::NO, LDB = B::LDB;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Ks = reinterpret_cast<TQ*>(smem);
  TQ* Vs = reinterpret_cast<TQ*>(smem + B::a_bytes);
  T* QD = reinterpret_cast<T*>(smem + B::b_off);
  float* X = reinterpret_cast<float*>(smem + B::x_off);
  float* ST = reinterpret_cast<float*>(smem + B::stat_off);  // stage i: lse2 then delta

  const int bh = blockIdx.x % nbh;
  const int k0 = tile_rank(nbh) * KT;  // causal: the heaviest k-tiles first
  const int c_out = CHUNK ? blockIdx.z * DMAX : 0;  // the block's chunk of dk, dv
  const int wv = min(DMAX, d - c_out);              // and its width
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % B::NRG, h = warp / B::NRG;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * rg;
  const int kd = B::kd(wv, h);
  const size_t base = static_cast<size_t>(bh) * s * d;
  const T* qb = q + base;
  const T* ob = dout + base;
  const float* lseb = lse + static_cast<size_t>(bh) * s;
  const float* dlb = delta + static_cast<size_t>(bh) * s;

  // the first q-tile that holds a query seeing key k0
  const int nq = (s + W - 1) / W;
  int qt0 = 0;
  if (causal) {
    const long long first = static_cast<long long>(kv_off) + k0 - q_off;
    qt0 = first <= 0 ? 0 : static_cast<int>(min(static_cast<long long>(nq), first / W));
  }
  mma16::RowStats<W> stat_next;  // the lse and delta of the tile being staged
  auto stage_q = [&](int qt) {
    T* dst = QD + ((qt - qt0) % 2) * B::stage;
    mma16::stage_rows<NT, DMAX, LDB, W>(dst, qb, qt * W, s, d, async_q);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst + W * LDB, ob, qt * W, s, d, async_q);
    if (async_q) mma16::cp_async_commit();
    stat_next.load(lseb, dlb, qt * W, s);
  };
  auto store_stats = [&](int qt) { stat_next.store(ST + ((qt - qt0) % 2) * 2 * W); };
  auto scale_q_tile = [&](T* Qb) {
    mma16::each_staged<NT, DMAX, LDB, W, T>(async_q, [&](int o) {
      Qb[o] = mma16::from_f32<T>(attn::to_f32(Qb[o]) * scale_q);
    });
  };
  if constexpr (!CHUNK) {
    if (qt0 < nq) {
      stage_q(qt0);
      store_stats(qt0);
    }
    mma16::load_q<KT, NT, DMAX, TR::LDQ>(Ks, k + base, k0, s, d, 1.f);
    mma16::load_q<KT, NT, DMAX, TR::LDQ>(Vs, v + base, k0, s, d, 1.f);
  }
  // the first query each of the team's keys g, g + 8 is visible to
  long long lo[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lo[hh] = causal ? static_cast<long long>(kv_off) + k0 + wr0 + g + 8 * hh - q_off : 0;
  }
  int since = 0;
  bool banked = false;
  T* dkb = dk + base;
  T* dvb = dv + base;
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[nt][c] = acc_v[nt][c] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * W;
    // a tile whose queries all lie before the team's first key adds nothing
    // to it: the whole team skips it
    const bool skip = causal && static_cast<long long>(q_off) + q0 + W - 1 <
                                    static_cast<long long>(kv_off) + k0 + wr0;
    float sp[NN][4], dp[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
    const T* Qb;  // the tile's q (scaled) and do in the block's columns: the pvs' B
    const float* st = ST;
    if constexpr (CHUNK) {
      T* Qc = QD + B::stage;
      B::scores_chunked(
          sp, dp, Ks, Vs, QD, X, k + base, v + base, k0, 1.f, qb, ob, q0, s, scale_q, s, d,
          async_q, skip, rg, h, wr0, lane,
          [&] {
            mma16::stage_rows<NT, DMAX, LDB, W>(Qc, qb + c_out, q0, s, d, async_q, wv);
            mma16::stage_rows<NT, DMAX, LDB, W>(Qc + W * LDB, ob + c_out, q0, s, d, async_q, wv);
            stat_next.load(lseb, dlb, q0, s);
            stat_next.store(ST);
          },
          [&] { scale_q_tile(Qc); });
      if (skip) continue;
      Qb = Qc;
    } else {
      T* Qt = QD + ((qt - qt0) % 2) * B::stage;
      if (async_q) mma16::cp_async_wait_all();
      scale_q_tile(Qt);
      // tile qt is staged, scaled and visible to every warp with its lse and
      // delta; every reader of the other stage (tile qt - 1) and of the
      // teams' partials is done
      __syncthreads();
      if (qt + 1 < nq) stage_q(qt + 1);
      Qb = Qt;
      st = ST + ((qt - qt0) % 2) * 2 * W;
      if (!skip) {
        B::partials(sp, dp, Ks, Vs, Qb, Qb + W * LDB, kd, h, wr0, lane);
        B::team_sum(sp, dp, X, rg, h, lane);
      }
    }
    if (!skip) {
      auto stat = [&](int, int nt, int c, float& l2, float& dl) {
        l2 = st[8 * nt + 2 * t + c];
        dl = st[W + 8 * nt + 2 * t + c];
      };
      // every query of the tile is inside s and sees every key of the team
      const bool full = q0 + W <= s &&
          (!causal || static_cast<long long>(q_off) + q0 >=
                          static_cast<long long>(kv_off) + k0 + wr0 + 15);
      if (full) {
        mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; });
      } else {
        const int qj0 = q0 + 2 * t;
        mma16::probs_ds<true>(sp, dp, stat, [&](int hh, int nt, int c) {
          const int qj = qj0 + 8 * nt + c;
          return qj < s && qj >= lo[hh];
        });
      }
      B::pv(acc_v, sp, Qb + W * LDB, kd, h, lane);
      B::pv(acc_k, dp, Qb, kd, h, lane);
      if constexpr (!ROUND) {
        if (++since == B::FOLD && qt + 1 < nq) {
          B::bank(dkb, acc_k, banked, k0 + wr0 + g, s, d, c_out, h, t);
          B::bank(dvb, acc_v, banked, k0 + wr0 + g, s, d, c_out, h, t);
          since = 0;
          banked = true;
        }
      }
    }
    if (!CHUNK && qt + 1 < nq) store_stats(qt + 1);
  }
  B::store(dkb, acc_k, banked, k0 + wr0 + g, s, d, c_out, h, t, 1.f);
  B::store(dvb, acc_v, banked, k0 + wr0 + g, s, d, c_out, h, t, 1.f);
}

// A kernel of this namespace over tiles of `rows` rows of every (batch,
// head) and `chunks` chunks of the output, with its shared memory allowed
template <typename Kernel, typename... Args>
int launch(Kernel kern, size_t smem, int nt, int bh, int s, int rows, int chunks,
           cudaStream_t stream, Args... args) {
  const long long blocks = static_cast<long long>(bh) * ((s + rows - 1) / rows);
  if (blocks > 0x7fffffffLL || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(blocks), 1, chunks), nt, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

using tcbwd::async_ok;

// d <= 256: the 256 instance; wider d the 512 instance, above 512 in
// 512-wide chunks of the output
template <bool ROUND, typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int bh, int s, int d, float scale_q, float sm_scale,
              int causal, int q_off, int kv_off, cudaStream_t stream) {
  using B = mma16::WideDqFor<ROUND, T, DMAX>;
  const int chunks = (d + DMAX - 1) / DMAX;
  constexpr bool CHUNKS = DMAX == 512;  // the 256 instance serves d <= 256 alone
  // the chunks also stage q and do by cp.async
  const bool async = async_ok<T>(d, k, v) && (chunks == 1 || async_ok<T>(d, q, dout));
  // dq streams no lse or delta: its shared memory ends at stat_off
  return launch(chunks > 1 ? flash_dq_wide_tc_kernel<ROUND, T, DMAX, CHUNKS>
                           : flash_dq_wide_tc_kernel<ROUND, T, DMAX, false>,
                B::stat_off, B::NT, bh, s, B::RT, chunks, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dq), bh, s, d, scale_q, sm_scale, causal, q_off, kv_off,
                static_cast<int>(async));
}

template <bool ROUND, typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int s, int d, float scale_q,
               int causal, int q_off, int kv_off, cudaStream_t stream) {
  using B = mma16::WideDkvFor<ROUND, T, DMAX>;
  const int chunks = (d + DMAX - 1) / DMAX;
  constexpr bool CHUNKS = DMAX == 512;
  // the chunks also stage k and v by cp.async
  const bool async = async_ok<T>(d, q, dout) && (chunks == 1 || async_ok<T>(d, k, v));
  return launch(chunks > 1 ? flash_dkv_wide_tc_kernel<ROUND, T, DMAX, CHUNKS>
                           : flash_dkv_wide_tc_kernel<ROUND, T, DMAX, false>,
                B::bytes, B::NT, bh, s, B::RT, chunks, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), bh, s, d, scale_q, causal, q_off,
                kv_off, static_cast<int>(async));
}

}  // namespace widebwd

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || s <= 0 || d <= 0 || bh > 65535 ||
         static_cast<long long>(bh) * s * d > (1LL << 40);
}

// d <= 128: the tensor-core forward on its q-tile; wider d: the teams of
// the wide tensor-core forward.
template <int DMAX, bool ROUND, typename T, bool WIDE>
int fwd_typed(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
              int d, float scale_q, int causal, int q_off, int kv_off, int block_q,
              cudaStream_t stream) {
  if constexpr (!WIDE) {
    return tcfwd::launch<DMAX, ROUND, T>(q, k, v, o, lse, bh, s, d, scale_q, causal, q_off,
                                         kv_off, block_q, stream);
  } else {
    if (d <= 256) {
      return widefwd::launch<ROUND, T, 256>(q, k, v, o, lse, bh, s, d, scale_q, causal, q_off,
                                            kv_off, stream);
    }
    return widefwd::launch<ROUND, T, 512>(q, k, v, o, lse, bh, s, d, scale_q, causal, q_off,
                                          kv_off, stream);
  }
}

// d <= 128: the tensor-core backward; wider d: the teams of the wide
// tensor-core backward.
template <int DMAX, bool ROUND, typename T, bool WIDE>
int dq_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int bh, int s, int d, float scale_q, float sm_scale,
             int causal, int q_off, int kv_off, cudaStream_t stream) {
  if constexpr (!WIDE) {
    return tcbwd::launch_dq<DMAX, ROUND, T>(q, k, v, dout, lse, delta, dq, bh, s, d, scale_q,
                                            sm_scale, causal, q_off, kv_off, stream);
  } else {
    if (d <= 256) {
      return widebwd::launch_dq<ROUND, T, 256>(q, k, v, dout, lse, delta, dq, bh, s, d, scale_q,
                                               sm_scale, causal, q_off, kv_off, stream);
    }
    return widebwd::launch_dq<ROUND, T, 512>(q, k, v, dout, lse, delta, dq, bh, s, d, scale_q,
                                             sm_scale, causal, q_off, kv_off, stream);
  }
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int bh, int s, int d, float scale_q,
              int causal, int q_off, int kv_off, cudaStream_t stream) {
  if constexpr (!WIDE) {
    return tcbwd::launch_dkv<DMAX, ROUND, T>(q, k, v, dout, lse, delta, dk, dv, bh, s, d,
                                             scale_q, causal, q_off, kv_off, stream);
  } else {
    if (d <= 256) {
      return widebwd::launch_dkv<ROUND, T, 256>(q, k, v, dout, lse, delta, dk, dv, bh, s, d,
                                                scale_q, causal, q_off, kv_off, stream);
    }
    return widebwd::launch_dkv<ROUND, T, 512>(q, k, v, dout, lse, delta, dk, dv, bh, s, d,
                                              scale_q, causal, q_off, kv_off, stream);
  }
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
                         int kv_off, int round_bf16, int block_q, int device, void* stream) {
  // block_q: the q-tile of the instances at d <= 128, 128 or 64 rows (0:
  // 128); d > 128 takes the wide forward's own (64 rows at d <= 256, 32
  // above). Every instance puts the q-tiles on gridDim.y.
  if (block_q == 0) block_q = mma16::BQ;
  if (bad_shape(bh, s, d) || (block_q != 64 && block_q != 128) ||
      (s + block_q - 1) / block_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(fwd_typed, q, k, v, o, lse, bh, s, d, scale_q, causal, q_off, kv_off, block_q,
                st);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int dtype, int bh, int s,
                        int d, float scale_q, float sm_scale, int causal, int q_off, int kv_off,
                        int round_bf16, int device, void* stream) {
  // the tensor-core instances put the 128-row tiles on gridDim.y
  if (bad_shape(bh, s, d) || (s + tcbwd::BQ - 1) / tcbwd::BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  // the tensor-core instances put the 128-row tiles on gridDim.y
  if (bad_shape(bh, s, d) || (s + tcbwd::BQ - 1) / tcbwd::BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(dkv_typed, q, k, v, dout, lse, delta, dk, dv, bh, s, d, scale_q, causal, q_off,
                 kv_off, st);
}
