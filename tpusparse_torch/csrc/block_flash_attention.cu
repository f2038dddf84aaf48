// Block-pattern fused attention for NVIDIA Hopper (sm_90a): softmax
// attention restricted to a block pattern (BigBird's window + global +
// random blocks, or any token pattern block-ified with exact per-tile
// masks), with its per-row logsumexp, and the two backward kernels that
// recompute the probabilities from that logsumexp, dq and (dk, dv). Only the
// listed kv blocks are read or computed; the score matrix never reaches
// device memory.
//
// Replaces three TPU kernels of tpusparse/kernels/flash_attention.py:
//   blk_flash_fwd  <- :929  _blk_flash_kernel (pallas_call l.1087)
//   blk_flash_dq   <- :1136 _blk_dq_kernel    (pallas_call l.1286)
//   blk_flash_dkv  <- :1175 _blk_dkv_kernel   (pallas_call l.1339)
// The TPU grids ran (bh, q-block, slot) with the slot axis sequential,
// picking the slot's kv block through a scalar-prefetched ELL list and
// carrying the online softmax in VMEM scratch from slot to slot. Here one
// thread block owns one q-tile inside one plan q-block (forward: 64 or 128
// rows, dq: 64) or one 64-row tile inside one plan kv block (dk/dv) of one
// (batch, head), reads its block's list itself and walks, in list order,
// every listed block's sub-tiles, keeping its accumulators in registers.
// The plan blocks (block_q, block_k) are part of the pattern's meaning and
// take any size (32, 64, 256, unequal); a block that is not a multiple of
// the sub-tile leaves the last sub-tile partly empty.
//
// Contract. q, k, v, do: (bh, s, d) row-major, one type (fp32 or bf16);
// lse, delta: (bh, s) fp32; any d, every kernel on the tensor cores (at d
// <= 128 on the tiles below; above it in flash_attention.cu's designs,
// attention_mma.cuh's WideFwd and WideBwd: teams of warps a 16-row group,
// each warp a slice of the output and of the scores' contraction, the
// partial scores summed through shared memory, and above d 512 one
// 512-wide chunk of the output a blockIdx.z, the scores taken over d in
// 512-wide pieces). Plan arrays, int32 on
// the device: kv_list (nq, L) and kv_cnt (nq) for the forward and dq,
// q_list (nk, Lt), q_cnt (nk) and q_slot (nk * Lt) for dk/dv; tile_masks
// (nq * L, bq, bk) int8, or null for a plan whose covered blocks are full.
// Slots l >= count are padding and are never visited.
//   - scores s = (q . k) * sm_scale: the scale comes after the product, as
//     in the TPU kernels (l.957, l.1126), not pre-scaled into q; the
//     backward recomputes p = exp(s - lse) from the same s;
//   - key j of query row i is visible when both lie inside their plan
//     blocks and below s, and the tile mask (if any) is set at (i, j).
//     Masked scores are -1e30 and their probabilities exactly 0, so a
//     sub-tile that is wholly masked (the band's partial tiles, the tail
//     past s) adds nothing even when it is a row's first; a row with no
//     visible key gets o = 0, lse = m + log 1 = -1e30 (l.983-991) and dq = 0,
//     a key that no query sees dk = dv = 0;
//   - dS = p * (dp - delta) * sm_scale (l.1162, l.1204), sm_scale inside dS
//     before it is rounded; dq = dS . k with no scale after; dk = dS^T . q
//     with the unscaled q; dv = p^T . do;
//   - ROUND ('default' tier on fp32, or bf16 inputs): q, k, v and do are
//     rounded to bf16 on load, and so are p and dS before their products,
//     with fp32 sums. Without it ('high', 'highest' on fp32 inputs) every
//     product is fp32-class, never one TF32 pass: 3xTF32.
//
// At d <= 128 all three kernels run on the tensor cores with `mma.sync`, on
// the tiles of flash_attention.cu (attention_mma.cuh: 3xTF32 m16n8k8 for
// fp32 'high'/'highest', bf16 m16n8k16 with fp32 sums for 'default' and
// bf16 operands; a warp's `score` C[16, 8 NN] += A . B^T and `pv` O[16, d]
// += C . B with the score's C fragment as its A fragment, so P and dS never
// leave the registers; the 3xTF32 sums banked into the output every 512
// streamed rows, FOLD). Each block's tile follows the plan's blocks, since
// two q-blocks list different kv blocks: four warps, 16 rows each, own a
// 64-row tile of one plan block (a tile partly past its block or s, as
// with blocks of 32 or s off the block, leaves its last warps idle), read
// their block's list themselves and walk, in list order, every listed
// block's sub-tiles (Walk), streaming them by cp.async (16-byte aligned
// operands with d a whole number of 16-byte chunks; other d load
// synchronously). A plan without tile masks takes the mask-free path on
// every sub-tile wholly inside its block and s; a masked plan stages the
// mask rows of each sub-tile beside it (rows of LDM bytes, so a warp's
// eight rows fall on distinct banks) and each lane reads the bytes at its
// C-fragment positions from there: no mask byte is read from device memory
// per score.
//   - blk_flash_fwd (blk_fwd_tc_kernel): q-tiles, 64-key sub-tiles, the
//     online softmax in registers (exp taken as exp2 with log2(e) folded
//     in), in the bf16 tiers eight warps on a 128-row tile where block_q is
//     a multiple of 128 (3xTF32 at eight warps spills at two blocks an SM
//     and is slower at one). One K and one V buffer: V of sub-tile j comes
//     in while its scores and softmax are computed, K (and the mask rows) of
//     sub-tile j + 1 while p.v of j is, across slot boundaries too; two
//     barriers a sub-tile. Two full K/V stages would hold a four-warp block
//     to two blocks an SM at d = 64 (87 KB of fp32); one K and one V buffer
//     (52 KB) let three (3xTF32, 149 registers) or four (bf16, 128) run.
//   - blk_flash_dq (tcbwd::blk_dq_tc_kernel): q-tiles with q and do
//     staged, lse and delta of the warp's rows in registers; K and V of the
//     listed blocks stream in W-key sub-tiles in two stages (with the mask
//     rows of the q-tile against them), the next sub-tile landing across
//     slot boundaries while this one computes, one barrier a sub-tile. S =
//     q k^T and dP = do v^T, then P = exp2(S sm_scale log2e - lse log2e) and
//     dS = P (dP - delta) sm_scale in registers (as blk_fwd_tc_kernel takes
//     s, so p matches the lse it stored), then dq += dS k.
//   - blk_flash_dkv (tcbwd::blk_dkv_tc_kernel): 64-key tiles inside one
//     plan kv block with k and v staged; q and do of the listed q-blocks
//     stream in W-query sub-tiles with their lse and delta (read into
//     registers as the sub-tile is staged, stored beside it once its stage
//     is free) and the mask rows of the forward's tile at q_slot, query-major
//     as stored: the C fragment is keys x queries, so lane (g, t) reads rows
//     8 nt + 2t + c, columns g, g + 8 of them (rows of 80 bytes: the four
//     rows a load touches fall on distinct banks). S^T = k q^T and dP^T = v
//     do^T, P^T and dS^T with lse and delta indexed by the C fragment's
//     column, then dv += P^T do and dk += dS^T q.
//   The streamed sub-tiles (tcbwd::Layout) are W = 32 rows on fp32
//   operands and at d <= 128, 64 on bf16 operands at d <= 64: at d = 64
//   every instance but 3xTF32 dk/dv runs three blocks (twelve warps) an SM,
//   and 3xTF32 dk/dv splits its streamed tiles into tf32 hi and lo once, as
//   they land (PRE), within two: on an H100 at 'bigbird' 512 that ran
//   faster than a third block without the split, and than 64-row
//   sub-tiles with the split (one block an SM) or without it (two).
// At d > 128 the forward runs blk_fwd_wide_tc_kernel (WideFwd's teams) and
// the backward blk_dq_wide_tc_kernel and blk_dkv_wide_tc_kernel, WideBwd's
// teams wrapped in the same list walk and tile masks: per streamed sub-tile
// each warp takes its partial S and dP over its 64 columns of d, the team
// sums both behind one named barrier, and every warp takes the same P and
// dS and adds its products into its own 64 columns of the output. d <= 256:
// two teams of four on 32 rows, dq's keys streamed 32 a sub-tile, dk/dv's
// queries 16; d <= 512: one team of eight on 16 rows, 16 a sub-tile; above
// 512 the same in 512-wide chunks of the output on blockIdx.z. The 3xTF32
// sums are banked every 256 streamed rows. dq's shared memory is full at d
// 256 in 3xTF32, so its mask rows stay in registers (MaskHalves: each lane
// holds half a row's bytes and the warp shuffles them into bits); dk/dv
// stages them beside its sub-tiles as the d <= 128 kernels do.
// No atomics: every output element is summed by one thread in a fixed
// order, so runs repeat bit for bit.
//
// What bounds them. At BERT-base 'bigbird' (bh = 96, s = 512, block 64, 48
// of 64 tiles covered) the forward does 4 bh T 64^2 d = 4.8 GFLOP: 0.029 ms
// on 3xTF32 (3 x 4.8 GFLOP at 495 TFLOP/s tf32), against ~50 MB of
// compulsory traffic (~0.015 ms at 3.35 TB/s); dq does 6 and dk/dv 8 per
// covered entry and d: 0.044 and 0.059 ms. On an H100 SXM at 700 W the
// forward takes 0.171 ms in 3xTF32 (the FFMA forward took 0.278), 0.075 in
// 'default' and 0.054 on bf16 operands; dq 0.216 and dk/dv 0.304 in 3xTF32
// (0.20 and 0.19 of their bounds; the FFMA kernels took 0.340 and 0.447),
// the pair 0.93x SDPA's masked autograd backward, 0.100 and 0.137 in
// 'default', 0.065 and 0.087 on bf16 operands (behind a sleep). Like
// flash's, the loops wait on latency more than they issue: four warps of
// mma.sync, three tf32 passes a product, the 3xTF32 splits and the shared
// loads of B; a tile's walk is short (six listed blocks of 64 at 'bigbird'
// 512), so staging the A tiles costs more than in flash. At d > 128 (the
// same pattern at (b, h, s, d) = (2, 8, 512, 256)) dq takes 0.222-0.225 ms
// and dk/dv 0.373-0.380 in 3xTF32, 0.13 and 0.10 of their bounds (0.0293 and
// 0.0390 ms; the FFMA kernels took 0.740 and 0.811), 0.125 and 0.180 in
// 'default' and 0.097 and 0.152 on bf16 operands.

#include <type_traits>

#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace {

// -- the walk and the tile masks of the tensor-core kernels -------------------

// A block's walk over its list: the W-row sub-tile at r0 of the listed
// block that starts at b0 (list slot `slot`), in list order; slot == cnt
// ends it. settle() moves past sub-tiles that lie past their block or s,
// reading each list entry once as it arrives.
template <int W>
struct Walk {
  const int* list;
  int cnt, bsize, s;
  struct Pos {
    int slot, b0, r0;
  };
  __device__ __forceinline__ void settle(Pos& p) const {
    while (p.slot < cnt && p.r0 >= min(p.b0 + bsize, s)) {
      if (++p.slot < cnt) p.b0 = p.r0 = list[p.slot] * bsize;
    }
  }
  __device__ __forceinline__ Pos first() const {
    Pos p{0, 0, 0};
    if (cnt > 0) p.b0 = p.r0 = list[0] * bsize;
    settle(p);
    return p;
  }
  __device__ __forceinline__ Pos next(const Pos& c) const {
    Pos p{c.slot, c.b0, c.r0 + W};
    settle(p);
    return p;
  }
  // the end of the sub-tile's rows: its block and s cut it
  __device__ __forceinline__ int end(const Pos& p) const {
    return min(min(p.b0 + bsize, s), p.r0 + W);
  }
};

// Bytes a staged mask row of COLS columns: COLS + 16, so the eight rows a
// warp's lanes read at once lie on distinct banks (as rows g = 0..7 in the
// forward and dq, as rows 2t + c, t = 0..3, in dk/dv), 16-byte aligned.
template <int COLS>
constexpr int LDM = COLS + 16;

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of one (bq, bk) tile
// mask into Ms, rows of LDM<COLS> bytes, by NT threads; rows past bq and
// columns past bk are 0. async: 16-byte cp.async copies (bk a multiple of
// 16, the masks 16-byte aligned); else one byte a load.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_mask(int8_t* Ms, const int8_t* __restrict__ tile, int r0,
                                           int c0, int bq, int bk, bool async) {
  constexpr int LD = LDM<COLS>;
  if (async) {
    constexpr int C = COLS / 16;
    for (int e = threadIdx.x; e < ROWS * C; e += NT) {
      const int r = e / C, c = 16 * (e % C);
      const bool in = r0 + r < bq && c0 + c < bk;
      mma16::cp_async16(Ms + r * LD + c,
                        in ? tile + static_cast<size_t>(r0 + r) * bk + c0 + c : tile, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, c = e % COLS;
      Ms[r * LD + c] =
          r0 + r < bq && c0 + c < bk ? tile[static_cast<size_t>(r0 + r) * bk + c0 + c] : 0;
    }
  }
}

// The visible columns of a lane's two rows (warp rows g, g + 8 from row r
// of the staged mask, NN n8 tiles of columns) in the C fragment's order:
// bit 2 nt + c of vis[h] is column col0 + 8 nt + c (col0 = the sub-tile's
// first column + 2t), set when it lies below lim and its mask byte is set.
// Two bytes a load, none from global memory. The forward and dq: rows are
// queries, columns keys.
template <int NN>
__device__ __forceinline__ void mask_bits(uint32_t (&vis)[2], const int8_t* Ms, int r, int t,
                                          int col0, int lim) {
  constexpr int LD = LDM<8 * NN>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int8_t* mr = Ms + (r + 8 * h) * LD + 2 * t;
    uint32_t bits = 0;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      const uint32_t w = *reinterpret_cast<const uint16_t*>(mr + 8 * nt);
      if ((w & 0xffu) != 0 && col0 + 8 * nt < lim) bits |= 1u << (2 * nt);
      if ((w >> 8) != 0 && col0 + 8 * nt + 1 < lim) bits |= 2u << (2 * nt);
    }
    vis[h] = bits;
  }
}

// The same where the warp's rows are keys and the columns queries (dk/dv):
// the staged mask stays query-major (W query rows of LDM<KT> bytes, one
// column a key of the block's key tile), so lane (g, t) reads the bytes of
// keys r + g and r + g + 8 in rows 8 nt + 2t + c, one byte a load.
template <int NN, int KT>
__device__ __forceinline__ void mask_bits_t(uint32_t (&vis)[2], const int8_t* Ms, int r, int g,
                                            int t, int col0, int lim) {
  constexpr int LD = LDM<KT>;
  vis[0] = vis[1] = 0;
#pragma unroll
  for (int nt = 0; nt < NN; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int8_t* mk = Ms + (8 * nt + 2 * t + c) * LD + r + g;
      const bool in = col0 + 8 * nt + c < lim;
      if (in && mk[0] != 0) vis[0] |= 1u << (2 * nt + c);
      if (in && mk[8] != 0) vis[1] |= 1u << (2 * nt + c);
    }
}

// -- launching ------------------------------------------------------------------

// The x extent of a grid of `rows`-row tiles over n plan blocks of b rows,
// or 0 where it passes the grid's limit.
unsigned tiles_x(int n, int b, int rows) {
  const long long x = static_cast<long long>(n) * ((b + rows - 1) / rows);
  return x > 0x7fffffffLL ? 0u : static_cast<unsigned>(x);
}

// 16-byte copies need d a whole number of 16-byte chunks and 16-byte
// aligned operands; the masks bk a multiple of 16 and a 16-byte aligned base
template <typename T>
bool async_ok(int d, const void* a, const void* b) {
  return d % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

bool async_mask_ok(const int8_t* tmask, int bk) {
  return tmask != nullptr && bk % 16 == 0 && reinterpret_cast<uintptr_t>(tmask) % 16 == 0;
}

// kern on `grid` with nt threads and its dynamic shared memory allowed (an
// error, and no launch, where the card has less), on `stream`; returns
// cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kern, size_t smem, dim3 grid, int nt, cudaStream_t stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, nt, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// -- blk_flash_fwd at d <= 128 on the tensor cores ----------------------------
namespace tcfwd {

using mma16::BK;  // keys a sub-tile

// Shared memory of an instance whose q-tile has QT rows: the q-tile, one K
// and one V sub-tile, and for a masked plan the mask rows of the q-tile
// against the sub-tile's keys.
template <bool ROUND, typename T, int DMAX, int QT>
struct Layout {
  using TR = mma16::Tier<ROUND, T, DMAX>;
  static constexpr size_t q_bytes = sizeof(typename TR::TQ) * QT * TR::LDQ;
  static constexpr size_t k_bytes = sizeof(T) * BK * TR::LDK;
  static constexpr size_t v_bytes = sizeof(T) * BK * TR::LDV;
  static constexpr size_t bytes(bool masked) {
    return q_bytes + k_bytes + v_bytes + (masked ? static_cast<size_t>(QT) * LDM<BK> : 0);
  }
};

// Blocks an SM an instance's launch bounds ask for. At d = 64 the bf16
// tiers fit 128 registers a thread: four four-warp or two eight-warp
// blocks, sixteen warps. 3xTF32 needs ~150 and spills at 128 (92 bytes on
// an H100), so three four-warp blocks. At d = 128 the accumulators alone
// take 64 registers: two four-warp blocks, or one of eight.
template <int DMAX, bool ROUND, int NW>
__host__ __device__ constexpr int min_blocks() {
  if (DMAX > 64) return NW == 4 ? 2 : 1;
  if (NW == 8) return 2;
  return ROUND ? 4 : 3;
}

// A q-tile of QT = 16 NW rows inside one plan q-block, NW warps of 16
// rows: four warps own a 64-row tile; eight a 128-row tile where the
// q-block is a multiple of 128 rows and the products are bf16.
template <int DMAX, bool ROUND, typename T, int NW>
__global__ void __launch_bounds__(32 * NW, min_blocks<DMAX, ROUND, NW>())
    blk_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse,
                      const int* __restrict__ kv_list, const int* __restrict__ kv_cnt,
                      const int8_t* __restrict__ tmask, int s, int d, int bq, int bk, int L,
                      float sm_scale, int async_kv, int async_mask) {
  constexpr int NT = 32 * NW, QT = 16 * NW, NO = DMAX / 8;
  using TR = mma16::Tier<ROUND, T, DMAX>;
  using LY = Layout<ROUND, T, DMAX, QT>;
  using TQ = typename TR::TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + LY::q_bytes);
  T* Vs = reinterpret_cast<T*>(smem + LY::q_bytes + LY::k_bytes);
  int8_t* Ms = reinterpret_cast<int8_t*>(smem + LY::q_bytes + LY::k_bytes + LY::v_bytes);

  const int bh = blockIdx.y;
  const int tiles_q = (bq + QT - 1) / QT;
  const int i = blockIdx.x / tiles_q;  // plan q-block
  const int qb0 = i * bq;
  const int q0 = qb0 + (blockIdx.x % tiles_q) * QT;
  const int q_end = min(min(qb0 + bq, s), q0 + QT);
  if (q0 >= q_end) return;  // a row tile past s (uniform over the block)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  // a warp whose rows all lie past the q-block or s stages and waits with
  // the others and computes nothing
  const bool idle = q0 + wr0 >= q_end;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = min(DMAX, (d + 15) / 16 * 16);  // columns the products run over
  const T* kb = k + base;
  const T* vb = v + base;
  const Walk<BK> walk{kv_list + static_cast<size_t>(i) * L, kv_cnt[i], bk, s};
  // K and the mask rows of a sub-tile; rows past its block or s are 0
  auto stage_k = [&](const Walk<BK>::Pos& p) {
    mma16::stage_rows<NT, DMAX, TR::LDK>(Ks, kb, p.r0, walk.end(p), d, async_kv);
    if (tmask != nullptr) {
      stage_mask<QT, BK, NT>(Ms, tmask + (static_cast<size_t>(i) * L + p.slot) * bq * bk,
                             q0 - qb0, p.r0 - p.b0, bq, bk, async_mask);
    }
    mma16::cp_async_commit();
  };

  auto cur = walk.first();
  if (cur.slot < walk.cnt) stage_k(cur);  // in flight while q is loaded
  mma16::load_q<QT, NT, DMAX, TR::LDQ>(Qs, q + base, q0, s, d, 1.f);
  float m[2] = {attn::NEG, attn::NEG}, l[2] = {0.f, 0.f};
  float mb[2] = {attn::NEG, attn::NEG};  // the bank's max (3xTF32)
  int since = 0;                         // sub-tiles summed since the last fold
  bool banked = false;
  T* ob = o + base;
  float oacc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[nt][c] = 0.f;

  while (cur.slot < walk.cnt) {
    mma16::cp_async_wait_all();
    // K and the mask rows of `cur` are staged and visible to every warp;
    // every reader of V (the last sub-tile's p.v) is done
    __syncthreads();
    mma16::stage_rows<NT, DMAX, TR::LDV>(Vs, vb, cur.r0, walk.end(cur), d, async_kv);
    mma16::cp_async_commit();  // V streams in while the scores are computed
    float sacc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[nt][c] = 0.f;
    if (!idle) {
      TR::score(sacc, Qs, Ks, kd, wr0, lane);
      const int lim = walk.end(cur);
      if (tmask != nullptr) {
        uint32_t vis[2];
        mask_bits<BK / 8>(vis, Ms, wr0 + g, t, cur.r0 + 2 * t, lim);
        mma16::softmax_tile_if<true>(sacc, oacc, m, l, sm_scale, [&](int h, int nt, int c) {
          return ((vis[h] >> (2 * nt + c)) & 1u) != 0;
        });
      } else if (lim == cur.r0 + BK) {  // every key of the sub-tile is visible
        mma16::softmax_tile<false>(sacc, oacc, m, l, sm_scale, 0, {lim, lim});
      } else {
        mma16::softmax_tile<true>(sacc, oacc, m, l, sm_scale, cur.r0 + 2 * t, {lim, lim});
      }
    }
    mma16::cp_async_wait_all();
    // V of `cur` is staged and visible; every reader of K and the mask rows
    // is done, so the next sub-tile's stream in while p.v is computed
    __syncthreads();
    const auto nxt = walk.next(cur);
    if (nxt.slot < walk.cnt) stage_k(nxt);
    if (!idle) {
      TR::pv(oacc, sacc, Vs, kd, lane);
      // 3xTF32: every FOLD sub-tiles the warp moves its sum into o (the
      // bank), so the tensor cores' own accumulation never adds more
      if constexpr (!ROUND) {
        if (++since == mma16::FOLD && nxt.slot < walk.cnt) {
          mma16::bank(ob, oacc, m, mb, banked, q0 + wr0 + g, q_end, d, t);
          since = 0;
          banked = true;
        }
      }
    }
    cur = nxt;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + wr0 + g + 8 * h;
    if (qp >= q_end) continue;
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
    if (t == 0) {
      lse[static_cast<size_t>(bh) * s + qp] = l[h] > 0.f ? m[h] + logf(l[h]) : attn::NEG;
    }
  }
}

template <int DMAX, bool ROUND, typename T, int NW>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const int* kv_list,
           const int* kv_cnt, const int8_t* tmask, int bh, int s, int d, int bq, int bk, int nq,
           int L, float sm_scale, cudaStream_t stream) {
  constexpr int QT = 16 * NW;
  const bool async_kv = async_ok<T>(d, k, v), async_mask = async_mask_ok(tmask, bk);
  const unsigned tiles = tiles_x(nq, bq, QT);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(blk_fwd_tc_kernel<DMAX, ROUND, T, NW>,
                       Layout<ROUND, T, DMAX, QT>::bytes(tmask != nullptr), dim3(tiles, bh),
                       32 * NW, stream, static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
                       kv_list, kv_cnt, tmask, s, d, bq, bk, L, sm_scale,
                       static_cast<int>(async_kv), static_cast<int>(async_mask));
}

}  // namespace tcfwd

// -- blk_flash_dq and blk_flash_dkv at d <= 128 on the tensor cores -----------
namespace tcbwd {

constexpr int NW = 4, NT = 32 * NW, RT = 16 * NW;  // warps, threads, rows a block

// The shared-memory layout of an instance (mma16::BwdLayout) and the rows W
// of its streamed sub-tiles: 64 on bf16 operands at d <= 64, else 32. The
// fp32 operands' loops wait on latency more than they issue, and 32 rows
// let dq and 'default' dk/dv run three blocks an SM, and 3xTF32 dk/dv split
// its streamed tiles at staging (SPLIT) within two.
template <bool ROUND, typename T, int DMAX, bool SPLIT>
using Layout = mma16::BwdLayout<ROUND, T, DMAX, RT, SPLIT,
                                (std::is_same_v<T, __nv_bfloat16> && DMAX <= 64) ? 64 : 32>;

// Bytes a stage of mask rows (dq: the q-tile's RT rows against the W keys of
// a sub-tile; dk/dv: the W queries of a sub-tile against the RT keys), and
// the instance's shared memory: the layout, then for a masked plan two
// stages of mask rows.
template <typename LY, bool DKV>
__host__ __device__ constexpr size_t mask_stage() {
  return DKV ? static_cast<size_t>(LY::W) * LDM<RT> : static_cast<size_t>(RT) * LDM<LY::W>;
}

template <typename LY, bool DKV>
__host__ __device__ constexpr size_t smem_bytes(bool masked) {
  return LY::bytes + (masked ? 2 * mask_stage<LY, DKV>() : 0);
}

// Blocks an SM the launch bounds ask for: as many as the SM's 228 KB of
// shared memory holds at the masked layout, at most three at d <= 64 (170
// registers a thread) and two at d <= 128 (255; dk/dv's accumulators alone
// take 128).
template <typename LY, bool DKV, int DMAX>
__host__ __device__ constexpr int min_blocks() {
  const size_t per = smem_bytes<LY, DKV>(true) + 1024;
  const int n = static_cast<int>((228 * 1024) / per), most = DMAX <= 64 ? 3 : 2;
  return n < 1 ? 1 : n > most ? most : n;
}

// dq = dS . k, dS = P (dP - delta) sm_scale, P = exp(q k^T sm_scale - lse),
// dP = do v^T: four warps own an RT-row q-tile inside one plan q-block, 16
// rows a warp, and walk the listed kv blocks' W-key sub-tiles in list
// order, K and V (and the mask rows) streaming in two stages.
template <int DMAX, bool ROUND, typename T, typename LY>
__global__ void __launch_bounds__(NT, min_blocks<LY, false, DMAX>())
    blk_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     const int* __restrict__ kv_list, const int* __restrict__ kv_cnt,
                     const int8_t* __restrict__ tmask, int s, int d, int bq, int bk, int L,
                     float sm_scale, int async_kv, int async_mask) {
  using TR = mma16::Tier<ROUND, T, DMAX>;
  using TQ = typename TR::TQ;
  constexpr int W = LY::W, NN = W / 8, NO = DMAX / 8, LDB = LY::LDB;
  constexpr size_t MS = mask_stage<LY, false>();
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  TQ* dOs = reinterpret_cast<TQ*>(smem + LY::a_bytes);
  T* KV = reinterpret_cast<T*>(smem + LY::b_off);
  int8_t* MK = reinterpret_cast<int8_t*>(smem + LY::bytes);

  const int bh = blockIdx.y;
  const int tiles_q = (bq + RT - 1) / RT;
  const int i = blockIdx.x / tiles_q;  // plan q-block
  const int qb0 = i * bq;
  const int q0 = qb0 + (blockIdx.x % tiles_q) * RT;
  const int q_end = min(min(qb0 + bq, s), q0 + RT);
  if (q0 >= q_end) return;  // a row tile past s (uniform over the block)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  // a warp whose rows all lie past the q-block or s stages and waits with
  // the others and computes nothing
  const bool idle = q0 + wr0 >= q_end;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = min(DMAX, (d + 15) / 16 * 16);  // columns the products run over
  const T* kb = k + base;
  const T* vb = v + base;
  const Walk<W> walk{kv_list + static_cast<size_t>(i) * L, kv_cnt[i], bk, s};

  // K, V and the mask rows of sub-tile p into stage n % 2; rows past its
  // block or s are 0
  auto stage = [&](const typename Walk<W>::Pos& p, int n) {
    T* dst = KV + (n % 2) * LY::stage;
    const int end = walk.end(p);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst, kb, p.r0, end, d, async_kv);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst + W * LDB, vb, p.r0, end, d, async_kv);
    if (tmask != nullptr) {
      stage_mask<RT, W, NT>(MK + (n % 2) * MS,
                            tmask + (static_cast<size_t>(i) * L + p.slot) * bq * bk, q0 - qb0,
                            p.r0 - p.b0, bq, bk, async_mask);
    }
    mma16::cp_async_commit();
  };
  auto cur = walk.first();
  if (cur.slot < walk.cnt) stage(cur, 0);  // in flight while q and do are loaded
  mma16::load_q<RT, NT, DMAX, TR::LDQ>(Qs, q + base, q0, s, d, 1.f);
  mma16::load_q<RT, NT, DMAX, TR::LDQ>(dOs, dout + base, q0, s, d, 1.f);
  // rows g and g + 8 of the warp: lse (log2 domain) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr0 + g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * s + row;
    lse2[h] = row < q_end ? lse[at] * mma16::LOG2E : 0.f;
    dlt[h] = row < q_end ? delta[at] : 0.f;
  }
  auto stat = [&](int h, int, int, float& l2, float& dl) {
    l2 = lse2[h];
    dl = dlt[h];
  };
  int since = 0;  // sub-tiles summed since the last fold (3xTF32)
  bool banked = false;
  T* dqb = dq + base;
  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  for (int n = 0; cur.slot < walk.cnt; ++n) {
    T* Kb = KV + (n % 2) * LY::stage;
    T* Vb = Kb + W * LDB;
    const int8_t* Ms = MK + (n % 2) * MS;
    mma16::cp_async_wait_all();
    LY::template split_staged<NT>(Kb, Vb, async_kv);
    // sub-tile n is staged and visible to every warp; every reader of the
    // other stage (sub-tile n - 1) is done, so sub-tile n + 1 may stream
    // into it, across slot boundaries too
    __syncthreads();
    const auto nxt = walk.next(cur);
    if (nxt.slot < walk.cnt) stage(nxt, n + 1);
    if (!idle) {
      float sp[NN][4], dp[NN][4];
#pragma unroll
      for (int nt = 0; nt < NN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
      LY::score(sp, Qs, Kb, kd, wr0, lane);
      LY::score(dp, dOs, Vb, kd, wr0, lane);
      const int lim = walk.end(cur);
      if (tmask != nullptr) {
        uint32_t vis[2];
        mask_bits<NN>(vis, Ms, wr0 + g, t, cur.r0 + 2 * t, lim);
        mma16::probs_ds<true>(
            sp, dp, stat,
            [&](int h, int nt, int c) { return ((vis[h] >> (2 * nt + c)) & 1u) != 0; },
            sm_scale, sm_scale);
      } else if (lim == cur.r0 + W) {  // every key of the sub-tile is visible
        mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; }, sm_scale,
                               sm_scale);
      } else {
        const int key0 = cur.r0 + 2 * t;
        mma16::probs_ds<true>(
            sp, dp, stat, [&](int, int nt, int c) { return key0 + 8 * nt + c < lim; }, sm_scale,
            sm_scale);
      }
      LY::pv(acc, dp, Kb, kd, lane);
      // 3xTF32: every FOLD sub-tiles the warp moves its sum into dq (the
      // bank), so the tensor cores' own accumulation never adds more
      if constexpr (!ROUND) {
        if (++since == LY::FOLD && nxt.slot < walk.cnt) {
          mma16::bank(dqb, acc, banked, q0 + wr0 + g, q_end, d, t);
          since = 0;
          banked = true;
        }
      }
    }
    cur = nxt;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + wr0 + g + 8 * h;
    if (qp >= q_end) continue;
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
        attn::store(p, x);
      }
  }
}

// dv = P^T . do and dk = dS^T . q: four warps own an RT-key tile inside one
// plan kv block, 16 keys a warp, and walk the listed q-blocks' W-query
// sub-tiles in list order, q and do (with their lse and delta, and the mask
// rows of the forward's tile at q_slot) streaming in two stages.
template <int DMAX, bool ROUND, typename T, typename LY>
__global__ void __launch_bounds__(NT, min_blocks<LY, true, DMAX>())
    blk_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      const int* __restrict__ q_list, const int* __restrict__ q_cnt,
                      const int* __restrict__ q_slot, const int8_t* __restrict__ tmask, int s,
                      int d, int bq, int bk, int Lt, float sm_scale, int async_q,
                      int async_mask) {
  using TR = mma16::Tier<ROUND, T, DMAX>;
  using TQ = typename TR::TQ;
  constexpr int W = LY::W, NN = W / 8, NO = DMAX / 8, LDB = LY::LDB;
  constexpr size_t MS = mask_stage<LY, true>();
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Ks = reinterpret_cast<TQ*>(smem);
  TQ* Vs = reinterpret_cast<TQ*>(smem + LY::a_bytes);
  T* QD = reinterpret_cast<T*>(smem + LY::b_off);
  float* ST = reinterpret_cast<float*>(smem + LY::stat_off);  // stage i: lse2 then delta
  int8_t* MK = reinterpret_cast<int8_t*>(smem + LY::bytes);

  const int bh = blockIdx.y;
  const int tiles_k = (bk + RT - 1) / RT;
  const int j = blockIdx.x / tiles_k;  // plan kv block
  const int kb0 = j * bk;
  const int k0 = kb0 + (blockIdx.x % tiles_k) * RT;
  const int k_end = min(min(kb0 + bk, s), k0 + RT);
  if (k0 >= k_end) return;  // keys past s: nothing to write
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  const bool idle = k0 + wr0 >= k_end;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = min(DMAX, (d + 15) / 16 * 16);
  const T* qb = q + base;
  const T* ob = dout + base;
  const float* lseb = lse + static_cast<size_t>(bh) * s;
  const float* dlb = delta + static_cast<size_t>(bh) * s;
  const Walk<W> walk{q_list + static_cast<size_t>(j) * Lt, q_cnt[j], bq, s};

  mma16::RowStats<W> stat_next;  // the lse and delta of the sub-tile being staged
  // q, do and the mask rows of sub-tile p into stage n % 2; rows past its
  // block or s are 0
  auto stage = [&](const typename Walk<W>::Pos& p, int n) {
    T* dst = QD + (n % 2) * LY::stage;
    const int end = walk.end(p);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst, qb, p.r0, end, d, async_q);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst + W * LDB, ob, p.r0, end, d, async_q);
    if (tmask != nullptr) {
      // the forward stored this (q-block, kv-block) tile's mask at q_slot
      const size_t tile = q_slot[static_cast<size_t>(j) * Lt + p.slot];
      stage_mask<W, RT, NT>(MK + (n % 2) * MS, tmask + tile * bq * bk, p.r0 - p.b0, k0 - kb0,
                            bq, bk, async_mask);
    }
    mma16::cp_async_commit();
    stat_next.load(lseb, dlb, p.r0, end);
  };
  auto cur = walk.first();
  if (cur.slot < walk.cnt) {
    stage(cur, 0);  // in flight while k and v are loaded
    stat_next.store(ST);
  }
  mma16::load_q<RT, NT, DMAX, TR::LDQ>(Ks, k + base, k0, s, d, 1.f);
  mma16::load_q<RT, NT, DMAX, TR::LDQ>(Vs, v + base, k0, s, d, 1.f);
  int since = 0;
  bool banked = false;
  T* dkb = dk + base;
  T* dvb = dv + base;
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[nt][c] = acc_v[nt][c] = 0.f;

  for (int n = 0; cur.slot < walk.cnt; ++n) {
    T* Qb = QD + (n % 2) * LY::stage;
    T* dOb = Qb + W * LDB;
    const int8_t* Ms = MK + (n % 2) * MS;
    const float* st = ST + (n % 2) * 2 * W;
    mma16::cp_async_wait_all();
    LY::template split_staged<NT>(Qb, dOb, async_q);
    // sub-tile n is staged and visible to every warp with its lse and
    // delta; every reader of the other stage (sub-tile n - 1) is done
    __syncthreads();
    const auto nxt = walk.next(cur);
    if (nxt.slot < walk.cnt) stage(nxt, n + 1);
    if (!idle) {
      float sp[NN][4], dp[NN][4];
#pragma unroll
      for (int nt = 0; nt < NN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
      LY::score(sp, Ks, Qb, kd, wr0, lane);
      LY::score(dp, Vs, dOb, kd, wr0, lane);
      // the statistics of the C fragment's column (query) 8 nt + 2t + c
      auto stat = [&](int, int nt, int c, float& l2, float& dl) {
        l2 = st[8 * nt + 2 * t + c];
        dl = st[W + 8 * nt + 2 * t + c];
      };
      const int lim = walk.end(cur);
      if (tmask != nullptr) {
        uint32_t vis[2];
        mask_bits_t<NN, RT>(vis, Ms, wr0, g, t, cur.r0 + 2 * t, lim);
        mma16::probs_ds<true>(
            sp, dp, stat,
            [&](int h, int nt, int c) { return ((vis[h] >> (2 * nt + c)) & 1u) != 0; },
            sm_scale, sm_scale);
      } else if (lim == cur.r0 + W) {  // every query of the sub-tile sees every key
        mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; }, sm_scale,
                               sm_scale);
      } else {
        const int qj0 = cur.r0 + 2 * t;
        mma16::probs_ds<true>(
            sp, dp, stat, [&](int, int nt, int c) { return qj0 + 8 * nt + c < lim; }, sm_scale,
            sm_scale);
      }
      LY::pv(acc_v, sp, dOb, kd, lane);
      LY::pv(acc_k, dp, Qb, kd, lane);
      if constexpr (!ROUND) {
        if (++since == LY::FOLD && nxt.slot < walk.cnt) {
          mma16::bank(dkb, acc_k, banked, k0 + wr0 + g, k_end, d, t);
          mma16::bank(dvb, acc_v, banked, k0 + wr0 + g, k_end, d, t);
          since = 0;
          banked = true;
        }
      }
    }
    if (nxt.slot < walk.cnt) stat_next.store(ST + ((n + 1) % 2) * 2 * W);
    cur = nxt;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + wr0 + g + 8 * h;
    if (kp >= k_end) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * t + c;
        if (col >= d) continue;
        const size_t at = static_cast<size_t>(kp) * d + col;
        float xk = acc_k[nt][2 * h + c], xv = acc_v[nt][2 * h + c];
        if constexpr (!ROUND) {
          if (banked) {
            xk = fmaf(dkb[at], 1.f, xk);
            xv = fmaf(dvb[at], 1.f, xv);
          }
        }
        attn::store(&dkb[at], xk);
        attn::store(&dvb[at], xv);
      }
  }
}

template <int DMAX, bool ROUND, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, const int* kv_list, const int* kv_cnt,
              const int8_t* tmask, int bh, int s, int d, int bq, int bk, int nq, int L,
              float sm_scale, cudaStream_t stream) {
  using LY = Layout<ROUND, T, DMAX, false>;
  const unsigned tiles = tiles_x(nq, bq, RT);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(blk_dq_tc_kernel<DMAX, ROUND, T, LY>,
                       smem_bytes<LY, false>(tmask != nullptr), dim3(tiles, bh), NT, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dq), kv_list, kv_cnt, tmask, s, d, bq, bk, L, sm_scale,
                       static_cast<int>(async_ok<T>(d, k, v)),
                       static_cast<int>(async_mask_ok(tmask, bk)));
}

template <int DMAX, bool ROUND, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, const int* q_list, const int* q_cnt,
               const int* q_slot, const int8_t* tmask, int bh, int s, int d, int bq, int bk,
               int nk, int Lt, float sm_scale, cudaStream_t stream) {
  using LY = Layout<ROUND, T, DMAX, true>;
  const unsigned tiles = tiles_x(nk, bk, RT);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(blk_dkv_tc_kernel<DMAX, ROUND, T, LY>,
                       smem_bytes<LY, true>(tmask != nullptr), dim3(tiles, bh), NT, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dk), static_cast<T*>(dv), q_list, q_cnt, q_slot, tmask, s,
                       d, bq, bk, Lt, sm_scale, static_cast<int>(async_ok<T>(d, q, dout)),
                       static_cast<int>(async_mask_ok(tmask, bk)));
}

}  // namespace tcbwd

// -- blk_flash_fwd at d > 128 on the tensor cores ------------------------------
namespace widefwd {

// Shared memory: mma16::WideFwd's, then two stages of the mask rows of the
// q-tile against a W-key sub-tile.
template <typename F>
constexpr size_t mask_stage = static_cast<size_t>(F::QT) * LDM<F::W>;

// The forward of mma16::WideFwd's teams on a q-tile inside one plan q-block:
// the listed blocks' W-key sub-tiles in list order (Walk). d <= DMAX: K, V
// and the mask rows streamed in two stages across slot boundaries, one
// barrier a sub-tile. CHUNK (d > DMAX): the block's DMAX-wide chunk of o on
// z, and per sub-tile q's and k's columns staged a DMAX-wide piece at a time
// for S, V's chunk and the mask rows with the first piece.
template <bool ROUND, typename T, int DMAX, bool CHUNK>
__global__ void __launch_bounds__(mma16::WideFwdFor<ROUND, T, DMAX>::NT, 1)
    blk_fwd_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ kv_list, const int* __restrict__ kv_cnt,
                           const int8_t* __restrict__ tmask, int s, int d, int bq, int bk, int L,
                           float sm_scale, int async_kv, int async_mask) {
  using FW = mma16::WideFwdFor<ROUND, T, DMAX>;
  using TR = typename FW::TR;
  using TQ = typename FW::TQ;
  constexpr int NT = FW::NT, QT = FW::QT, W = FW::W, NN = FW::NN, NO = FW::NO;
  constexpr size_t MS = mask_stage<FW>;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  T* KV = reinterpret_cast<T*>(smem + FW::q_bytes);
  float* X = reinterpret_cast<float*>(smem + FW::x_off);
  int8_t* MK = reinterpret_cast<int8_t*>(smem + FW::bytes);

  const int bh = blockIdx.y;
  const int tiles_q = (bq + QT - 1) / QT;
  const int i = blockIdx.x / tiles_q;  // plan q-block
  const int qb0 = i * bq;
  const int q0 = qb0 + (blockIdx.x % tiles_q) * QT;
  const int q_end = min(min(qb0 + bq, s), q0 + QT);
  if (q0 >= q_end) return;  // a row tile past s (uniform over the block)
  const int c_out = CHUNK ? blockIdx.z * FW::DMAX : 0;  // the block's chunk of o
  const int wv = min(FW::DMAX, d - c_out);               // and its width
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % (QT / 16), h = warp / (QT / 16);  // the warp's team and slice
  const int g = lane / 4, t = lane % 4, wr0 = 16 * rg;
  // a team whose rows all lie past the q-block or s stages and waits with
  // the others and computes nothing
  const bool idle = q0 + wr0 >= q_end;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const T* kb = k + base;
  const T* vb = v + base;
  const Walk<W> walk{kv_list + static_cast<size_t>(i) * L, kv_cnt[i], bk, s};

  auto stage_mask_rows = [&](const typename Walk<W>::Pos& p, int8_t* dst) {
    if (tmask != nullptr) {
      stage_mask<QT, W, NT>(dst, tmask + (static_cast<size_t>(i) * L + p.slot) * bq * bk,
                            q0 - qb0, p.r0 - p.b0, bq, bk, async_mask);
    }
  };
  // K, V and the mask rows of sub-tile p into stage n % 2; rows past its
  // block or s are 0
  auto stage = [&](const typename Walk<W>::Pos& p, int n) {
    T* dst = KV + (n % 2) * FW::stage;
    const int end = walk.end(p);
    mma16::stage_rows<NT, FW::DMAX, TR::LDK, W>(dst, kb, p.r0, end, d, async_kv);
    mma16::stage_rows<NT, FW::DMAX, TR::LDV, W>(dst + W * TR::LDK, vb, p.r0, end, d, async_kv);
    stage_mask_rows(p, MK + (n % 2) * MS);
    mma16::cp_async_commit();
  };
  auto cur = walk.first();
  if constexpr (!CHUNK) {
    if (cur.slot < walk.cnt) stage(cur, 0);  // in flight while q is loaded
    mma16::load_q<QT, NT, FW::DMAX, TR::LDQ>(Qs, q + base, q0, s, d, 1.f);
  }
  float m[2] = {attn::NEG, attn::NEG}, l[2] = {0.f, 0.f};
  float mb[2] = {attn::NEG, attn::NEG};  // the bank's max (3xTF32)
  int since = 0;                         // sub-tiles summed since the last fold
  bool banked = false;
  T* ob = o + base;
  float oacc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[nt][c] = 0.f;

  for (int n = 0; cur.slot < walk.cnt; ++n) {
    const auto nxt = walk.next(cur);
    float sacc[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[nt][c] = 0.f;
    const T* Vb;
    const int8_t* Ms;
    if constexpr (CHUNK) {
      Vb = KV + W * TR::LDK;
      Ms = MK;
      FW::score_chunked(sacc, Qs, KV, KV + FW::stage, X, q + base, q0, s, 1.f, kb, cur.r0,
                        walk.end(cur), d, async_kv, idle, rg, h, wr0, lane, [&] {
                          mma16::stage_rows<NT, FW::DMAX, TR::LDV, W>(
                              KV + W * TR::LDK, vb + c_out, cur.r0, walk.end(cur), d, async_kv,
                              wv);
                          stage_mask_rows(cur, MK);
                        });
    } else {
      const T* Kb = KV + (n % 2) * FW::stage;
      Vb = Kb + W * TR::LDK;
      Ms = MK + (n % 2) * MS;
      mma16::cp_async_wait_all();
      // sub-tile n is staged and visible to every warp; every reader of the
      // other stage (sub-tile n - 1) and of the teams' partials is done, so
      // sub-tile n + 1 may stream into it, across slot boundaries too
      __syncthreads();
      if (nxt.slot < walk.cnt) stage(nxt, n + 1);
      if (!idle) FW::score(sacc, Qs, Kb, X, d, rg, h, wr0, lane);
    }
    if (!idle) {
      const int lim = walk.end(cur);
      if (tmask != nullptr) {
        uint32_t vis[2];
        mask_bits<NN>(vis, Ms, wr0 + g, t, cur.r0 + 2 * t, lim);
        mma16::softmax_tile_if<true>(sacc, oacc, m, l, sm_scale, [&](int hh, int nt, int c) {
          return ((vis[hh] >> (2 * nt + c)) & 1u) != 0;
        });
      } else if (lim == cur.r0 + W) {  // every key of the sub-tile is visible
        mma16::softmax_tile<false>(sacc, oacc, m, l, sm_scale, 0, {lim, lim});
      } else {
        mma16::softmax_tile<true>(sacc, oacc, m, l, sm_scale, cur.r0 + 2 * t, {lim, lim});
      }
      FW::pv(oacc, sacc, Vb, wv, h, lane);
      // 3xTF32: every FOLD sub-tiles the warp moves its sum into o (the
      // bank), so the tensor cores' own accumulation never adds more
      if constexpr (!ROUND) {
        if (++since == FW::FOLD && nxt.slot < walk.cnt) {
          mma16::bank(ob, oacc, m, mb, banked, q0 + wr0 + g, q_end, d, t, c_out + FW::DW * h);
          since = 0;
          banked = true;
        }
      }
    }
    cur = nxt;
  }
  FW::store(ob, lse + static_cast<size_t>(bh) * s, oacc, m, l, mb, banked, q0 + wr0 + g, q_end,
            d, c_out + FW::DW * h, h == 0 && c_out == 0, t);
}

// d <= 256: the 256 instance; wider d the 512 instance, above 512 in
// 512-wide chunks of o
template <bool ROUND, typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const int* kv_list,
           const int* kv_cnt, const int8_t* tmask, int bh, int s, int d, int bq, int bk, int nq,
           int L, float sm_scale, cudaStream_t stream) {
  using FW = mma16::WideFwdFor<ROUND, T, DMAX>;
  const unsigned tiles = tiles_x(nq, bq, FW::QT);
  const int chunks = (d + FW::DMAX - 1) / FW::DMAX;
  if (tiles == 0 || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // the chunks also stage q by cp.async
  const bool async_kv =
      async_ok<T>(d, k, v) && (chunks == 1 || reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const size_t smem = FW::bytes + (tmask != nullptr ? 2 * mask_stage<FW> : 0);
  constexpr bool CHUNKS = DMAX == 512;  // the 256 instance serves d <= 256 alone
  return launch_kernel(chunks > 1 ? blk_fwd_wide_tc_kernel<ROUND, T, DMAX, CHUNKS>
                                  : blk_fwd_wide_tc_kernel<ROUND, T, DMAX, false>,
                       smem, dim3(tiles, bh, chunks), FW::NT, stream, static_cast<const T*>(q),
                       static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
                       static_cast<float*>(lse), kv_list, kv_cnt, tmask, s, d, bq, bk, L,
                       sm_scale, static_cast<int>(async_kv),
                       static_cast<int>(async_mask_ok(tmask, bk)));
}

}  // namespace widefwd

// -- blk_flash_dq and blk_flash_dkv at d > 128 on the tensor cores ------------
namespace widebwd {

using mma16::LOG2E;

constexpr size_t SMEM_MAX = 232448;  // the shared memory an H100 block may have

// The tile-mask rows of a team's 16 queries against a W-key sub-tile, held
// in registers: the wide dq's shared memory is full (fp32 'high' at d 256
// takes all of SMEM_MAX). Lane l reads half of row l / 2, its bytes
// (l % 2) W / 2 onwards, from device memory as the sub-tile is staged (the
// team's warps each read the same rows) and turns them into bits when the
// sub-tile is computed. Rows past bq and columns past bk are 0.
template <int W>
struct MaskHalves {
  static_assert(W == 16 || W == 32, "a row of a sub-tile's mask: at most 32 bits");
  static constexpr int HB = W / 2, NWD = HB / 4;  // bytes, and 32-bit words, a lane
  uint32_t raw[NWD];

  // tile: the (bq, bk) mask; r0: the tile row of the team's first query;
  // c0: the sub-tile's first column. vec: rows of a multiple of 16 bytes
  // from a 16-byte aligned tile (async_mask_ok), read HB bytes a load.
  __device__ __forceinline__ void load(const int8_t* __restrict__ tile, int r0, int c0, int bq,
                                       int bk, bool vec, int lane) {
    const int r = r0 + lane / 2, c = c0 + (lane % 2) * HB;
    const int8_t* src = tile + static_cast<size_t>(r) * bk + c;
    if (vec) {
      const bool in = r < bq && c < bk;  // bk % 16 == 0: the whole half or none of it
      if constexpr (NWD == 4) {
        const uint4 x = in ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
        raw[0] = x.x;
        raw[1] = x.y;
        raw[2] = x.z;
        raw[3] = x.w;
      } else {
        const uint2 x = in ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0, 0);
        raw[0] = x.x;
        raw[1] = x.y;
      }
    } else {
#pragma unroll
      for (int w = 0; w < NWD; ++w) {
        raw[w] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = 4 * w + b;
          if (r < bq && c + j < bk) raw[w] |= static_cast<uint32_t>(src[j] != 0) << (8 * b);
        }
      }
    }
  }

  // The visible keys of the lane's rows g and g + 8 in mask_bits' order:
  // bit 2 nt + c of vis[h] is column 2t + 8 nt + c of the sub-tile, cleared
  // at or past column n (the end of the sub-tile's block, or s). Every lane
  // of the warp calls it: the rows' halves come by shuffles.
  __device__ __forceinline__ void bits(uint32_t (&vis)[2], int g, int t, int n) const {
    uint32_t half = 0;
#pragma unroll
    for (int w = 0; w < NWD; ++w)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (((raw[w] >> (8 * b)) & 0xffu) != 0) half |= 1u << (4 * w + b);
    const uint32_t keep = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      const uint32_t lo = __shfl_sync(0xffffffffu, half, 2 * row);
      const uint32_t hi = __shfl_sync(0xffffffffu, half, 2 * row + 1);
      const uint32_t w = (lo | (hi << HB)) & keep;
      uint32_t v = 0;
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if ((w >> (2 * t + 8 * nt + c)) & 1u) v |= 1u << (2 * nt + c);
      vis[h] = v;
    }
  }
};

// dq = dS . k, dS = P (dP - delta) sm_scale, P = exp(q k^T sm_scale - lse),
// dP = do v^T on mma16::WideBwd's teams: a tile of RT queries inside one
// plan q-block (q and do staged once, unscaled) walks the listed kv blocks'
// W-key sub-tiles in list order (Walk), K and V streamed in two cp.async
// stages across slot boundaries, one block barrier a sub-tile, the mask
// rows in registers (MaskHalves). S and dP are summed over the team's
// slices, P and dS taken as blk_dq_tc_kernel takes them, then dq[:, slice]
// += dS k[:, slice], stored with no scale. A team whose rows all lie past
// the q-block or s stages and waits with the others and computes nothing.
// CHUNK (d > DMAX): the block's DMAX-wide chunk of dq on z, and per
// sub-tile the pieces of q, do, K and V staged in turn for S and dP over
// all of d, K's chunk with the first piece (stage 1).
template <bool ROUND, typename T, int DMAX, bool CHUNK>
__global__ void __launch_bounds__(mma16::WideDqFor<ROUND, T, DMAX>::NT, 1)
    blk_dq_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, const int* __restrict__ kv_list,
                          const int* __restrict__ kv_cnt, const int8_t* __restrict__ tmask, int s,
                          int d, int bq, int bk, int L, float sm_scale, int async_kv,
                          int async_mask) {
  using B = mma16::WideDqFor<ROUND, T, DMAX>;
  using TQ = typename B::TQ;
  using TR = typename B::TR;
  constexpr int NT = B::NT, RT = B::RT, W = B::W, NN = B::NN, NO = B::NO, LDB = B::LDB;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Qs = reinterpret_cast<TQ*>(smem);
  TQ* dOs = reinterpret_cast<TQ*>(smem + B::a_bytes);
  T* KV = reinterpret_cast<T*>(smem + B::b_off);
  float* X = reinterpret_cast<float*>(smem + B::x_off);

  const int bh = blockIdx.y;
  const int tiles_q = (bq + RT - 1) / RT;
  const int i = blockIdx.x / tiles_q;  // plan q-block
  const int qb0 = i * bq;
  const int q0 = qb0 + (blockIdx.x % tiles_q) * RT;
  const int q_end = min(min(qb0 + bq, s), q0 + RT);
  if (q0 >= q_end) return;  // a row tile past s (uniform over the block)
  const int c_out = CHUNK ? blockIdx.z * DMAX : 0;  // the block's chunk of dq
  const int wv = min(DMAX, d - c_out);              // and its width
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % B::NRG, h = warp / B::NRG;  // the warp's team and slice
  const int g = lane / 4, t = lane % 4, wr0 = 16 * rg;
  // a team whose rows all lie past the q-block or s stages and waits with
  // the others and computes nothing
  const bool idle = q0 + wr0 >= q_end;
  const int kd = B::kd(wv, h);
  const size_t base = static_cast<size_t>(bh) * s * d;
  const T* kb = k + base;
  const T* vb = v + base;
  const Walk<W> walk{kv_list + static_cast<size_t>(i) * L, kv_cnt[i], bk, s};

  MaskHalves<W> mk;  // the mask rows of the sub-tile staged last
  auto load_mask = [&](const typename Walk<W>::Pos& p) {
    if (tmask != nullptr) {
      mk.load(tmask + (static_cast<size_t>(i) * L + p.slot) * bq * bk, q0 - qb0 + wr0,
              p.r0 - p.b0, bq, bk, async_mask, lane);
    }
  };
  // K and V of sub-tile p into stage n % 2 (rows past its block or s 0),
  // and its mask rows
  auto stage = [&](const typename Walk<W>::Pos& p, int n) {
    T* dst = KV + (n % 2) * B::stage;
    const int end = walk.end(p);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst, kb, p.r0, end, d, async_kv);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst + W * LDB, vb, p.r0, end, d, async_kv);
    mma16::cp_async_commit();
    load_mask(p);
  };
  auto cur = walk.first();
  if constexpr (!CHUNK) {
    if (cur.slot < walk.cnt) stage(cur, 0);  // in flight while q and do are loaded
    mma16::load_q<RT, NT, DMAX, TR::LDQ>(Qs, q + base, q0, s, d, 1.f);
    mma16::load_q<RT, NT, DMAX, TR::LDQ>(dOs, dout + base, q0, s, d, 1.f);
  }
  // rows g and g + 8 of the team: lse (log2 domain) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + wr0 + g + 8 * hh;
    const size_t at = static_cast<size_t>(bh) * s + row;
    lse2[hh] = row < q_end ? lse[at] * LOG2E : 0.f;
    dlt[hh] = row < q_end ? delta[at] : 0.f;
  }
  auto stat = [&](int hh, int, int, float& l2, float& dl) {
    l2 = lse2[hh];
    dl = dlt[hh];
  };
  int since = 0;  // sub-tiles summed since the last fold (3xTF32)
  bool banked = false;
  T* dqb = dq + base;
  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  for (int n = 0; cur.slot < walk.cnt; ++n) {
    const auto nxt = walk.next(cur);
    const int lim = walk.end(cur);
    float sp[NN][4], dp[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
    uint32_t vis[2] = {0u, 0u};
    const T* Kb;  // the sub-tile's K in the block's columns: the pv's B
    if constexpr (CHUNK) {
      T* Kc = KV + B::stage;
      load_mask(cur);  // in flight while the pieces are staged
      B::scores_chunked(
          sp, dp, Qs, dOs, KV, X, q + base, dout + base, q0, 1.f, kb, vb, cur.r0, lim, 1.f, s,
          d, async_kv, idle, rg, h, wr0, lane,
          [&] {
            mma16::stage_rows<NT, DMAX, LDB, W>(Kc, kb + c_out, cur.r0, lim, d, async_kv, wv);
          },
          [] {});
      if (tmask != nullptr) mk.bits(vis, g, t, lim - cur.r0);
      Kb = Kc;
    } else {
      Kb = KV + (n % 2) * B::stage;
      mma16::cp_async_wait_all();
      // sub-tile n is staged and visible to every warp; every reader of the
      // other stage (sub-tile n - 1) and of the teams' partials is done, so
      // sub-tile n + 1 may stream into it, across slot boundaries too
      __syncthreads();
      if (tmask != nullptr) mk.bits(vis, g, t, lim - cur.r0);  // before nxt's rows are read
      if (nxt.slot < walk.cnt) stage(nxt, n + 1);
      if (!idle) {
        B::partials(sp, dp, Qs, dOs, Kb, Kb + W * LDB, kd, h, wr0, lane);
        B::team_sum(sp, dp, X, rg, h, lane);
      }
    }
    if (!idle) {
      if (tmask != nullptr) {
        mma16::probs_ds<true>(
            sp, dp, stat,
            [&](int hh, int nt, int c) { return ((vis[hh] >> (2 * nt + c)) & 1u) != 0; },
            sm_scale, sm_scale);
      } else if (lim == cur.r0 + W) {  // every key of the sub-tile is visible
        mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; }, sm_scale,
                               sm_scale);
      } else {
        const int key0 = cur.r0 + 2 * t;
        mma16::probs_ds<true>(
            sp, dp, stat, [&](int, int nt, int c) { return key0 + 8 * nt + c < lim; }, sm_scale,
            sm_scale);
      }
      B::pv(acc, dp, Kb, kd, h, lane);
      // 3xTF32: every FOLD sub-tiles the warp moves its sums into dq
      if constexpr (!ROUND) {
        if (++since == B::FOLD && nxt.slot < walk.cnt) {
          B::bank(dqb, acc, banked, q0 + wr0 + g, q_end, d, c_out, h, t);
          since = 0;
          banked = true;
        }
      }
    }
    cur = nxt;
  }
  B::store(dqb, acc, banked, q0 + wr0 + g, q_end, d, c_out, h, t, 1.f);
}

// Bytes a stage of dk/dv's mask rows: the W queries of a sub-tile against
// the block's RT keys, query-major as the forward stored them.
template <typename B>
constexpr size_t dkv_mask_stage = static_cast<size_t>(B::W) * LDM<B::RT>;

// dv = P^T do and dk = dS^T q on mma16::WideBwd's teams: a tile of RT keys
// inside one plan kv block (k and v staged once) walks the listed q-blocks'
// W-query sub-tiles in list order, q and do (unscaled) streamed in two
// cp.async stages with their lse and delta (RowStats) and the mask rows of
// the forward's tile at q_slot, query-major as stored and read transposed
// (mask_bits_t). S^T = k q^T and dP^T = v do^T are summed over the team's
// slices, P^T and dS^T taken as blk_dkv_tc_kernel takes them, then
// dv[:, slice] += P^T do[:, slice] and dk[:, slice] += dS^T q[:, slice].
// CHUNK (d > DMAX): the block's DMAX-wide chunk of dk and dv on z, and per
// sub-tile the pieces of k, v, q and do staged in turn for S^T and dP^T
// over all of d, q's and do's chunks, the statistics and the mask rows with
// the first piece (stage 1).
template <bool ROUND, typename T, int DMAX, bool CHUNK>
__global__ void __launch_bounds__(mma16::WideDkvFor<ROUND, T, DMAX>::NT, 1)
    blk_dkv_wide_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           const int* __restrict__ q_list, const int* __restrict__ q_cnt,
                           const int* __restrict__ q_slot, const int8_t* __restrict__ tmask,
                           int s, int d, int bq, int bk, int Lt, float sm_scale, int async_q,
                           int async_mask) {
  using B = mma16::WideDkvFor<ROUND, T, DMAX>;
  using TQ = typename B::TQ;
  using TR = typename B::TR;
  constexpr int NT = B::NT, KT = B::RT, W = B::W, NN = B::NN, NO = B::NO, LDB = B::LDB;
  constexpr size_t MS = dkv_mask_stage<B>;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* Ks = reinterpret_cast<TQ*>(smem);
  TQ* Vs = reinterpret_cast<TQ*>(smem + B::a_bytes);
  T* QD = reinterpret_cast<T*>(smem + B::b_off);
  float* X = reinterpret_cast<float*>(smem + B::x_off);
  float* ST = reinterpret_cast<float*>(smem + B::stat_off);  // stage i: lse2 then delta
  int8_t* MK = reinterpret_cast<int8_t*>(smem + B::bytes);

  const int bh = blockIdx.y;
  const int tiles_k = (bk + KT - 1) / KT;
  const int j = blockIdx.x / tiles_k;  // plan kv block
  const int kb0 = j * bk;
  const int k0 = kb0 + (blockIdx.x % tiles_k) * KT;
  const int k_end = min(min(kb0 + bk, s), k0 + KT);
  if (k0 >= k_end) return;  // keys past s: nothing to write
  const int c_out = CHUNK ? blockIdx.z * DMAX : 0;  // the block's chunk of dk, dv
  const int wv = min(DMAX, d - c_out);              // and its width
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % B::NRG, h = warp / B::NRG;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * rg;
  const bool idle = k0 + wr0 >= k_end;
  const int kd = B::kd(wv, h);
  const size_t base = static_cast<size_t>(bh) * s * d;
  const T* qb = q + base;
  const T* ob = dout + base;
  const float* lseb = lse + static_cast<size_t>(bh) * s;
  const float* dlb = delta + static_cast<size_t>(bh) * s;
  const Walk<W> walk{q_list + static_cast<size_t>(j) * Lt, q_cnt[j], bq, s};

  mma16::RowStats<W> stat_next;  // the lse and delta of the sub-tile being staged
  auto stage_mask_rows = [&](const typename Walk<W>::Pos& p, int8_t* dst) {
    if (tmask != nullptr) {
      // the forward stored this (q-block, kv-block) tile's mask at q_slot
      const size_t tile = q_slot[static_cast<size_t>(j) * Lt + p.slot];
      stage_mask<W, KT, NT>(dst, tmask + tile * bq * bk, p.r0 - p.b0, k0 - kb0, bq, bk,
                            async_mask);
    }
  };
  // q, do and the mask rows of sub-tile p into stage n % 2 (rows past its
  // block or s 0), its statistics into registers
  auto stage = [&](const typename Walk<W>::Pos& p, int n) {
    T* dst = QD + (n % 2) * B::stage;
    const int end = walk.end(p);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst, qb, p.r0, end, d, async_q);
    mma16::stage_rows<NT, DMAX, LDB, W>(dst + W * LDB, ob, p.r0, end, d, async_q);
    stage_mask_rows(p, MK + (n % 2) * MS);
    mma16::cp_async_commit();
    stat_next.load(lseb, dlb, p.r0, end);
  };
  auto cur = walk.first();
  if constexpr (!CHUNK) {
    if (cur.slot < walk.cnt) {
      stage(cur, 0);  // in flight while k and v are loaded
      stat_next.store(ST);
    }
    mma16::load_q<KT, NT, DMAX, TR::LDQ>(Ks, k + base, k0, s, d, 1.f);
    mma16::load_q<KT, NT, DMAX, TR::LDQ>(Vs, v + base, k0, s, d, 1.f);
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

  for (int n = 0; cur.slot < walk.cnt; ++n) {
    const auto nxt = walk.next(cur);
    const int lim = walk.end(cur);
    float sp[NN][4], dp[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sp[nt][c] = dp[nt][c] = 0.f;
    const T* Qb;  // the sub-tile's q and do in the block's columns: the pvs' B
    const float* st;
    const int8_t* Ms;
    if constexpr (CHUNK) {
      T* Qc = QD + B::stage;
      B::scores_chunked(
          sp, dp, Ks, Vs, QD, X, k + base, v + base, k0, 1.f, qb, ob, cur.r0, lim, 1.f, s, d,
          async_q, idle, rg, h, wr0, lane,
          [&] {
            mma16::stage_rows<NT, DMAX, LDB, W>(Qc, qb + c_out, cur.r0, lim, d, async_q, wv);
            mma16::stage_rows<NT, DMAX, LDB, W>(Qc + W * LDB, ob + c_out, cur.r0, lim, d,
                                                async_q, wv);
            stage_mask_rows(cur, MK);
            stat_next.load(lseb, dlb, cur.r0, lim);
            stat_next.store(ST);
          },
          [] {});
      Qb = Qc;
      st = ST;
      Ms = MK;
    } else {
      Qb = QD + (n % 2) * B::stage;
      st = ST + (n % 2) * 2 * W;
      Ms = MK + (n % 2) * MS;
      mma16::cp_async_wait_all();
      // sub-tile n is staged and visible to every warp with its lse and
      // delta; every reader of the other stage (sub-tile n - 1) and of the
      // teams' partials is done
      __syncthreads();
      if (nxt.slot < walk.cnt) stage(nxt, n + 1);
      if (!idle) {
        B::partials(sp, dp, Ks, Vs, Qb, Qb + W * LDB, kd, h, wr0, lane);
        B::team_sum(sp, dp, X, rg, h, lane);
      }
    }
    if (!idle) {
      // the statistics of the C fragment's column (query) 8 nt + 2t + c
      auto stat = [&](int, int nt, int c, float& l2, float& dl) {
        l2 = st[8 * nt + 2 * t + c];
        dl = st[W + 8 * nt + 2 * t + c];
      };
      if (tmask != nullptr) {
        uint32_t vis[2];
        mask_bits_t<NN, KT>(vis, Ms, wr0, g, t, cur.r0 + 2 * t, lim);
        mma16::probs_ds<true>(
            sp, dp, stat,
            [&](int hh, int nt, int c) { return ((vis[hh] >> (2 * nt + c)) & 1u) != 0; },
            sm_scale, sm_scale);
      } else if (lim == cur.r0 + W) {  // every query of the sub-tile sees every key
        mma16::probs_ds<false>(sp, dp, stat, [](int, int, int) { return true; }, sm_scale,
                               sm_scale);
      } else {
        const int qj0 = cur.r0 + 2 * t;
        mma16::probs_ds<true>(
            sp, dp, stat, [&](int, int nt, int c) { return qj0 + 8 * nt + c < lim; }, sm_scale,
            sm_scale);
      }
      B::pv(acc_v, sp, Qb + W * LDB, kd, h, lane);
      B::pv(acc_k, dp, Qb, kd, h, lane);
      if constexpr (!ROUND) {
        if (++since == B::FOLD && nxt.slot < walk.cnt) {
          B::bank(dkb, acc_k, banked, k0 + wr0 + g, k_end, d, c_out, h, t);
          B::bank(dvb, acc_v, banked, k0 + wr0 + g, k_end, d, c_out, h, t);
          since = 0;
          banked = true;
        }
      }
    }
    if (!CHUNK && nxt.slot < walk.cnt) stat_next.store(ST + ((n + 1) % 2) * 2 * W);
    cur = nxt;
  }
  B::store(dkb, acc_k, banked, k0 + wr0 + g, k_end, d, c_out, h, t, 1.f);
  B::store(dvb, acc_v, banked, k0 + wr0 + g, k_end, d, c_out, h, t, 1.f);
}

// d <= 256: the 256 instance; wider d the 512 instance, above 512 in
// 512-wide chunks of the output. dq streams no lse or delta and holds its
// mask rows in registers, so its shared memory ends at stat_off.
template <bool ROUND, typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, const int* kv_list, const int* kv_cnt,
              const int8_t* tmask, int bh, int s, int d, int bq, int bk, int nq, int L,
              float sm_scale, cudaStream_t stream) {
  using B = mma16::WideDqFor<ROUND, T, DMAX>;
  static_assert(B::stat_off <= SMEM_MAX, "dq's shared memory");
  const unsigned tiles = tiles_x(nq, bq, B::RT);
  const int chunks = (d + DMAX - 1) / DMAX;
  if (tiles == 0 || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool CHUNKS = DMAX == 512;  // the 256 instance serves d <= 256 alone
  // the chunks also stage q and do by cp.async
  const bool async = async_ok<T>(d, k, v) && (chunks == 1 || async_ok<T>(d, q, dout));
  return launch_kernel(chunks > 1 ? blk_dq_wide_tc_kernel<ROUND, T, DMAX, CHUNKS>
                                  : blk_dq_wide_tc_kernel<ROUND, T, DMAX, false>,
                       B::stat_off, dim3(tiles, bh, chunks), B::NT, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dq), kv_list, kv_cnt, tmask, s, d, bq, bk, L, sm_scale,
                       static_cast<int>(async), static_cast<int>(async_mask_ok(tmask, bk)));
}

template <bool ROUND, typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, const int* q_list, const int* q_cnt,
               const int* q_slot, const int8_t* tmask, int bh, int s, int d, int bq, int bk,
               int nk, int Lt, float sm_scale, cudaStream_t stream) {
  using B = mma16::WideDkvFor<ROUND, T, DMAX>;
  constexpr size_t masked = B::bytes + 2 * dkv_mask_stage<B>;
  static_assert(masked <= SMEM_MAX, "dk/dv's shared memory with the mask rows");
  const unsigned tiles = tiles_x(nk, bk, B::RT);
  const int chunks = (d + DMAX - 1) / DMAX;
  if (tiles == 0 || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool CHUNKS = DMAX == 512;
  // the chunks also stage k and v by cp.async
  const bool async = async_ok<T>(d, q, dout) && (chunks == 1 || async_ok<T>(d, k, v));
  return launch_kernel(chunks > 1 ? blk_dkv_wide_tc_kernel<ROUND, T, DMAX, CHUNKS>
                                  : blk_dkv_wide_tc_kernel<ROUND, T, DMAX, false>,
                       tmask != nullptr ? masked : B::bytes, dim3(tiles, bh, chunks), B::NT,
                       stream, static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dk), static_cast<T*>(dv), q_list, q_cnt, q_slot, tmask, s,
                       d, bq, bk, Lt, sm_scale, static_cast<int>(async),
                       static_cast<int>(async_mask_ok(tmask, bk)));
}

}  // namespace widebwd

// The plan's blocks must cover s, and bh fit the grid's y; each launcher
// checks its own x extent (tiles_x).
bool bad_shape(int bh, int s, int d, int bq, int bk, int nq, int nk, int L) {
  return bh <= 0 || s <= 0 || d <= 0 || bh > 65535 || bq <= 0 || bk <= 0 ||
         nq <= 0 || nk <= 0 || L <= 0 || static_cast<long long>(nq) * bq < s ||
         static_cast<long long>(nk) * bk < s ||
         static_cast<long long>(bh) * s * d > (1LL << 40);
}

// d <= 128: the tensor-core forward, eight warps a q-tile for the bf16
// tiers' q-blocks of a multiple of 128 rows and four for the rest (3xTF32
// at eight warps would spill at two blocks an SM or run one); wider d: the
// teams of the wide tensor-core forward.
template <int DMAX, bool ROUND, typename T, bool WIDE>
int fwd_typed(const void* q, const void* k, const void* v, void* o, void* lse,
              const int* kv_list, const int* kv_cnt, const int8_t* tmask, int bh, int s, int d,
              int bq, int bk, int nq, int L, float sm_scale, cudaStream_t stream) {
  if constexpr (!WIDE) {
    if constexpr (ROUND) {
      if (bq % 128 == 0) {
        return tcfwd::launch<DMAX, ROUND, T, 8>(q, k, v, o, lse, kv_list, kv_cnt, tmask, bh, s,
                                                d, bq, bk, nq, L, sm_scale, stream);
      }
    }
    return tcfwd::launch<DMAX, ROUND, T, 4>(q, k, v, o, lse, kv_list, kv_cnt, tmask, bh, s, d,
                                            bq, bk, nq, L, sm_scale, stream);
  } else {
    if (d <= 256) {
      return widefwd::launch<ROUND, T, 256>(q, k, v, o, lse, kv_list, kv_cnt, tmask, bh, s, d,
                                            bq, bk, nq, L, sm_scale, stream);
    }
    return widefwd::launch<ROUND, T, 512>(q, k, v, o, lse, kv_list, kv_cnt, tmask, bh, s, d, bq,
                                          bk, nq, L, sm_scale, stream);
  }
}

// d <= 128: the tensor-core backward; wider d: the teams of the wide
// tensor-core backward.
template <int DMAX, bool ROUND, typename T, bool WIDE>
int dq_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, const int* kv_list, const int* kv_cnt,
             const int8_t* tmask, int bh, int s, int d, int bq, int bk, int nq, int L,
             float sm_scale, cudaStream_t stream) {
  if constexpr (!WIDE) {
    return tcbwd::launch_dq<DMAX, ROUND, T>(q, k, v, dout, lse, delta, dq, kv_list, kv_cnt,
                                            tmask, bh, s, d, bq, bk, nq, L, sm_scale, stream);
  } else {
    if (d <= 256) {
      return widebwd::launch_dq<ROUND, T, 256>(q, k, v, dout, lse, delta, dq, kv_list, kv_cnt,
                                               tmask, bh, s, d, bq, bk, nq, L, sm_scale, stream);
    }
    return widebwd::launch_dq<ROUND, T, 512>(q, k, v, dout, lse, delta, dq, kv_list, kv_cnt,
                                             tmask, bh, s, d, bq, bk, nq, L, sm_scale, stream);
  }
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, const int* q_list, const int* q_cnt,
              const int* q_slot, const int8_t* tmask, int bh, int s, int d, int bq, int bk,
              int nk, int Lt, float sm_scale, cudaStream_t stream) {
  if constexpr (!WIDE) {
    return tcbwd::launch_dkv<DMAX, ROUND, T>(q, k, v, dout, lse, delta, dk, dv, q_list, q_cnt,
                                             q_slot, tmask, bh, s, d, bq, bk, nk, Lt, sm_scale,
                                             stream);
  } else {
    if (d <= 256) {
      return widebwd::launch_dkv<ROUND, T, 256>(q, k, v, dout, lse, delta, dk, dv, q_list,
                                                q_cnt, q_slot, tmask, bh, s, d, bq, bk, nk, Lt,
                                                sm_scale, stream);
    }
    return widebwd::launch_dkv<ROUND, T, 512>(q, k, v, dout, lse, delta, dk, dv, q_list, q_cnt,
                                              q_slot, tmask, bh, s, d, bq, bk, nk, Lt, sm_scale,
                                              stream);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16 (q, k, v, do and the outputs o, dq, dk, dv share it); lse
// and delta are fp32, the plan arrays int32, tmask int8 or null. round_bf16
// selects the 'default' tier for fp32 inputs. Each launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int blk_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_list, const void* kv_cnt, const void* tmask,
                             int dtype, int bh, int s, int d, int bq, int bk, int nq, int nk,
                             int L, float sm_scale, int round_bf16, int device, void* stream) {
  if (bad_shape(bh, s, d, bq, bk, nq, nk, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  auto kvl = static_cast<const int*>(kv_list);
  auto kvc = static_cast<const int*>(kv_cnt);
  auto tm = static_cast<const int8_t*>(tmask);
  ATTN_DISPATCH(fwd_typed, q, k, v, o, lse, kvl, kvc, tm, bh, s, d, bq, bk, nq, L, sm_scale, st);
}

extern "C" int blk_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, const void* kv_list,
                            const void* kv_cnt, const void* tmask, int dtype, int bh, int s,
                            int d, int bq, int bk, int nq, int nk, int L, float sm_scale,
                            int round_bf16, int device, void* stream) {
  if (bad_shape(bh, s, d, bq, bk, nq, nk, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  auto kvl = static_cast<const int*>(kv_list);
  auto kvc = static_cast<const int*>(kv_cnt);
  auto tm = static_cast<const int8_t*>(tmask);
  ATTN_DISPATCH(dq_typed, q, k, v, dout, lse, delta, dq, kvl, kvc, tm, bh, s, d, bq, bk, nq, L,
                sm_scale, st);
}

extern "C" int blk_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const void* q_list, const void* q_cnt, const void* q_slot,
                             const void* tmask, int dtype, int bh, int s, int d, int bq, int bk,
                             int nq, int nk, int Lt, float sm_scale, int round_bf16, int device,
                             void* stream) {
  if (bad_shape(bh, s, d, bq, bk, nq, nk, Lt)) return static_cast<int>(cudaErrorInvalidValue);
  if (tmask != nullptr && q_slot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  auto ql = static_cast<const int*>(q_list);
  auto qc = static_cast<const int*>(q_cnt);
  auto qs = static_cast<const int*>(q_slot);
  auto tm = static_cast<const int8_t*>(tmask);
  ATTN_DISPATCH(dkv_typed, q, k, v, dout, lse, delta, dk, dv, ql, qc, qs, tm, bh, s, d, bq, bk, nk,
                Lt, sm_scale, st);
}
