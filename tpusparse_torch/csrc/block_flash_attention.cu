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
// every listed block's 64-row sub-tiles, keeping its accumulators in
// registers. The plan blocks (block_q, block_k) are part of the pattern's
// meaning and take any size (32, 64, 256, unequal); a block that is not a
// multiple of 64 leaves the last sub-tile partly empty. No atomics: every
// output element is summed by one thread in a fixed order, so runs repeat
// bit for bit.
//
// Contract. q, k, v, do: (bh, s, d) row-major, one type (fp32 or bf16);
// lse, delta: (bh, s) fp32; any d (d <= 64 and d <= 128 hold a whole row in
// a tile, a wider d runs the WIDE instances of attention_tiles.cuh: 128-wide
// output chunks on blockIdx.z, the scores recomputed per chunk over d staged
// in 128-wide pieces). Plan arrays, int32 on
// the device: kv_list (nq, L) and kv_cnt (nq) for the forward and dq,
// q_list (nk, Lt), q_cnt (nk) and q_slot (nk * Lt) for dk/dv; tile_masks
// (nq * L, bq, bk) int8, or null for a plan whose covered blocks are full.
// Slots l >= count are padding and are never visited.
//   - scores s = (q . k) * sm_scale: the scale comes after the product, as
//     in the TPU kernels (l.957, l.1126), not pre-scaled into q;
//   - key j of query row i is visible when both lie inside their plan
//     blocks and below s, and the tile mask (if any) is set at (i, j).
//     Masked scores are -1e30 and their probabilities exactly 0, so a
//     sub-tile that is wholly masked (the band's partial tiles, the tail
//     past s) adds nothing even when it is a row's first; a row with no
//     visible key gets o = 0 and lse = m + log 1 = -1e30 (l.983-991);
//   - dS = p * (dp - delta) * sm_scale (l.1162, l.1204); dq = dS . k with no
//     scale after; dk = dS^T . q with the unscaled q; dv = p^T . do;
//   - ROUND ('default' tier on fp32, or bf16 inputs): q, k, v and do are
//     rounded to bf16 on load, and so are p and dS before their products,
//     with fp32 sums. Without it ('high', 'highest' on fp32 inputs) every
//     product is fp32-class, never one TF32 pass: 3xTF32 in the forward at
//     d <= 128, fp32 FFMA elsewhere.
//
// The forward at d <= 128 (blk_fwd_tc_kernel) runs on the tensor cores with
// `mma.sync`, on the tiles of flash_attention.cu's flash_fwd
// (attention_mma.cuh: 3xTF32 m16n8k8 for fp32 'high'/'highest', the warp
// splitting the fragments it loads and banking its sum in o every FOLD
// sub-tiles; bf16 m16n8k16 with fp32 sums for 'default' and bf16
// operands), P in registers, exp taken as exp2 with log2(e) folded in, the
// softmax state of a row in one quad of lanes. Its q-tile follows the
// plan's blocks, since two q-blocks list different kv blocks: four warps,
// 16 rows each, own a 64-row tile of one q-block; in the bf16 tiers eight
// warps own a 128-row tile where block_q is a multiple of 128 (3xTF32 at
// eight warps spills at two blocks an SM and is slower at one). A tile
// partly past its q-block (blocks of 32, s off the block) leaves its last
// warps idle. The block reads its list once as the walk arrives at each
// slot and streams the sub-tiles by cp.async (16-byte aligned operands
// with d a whole number of 16-byte chunks; other d load synchronously), K
// and V apart: V of sub-tile j comes in while its scores and softmax are
// computed, K (and the mask rows) of sub-tile j + 1 while p.v of j is,
// across slot boundaries too; two barriers a sub-tile. Two full K/V stages
// would hold a four-warp block to two blocks an SM at d = 64 (87 KB of
// fp32), eight warps; one K and one V buffer (52 KB) let three (3xTF32,
// 149 registers) or four (bf16 products, 128) run, since the k-tile loop
// of flash_fwd waits on latency more than it issues. A plan
// without tile masks takes the mask-free softmax on every sub-tile wholly
// inside its block and s. A masked plan stages the q-tile's mask rows
// against the sub-tile's keys (64 x 64 bytes at block 64) beside K, and
// each lane reads the two bytes at each of its C-fragment positions (rows
// g, g + 8; keys 2t, 2t + 1 of each n8 tile) from there: no mask byte is
// read from device memory per score. The forward at d > 128
// (blk_fwd_wide_kernel) and the two backward kernels stay on FFMA.
//
// What bounds them. At BERT-base 'bigbird' (bh = 96, s = 512, block 64, 48
// of 64 tiles covered) the forward does 4 bh T 64^2 d = 4.8 GFLOP: 0.029
// ms on 3xTF32 (3 x 4.8 GFLOP at 495 TFLOP/s tf32), against ~50 MB of
// compulsory traffic (~0.015 ms at 3.35 TB/s); dq does 6 and dk/dv 8 per
// covered entry and d, on FFMA (~67 TFLOP/s): 0.11 and 0.14 ms. On an
// H100 SXM at 700 W the forward takes 0.171 ms in 3xTF32 (28 TFLOP/s,
// 0.17 of its bound; the FFMA forward took 0.278), 0.075 in 'default' and
// 0.054 on bf16 operands: latency-bound, as flash_fwd is, with three
// 3xTF32 blocks an SM. The backward kernels reuse the flash kernels'
// register tiling
// (attention_tiles.cuh): 4x4 scores a thread, row reductions in a
// half-warp, the tile masks read from device memory (L1-cached) beside
// each score.

#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace {

// Rows of one 64-row sub-tile: [r0, r_end) of the block [b0, b0 + bsize),
// clipped to s. r_end <= r0 means the sub-tile lies past s.
__device__ __forceinline__ int sub_end(int b0, int bsize, int r0, int s) {
  return min(min(b0 + bsize, s), r0 + 64);
}

// -- blk_flash_fwd at d <= 128 on the tensor cores ----------------------------
namespace tcfwd {

using mma16::BK;          // keys a sub-tile
constexpr int LDM = 80;   // bytes a staged mask row: 64 + 16, so the eight rows
                          // a warp's lanes read lie on distinct banks

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
    return q_bytes + k_bytes + v_bytes + (masked ? static_cast<size_t>(QT) * LDM : 0);
  }
};

// Rows [r0, r0 + QT) and columns [c0, c0 + BK) of one (bq, bk) tile mask
// into Ms, rows of LDM bytes, by NT threads; rows past bq and columns past
// bk are 0. async: 16-byte cp.async copies (bk a multiple of 16, the masks
// 16-byte aligned); else one byte a load.
template <int QT, int NT>
__device__ __forceinline__ void stage_mask(int8_t* Ms, const int8_t* __restrict__ tile, int r0,
                                           int c0, int bq, int bk, bool async) {
  if (async) {
    constexpr int C = BK / 16;
    for (int e = threadIdx.x; e < QT * C; e += NT) {
      const int r = e / C, c = 16 * (e % C);
      const bool in = r0 + r < bq && c0 + c < bk;
      mma16::cp_async16(Ms + r * LDM + c,
                        in ? tile + static_cast<size_t>(r0 + r) * bk + c0 + c : tile, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < QT * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      Ms[r * LDM + c] =
          r0 + r < bq && c0 + c < bk ? tile[static_cast<size_t>(r0 + r) * bk + c0 + c] : 0;
    }
  }
}

// The visible keys of a lane's two rows (warp rows g, g + 8 from row r of
// the staged mask) in the C fragment's order: bit 2 nt + c of vis[h] is key
// key0 + 8 nt + c (key0 = the sub-tile's first key + 2t), set when it lies
// below lim and its mask byte is set. Two bytes a load, none from global
// memory.
__device__ __forceinline__ void mask_bits(uint32_t (&vis)[2], const int8_t* Ms, int r, int t,
                                          int key0, int lim) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int8_t* mr = Ms + (r + 8 * h) * LDM + 2 * t;
    uint32_t bits = 0;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const uint32_t w = *reinterpret_cast<const uint16_t*>(mr + 8 * nt);
      if ((w & 0xffu) != 0 && key0 + 8 * nt < lim) bits |= 1u << (2 * nt);
      if ((w >> 8) != 0 && key0 + 8 * nt + 1 < lim) bits |= 2u << (2 * nt);
    }
    vis[h] = bits;
  }
}

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
  const int* list = kv_list + static_cast<size_t>(i) * L;
  const int cnt = kv_cnt[i];

  // The walk: the 64-key sub-tile at k0 of the listed block starting at kb0
  // (list slot `slot`), in list order; slot == cnt ends it. settle() moves
  // past sub-tiles that lie past the block or s, reading each list entry
  // once as it arrives.
  struct Pos {
    int slot, kb0, k0;
  };
  auto settle = [&](Pos& p) {
    while (p.slot < cnt && p.k0 >= min(p.kb0 + bk, s)) {
      if (++p.slot < cnt) p.kb0 = p.k0 = list[p.slot] * bk;
    }
  };
  auto k_end = [&](const Pos& p) { return min(min(p.kb0 + bk, s), p.k0 + BK); };
  // K and the mask rows of a sub-tile; rows past its block or s are 0
  auto stage_k = [&](const Pos& p) {
    mma16::stage_rows<NT, DMAX, TR::LDK>(Ks, kb, p.k0, k_end(p), d, async_kv);
    if (tmask != nullptr) {
      stage_mask<QT, NT>(Ms, tmask + (static_cast<size_t>(i) * L + p.slot) * bq * bk, q0 - qb0,
                         p.k0 - p.kb0, bq, bk, async_mask);
    }
    mma16::cp_async_commit();
  };

  Pos cur{0, 0, 0};
  if (cnt > 0) cur.kb0 = cur.k0 = list[0] * bk;
  settle(cur);
  if (cur.slot < cnt) stage_k(cur);  // in flight while q is loaded
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

  while (cur.slot < cnt) {
    mma16::cp_async_wait_all();
    // K and the mask rows of `cur` are staged and visible to every warp;
    // every reader of V (the last sub-tile's p.v) is done
    __syncthreads();
    mma16::stage_rows<NT, DMAX, TR::LDV>(Vs, vb, cur.k0, k_end(cur), d, async_kv);
    mma16::cp_async_commit();  // V streams in while the scores are computed
    float sacc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[nt][c] = 0.f;
    if (!idle) {
      TR::score(sacc, Qs, Ks, kd, wr0, lane);
      const int lim = k_end(cur);
      if (tmask != nullptr) {
        uint32_t vis[2];
        mask_bits(vis, Ms, wr0 + g, t, cur.k0 + 2 * t, lim);
        mma16::softmax_tile_if<true>(sacc, oacc, m, l, sm_scale, [&](int h, int nt, int c) {
          return ((vis[h] >> (2 * nt + c)) & 1u) != 0;
        });
      } else if (lim == cur.k0 + BK) {  // every key of the sub-tile is visible
        mma16::softmax_tile<false>(sacc, oacc, m, l, sm_scale, 0, {lim, lim});
      } else {
        mma16::softmax_tile<true>(sacc, oacc, m, l, sm_scale, cur.k0 + 2 * t, {lim, lim});
      }
    }
    mma16::cp_async_wait_all();
    // V of `cur` is staged and visible; every reader of K and the mask rows
    // is done, so the next sub-tile's stream in while p.v is computed
    __syncthreads();
    const Pos nxt = [&] {
      Pos p{cur.slot, cur.kb0, cur.k0 + BK};
      settle(p);
      return p;
    }();
    if (nxt.slot < cnt) stage_k(nxt);
    if (!idle) {
      TR::pv(oacc, sacc, Vs, kd, lane);
      // 3xTF32: every FOLD sub-tiles the warp moves its sum into o (the
      // bank), so the tensor cores' own accumulation never adds more
      if constexpr (!ROUND) {
        if (++since == mma16::FOLD && nxt.slot < cnt) {
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
  constexpr int E = 16 / sizeof(T), QT = 16 * NW;
  const bool async_kv = d % E == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const bool async_mask =
      tmask != nullptr && bk % 16 == 0 && reinterpret_cast<uintptr_t>(tmask) % 16 == 0;
  const size_t smem = Layout<ROUND, T, DMAX, QT>::bytes(tmask != nullptr);
  auto* kern = blk_fwd_tc_kernel<DMAX, ROUND, T, NW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nq * ((bq + QT - 1) / QT), bh);
  kern<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), kv_list, kv_cnt, tmask, s, d, bq, bk, L,
      sm_scale, static_cast<int>(async_kv), static_cast<int>(async_mask));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcfwd

// -- the FFMA kernels ---------------------------------------------------------

using namespace attn;

// Whether (query qp, key kp) is visible: inside the rows [.., q_end) and
// keys [.., k_end) of this sub-tile pair, and set in the tile mask `tile`
// (bq x bk, rows from qb0, columns from kb0) when there is one.
__device__ __forceinline__ bool visible(int qp, int q_end, int kp, int k_end,
                                        const int8_t* __restrict__ tile, int qb0, int kb0,
                                        int bk) {
  return qp < q_end && kp < k_end &&
         (tile == nullptr || tile[static_cast<size_t>(qp - qb0) * bk + (kp - kb0)] != 0);
}

// The forward at head dims above 128 on FFMA: the DMAX = 128 tiles, one
// 128-wide output chunk a blockIdx.z (the scores recomputed per chunk).
constexpr int WD = 128;
constexpr size_t fwd_wide_smem =
    sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (WD + 4) + BQ * LDP);

template <bool ROUND, typename T>
__global__ void __launch_bounds__(NT) blk_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kv_list,
    const int* __restrict__ kv_cnt, const int8_t* __restrict__ tmask, int s, int d, int bq,
    int bk, int L, float sm_scale) {
  constexpr int G = WD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // (BQ, WD + 4) a chunk of q
  float* Ks = Qs + BQ * (WD + 4);  // (BK, WD + 4)
  float* Vs = Ks + BK * (WD + 4);  // (BK, WD + 4)
  float* Ps = Vs + BK * (WD + 4);  // (BQ, LDP) probabilities of this sub-tile
  const int bh = blockIdx.y;
  const int tiles_q = (bq + BQ - 1) / BQ;
  const int i = blockIdx.x / tiles_q;  // plan q-block
  const int qb0 = i * bq;
  const int q0 = qb0 + (blockIdx.x % tiles_q) * BQ;
  const int q_end = sub_end(qb0, bq, q0, s);
  if (q0 >= q_end) return;  // a row tile past s (uniform over the block)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int c_out = blockIdx.z * WD;  // first output column

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[a][c] = 0.f;
  }

  const int cnt = kv_cnt[i];
  for (int slot = 0; slot < cnt; ++slot) {
    const int kb0 = kv_list[i * L + slot] * bk;
    const int8_t* tile =
        tmask == nullptr ? nullptr : tmask + static_cast<size_t>(i * L + slot) * bq * bk;
    for (int k0 = kb0; k0 < kb0 + bk; k0 += BK) {
      const int k_end = sub_end(kb0, bk, k0, s);
      if (k0 >= k_end) break;  // the rest of this block lies past s
      float sc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[a][j] = 0.f;
      mma_nt_chunked<WD, ROUND, ROUND>(sc, Qs, Ks, q + base, q0, q_end, 1.f, k + base, k0, k_end,
                                       1.f, d, ty, tx);
      load_chunk<WD, ROUND>(Vs, v + base, k0, k_end, d, c_out, 1.f);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qp = q0 + ty + 16 * a;
        bool vis[4];
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vis[j] = visible(qp, q_end, k0 + tx + 16 * j, k_end, tile, qb0, kb0, bk);
          sc[a][j] = vis[j] ? sc[a][j] * sm_scale : NEG;
          mx = fmaxf(mx, sc[a][j]);
        }
        const float m_new = fmaxf(m[a], half_warp_max(mx));
        const float corr = expf(m[a] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = vis[j] ? expf(sc[a][j] - m_new) : 0.f;
          rs += p;
          Ps[(ty + 16 * a) * LDP + tx + 16 * j] = tier<ROUND>(p);
        }
        l[a] = corr * l[a] + half_warp_sum(rs);
        m[a] = m_new;
#pragma unroll
        for (int c = 0; c < 4 * G; ++c) acc[a][c] *= corr;
      }
      __syncthreads();
      mma_nn<WD>(acc, Ps, Vs, ty, tx);
    }
  }

  T* ob = o + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty + 16 * a;
    if (qp >= q_end) continue;
    const float den = l[a] == 0.f ? 1.f : l[a];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) store(&ob[static_cast<size_t>(qp) * d + col], acc[a][4 * g + c] / den);
      }
    if (tx == 0 && c_out == 0) lse[static_cast<size_t>(bh) * s + qp] = m[a] + logf(den);
  }
}

template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BQ + 2 * BK) * (DMAX + 4) + BQ * LDP);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) blk_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, const int* __restrict__ kv_list,
    const int* __restrict__ kv_cnt, const int8_t* __restrict__ tmask, int s, int d, int bq,
    int bk, int L, float sm_scale) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // (BQ, LD)
  float* dOs = Qs + BQ * LD;    // (BQ, LD)
  float* Ks = dOs + BQ * LD;    // (BK, LD)
  float* Vs = Ks + BK * LD;     // (BK, LD)
  float* dSs = Vs + BK * LD;    // (BQ, LDP)
  const int bh = blockIdx.y;
  const int tiles_q = (bq + BQ - 1) / BQ;
  const int i = blockIdx.x / tiles_q;
  const int qb0 = i * bq;
  const int q0 = qb0 + (blockIdx.x % tiles_q) * BQ;
  const int q_end = sub_end(qb0, bq, q0, s);
  if (q0 >= q_end) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) {
    load_tile<DMAX, ROUND>(Qs, q + base, q0, q_end, d, 1.f);
    load_tile<DMAX, ROUND>(dOs, dout + base, q0, q_end, d, 1.f);
  }
  float lse_r[4], delta_r[4], acc[4][4 * G];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty + 16 * a;
    lse_r[a] = qp < q_end ? lse[static_cast<size_t>(bh) * s + qp] : 0.f;
    delta_r[a] = qp < q_end ? delta[static_cast<size_t>(bh) * s + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[a][c] = 0.f;
  }

  const int cnt = kv_cnt[i];
  for (int slot = 0; slot < cnt; ++slot) {
    const int kb0 = kv_list[i * L + slot] * bk;
    const int8_t* tile =
        tmask == nullptr ? nullptr : tmask + static_cast<size_t>(i * L + slot) * bq * bk;
    for (int k0 = kb0; k0 < kb0 + bk; k0 += BK) {
      const int k_end = sub_end(kb0, bk, k0, s);
      if (k0 >= k_end) break;
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[a][j] = dp[a][j] = 0.f;
      if constexpr (WIDE) {
        mma_nt_chunked<DMAX, ROUND, ROUND>(sc, Qs, Ks, q + base, q0, q_end, 1.f, k + base, k0,
                                           k_end, 1.f, d, ty, tx);
        mma_nt_chunked<DMAX, ROUND, ROUND>(dp, dOs, Vs, dout + base, q0, q_end, 1.f, v + base,
                                           k0, k_end, 1.f, d, ty, tx);
        __syncthreads();  // the score product's readers of Ks are done
        load_chunk<DMAX, ROUND>(Ks, k + base, k0, k_end, d, c_out, 1.f);
      } else {
        __syncthreads();
        load_tile<DMAX, ROUND>(Ks, k + base, k0, k_end, d, 1.f);
        load_tile<DMAX, ROUND>(Vs, v + base, k0, k_end, d, 1.f);
        __syncthreads();
        mma_nt<LD>(sc, Qs, Ks, kd, ty, tx);
        mma_nt<LD>(dp, dOs, Vs, kd, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qp = q0 + ty + 16 * a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool vis = visible(qp, q_end, k0 + tx + 16 * j, k_end, tile, qb0, kb0, bk);
          const float p = vis ? expf(sc[a][j] * sm_scale - lse_r[a]) : 0.f;
          dSs[(ty + 16 * a) * LDP + tx + 16 * j] =
              tier<ROUND>(p * (dp[a][j] - delta_r[a]) * sm_scale);
        }
      }
      __syncthreads();
      mma_nn<DMAX>(acc, dSs, Ks, ty, tx);
    }
  }

  T* out = dq + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty + 16 * a;
    if (qp >= q_end) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) store(&out[static_cast<size_t>(qp) * d + col], acc[a][4 * g + c]);
      }
  }
}

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (static_cast<size_t>(2 * BQ + 2 * BK) * (DMAX + 4) + 2 * BK * LDP + 2 * BQ);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) blk_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const int* __restrict__ q_list, const int* __restrict__ q_cnt,
    const int* __restrict__ q_slot, const int8_t* __restrict__ tmask, int s, int d, int bq,
    int bk, int Lt, float sm_scale) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // (BK, LD)
  float* Vs = Ks + BK * LD;       // (BK, LD)
  float* Qs = Vs + BK * LD;       // (BQ, LD)
  float* dOs = Qs + BQ * LD;      // (BQ, LD)
  float* Ps = dOs + BQ * LD;      // (BK, LDP): p^T of this q sub-tile, keys by queries
  float* dSs = Ps + BK * LDP;     // (BK, LDP): dS^T
  float* lse_s = dSs + BK * LDP;  // (BQ)
  float* delta_s = lse_s + BQ;    // (BQ)
  const int bh = blockIdx.y;
  const int tiles_k = (bk + BK - 1) / BK;
  const int j = blockIdx.x / tiles_k;  // plan kv block
  const int kb0 = j * bk;
  const int k0 = kb0 + (blockIdx.x % tiles_k) * BK;
  const int k_end = sub_end(kb0, bk, k0, s);
  if (k0 >= k_end) return;  // keys past s: nothing to write
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) {
    load_tile<DMAX, ROUND>(Ks, k + base, k0, k_end, d, 1.f);
    load_tile<DMAX, ROUND>(Vs, v + base, k0, k_end, d, 1.f);
  }
  float acc_k[4][4 * G], acc_v[4][4 * G];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  const int cnt = q_cnt[j];
  for (int slot = 0; slot < cnt; ++slot) {
    const int qb0 = q_list[j * Lt + slot] * bq;
    // the forward stored this (q-block, kv-block) tile's mask at q_slot
    const int8_t* tile =
        tmask == nullptr ? nullptr : tmask + static_cast<size_t>(q_slot[j * Lt + slot]) * bq * bk;
    for (int q0 = qb0; q0 < qb0 + bq; q0 += BQ) {
      const int q_end = sub_end(qb0, bq, q0, s);
      if (q0 >= q_end) break;
      float st[4][4], dpt[4][4];  // rows: keys ty + 16a; columns: queries tx + 16c
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[a][c] = dpt[a][c] = 0.f;
      if constexpr (WIDE) {
        mma_nt_chunked<DMAX, ROUND, ROUND>(st, Ks, Qs, k + base, k0, k_end, 1.f, q + base, q0,
                                           q_end, 1.f, d, ty, tx);
        mma_nt_chunked<DMAX, ROUND, ROUND>(dpt, Vs, dOs, v + base, k0, k_end, 1.f, dout + base,
                                           q0, q_end, 1.f, d, ty, tx);
        __syncthreads();  // the score products' readers of Qs, dOs are done
        load_chunk<DMAX, ROUND>(Qs, q + base, q0, q_end, d, c_out, 1.f);
        load_chunk<DMAX, ROUND>(dOs, dout + base, q0, q_end, d, c_out, 1.f);
      } else {
        __syncthreads();
        load_tile<DMAX, ROUND>(Qs, q + base, q0, q_end, d, 1.f);
        load_tile<DMAX, ROUND>(dOs, dout + base, q0, q_end, d, 1.f);
      }
      if (threadIdx.x < BQ) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < q_end ? lse[static_cast<size_t>(bh) * s + qp] : 0.f;
        delta_s[threadIdx.x] = qp < q_end ? delta[static_cast<size_t>(bh) * s + qp] : 0.f;
      }
      __syncthreads();
      if constexpr (!WIDE) {
        mma_nt<LD>(st, Ks, Qs, kd, ty, tx);
        mma_nt<LD>(dpt, Vs, dOs, kd, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kp = k0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qj = tx + 16 * c;
          const bool vis = visible(q0 + qj, q_end, kp, k_end, tile, qb0, kb0, bk);
          const float p = vis ? expf(st[a][c] * sm_scale - lse_s[qj]) : 0.f;
          Ps[(ty + 16 * a) * LDP + qj] = tier<ROUND>(p);
          dSs[(ty + 16 * a) * LDP + qj] = tier<ROUND>(p * (dpt[a][c] - delta_s[qj]) * sm_scale);
        }
      }
      __syncthreads();
      mma_nn<DMAX>(acc_v, Ps, dOs, ty, tx);
      mma_nn<DMAX>(acc_k, dSs, Qs, ty, tx);
    }
  }

  T* dkb = dk + base;
  T* dvb = dv + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + ty + 16 * a;
    if (kp >= k_end) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) {
          store(&dkb[static_cast<size_t>(kp) * d + col], acc_k[a][4 * g + c]);
          store(&dvb[static_cast<size_t>(kp) * d + col], acc_v[a][4 * g + c]);
        }
      }
  }
}

// The plan's blocks must cover s, and the grid's x and y must fit.
bool bad_shape(int bh, int s, int d, int bq, int bk, int nq, int nk, int L) {
  return bh <= 0 || s <= 0 || d <= 0 || bh > 65535 || bq <= 0 || bk <= 0 ||
         nq <= 0 || nk <= 0 || L <= 0 || static_cast<long long>(nq) * bq < s ||
         static_cast<long long>(nk) * bk < s ||
         static_cast<long long>(nq) * ((bq + BQ - 1) / BQ) > 0x7fffffffLL ||
         static_cast<long long>(nk) * ((bk + BK - 1) / BK) > 0x7fffffffLL ||
         static_cast<long long>(bh) * s * d > (1LL << 40);
}

// d <= 128: the tensor-core forward, eight warps a q-tile for the bf16
// tiers' q-blocks of a multiple of 128 rows and four for the rest (3xTF32
// at eight warps would spill at two blocks an SM or run one); wider d: the
// FFMA WIDE kernel.
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
    const dim3 grid(nq * ((bq + BQ - 1) / BQ), bh, out_chunks<WD, true>(d));
    return launch(blk_fwd_wide_kernel<ROUND, T>, fwd_wide_smem, grid, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), static_cast<float*>(lse), kv_list, kv_cnt, tmask, s, d, bq,
                  bk, L, sm_scale);
  }
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dq_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, const int* kv_list, const int* kv_cnt,
             const int8_t* tmask, int bh, int s, int d, int bq, int bk, int nq, int L,
             float sm_scale, cudaStream_t stream) {
  const dim3 grid(nq * ((bq + BQ - 1) / BQ), bh, out_chunks<DMAX, WIDE>(d));
  return launch(blk_dq_kernel<DMAX, ROUND, T, WIDE>, dq_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), kv_list, kv_cnt, tmask,
                s, d, bq, bk, L, sm_scale);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, const int* q_list, const int* q_cnt,
              const int* q_slot, const int8_t* tmask, int bh, int s, int d, int bq, int bk,
              int nk, int Lt, float sm_scale, cudaStream_t stream) {
  const dim3 grid(nk * ((bk + BK - 1) / BK), bh, out_chunks<DMAX, WIDE>(d));
  return launch(blk_dkv_kernel<DMAX, ROUND, T, WIDE>, dkv_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
                q_list, q_cnt, q_slot, tmask, s, d, bq, bk, Lt, sm_scale);
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
