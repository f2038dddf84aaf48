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
// thread block owns one 64-row tile inside one plan q-block (forward, dq)
// or one 64-row tile inside one plan kv block (dk/dv) of one (batch, head),
// reads its block's list itself and walks, in list order, every listed
// block's 64-row sub-tiles, keeping its accumulators in registers. The plan
// blocks (block_q, block_k) are part of the pattern's meaning and take any
// size (32, 64, 256, unequal); a block that is not a multiple of 64 leaves
// the last sub-tile partly empty. No atomics: every output element is summed
// by one thread in a fixed order, so runs repeat bit for bit.
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
//     with fp32 sums; without it everything is fp32 FFMA, never TF32.
//
// What bounds them. At BERT-base 'bigbird' (bh = 96, s = 512, block 64, 48
// of 64 tiles covered) the forward does 4 bh T 64^2 d = 4.8 GFLOP
// (~0.072 ms at the H100's ~67 TFLOP/s fp32 FFMA datasheet rate) against
// ~50 MB of compulsory traffic (~0.015 ms at 3.35 TB/s); dq does 6 and
// dk/dv 8 per covered entry and d. All three are compute-bound for an FFMA
// design, so they reuse the flash kernels' register tiling
// (attention_tiles.cuh): 4x4 scores a thread, row reductions in a
// half-warp. The tile masks are read from device memory (L1-cached) beside
// each score; staging them in shared memory, double-buffered loads and
// tensor cores are later work.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

// Rows of one 64-row sub-tile: [r0, r_end) of the block [b0, b0 + bsize),
// clipped to s. r_end <= r0 means the sub-tile lies past s.
__device__ __forceinline__ int sub_end(int b0, int bsize, int r0, int s) {
  return min(min(b0 + bsize, s), r0 + 64);
}

// Whether (query qp, key kp) is visible: inside the rows [.., q_end) and
// keys [.., k_end) of this sub-tile pair, and set in the tile mask `tile`
// (bq x bk, rows from qb0, columns from kb0) when there is one.
__device__ __forceinline__ bool visible(int qp, int q_end, int kp, int k_end,
                                        const int8_t* __restrict__ tile, int qb0, int kb0,
                                        int bk) {
  return qp < q_end && kp < k_end &&
         (tile == nullptr || tile[static_cast<size_t>(qp - qb0) * bk + (kp - kb0)] != 0);
}

template <int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (DMAX + 4) + BQ * LDP);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) blk_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kv_list,
    const int* __restrict__ kv_cnt, const int8_t* __restrict__ tmask, int s, int d, int bq,
    int bk, int L, float sm_scale) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // (BQ, LD)
  float* Ks = Qs + BQ * LD;    // (BK, LD)
  float* Vs = Ks + BK * LD;    // (BK, LD)
  float* Ps = Vs + BK * LD;    // (BQ, LDP) probabilities of this sub-tile
  const int bh = blockIdx.y;
  const int tiles_q = (bq + BQ - 1) / BQ;
  const int i = blockIdx.x / tiles_q;  // plan q-block
  const int qb0 = i * bq;
  const int q0 = qb0 + (blockIdx.x % tiles_q) * BQ;
  const int q_end = sub_end(qb0, bq, q0, s);
  if (q0 >= q_end) return;  // a row tile past s (uniform over the block)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) load_tile<DMAX, ROUND>(Qs, q + base, q0, q_end, d, 1.f);
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
      if constexpr (WIDE) {
        mma_nt_chunked<DMAX, ROUND, ROUND>(sc, Qs, Ks, q + base, q0, q_end, 1.f, k + base, k0,
                                           k_end, 1.f, d, ty, tx);
        load_chunk<DMAX, ROUND>(Vs, v + base, k0, k_end, d, c_out, 1.f);
      } else {
        __syncthreads();  // the previous sub-tile's readers of Ks, Vs, Ps are done
        load_tile<DMAX, ROUND>(Ks, k + base, k0, k_end, d, 1.f);
        load_tile<DMAX, ROUND>(Vs, v + base, k0, k_end, d, 1.f);
        __syncthreads();
        mma_nt<LD>(sc, Qs, Ks, kd, ty, tx);
      }
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
      mma_nn<DMAX>(acc, Ps, Vs, ty, tx);
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

template <int DMAX, bool ROUND, typename T, bool WIDE>
int fwd_typed(const void* q, const void* k, const void* v, void* o, void* lse,
              const int* kv_list, const int* kv_cnt, const int8_t* tmask, int bh, int s, int d,
              int bq, int bk, int nq, int L, float sm_scale, cudaStream_t stream) {
  const dim3 grid(nq * ((bq + BQ - 1) / BQ), bh, out_chunks<DMAX, WIDE>(d));
  return launch(blk_fwd_kernel<DMAX, ROUND, T, WIDE>, fwd_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), kv_list, kv_cnt, tmask, s, d, bq,
                bk, L, sm_scale);
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
