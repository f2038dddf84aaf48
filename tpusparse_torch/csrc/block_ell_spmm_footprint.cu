// Footprint block SpMM for NVIDIA Hopper (sm_90a): C = A @ B, where A is
// given by a FootprintPlan. S consecutive row-blocks form a super-row; a
// super's occupied slots are sorted by (column, row-block), so the slots that
// read one B tile are adjacent. Per super s and slot l < nslots[s]:
// lrow (row-block within the super), bslot (ordinal of its distinct column)
// and newcol (1 where a new column starts); ucols (ns, Lu) lists the
// distinct columns. Values (ns * Ls, bm, bk); B (k, n), C (m, n), row-major.
//
// Replaces tpusparse/kernels/tiled_spmm.py:1344 _footprint_kernel (behind
// footprint_spmm_pallas, pallas_call l.1487), the TPU form of the reference
// inspector's footprint compression: each distinct B tile is fetched once per
// super-row and used by every block of the super in that column.
//
// Contract: C rows of row-block s*S + lrow[s*Ls + l] += vals[s*Ls + l] @
// B[ucols[s*Lu + bslot[s*Ls + l]]*bk : +bk, :]; fp32 sums; C in its own
// type; a row-block with no slot is written as zeros. Every output element
// is one `acc = fmaf(a, b, acc)` chain from 0.f over its row-block's slots in
// ascending column order and, within a slot, over k ascending in 16-wide
// chunks (a block's ragged k edge masked with zeros), with the operands
// rounded to bf16 on staging in the 'default' tier: the chain of
// block_tiles.cuh. So C is bitwise equal to block_ell_spmm on the plan the
// footprint plan was derived from, and the kernel stays on FFMA in every
// tier (a tensor-core tier would change the bits of all five executors).
//
// What bounds it: the FFMA work 2 * nblocks * bm * bk * n, 0.418 ms at the
// 16384^2 headline at 67 TFLOP/s; its bytes (blocks, B, C once) take 0.05
// ms. The first port kept all S * bm * ntile accumulators of a super in
// shared memory, so it ran a 16-column n-tile in one 128-thread block a SM
// (256 blocks), loaded and stored each slot's accumulator slice around
// every slot, and paid two barriers a 16-deep chunk: 21.87 ms. This design:
//   - A thread block of 256 threads owns a 128-row window of a super's rows
//     (at bm 128 one row-block; several smaller ones; a slice of a taller
//     one) and a 64-column n-tile. Each thread keeps its 4 x 8 piece of
//     that 128 x 64 tile in registers for the whole slot walk: rows 4 ty +
//     i, columns 4 tx + j and 32 + 4 tx + j, so the A loads of a warp are
//     one 16-byte broadcast per row group and the B loads conflict-free.
//     The grid is supers x windows x n-tiles: 1,024 blocks at the headline.
//   - The block walks its super's slots in the plan's (column, row-block)
//     order and takes, column by column, the group of slots whose
//     row-blocks meet its window: one B chunk staged serves every slot of
//     the group (the footprint plan's reuse, inside the block; at the
//     headline a window is one row-block and a group one slot, at the
//     low-fill plan's 8-row blocks a group holds up to 16 slots). Each row
//     still sees its row-block's slots in ascending column order. The
//     steps are (group, 16-deep chunk); the next step's A chunk and B rows
//     are loaded into registers before the current step's FFMAs and stored
//     into the other half of a double buffer after them: one barrier a
//     chunk, and the loads in flight during the arithmetic. The staging
//     goes through registers (and not cp.async) because it rounds to bf16
//     in the 'default' tier, widens bf16 inputs and transposes A on the way.
//   - B tiles: each block loads the B rows it needs and L2 absorbs the
//     repeats (B is 32 MB at the headline, within the 50 MB L2). The
//     footprint plan's own reuse across a thread-block cluster was measured
//     against this: the blocks of one super in a non-portable cluster of up
//     to 16, walking the super's distinct columns in step, each pushing a
//     1/C share of the bk x 64 tile into every block's shared memory
//     (distributed shared memory) behind one cluster barrier a column. On
//     the H100 it took 7.43 ms at the headline against 1.16 here, and 1.34
//     against 0.87 at the low-fill plan (PERF.md), so it was not kept.

#include "block_tiles.cuh"

using namespace tiles;

namespace {

constexpr int WR = 128;       // rows of a block's window
constexpr int WN = 64;        // columns of its n-tile
constexpr int NTH = 256;      // threads: 32 row groups of 4 x 8 column groups of 8
constexpr int AL = WR + 4;    // padded row of the transposed A chunk

// A super's slots as the window of one block sees them.
struct Walk {
  const int* lrow;   // this super's lrow
  const int* bslot;  // this super's bslot
  size_t s0;         // its first slot
  int nvalid, bm, bk, R0;
  // rows of slot l's row-block relative to the window: [lo, lo + bm)
  __device__ int lo(int l) const { return lrow[l] * bm - R0; }
  __device__ bool meets(int l) const { return lo(l) < WR && lo(l) + bm > 0; }
  // the first slot after l whose row-block meets the window, or nvalid
  __device__ int next(int l) const {
    for (++l; l < nvalid && !meets(l); ++l) {
    }
    return l;
  }
};

// One column's slots in the window (a group: the slots from l0 on with
// l0's column, sorted by row-block, so disjoint rows), as one thread needs
// them: arow[p], the row of the super's packed values (slot l's block row
// r at l * bm + r) behind its A-load row tid / 16 + 16 p, or -1 where no
// slot of the group covers it; act[i],
// whether a slot covers its FFMA row 4 ty + i; full, whether the group
// covers every row of the window; col, the column's ordinal; end, the slot
// after the group.
struct Group {
  int arow[8];
  bool act[4];
  bool full;
  int col, end;
};

__device__ __forceinline__ void group_at(Group& gr, const Walk& w, int l0) {
  const int ty = threadIdx.x / 8;
  gr.col = w.bslot[l0];
#pragma unroll
  for (int p = 0; p < 8; ++p) gr.arow[p] = -1;
#pragma unroll
  for (int i = 0; i < 4; ++i) gr.act[i] = false;
  int covered = 0, l = l0;
  for (; l < w.nvalid && w.bslot[l] == gr.col; ++l) {
    const int lo = w.lo(l);
    if (lo >= WR || lo + w.bm <= 0) continue;
    covered += min(lo + w.bm, WR) - max(lo, 0);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = threadIdx.x / 16 + 16 * p;
      if (r >= lo && r < lo + w.bm) gr.arow[p] = l * w.bm + r - lo;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) gr.act[i] |= 4 * ty + i >= lo && 4 * ty + i < lo + w.bm;
  }
  gr.full = covered == WR;
  gr.end = l;
}

// The thread's 8 values of a 128 x 16 A chunk: window rows tid / 16 + 16 p,
// k = k0 + tid % 16; rows no slot of the group covers and k past bk are 0.
// vals points at the super's first slot.
template <typename TA, bool RND>
__device__ __forceinline__ void load_a(float (&ra)[8], const TA* __restrict__ vals,
                                       const Group& gr, int bk, int k0) {
  const int q = threadIdx.x % 16;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float v = 0.f;
    if (gr.arow[p] >= 0 && k0 + q < bk) {
      v = tier<RND>(to_f32(vals[static_cast<size_t>(gr.arow[p]) * bk + k0 + q]));
    }
    ra[p] = v;
  }
}

__device__ __forceinline__ void store_a(float* as, const float (&ra)[8]) {
  const int q = threadIdx.x % 16;
#pragma unroll
  for (int p = 0; p < 8; ++p) as[q * AL + threadIdx.x / 16 + 16 * p] = ra[p];
}

// The thread's 4 values of a 16 x 64 B chunk: k rows tid / 64 + 4 p, column
// tid % 64; masked as in block_tiles.cuh (k past bk or past the matrix, n
// past n).
template <typename TB, bool RND>
__device__ __forceinline__ void load_b(float (&rb)[4], const TB* __restrict__ b, int kb, int k0,
                                       int bk, int k, int n, int n0) {
  const int col = threadIdx.x % WN;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int q = threadIdx.x / WN + 4 * p;
    const int kr = kb + k0 + q, cn = n0 + col;
    float v = 0.f;
    if (k0 + q < bk && kr < k && cn < n) v = tier<RND>(to_f32(b[static_cast<size_t>(kr) * n + cn]));
    rb[p] = v;
  }
}

__device__ __forceinline__ void store_b(float* bs, const float (&rb)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) bs[(threadIdx.x / WN + 4 * p) * WN + threadIdx.x % WN] = rb[p];
}

// acc += A chunk (k-major, rows of AL) . B chunk (16 rows of WN) in ascending
// k, for the thread's rows that a slot of the group covers (all of them when
// the group covers the window).
template <bool FULL>
__device__ __forceinline__ void fma_chunk(float (&acc)[4][8], const float* as, const float* bs,
                                          const bool (&act)[4]) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int q = 0; q < BK_T; ++q) {
    const float4 av = *reinterpret_cast<const float4*>(&as[q * AL + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[q * WN + 4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[q * WN + 32 + 4 * tx]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!FULL && !act[i]) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void fma_step(float (&acc)[4][8], const float* as, const float* bs,
                                         const Group& gr) {
  if (gr.full) {
    fma_chunk<true>(acc, as, bs, gr.act);
  } else {
    fma_chunk<false>(acc, as, bs, gr.act);
  }
}

// C rows of the window that belong to the super (local row < rows_super)
// and to the matrix (< m), columns < n.
template <typename TC>
__device__ __forceinline__ void store_window(const float (&acc)[4][8], TC* __restrict__ c,
                                             size_t row0, int R0, int rows_super, int m, int n,
                                             int n0) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = R0 + 4 * ty + i;
    const size_t grow = row0 + lr;
    if (lr >= rows_super || grow >= static_cast<size_t>(m)) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cn = n0 + (j < 4 ? 4 * tx + j : 32 + 4 * tx + j - 4);
      if (cn < n) store(&c[grow * n + cn], acc[i][j]);
    }
  }
}

struct Args {
  const int* ucols;   // (ns * Lu)
  const int* nslots;  // (ns)
  const int* lrow;    // (ns * Ls)
  const int* bslot;   // (ns * Ls)
  int m, k, n, bm, bk, nbr, S, Ls, Lu, wps;  // wps: windows (blocks) a super
};

__device__ __forceinline__ Walk walk_of(const Args& g, int sup, int R0) {
  const size_t s0 = static_cast<size_t>(sup) * g.Ls;
  return Walk{g.lrow + s0, g.bslot + s0, s0, g.nslots[sup], g.bm, g.bk, R0};
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

template <typename TA, typename TB, typename TC, bool RND>
__global__ void __launch_bounds__(NTH) footprint_kernel(const TA* __restrict__ vals,
                                                        const TB* __restrict__ b,
                                                        TC* __restrict__ c, Args g) {
  __shared__ __align__(16) float as[2][BK_T * AL];
  __shared__ __align__(16) float bs[2][BK_T * WN];
  const int sup = blockIdx.x / g.wps;
  const int R0 = (blockIdx.x % g.wps) * WR;
  const int n0 = blockIdx.y * WN;
  const Walk w = walk_of(g, sup, R0);
  const int* ucols = g.ucols + static_cast<size_t>(sup) * g.Lu;
  vals += w.s0 * g.bm * g.bk;

  float acc[4][8];
  zero(acc);
  const int l = w.next(-1);
  if (l < w.nvalid) {
    // steps: (group, 16-deep chunk); cur is computed while nxt is loaded
    Group cur, nxt;
    group_at(cur, w, l);
    float ra[8], rb[4];
    load_a<TA, RND>(ra, vals, cur, g.bk, 0);
    load_b<TB, RND>(rb, b, ucols[cur.col] * g.bk, 0, g.bk, g.k, g.n, n0);
    store_a(as[0], ra);
    store_b(bs[0], rb);
    __syncthreads();
    for (int buf = 0, k0 = 0;; buf ^= 1) {
      int nk0 = k0 + BK_T;
      bool more = true;
      if (nk0 < g.bk) {
        nxt = cur;
      } else {
        const int nl = w.next(cur.end - 1);
        more = nl < w.nvalid;
        if (more) group_at(nxt, w, nl);
        nk0 = 0;
      }
      if (more) {  // the next step's operands, in flight during this one's FFMAs
        load_a<TA, RND>(ra, vals, nxt, g.bk, nk0);
        load_b<TB, RND>(rb, b, ucols[nxt.col] * g.bk, nk0, g.bk, g.k, g.n, n0);
      }
      fma_step(acc, as[buf], bs[buf], cur);
      if (!more) break;
      store_a(as[buf ^ 1], ra);  // its last readers passed the previous barrier
      store_b(bs[buf ^ 1], rb);
      __syncthreads();
      cur = nxt;
      k0 = nk0;
    }
  }
  const int rows_super = min(g.S, g.nbr - sup * g.S) * g.bm;
  store_window(acc, c, static_cast<size_t>(sup) * g.S * g.bm, R0, rows_super, g.m, g.n, n0);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. wps: blocks (128-row windows) a super, ceil(S * bm / 128).
// Launches on `stream` and does not synchronise; returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int footprint_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                              void* c, int c_dtype, const void* ucols, const void* nslots,
                              const void* lrow, const void* bslot, int m, int k, int n, int bm,
                              int bk, int nbr, int S, int Ls, int Lu, int wps, int round_bf16,
                              int device, void* stream) {
  const int ns = (nbr + S - 1) / S;
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || S <= 0 || Ls <= 0 ||
      Lu <= 0 || wps != (S * bm + WR - 1) / WR || (n + WN - 1) / WN > 65535 ||
      static_cast<long long>(ns) * wps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(ns * wps), (n + WN - 1) / WN);
  const Args args{static_cast<const int*>(ucols), static_cast<const int*>(nslots),
                  static_cast<const int*>(lrow), static_cast<const int*>(bslot),
                  m, k, n, bm, bk, nbr, S, Ls, Lu, wps};
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = dispatch(vals_dtype, b_dtype, c_dtype, round_bf16,
                          [&](auto ta, auto tb, auto tc, auto rnd) {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    using TC = typename decltype(tc)::type;
    footprint_kernel<TA, TB, TC, decltype(rnd)::value><<<grid, NTH, 0, s>>>(
        static_cast<const TA*>(vals), static_cast<const TB*>(b), static_cast<TC*>(c), args);
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
