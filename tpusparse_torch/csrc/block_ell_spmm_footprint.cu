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
// window_tiles.cuh. So C is bitwise equal to the grouped executor on the
// plan the footprint plan was derived from, and the kernel stays on FFMA in
// every tier (a tensor-core tier would change the bits of both); it is
// within the tier of block_ell_spmm (and the batched and compact
// executors), which sum on the tensor cores.
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
//     The register tile and the double-buffered walk are window_tiles.cuh's,
//     shared with the grouped executor; this file keeps the footprint walk.
//   - B tiles: each block loads the B rows it needs and L2 absorbs the
//     repeats (B is 32 MB at the headline, within the 50 MB L2). The
//     footprint plan's own reuse across a thread-block cluster was measured
//     against this: the blocks of one super in a non-portable cluster of up
//     to 16, walking the super's distinct columns in step, each pushing a
//     1/C share of the bk x 64 tile into every block's shared memory
//     (distributed shared memory) behind one cluster barrier a column. On
//     the H100 it took 7.43 ms at the headline against 1.16 here, and 1.34
//     against 0.87 at the low-fill plan (PERF.md), so it was not kept.

#include "window_tiles.cuh"

using namespace tiles;

namespace {

using T = WTile<128, 64, 4, 256>;  // a 128-row window, a 64-column n-tile, 4 x 8 a thread
constexpr int WR = T::WR, WN = T::WN, NTH = T::NTH;

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
// r at l * bm + r) behind its A value p (window row T::a_row(p)), or -1
// where no slot of the group covers it; act[i], whether a slot covers its
// FFMA row 4 ty + i; full, whether the group covers every row of the
// window; col, the column's ordinal; end, the slot after the group.
struct Group {
  int arow[T::PA];
  bool act[T::TR];
  bool full;
  int col, end;
};

__device__ __forceinline__ void group_at(Group& gr, const Walk& w, int l0) {
  const int ty = T::tid() / T::CX;
  gr.col = w.bslot[l0];
#pragma unroll
  for (int p = 0; p < T::PA; ++p) gr.arow[p] = -1;
#pragma unroll
  for (int i = 0; i < T::TR; ++i) gr.act[i] = false;
  int covered = 0, l = l0;
  for (; l < w.nvalid && w.bslot[l] == gr.col; ++l) {
    const int lo = w.lo(l);
    if (lo >= WR || lo + w.bm <= 0) continue;
    covered += min(lo + w.bm, WR) - max(lo, 0);
#pragma unroll
    for (int p = 0; p < T::PA; ++p) {
      const int r = T::a_row(p);
      if (r >= lo && r < lo + w.bm) gr.arow[p] = l * w.bm + r - lo;
    }
#pragma unroll
    for (int i = 0; i < T::TR; ++i) {
      gr.act[i] |= T::TR * ty + i >= lo && T::TR * ty + i < lo + w.bm;
    }
  }
  gr.full = covered == WR;
  gr.end = l;
}

struct Args {
  const int* ucols;   // (ns * Lu)
  const int* nslots;  // (ns)
  const int* lrow;    // (ns * Ls)
  const int* bslot;   // (ns * Ls)
  int m, k, n, bm, bk, nbr, S, Ls, Lu, wps;  // wps: windows (blocks) a super
};

// The block's steps: (group, 16-deep chunk), groups in the super's
// (column, row-block) order, chunks in ascending k.
template <typename TA, typename TB, bool RND>
struct FootprintWalker {
  struct Step {
    Group gr;
    int k0;
  };
  Walk w;
  const int* ucols;  // this super's distinct columns
  const TA* vals;    // this super's first slot
  const TB* b;
  int k, n, n0;

  __device__ bool first(Step& s) const {
    const int l = w.next(-1);
    if (l >= w.nvalid) return false;
    group_at(s.gr, w, l);
    s.k0 = 0;
    return true;
  }
  __device__ bool next(const Step& cur, Step& nxt) const {
    if (cur.k0 + BK_T < w.bk) {
      nxt = cur;
      nxt.k0 = cur.k0 + BK_T;
      return true;
    }
    const int nl = w.next(cur.gr.end - 1);
    if (nl >= w.nvalid) return false;
    group_at(nxt.gr, w, nl);
    nxt.k0 = 0;
    return true;
  }
  __device__ void load(const Step& s, float (&ra)[T::PA], float (&rb)[T::PB]) const {
    T::load_a<TA, RND>(ra, vals, s.gr.arow, w.bk, s.k0);
    T::load_b<TB, RND>(rb, b, ucols[s.gr.col] * w.bk, s.k0, w.bk, k, n, n0);
  }
  __device__ void fma(float (&acc)[T::TR][8], const float* as, const float* bs,
                      const Step& s) const {
    if (s.gr.full) {
      T::fma_chunk<true>(acc, as, bs, s.gr.act);
    } else {
      T::fma_chunk<false>(acc, as, bs, s.gr.act);
    }
  }
};

template <typename TA, typename TB, typename TC, bool RND>
__global__ void __launch_bounds__(NTH) footprint_kernel(const TA* __restrict__ vals,
                                                        const TB* __restrict__ b,
                                                        TC* __restrict__ c, Args g) {
  __shared__ __align__(16) float as[2][T::A_FLOATS];
  __shared__ __align__(16) float bs[2][T::B_FLOATS];
  const int sup = blockIdx.x / g.wps;
  const int R0 = (blockIdx.x % g.wps) * WR;
  const int n0 = blockIdx.y * WN;
  const size_t s0 = static_cast<size_t>(sup) * g.Ls;
  const Walk w{g.lrow + s0, g.bslot + s0, s0, g.nslots[sup], g.bm, g.bk, R0};
  const FootprintWalker<TA, TB, RND> walker{
      w, g.ucols + static_cast<size_t>(sup) * g.Lu, vals + s0 * g.bm * g.bk, b, g.k, g.n, n0};

  float acc[T::TR][8];
  T::zero(acc);
  run_steps<T>(acc, &as[0][0], &bs[0][0], walker);
  const int rows_super = min(g.S, g.nbr - sup * g.S) * g.bm;
  T::store_window(acc, c, static_cast<size_t>(sup) * g.S * g.bm, R0, rows_super, g.m, g.n, n0);
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
