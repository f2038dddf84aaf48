// Grouped block SpMM for NVIDIA Hopper (sm_90a): C = A @ B, where A is given
// by a GroupedPlan: the occupied slots of G consecutive row-blocks form one
// stream per group (block_cols, local_rb, nslots; ELL-padded to Lg per
// group), with the values (ng * Lg, bm, bk). B is (k, n), C (m, n), both
// row-major.
//
// Replaces tpusparse/kernels/tiled_spmm.py:1186 _grouped_kernel (behind
// grouped_spmm_pallas, pallas_call l.1297). On low-fill plans the TPU's
// per-row-block grid cells had too few slots to fill their DMA ring; one
// cell per group kept many B-tile fetches in flight. On the H100 the scarce
// thing is the other way round: thread blocks to fill 132 SMs. The first
// port gave a thread block a whole group's stream (32 blocks at the 16384^2
// headline, 15.1 ms); here a thread block owns one row window of one
// row-block and finds that row-block's slots in its group's stream itself.
//
// Contract: for each group g and slot l < nslots[g], C rows of row-block
// g*G + local_rb[g*Lg + l] += vals[g*Lg + l] @ B[block_cols[g*Lg + l]*bk :
// +bk, :]; fp32 sums (the TPU kernel added each slot into its output block
// in the output's type); C in its own type; a row-block with no slot is
// written as zeros. Every output element is one `acc = fmaf(a, b, acc)`
// chain from 0.f over its row-block's slots in the stream's order (the base
// plan's ascending column order) and, within a slot, over k ascending in
// 16-wide chunks (the ragged k edge masked with zeros), operands rounded to
// bf16 on staging in the 'default' tier: window_tiles.cuh's chain. So C is
// bitwise equal to the footprint executor on the plan the grouped plan was
// derived from, and the kernel stays on FFMA in every tier; it is within
// the tier of block_ell_spmm (and the batched and compact executors),
// which sum on the tensor cores.
//
// What bounds it: the FFMA work 2 * nblocks * bm * bk * n (0.418 ms at the
// headline at 67 TFLOP/s); at low fill (the 4096^2 plan at 1 % with 8x32
// blocks, n 256) the latency of many small slots and the gathered B rows.
// Design (the register tile and double-buffered walk of window_tiles.cuh,
// the footprint kernel's):
//   - A thread block of 256 owns a window of one row-block (a slice of it
//     when bm > 128) and an n-tile, its accumulators in registers: 8 x 256
//     for bm <= 8 (1 x 8 a thread), 128 x 64 above (4 x 8 a thread). The
//     grid is (row-blocks x slices) x n-tiles: 128 x 8 = 1,024 blocks at
//     the headline, 512 x 1 at the low-fill plan. At bm <= 8 a design with
//     a warp a row-block and 16 row-blocks a block was measured too and
//     came within 2.4 %, inside the run-to-run spread (PERF.md), so the one
//     kernel body serves both. `grouped_tile` in kernels/tiled_spmm.py
//     mirrors `window_rows` on the CPU.
//   - Within a group, local_rb ascends and each row-block's slots are
//     contiguous, so a binary search over the group's stream gives the
//     window's [first, last) slots. No plan array is added.
//   - The steps are (slot, 16-deep chunk); every step covers the whole
//     window (one row-block), so no row is predicated off.

#include "window_tiles.cuh"

using namespace tiles;

namespace {

// window tiles: rows, columns, rows a thread, threads of the block
using T8 = WTile<8, 256, 1, 256>;  // bm <= 8
using T128 = WTile<128, 64, 4, 256>;

struct Args {
  const int* block_cols;  // (ng * Lg)
  const int* local_rb;    // (ng * Lg)
  const int* nslots;      // (ng)
  int m, k, n, bm, bk, G, Lg, slices;  // slices: windows a row-block
};

// The first slot in [lo, hi) of the stream whose row-block is >= lr.
__device__ __forceinline__ int lower_bound(const int* __restrict__ local_rb, int lo, int hi,
                                           int lr) {
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (local_rb[mid] < lr) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One row-block's slots [first, last) of the stream, chunk by chunk.
template <class T, typename TA, typename TB, bool RND>
struct RowBlockWalker {
  struct Step {
    int slot, k0;
  };
  const TA* vals;
  const TB* b;
  const int* block_cols;
  int lo, hi, bm, bk, k, n, n0;  // [lo, hi): the row-block's slots
  int arow[T::PA];  // the window row behind each A value, -1 past the row-block

  __device__ bool first(Step& s) const {
    s = Step{lo, 0};
    return lo < hi;
  }
  __device__ bool next(const Step& cur, Step& nxt) const {
    if (cur.k0 + BK_T < bk) {
      nxt = Step{cur.slot, cur.k0 + BK_T};
      return true;
    }
    nxt = Step{cur.slot + 1, 0};
    return nxt.slot < hi;
  }
  __device__ void load(const Step& s, float (&ra)[T::PA], float (&rb)[T::PB]) const {
    T::template load_a<TA, RND>(ra, vals + static_cast<size_t>(s.slot) * bm * bk, arow, bk,
                                s.k0);
    T::template load_b<TB, RND>(rb, b, block_cols[s.slot] * bk, s.k0, bk, k, n, n0);
  }
  __device__ void fma(float (&acc)[T::TR][8], const float* as, const float* bs,
                      const Step&) const {
    bool all[T::TR];
#pragma unroll
    for (int i = 0; i < T::TR; ++i) all[i] = true;
    T::template fma_chunk<true>(acc, as, bs, all);
  }
};

// Block (x, y): the window at row r0 = (x % slices) * WR of row-block rb =
// x / slices over the n-tile at n0 = y * WN. acc over the row-block's slots,
// then the window's rows of C.
template <class T, typename TA, typename TB, typename TC, bool RND>
__global__ void __launch_bounds__(T::NTH) grouped_spmm_kernel(const TA* __restrict__ vals,
                                                              const TB* __restrict__ b,
                                                              TC* __restrict__ c, Args g) {
  __shared__ __align__(16) float as[2][T::A_FLOATS];
  __shared__ __align__(16) float bs[2][T::B_FLOATS];
  const int rb = blockIdx.x / g.slices;
  const int r0 = (blockIdx.x % g.slices) * T::WR;
  const int n0 = blockIdx.y * T::WN;
  const int grp = rb / g.G;
  const int s0 = grp * g.Lg;
  const int lr = rb - grp * g.G;
  const int nv = g.nslots[grp];
  const int rows = min(T::WR, g.bm - r0);
  RowBlockWalker<T, TA, TB, RND> w{vals, b, g.block_cols, 0, 0, g.bm, g.bk, g.k, g.n, n0, {}};
  w.lo = s0 + lower_bound(g.local_rb + s0, 0, nv, lr);
  w.hi = s0 + lower_bound(g.local_rb + s0, w.lo - s0, nv, lr + 1);
#pragma unroll
  for (int p = 0; p < T::PA; ++p) {
    const int r = T::a_row(p);
    w.arow[p] = r >= 0 && r < rows ? r0 + r : -1;
  }
  float acc[T::TR][8];
  T::zero(acc);
  run_steps<T>(acc, &as[0][0], &bs[0][0], w);
  T::store_window(acc, c, static_cast<size_t>(rb) * g.bm + r0, 0, rows, g.m, g.n, n0);
}

// rows of a block's window for blocks of bm rows; kernels/tiled_spmm.py's
// GROUPED_TILES mirrors it
int window_rows(int bm) { return bm <= 8 ? T8::WR : T128::WR; }

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16; nbr: row-blocks, ceil(m / bm). The window follows bm
// (window_rows). Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int grouped_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                            void* c, int c_dtype, const void* block_cols,
                            const void* local_rb, const void* nslots, int m, int k, int n,
                            int bm, int bk, int nbr, int G, int Lg, int round_bf16,
                            int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || G <= 0 || Lg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wr = window_rows(bm);
  const int wn = wr == T8::WR ? T8::WN : T128::WN;
  const int slices = (bm + wr - 1) / wr;
  const long long gx = static_cast<long long>(nbr) * slices;
  if (gx > 0x7fffffffLL || (n + wn - 1) / wn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(gx), (n + wn - 1) / wn);
  const Args args{static_cast<const int*>(block_cols), static_cast<const int*>(local_rb),
                  static_cast<const int*>(nslots), m, k, n, bm, bk, G, Lg, slices};
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = dispatch(vals_dtype, b_dtype, c_dtype, round_bf16,
                          [&](auto ta, auto tb, auto tc, auto rnd) {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    using TC = typename decltype(tc)::type;
    constexpr bool RND = decltype(rnd)::value;
    const auto* v = static_cast<const TA*>(vals);
    const auto* bb = static_cast<const TB*>(b);
    auto* cc = static_cast<TC*>(c);
    if (wr == T8::WR) {
      grouped_spmm_kernel<T8, TA, TB, TC, RND><<<grid, T8::NTH, 0, s>>>(v, bb, cc, args);
    } else {
      grouped_spmm_kernel<T128, TA, TB, TC, RND><<<grid, T128::NTH, 0, s>>>(v, bb, cc, args);
    }
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
