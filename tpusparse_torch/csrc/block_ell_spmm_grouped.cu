// Grouped block SpMM for NVIDIA Hopper (sm_90a): C = A @ B, where A is given
// by a GroupedPlan: the occupied slots of G consecutive row-blocks form one
// stream per group (block_cols, local_rb, nslots; ELL-padded to Lg per
// group), with the values (ng * Lg, bm, bk). B is (k, n), C (m, n), both
// row-major.
//
// Replaces tpusparse/kernels/tiled_spmm.py:1186 _grouped_kernel (behind
// grouped_spmm_pallas, pallas_call l.1297). On low-fill plans the TPU's
// per-row-block grid cells had too few slots to fill their DMA ring; one
// cell per group kept many B-tile fetches in flight. Here a thread block
// owns (group, 64-row slice, 64-column n-tile) and walks the group's slot
// stream. A row-block's slots are contiguous in the stream and come in
// ascending local_rb, so the block keeps one register accumulator, stores it
// when local_rb changes, and writes zeros for the row-blocks that own no
// slot.
//
// Contract: for each group g and slot l < nslots[g], C rows of row-block
// g*G + local_rb[g*Lg + l] += vals[g*Lg + l] @ B[block_cols[g*Lg + l]*bk :
// +bk, :]; fp32 sums (the TPU kernel added each slot into its output block
// in the output's type); C in its own type. The tile is block_ell_spmm.cu's
// (block_tiles.cuh) and each row-block's slots keep the base plan's
// ascending column order, so C is bitwise equal to block_ell_spmm on the
// plan the grouped plan was derived from.
//
// What bounds it: as block_ell_spmm, the FFMA work 2 * nblocks * bm * bk * n
// above the bytes of the blocks, B and C at dense-ish fills; at low fill
// (the 4096^2 plan at 1 % with 8x32 blocks) the bytes of the gathered B rows
// and the latency of each small slot. wgmma, TMA and a deeper stream of B
// tiles in flight are later work.

#include "block_tiles.cuh"

using namespace tiles;

namespace {

template <typename TA, typename TB, typename TC, bool ROUND_BF16>
__global__ void __launch_bounds__(NT) grouped_spmm_kernel(
    const TA* __restrict__ vals,          // (ng * Lg, bm, bk)
    const TB* __restrict__ b,             // (k, n)
    TC* __restrict__ c,                   // (m, n)
    const int* __restrict__ block_cols,   // (ng * Lg)
    const int* __restrict__ local_rb,     // (ng * Lg)
    const int* __restrict__ nslots,       // (ng)
    int m, int k, int n, int bm, int bk, int nbr, int G, int Lg, int m_sub) {
  __shared__ Staging st;

  const int grp = blockIdx.x / m_sub;
  const int r0 = (blockIdx.x % m_sub) * BM_T;   // first row inside each row-block
  const int rows = min(BM_T, bm - r0);
  const int n0 = blockIdx.y * BN_T;
  const int rb0 = grp * G;                      // first row-block of the group
  const int nrb = min(G, nbr - rb0);            // row-blocks in the group

  float acc[TM][TN];
  zero(acc);
  int cur = -1;  // local row-block whose sum acc holds
  const int nvalid = nslots[grp];
  for (int l = 0; l < nvalid; ++l) {
    const size_t slot = static_cast<size_t>(grp) * Lg + l;
    const int lr = local_rb[slot];
    if (lr != cur) {
      if (cur >= 0) {
        store_tile(acc, c, (rb0 + cur) * bm + r0, rows, m, n, n0);
        zero(acc);
      }
      for (int e = cur + 1; e < lr; ++e) {  // row-blocks without a slot
        store_tile(acc, c, (rb0 + e) * bm + r0, rows, m, n, n0);
      }
      cur = lr;
    }
    accumulate_slot<TA, TB, ROUND_BF16>(
        acc, st, vals + (slot * bm + r0) * static_cast<size_t>(bk), rows, bk, b,
        block_cols[slot] * bk, k, n, n0);
  }
  if (cur >= 0) {
    store_tile(acc, c, (rb0 + cur) * bm + r0, rows, m, n, n0);
    zero(acc);
  }
  for (int e = cur + 1; e < nrb; ++e) {
    store_tile(acc, c, (rb0 + e) * bm + r0, rows, m, n, n0);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int grouped_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                            void* c, int c_dtype, const void* block_cols,
                            const void* local_rb, const void* nslots, int m, int k, int n,
                            int bm, int bk, int nbr, int G, int Lg, int round_bf16,
                            int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || G <= 0 ||
      Lg <= 0 || (n + BN_T - 1) / BN_T > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_sub = (bm + BM_T - 1) / BM_T;
  const int ng = (nbr + G - 1) / G;
  const dim3 grid(static_cast<unsigned>(ng) * m_sub, (n + BN_T - 1) / BN_T);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = dispatch(vals_dtype, b_dtype, c_dtype, round_bf16,
                          [&](auto ta, auto tb, auto tc, auto rnd) {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    using TC = typename decltype(tc)::type;
    grouped_spmm_kernel<TA, TB, TC, decltype(rnd)::value><<<grid, NT, 0, s>>>(
        static_cast<const TA*>(vals), static_cast<const TB*>(b), static_cast<TC*>(c),
        static_cast<const int*>(block_cols), static_cast<const int*>(local_rb),
        static_cast<const int*>(nslots), m, k, n, bm, bk, nbr, G, Lg, m_sub);
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
