// Padding-free block SpMM for NVIDIA Hopper (sm_90a): C = A @ B, where A is
// given by a CompactPlan (cols, row_base) and its values packed without ELL
// padding, (nblocks, bm, bk): row-block i owns the slots
// row_base[i] .. row_base[i+1] - 1, in ascending column order. B is (k, n),
// C (m, n), both row-major.
//
// Replaces tpusparse/kernels/tiled_spmm.py:1029 _compact_kernel (behind
// compact_spmm_pallas, pallas_call l.1150). On the TPU the ELL layout
// moved every pad slot's value block through the grid pipeline, so the
// compact kernel streamed each occupied block and its B tile through a
// manual DMA ring instead. Here pad slots never move in either layout (the
// ELL kernel stops at nslots), and the compact plan's gain is the smaller
// value array: nblocks blocks instead of nbr * L.
//
// Contract: for each row-block i and slot s in [row_base[i], row_base[i+1]),
// C[i*bm : (i+1)*bm, :] += vals[s] @ B[cols[s]*bk : +bk, :]; fp32 sums; C in
// its own type. A row-block with no slot is written as zeros. The tile is
// block_tiles.cuh's FFMA chain and a row-block's slots come in the base
// plan's ascending column order, so C is bitwise equal to the batched
// executor (block_ell_spmm_batched.cu) on a batch of one on the plan the
// compact plan was derived from, and to the grouped and footprint
// executors; it is within the tier of the tensor-core block_ell_spmm.
//
// What bounds it: as block_ell_spmm, the FFMA work 2 * nblocks * bm * bk * n
// (~0.41 ms at the 16384^2 headline) above the bytes of the blocks, B and C.
// One thread block per (64-row slice of a row-block, 64-column n-tile);
// wgmma, TMA and a persistent schedule are later work.

#include "block_tiles.cuh"

using namespace tiles;

namespace {

template <typename TA, typename TB, typename TC, bool ROUND_BF16>
__global__ void __launch_bounds__(NT) compact_spmm_kernel(
    const TA* __restrict__ vals,          // (nblocks, bm, bk)
    const TB* __restrict__ b,             // (k, n)
    TC* __restrict__ c,                   // (m, n)
    const int* __restrict__ cols,         // (nblocks)
    const int* __restrict__ row_base,     // (nbr + 1)
    int m, int k, int n, int bm, int bk, int m_sub) {
  __shared__ Staging st;

  const int i = blockIdx.x / m_sub;             // row-block
  const int r0 = (blockIdx.x % m_sub) * BM_T;   // first row inside the row-block
  const int rows = min(BM_T, bm - r0);
  const int n0 = blockIdx.y * BN_T;

  float acc[TM][TN];
  zero(acc);
  const int end = row_base[i + 1];
  for (int slot = row_base[i]; slot < end; ++slot) {
    accumulate_slot<TA, TB, ROUND_BF16>(
        acc, st, vals + (static_cast<size_t>(slot) * bm + r0) * static_cast<size_t>(bk),
        rows, bk, b, cols[slot] * bk, k, n, n0);
  }
  store_tile(acc, c, i * bm + r0, rows, m, n, n0);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int compact_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                            void* c, int c_dtype, const void* cols, const void* row_base,
                            int m, int k, int n, int bm, int bk, int nbr, int round_bf16,
                            int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 ||
      (n + BN_T - 1) / BN_T > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_sub = (bm + BM_T - 1) / BM_T;
  const dim3 grid(static_cast<unsigned>(nbr) * m_sub, (n + BN_T - 1) / BN_T);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = dispatch(vals_dtype, b_dtype, c_dtype, round_bf16,
                          [&](auto ta, auto tb, auto tc, auto rnd) {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    using TC = typename decltype(tc)::type;
    compact_spmm_kernel<TA, TB, TC, decltype(rnd)::value><<<grid, NT, 0, s>>>(
        static_cast<const TA*>(vals), static_cast<const TB*>(b), static_cast<TC*>(c),
        static_cast<const int*>(cols), static_cast<const int*>(row_base), m, k, n, bm, bk,
        m_sub);
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
