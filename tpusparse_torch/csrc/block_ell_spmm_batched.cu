// Batched block-ELL SpMM for NVIDIA Hopper (sm_90a): C[g] = A @ B[g] for a
// 3-D B (batch, k, n) under one plan (block_cols, nslots) and its packed
// values (nbr * L, bm, bk); C is (batch, m, n). Both row-major.
//
// Replaces tpusparse/kernels/tiled_spmm.py:420 _resident_batched_kernel
// (behind resident_spmm_batched_pallas, pallas_call l.600). The TPU kernel
// kept the whole packed-vals array resident in VMEM and put the batch on the
// grid, so that a 3-D B needs neither the fold's transposing copies of B and
// C nor a re-stream of the values per (batch element, n-tile). Here the batch
// goes on gridDim.z, with the strides of B and C, and B and C are read and
// written in place; the values stream through the 50 MB L2, which holds them
// at both shapes this kernel serves (0.4 MB and 4 MB of fp32 blocks). There
// is no VMEM budget to check.
//
// Contract: for each batch element g, row-block i and valid slot
// l < nslots[i], C[g, i*bm : (i+1)*bm, :] += vals[i*L + l] @
// B[g, block_cols[i*L + l]*bk : +bk, :]; pad slots skipped; fp32 sums; C in
// its own type. The tile is block_tiles.cuh's FFMA chain and the slot order
// the plan's, so C[g] is bitwise equal to this kernel applied to B[g] alone
// and to the compact, grouped and footprint executors on B[g]. The 2-D
// block_ell_spmm.cu sums on the tensor cores (3xTF32 or bf16 wgmma) in
// another order: C[g] is within the tier of it on B[g] and on the folded
// (k, batch*n) operand, not bitwise equal.
//
// What bounds it: the FFMA work, 2 * nblocks * bm * bk * n * batch. At the
// block-sparse batched shape (2048^2, 10 % of the 128^2 blocks, B (32, 2048,
// 512)) that is ~14 GFLOP, ~0.21 ms at ~67 TFLOP/s, against ~0.08 ms for
// the 268 MB of B and C at 3.35 TB/s; at the bert4d shape (512^2, all 16
// blocks, B (4096, 512, 64)) ~137 GFLOP, ~2.05 ms, against ~0.32 ms. The
// same FFMA tile as the 2-D kernel; a tensor-core (3xTF32 or bf16 wgmma)
// tile and TMA staging are later work.

#include <algorithm>

#include "block_tiles.cuh"

using namespace tiles;

namespace {

constexpr int MAX_GRID_Z = 65535;

template <typename TA, typename TB, typename TC, bool ROUND_BF16>
__global__ void __launch_bounds__(NT) block_ell_spmm_batched_kernel(
    const TA* __restrict__ vals,          // (nbr * L, bm, bk)
    const TB* __restrict__ b,             // (batch, k, n)
    TC* __restrict__ c,                   // (batch, m, n)
    const int* __restrict__ block_cols,   // (nbr * L)
    const int* __restrict__ nslots,       // (nbr)
    int m, int k, int n, int bm, int bk, int L, int m_sub, int g0) {
  __shared__ Staging st;

  const int i = blockIdx.x / m_sub;             // row-block
  const int r0 = (blockIdx.x % m_sub) * BM_T;   // first row inside the row-block
  const int rows = min(BM_T, bm - r0);
  const int n0 = blockIdx.y * BN_T;
  const size_t g = static_cast<size_t>(g0) + blockIdx.z;  // batch element
  const TB* bg = b + g * k * n;
  TC* cg = c + g * m * n;

  float acc[TM][TN];
  zero(acc);
  const int nvalid = nslots[i];
  for (int l = 0; l < nvalid; ++l) {
    const size_t slot = static_cast<size_t>(i) * L + l;
    accumulate_slot<TA, TB, ROUND_BF16>(
        acc, st, vals + (slot * bm + r0) * static_cast<size_t>(bk), rows, bk, bg,
        block_cols[slot] * bk, k, n, n0);
  }
  store_tile(acc, cg, i * bm + r0, rows, m, n, n0);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. A batch above 65,535 (the grid's z limit) is launched in
// chunks. Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int block_ell_spmm_batched(const void* vals, int vals_dtype, const void* b,
                                      int b_dtype, void* c, int c_dtype,
                                      const void* block_cols, const void* nslots,
                                      int batch, int m, int k, int n, int bm, int bk,
                                      int nbr, int L, int round_bf16, int device,
                                      void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 ||
      L <= 0 || (n + BN_T - 1) / BN_T > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_sub = (bm + BM_T - 1) / BM_T;
  auto s = static_cast<cudaStream_t>(stream);
  for (int g0 = 0; g0 < batch; g0 += MAX_GRID_Z) {
    const dim3 grid(static_cast<unsigned>(nbr) * m_sub, (n + BN_T - 1) / BN_T,
                    std::min(MAX_GRID_Z, batch - g0));
    const int rc = dispatch(vals_dtype, b_dtype, c_dtype, round_bf16,
                            [&](auto ta, auto tb, auto tc, auto rnd) {
      using TA = typename decltype(ta)::type;
      using TB = typename decltype(tb)::type;
      using TC = typename decltype(tc)::type;
      block_ell_spmm_batched_kernel<TA, TB, TC, decltype(rnd)::value><<<grid, NT, 0, s>>>(
          static_cast<const TA*>(vals), static_cast<const TB*>(b), static_cast<TC*>(c),
          static_cast<const int*>(block_cols), static_cast<const int*>(nslots), m, k, n,
          bm, bk, L, m_sub, g0);
    });
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
