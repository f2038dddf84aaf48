// Block-ELL SpMM executor for NVIDIA Hopper (sm_90a): C = A @ B, where A is
// given by an inspector plan (block_cols, nslots) and its packed values
// block_vals (nbr * L, bm, bk), and B is dense (k, n), row-major.
//
// Replaces the two TPU kernels of tpusparse/kernels/tiled_spmm.py:
//   _executor_kernel (l.43, the DMA-ring executor behind tiled_spmm_pallas)
//   _resident_kernel (l.210, the resident-B-panel executor behind
//                     resident_spmm_pallas).
// Both computed the same thing in the same slot order; the ring and the
// resident panel were answers to the TPU's DMA latency and VMEM size. One
// CUDA kernel serves both entry points, so their outputs are bitwise equal.
//
// Contract, for each row-block i and each valid slot l < nslots[i]:
//   C[i*bm:(i+1)*bm, :] += block_vals[i*L + l] @ B[block_cols[i*L + l]*bk : +bk, :]
// Padded slots (l >= nslots[i]) are skipped. Accumulation is fp32; C is
// written in its own type (fp32 or bf16). Any (bm, bk) is taken; the ragged
// m, k and n edges are masked here, B is never padded or copied.
// Precision tiers: fp32 FFMA ('high'/'highest', never TF32); with
// ROUND_BF16 ('default') both operands are rounded to bf16 (RTN) on load,
// their products are exact in fp32, and the sums are fp32.
//
// What bounds it. At the 16384^2 headline (10% of the 128x128 blocks
// occupied, nblocks ~ 1,638, nnz ~ 26.8 M, n = 512) the work is about
// 27.5 GFLOP, ~0.41 ms at the H100's ~67 TFLOP/s fp32 FFMA datasheet rate,
// against ~174 MB of compulsory traffic (107 MB block values, 34 MB B,
// 34 MB C), ~0.05 ms at 3.35 TB/s. So an FFMA kernel is compute-bound, and
// this design spends its effort on FFMA issue: each thread keeps a 4x4
// register tile, fed from shared memory by two 16-byte loads per 16 FFMAs;
// B's rows are reused out of L2 across the row-blocks that share an n-tile
// (blockIdx.x walks the row-blocks fastest). A 3xTF32 tensor-core design
// would lower the bound to ~0.17 ms; that, wgmma, TMA and a persistent
// schedule are later work.
//
// Design (first version, simple and deterministic):
//   one thread block per (64-row slice of a row-block, 64-column n-tile);
//   loop over the slots in ascending l and over k in ascending 16-wide
//   chunks; stage the A chunk (transposed) and the B chunk in shared
//   memory; accumulators in registers; no atomics. Each output element is
//   summed by one thread in one fixed order. The tile is the one of
//   block_tiles.cuh, which the batched, compact and grouped executors share,
//   so they agree with this kernel bit for bit.

#include "block_tiles.cuh"

using namespace tiles;

namespace {

template <typename TA, typename TB, typename TC, bool ROUND_BF16>
__global__ void __launch_bounds__(NT) block_ell_spmm_kernel(
    const TA* __restrict__ vals,          // (nbr * L, bm, bk)
    const TB* __restrict__ b,             // (k, n)
    TC* __restrict__ c,                   // (m, n)
    const int* __restrict__ block_cols,   // (nbr * L)
    const int* __restrict__ nslots,       // (nbr)
    int m, int k, int n, int bm, int bk, int L, int m_sub) {
  __shared__ Staging st;

  const int i = blockIdx.x / m_sub;             // row-block
  const int r0 = (blockIdx.x % m_sub) * BM_T;   // first row inside the row-block
  const int rows = min(BM_T, bm - r0);          // rows of this slice
  const int n0 = blockIdx.y * BN_T;

  float acc[TM][TN];
  zero(acc);
  const int nvalid = nslots[i];
  for (int l = 0; l < nvalid; ++l) {
    const size_t slot = static_cast<size_t>(i) * L + l;
    accumulate_slot<TA, TB, ROUND_BF16>(
        acc, st, vals + (slot * bm + r0) * static_cast<size_t>(bk), rows, bk, b,
        block_cols[slot] * bk, k, n, n0);
  }
  store_tile(acc, c, i * bm + r0, rows, m, n, n0);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. Launches on `stream` (PyTorch's current stream) and does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int block_ell_spmm(const void* vals, int vals_dtype, const void* b,
                              int b_dtype, void* c, int c_dtype,
                              const void* block_cols, const void* nslots, int m,
                              int k, int n, int bm, int bk, int nbr, int L,
                              int round_bf16, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || L <= 0 ||
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
    block_ell_spmm_kernel<TA, TB, TC, decltype(rnd)::value><<<grid, NT, 0, s>>>(
        static_cast<const TA*>(vals), static_cast<const TB*>(b), static_cast<TC*>(c),
        static_cast<const int*>(block_cols), static_cast<const int*>(nslots), m, k, n,
        bm, bk, L, m_sub);
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
