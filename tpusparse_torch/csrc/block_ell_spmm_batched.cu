// Batched block-ELL SpMM for NVIDIA Hopper (sm_90a) on the tensor cores
// (wgmma): C[g] = A @ B[g] for a 3-D B (batch, k, n) under one plan
// (block_cols, nslots) and its packed values (nbr * L, bm, bk); C is
// (batch, m, n). Both row-major.
//
// Replaces tpusparse/kernels/tiled_spmm.py:420 _resident_batched_kernel
// (behind resident_spmm_batched_pallas, pallas_call l.600). The TPU kernel
// kept the whole packed-vals array resident in VMEM and put the batch on the
// grid, so that a 3-D B needs neither the fold's transposing copies of B and
// C nor a re-stream of the values per (batch element, n-tile). Here the
// kernel's tiles run over the batch folded into columns, (k, batch n), as
// the fold onto block_ell_spmm would give them, but B and C are read and
// written in place at their strides: no copy, and a batch of n = 64 still
// fills 128-column tiles. The values stream through the 50 MB L2, which
// holds them at both shapes this kernel serves (0.4 MB and 4 MB of fp32
// blocks); an n-tile's row-blocks run together, so each B panel comes from
// device memory once. There is no VMEM budget to check.
//
// Contract: for each batch element g, row-block i and valid slot
// l < nslots[i], C[g, i*bm : (i+1)*bm, :] += vals[i*L + l] @
// B[g, block_cols[i*L + l]*bk : +bk, :]; pad slots skipped; fp32 sums; C in
// its own type. The kernel is block_ell_spmm.cuh's body on the ELL walk,
// the one block_ell_spmm.cu launches, with the same tile chooser given the
// folded width: C is bitwise equal to block_ell_spmm on the folded (k,
// batch n) operand, and each output element is summed in the order
// block_ell_spmm sums it on B[g] alone.
//
// What bounds it: 3xTF32's three passes of 2 * nblocks * bm * bk * n * batch
// at 495 TFLOP/s. At the block-sparse batched shape (2048^2, 10 % of the
// 128^2 blocks, B (32, 2048, 512)) that is 3 x 14 GFLOP, 0.101 ms, against
// ~0.08 ms for the 268 MB of B and C at 3.35 TB/s; at the bert4d shape
// (512^2, all 16 blocks, B (4096, 512, 64)) 3 x 137 GFLOP, 0.833 ms,
// against 0.32 ms for 1.07 GB. Folded, bert4d's n = 64 runs the
// headline's 128 x 128 tile on the raw ring. The first port, on an FFMA
// tile (~67 TFLOP/s at best), ran
// 0.822 and 5.962 ms on an NVIDIA H100 80GB HBM3 at 700 W.

#include "block_ell_spmm.cuh"

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. order (nbr) int32: the row-blocks by slot count, most
// first. batch * n must stay below 2^31. Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int block_ell_spmm_batched(const void* vals, int vals_dtype, const void* b,
                                      int b_dtype, void* c, int c_dtype,
                                      const void* block_cols, const void* nslots,
                                      const void* order, int batch, int m, int k, int n,
                                      int bm, int bk, int nbr, int L, int round_bf16,
                                      int device, void* stream) {
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return wt::launch_block_spmm<wt::EllWalk, true>(vals, vals_dtype, b, b_dtype, c, c_dtype,
                                                  block_cols, nslots, order, batch, m, k, n, bm,
                                                  bk, nbr, L, round_bf16, device, stream);
}
