// Padding-free block SpMM for NVIDIA Hopper (sm_90a) on the tensor cores
// (wgmma): C = A @ B, where A is given by a CompactPlan (cols, row_base) and
// its values packed without ELL padding, (nblocks, bm, bk): row-block i owns
// the slots row_base[i] .. row_base[i+1] - 1, in ascending column order. B
// is (k, n), C (m, n), both row-major.
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
// its own type. A row-block with no slot is written as zeros. The kernel is
// block_ell_spmm.cuh's body on the compact walk, with block_ell_spmm's tile
// chooser, and a row-block's slots come in the base plan's order, so C is
// bitwise equal to block_ell_spmm on the plan the compact plan was derived
// from. Row-blocks start heaviest first (the plan's `heaviest_first`).
//
// What bounds it: as block_ell_spmm, 3xTF32's three passes of 2 * nblocks *
// bm * bk * n (0.170 ms at the 16384^2 headline) above the bytes of the
// blocks, B and C. At the low-fill plan (4096^2 at 1 %, blocks 8 x 32, n
// 256: 60,600 blocks) the bound is 0.048 ms, but each slot reads a 32 x 256
// panel of B, ~2.0 GB from L2 in all (~0.38 ms at the 5.24 TB/s L2 gather
// rate measured for naive_spmm); its 8-row blocks take the n-major tile.
// The first port, on an FFMA tile, ran 1.501 and 2.882 ms
// on an NVIDIA H100 80GB HBM3 at 700 W.

#include "block_ell_spmm.cuh"

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. order (nbr) int32: the row-blocks by slot count, most
// first. Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int compact_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                            void* c, int c_dtype, const void* cols, const void* row_base,
                            const void* order, int m, int k, int n, int bm, int bk, int nbr,
                            int round_bf16, int device, void* stream) {
  return wt::launch_block_spmm<wt::CompactWalk, false>(vals, vals_dtype, b, b_dtype, c, c_dtype,
                                                       cols, row_base, order, 1, m, k, n, bm,
                                                       bk, nbr, 0, round_bf16, device, stream);
}
