// Block-ELL SpMM executor for NVIDIA Hopper (sm_90a) on the tensor cores
// (wgmma): C = A @ B, where A is given by an inspector plan (block_cols,
// nslots) and its packed values block_vals (nbr * L, bm, bk), and B is
// dense (k, n), row-major.
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
// in ascending l. Padded slots (l >= nslots[i]) are skipped; a row-block
// with no slot is written as zeros. Sums are fp32; C is written in its own
// type (fp32 or bf16). The kernel is block_ell_spmm.cuh's body on the ELL
// walk, which the batched (block_ell_spmm_batched.cu) and compact
// (block_ell_spmm_compact.cu) executors share: its contract, tiers, tiles
// and determinism are set out there.
//
// What bounds it. At the 16384^2 headline (10% of the 128x128 blocks
// occupied: 1,669 blocks, 27.3 M nonzeros, n = 512) the work is 28.0 GFLOP:
// 3xTF32's three passes at the H100's 495 TFLOP/s tf32 rate take 0.170 ms,
// against ~176 MB of compulsory traffic (109 MB of block values, 34 MB of
// B, 34 MB of C), 0.053 ms at 3.35 TB/s. The FFMA kernel this replaces
// (bounded at 0.418 ms by 67 TFLOP/s) ran 1.44 ms. On an NVIDIA H100 80GB
// HBM3 at 700 W this kernel runs 0.376 ms (queued; 74 TFLOP/s, 0.45 of the
// bound); the transpose plan's dB 0.380, 'default' 0.179. Of the 0.376,
// the tensor-core loop with its barrier a chunk takes 0.217 (a variant
// with no loads and no shared stores); the staging takes the rest.

#include "block_ell_spmm.cuh"

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. order (nbr) int32: the row-blocks by slot count, most
// first. Launches on `stream` (PyTorch's current stream) and does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int block_ell_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                              void* c, int c_dtype, const void* block_cols, const void* nslots,
                              const void* order, int m, int k, int n, int bm, int bk, int nbr,
                              int L, int round_bf16, int device, void* stream) {
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return wt::launch_block_spmm<wt::EllWalk, false>(vals, vals_dtype, b, b_dtype, c, c_dtype,
                                                   block_cols, nslots, order, 1, m, k, n, bm,
                                                   bk, nbr, L, round_bf16, device, stream);
}
