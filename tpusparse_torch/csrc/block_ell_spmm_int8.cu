// int8 block-ELL SpMM executor for NVIDIA Hopper (sm_90a), the serving
// tier's w8a8 product: C = (sum_l s_a[l] * (Qa[l] @ Qb[col_l])) * t.
//
// Replaces the two TPU kernels of tpusparse/kernels/tiled_spmm.py:
//   _resident_int8_kernel (l.643, pallas_call l.804, behind
//                          resident_spmm_int8_pallas)
//   _tiled_int8_kernel    (l.845, pallas_call l.994, behind
//                          tiled_spmm_int8_pallas)
// The two differ only in how the TPU fed B (a resident VMEM panel or a DMA
// ring); they consume the slots in the same order and are bitwise equal.
// One CUDA kernel serves both entry points, so theirs are too.
//
// Contract, for each row-block i and each valid slot l < nslots[i]
// (padded slots are skipped; their scale is 0 as well):
//   P_l  = qvals[i*L + l] @ b_q[block_cols[i*L + l]*bk : +bk, :]   exact int32
//   acc  = acc + s_a[i*L + l] * float(P_l)                         fp32, in l order
//   C[i*bm : (i+1)*bm, :] = acc * t                                 fp32
// qvals (nbr * L, bm, bk) int8; scales (nbr * L,) fp32; b_q (k, n) int8;
// t (n,) fp32; C (m, n) fp32. Each multiply and each add of the epilogue
// rounds on its own (__fmul_rn, __fadd_rn: no FMA contraction), as the plain
// PyTorch version and the JAX kernel do, so the result is bitwise equal to
// the plain version. int32 holds a slot's product while 127^2 * bk < 2^31.
//
// What bounds it. At the 16384^2 headline (1,669 valid 128x128 blocks,
// n = 512) the work is 28.0 G int8 ops (0.014 ms at the H100's 1,979 TOPS
// int8 datasheet rate) against 69 MB of compulsory traffic (27.3 MB of
// valid blocks, 8.4 MB of b_q, 33.6 MB of C: 0.021 ms at 3.35 TB/s): bytes
// bound it, and C's fp32 write is half of them. This first design puts the
// products on the tensor cores with mma.sync (m16n8k32, s8 x s8 -> s32),
// staged through shared memory one 32-deep chunk at a time, without double
// buffering; wgmma, TMA and a persistent schedule are later work.
//
// Design: one thread block per (64-row slice of a row-block, 128-column
// n-tile); blockIdx.x walks the row-blocks fastest, so the blocks that share
// an n-tile of b_q run together and reuse it from L2. Loop over the slots in
// ascending l; per slot, loop over bk in 32-deep chunks into int32
// fragments, then fold them into the fp32 accumulator with the slot's
// scale. No atomics: each output element is summed by one thread in one
// fixed order.

#include "int8_tiles.cuh"

namespace {

using namespace i8;

__global__ void __launch_bounds__(NT) block_ell_spmm_int8_kernel(
    const int8_t* __restrict__ qvals,    // (nbr * L, bm, bk)
    const float* __restrict__ scales,    // (nbr * L)
    const int8_t* __restrict__ bq,       // (k, n)
    const float* __restrict__ t,         // (n)
    float* __restrict__ c,               // (m, n)
    const int* __restrict__ block_cols,  // (nbr * L)
    const int* __restrict__ nslots,      // (nbr)
    int m, int k, int n, int bm, int bk, int L, int m_sub) {
  __shared__ __align__(16) uint32_t As[TM * LDW];
  __shared__ __align__(16) uint32_t Bs[TN * LDW];

  const int i = blockIdx.x / m_sub;            // row-block
  const int r0 = (blockIdx.x % m_sub) * TM;    // first row inside the row-block
  const int rows = min(TM, bm - r0);           // rows of this slice
  const int n0 = blockIdx.y * TN;

  float acc[2][4][4];
  Acc part;
  for_each([&](int a, int j, int e, int, int) { acc[a][j][e] = 0.f; });

  const int nvalid = nslots[i];
  for (int l = 0; l < nvalid; ++l) {
    const size_t slot = static_cast<size_t>(i) * L + l;
    const int8_t* a_blk = qvals + (slot * bm + r0) * static_cast<size_t>(bk);
    const int kb = block_cols[slot] * bk;  // first b_q row of this slot
    const int8_t* b_blk = bq + static_cast<size_t>(kb) * n;
    const int krows = min(bk, k - kb);     // the last block-column may be ragged
    for_each([&](int a, int j, int e, int, int) { part[a][j][e] = 0; });
    for (int k0 = 0; k0 < bk; k0 += KC) {
      stage_a(As, a_blk, bk, rows, bk, k0);
      stage_b(Bs, b_blk, n, krows, n, k0, n0);
      __syncthreads();
      mma_chunk(part, As, Bs);
      __syncthreads();
    }
    const float s = scales[slot];
    for_each([&](int a, int j, int e, int, int) {
      acc[a][j][e] = __fadd_rn(acc[a][j][e], __fmul_rn(s, __int2float_rn(part[a][j][e])));
    });
  }

  for_each([&](int a, int j, int e, int r, int col) {
    const int grow = i * bm + r0 + r, gcol = n0 + col;
    if (r < rows && grow < m && gcol < n) {
      c[static_cast<size_t>(grow) * n + gcol] = __fmul_rn(acc[a][j][e], t[gcol]);
    }
  });
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` (PyTorch's
// current stream) and does not synchronise; returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int block_ell_spmm_int8(const void* qvals, const void* scales, const void* bq,
                                   const void* t, void* c, const void* block_cols,
                                   const void* nslots, int m, int k, int n, int bm, int bk,
                                   int nbr, int L, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || L <= 0 ||
      (n + TN - 1) / TN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_sub = (bm + TM - 1) / TM;
  const dim3 grid(static_cast<unsigned>(nbr) * m_sub, (n + TN - 1) / TN);
  block_ell_spmm_int8_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qvals), static_cast<const float*>(scales),
      static_cast<const int8_t*>(bq), static_cast<const float*>(t), static_cast<float*>(c),
      static_cast<const int*>(block_cols), static_cast<const int*>(nslots), m, k, n, bm, bk, L,
      m_sub);
  return static_cast<int>(cudaGetLastError());
}
