// int8 GEMM for NVIDIA Hopper (sm_90a): C = A @ B for int8 A (m, k) and
// int8 B (k, n), both row-major, with exact int32 sums, C (m, n) int32.
//
// Replaces the TPU kernel tpusparse/kernels/gemm.py:298 _gemm_s8_kernel
// (pallas_call l.355, behind gemm_int8_pallas): the blocked (M/bm, N/bn,
// K/bk) grid with an int32 VMEM accumulator carried across the sequential K
// axis. Here one thread block owns one 64 x 128 tile of C and runs the whole
// K loop itself, so nothing carries between blocks. The TPU wrapper padded
// A and B to its tiles and sliced C; here the ragged m, n and k edges (k
// need not be a multiple of 4) are zero-filled in shared memory. The TPU's
// block-size knobs are not carried. The caller owns dequantization.
//
// Exactness: every s8 x s8 product and every int32 sum is exact while the
// sums stay inside int32, that is while 127^2 * k < 2^31 (k < ~133,000), as
// on the TPU; past that they wrap, and no guard is added.
//
// What bounds it. At 4096^3 the work is 2 * 4096^3 = 137.4 G int8 ops,
// 0.069 ms at the H100's 1,979 TOPS int8 datasheet rate, against 100.7 MB of
// compulsory traffic (A, B and the int32 C: 0.030 ms at 3.35 TB/s): the
// operations bound it. This first design runs the products on the tensor
// cores with mma.sync (m16n8k32, s8 x s8 -> s32), 32-deep chunks staged
// through shared memory (int8_tiles.cuh) without double buffering; wgmma
// with TMA and a multi-stage pipeline are what reach the int8 peak, later
// work.
//
// Determinism: no atomics; each output element is summed by one thread in
// ascending k (integer sums are exact in any order anyway).

#include "int8_tiles.cuh"

namespace {

using namespace i8;

__global__ void __launch_bounds__(NT) gemm_s8_kernel(const int8_t* __restrict__ a,
                                                     const int8_t* __restrict__ b,
                                                     int32_t* __restrict__ c, int m, int n,
                                                     int k) {
  __shared__ __align__(16) uint32_t As[TM * LDW];
  __shared__ __align__(16) uint32_t Bs[TN * LDW];

  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int rows = min(TM, m - m0);
  const int8_t* a_tile = a + static_cast<size_t>(m0) * k;

  Acc acc;
  for_each([&](int i, int j, int e, int, int) { acc[i][j][e] = 0; });
  for (int k0 = 0; k0 < k; k0 += KC) {
    stage_a(As, a_tile, k, rows, k, k0);
    stage_b(Bs, b, n, k, n, k0, n0);
    __syncthreads();
    mma_chunk(acc, As, Bs);
    __syncthreads();
  }

  for_each([&](int i, int j, int e, int r, int col) {
    const int gcol = n0 + col;
    if (r < rows && gcol < n) c[static_cast<size_t>(m0 + r) * n + gcol] = acc[i][j][e];
  });
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` (PyTorch's
// current stream) and does not synchronise; returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int gemm_s8(const void* a, const void* b, void* c, int m, int n, int k, int device,
                       void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + TM - 1) / TM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  gemm_s8_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int32_t*>(c), m,
      n, k);
  return static_cast<int>(cudaGetLastError());
}
