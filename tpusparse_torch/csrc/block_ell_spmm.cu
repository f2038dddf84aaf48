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
//   summed by one thread in one fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM_T = 64;  // output rows per thread block (slice of a row-block)
constexpr int BN_T = 64;  // output columns per thread block
constexpr int BK_T = 16;  // k-chunk staged in shared memory
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int NT = (BM_T / TM) * (BN_T / TN);  // 256 threads
constexpr int A_LD = BM_T + 4;  // padded row of the transposed A chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool ROUND_BF16>
__device__ __forceinline__ float tier(float x) {
  if constexpr (ROUND_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TA, typename TB, typename TC, bool ROUND_BF16>
__global__ void __launch_bounds__(NT) block_ell_spmm_kernel(
    const TA* __restrict__ vals,          // (nbr * L, bm, bk)
    const TB* __restrict__ b,             // (k, n)
    TC* __restrict__ c,                   // (m, n)
    const int* __restrict__ block_cols,   // (nbr * L)
    const int* __restrict__ nslots,       // (nbr)
    int m, int k, int n, int bm, int bk, int L, int m_sub) {
  __shared__ __align__(16) float As[BK_T][A_LD];  // A chunk, k-major
  __shared__ __align__(16) float Bs[BK_T][BN_T];

  const int i = blockIdx.x / m_sub;             // row-block
  const int r0 = (blockIdx.x % m_sub) * BM_T;   // first row inside the row-block
  const int rows = min(BM_T, bm - r0);          // rows of this slice
  const int n0 = blockIdx.y * BN_T;
  const int tid = threadIdx.x;
  const int tx = tid % (BN_T / TN);
  const int ty = tid / (BN_T / TN);

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[a][q] = 0.f;

  const int nvalid = nslots[i];
  for (int l = 0; l < nvalid; ++l) {
    const size_t slot = static_cast<size_t>(i) * L + l;
    const TA* a_blk = vals + (slot * bm + r0) * static_cast<size_t>(bk);
    const int kb = block_cols[slot] * bk;  // first B row of this slot
    for (int k0 = 0; k0 < bk; k0 += BK_T) {
      for (int e = tid; e < BM_T * BK_T; e += NT) {
        const int r = e / BK_T, q = e % BK_T;
        float v = 0.f;
        if (r < rows && k0 + q < bk) {
          v = tier<ROUND_BF16>(to_f32(a_blk[static_cast<size_t>(r) * bk + k0 + q]));
        }
        As[q][r] = v;
      }
      for (int e = tid; e < BK_T * BN_T; e += NT) {
        const int q = e / BN_T, col = e % BN_T;
        const int kr = kb + k0 + q, cn = n0 + col;
        float v = 0.f;
        if (k0 + q < bk && kr < k && cn < n) {
          v = tier<ROUND_BF16>(to_f32(b[static_cast<size_t>(kr) * n + cn]));
        }
        Bs[q][col] = v;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < BK_T; ++q) {
        const float4 av = *reinterpret_cast<const float4*>(&As[q][ty * TM]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[q][tx * TN]);
        const float ar[TM] = {av.x, av.y, av.z, av.w};
        const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[a][j] = fmaf(ar[a], br[j], acc[a][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = ty * TM + a;
    const int grow = i * bm + r0 + r;
    if (r >= rows || grow >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cn = n0 + tx * TN + j;
      if (cn < n) store(&c[static_cast<size_t>(grow) * n + cn], acc[a][j]);
    }
  }
}

template <typename TA, typename TB, typename TC>
void launch_typed(const void* vals, const void* b, void* c, const int* cols,
                  const int* nslots, int m, int k, int n, int bm, int bk,
                  int nbr, int L, int round_bf16, cudaStream_t stream) {
  const int m_sub = (bm + BM_T - 1) / BM_T;
  const dim3 grid(static_cast<unsigned>(nbr) * m_sub, (n + BN_T - 1) / BN_T);
  const auto* va = static_cast<const TA*>(vals);
  const auto* vb = static_cast<const TB*>(b);
  auto* vc = static_cast<TC*>(c);
  if (round_bf16) {
    block_ell_spmm_kernel<TA, TB, TC, true><<<grid, NT, 0, stream>>>(
        va, vb, vc, cols, nslots, m, k, n, bm, bk, L, m_sub);
  } else {
    block_ell_spmm_kernel<TA, TB, TC, false><<<grid, NT, 0, stream>>>(
        va, vb, vc, cols, nslots, m, k, n, bm, bk, L, m_sub);
  }
}

template <typename TA, typename TB>
int launch_out(const void* vals, const void* b, void* c, int c_dtype,
               const int* cols, const int* nslots, int m, int k, int n, int bm,
               int bk, int nbr, int L, int round_bf16, cudaStream_t stream) {
  if (c_dtype == 0) {
    launch_typed<TA, TB, float>(vals, b, c, cols, nslots, m, k, n, bm, bk, nbr, L,
                                round_bf16, stream);
  } else if (c_dtype == 1) {
    launch_typed<TA, TB, __nv_bfloat16>(vals, b, c, cols, nslots, m, k, n, bm, bk,
                                        nbr, L, round_bf16, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
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
  auto s = static_cast<cudaStream_t>(stream);
  const auto* cols = static_cast<const int*>(block_cols);
  const auto* ns = static_cast<const int*>(nslots);
  int rc;
  if (vals_dtype == 0 && b_dtype == 0) {
    rc = launch_out<float, float>(vals, b, c, c_dtype, cols, ns, m, k, n, bm, bk, nbr,
                                  L, round_bf16, s);
  } else if (vals_dtype == 0 && b_dtype == 1) {
    rc = launch_out<float, __nv_bfloat16>(vals, b, c, c_dtype, cols, ns, m, k, n, bm,
                                          bk, nbr, L, round_bf16, s);
  } else if (vals_dtype == 1 && b_dtype == 0) {
    rc = launch_out<__nv_bfloat16, float>(vals, b, c, c_dtype, cols, ns, m, k, n, bm,
                                          bk, nbr, L, round_bf16, s);
  } else if (vals_dtype == 1 && b_dtype == 1) {
    rc = launch_out<__nv_bfloat16, __nv_bfloat16>(vals, b, c, c_dtype, cols, ns, m, k,
                                                  n, bm, bk, nbr, L, round_bf16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
