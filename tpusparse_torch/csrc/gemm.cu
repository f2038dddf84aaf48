// Dense GEMM for NVIDIA Hopper (sm_90a): C = op(A) @ op(B) for 2-D
// row-major operands, where op transposes when its flag is set.
//
// Replaces the TPU kernel tpusparse/kernels/gemm.py:31 _gemm_kernel
// (pallas_call l.130, behind gemm_pallas): the blocked (M/bm, N/bn, K/bk)
// grid with a VMEM accumulator carried across the sequential K axis. Here
// one thread block owns one 64x64 tile of C and runs the whole K loop
// itself, so nothing carries between blocks. The TPU wrapper padded A and B
// to its tiles and sliced C; here the ragged m, n and k edges are masked in
// the loads and the store. The transpose flags are read by the kernel (it
// indexes the stored operand with the transposed strides), so the
// backward's transposed products copy nothing.
//
// Contract: A is stored (m, k), or (k, m) when transa; B is stored (k, n),
// or (n, k) when transb; C (m, n). Operands fp32 or bf16, accumulation
// fp32, C written in its own type. Precision tiers: fp32 FFMA
// ('high'/'highest', never TF32); with ROUND_BF16 ('default') both
// operands are rounded to bf16 (RTN) on load, their products are exact in
// fp32, and the sums are fp32.
// Determinism: no atomics. Each output element is summed by one thread, in
// ascending k, so runs repeat bit for bit.
//
// What bounds it. At 4096^3 fp32 the work is 2 * 4096^3 = 137.4 GFLOP,
// ~2.05 ms at the H100's ~67 TFLOP/s fp32 FFMA datasheet rate, against
// 201 MB of compulsory traffic (~0.06 ms at 3.35 TB/s): compute-bound for
// an FFMA kernel. The design spends its effort on FFMA issue: a 4x4
// register tile per thread, fed from shared memory by two 16-byte loads per
// 16 FFMAs; each A and B tile is re-read from L2 by the blocks of its row or
// column of C. At the MLP's shapes (m = 32, n <= 784) the kernel is
// latency-bound: a handful of blocks. A bigger per-thread tile, double
// buffering, and a tensor-core path (3xTF32 or bf16 wgmma with TMA) are
// later work.
//
// Design (first version, simple and deterministic): grid (n-tile, m-tile);
// each block loops over k in ascending 16-wide chunks, stages op(A)'s chunk
// k-major and op(B)'s chunk k-major in shared memory, reading each operand
// along its contiguous axis, and accumulates in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 64;  // rows and columns of C per thread block
constexpr int KC = 16;    // k-chunk staged in shared memory
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int NT = (TILE / TM) * (TILE / TN);  // 256 threads
constexpr int LD = TILE + 4;                   // padded row of a staged chunk

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

// Stage a (TILE x KC) chunk of op(X) into S[q][r] (k-major): element (r, q)
// is op(X)[base + r][k0 + q]. When `trans`, X is stored (k, rows) and the
// chunk is read along r; otherwise X is stored (rows, k) and read along q.
// Either way neighbouring threads read neighbouring addresses.
template <typename T, bool ROUND_BF16>
__device__ __forceinline__ void stage(float (*S)[LD], const T* __restrict__ x, bool trans,
                                      int base, int rows, int k0, int k, int tid) {
  if (trans) {
    for (int e = tid; e < TILE * KC; e += NT) {
      const int q = e / TILE, r = e % TILE;
      const int gr = base + r, gk = k0 + q;
      float v = 0.f;
      if (gr < rows && gk < k) v = tier<ROUND_BF16>(to_f32(x[static_cast<size_t>(gk) * rows + gr]));
      S[q][r] = v;
    }
  } else {
    for (int e = tid; e < TILE * KC; e += NT) {
      const int r = e / KC, q = e % KC;
      const int gr = base + r, gk = k0 + q;
      float v = 0.f;
      if (gr < rows && gk < k) v = tier<ROUND_BF16>(to_f32(x[static_cast<size_t>(gr) * k + gk]));
      S[q][r] = v;
    }
  }
}

template <typename TA, typename TB, typename TC, bool ROUND_BF16>
__global__ void __launch_bounds__(NT) gemm_kernel(
    const TA* __restrict__ a,  // (m, k), or (k, m) when transa
    const TB* __restrict__ b,  // (k, n), or (n, k) when transb
    TC* __restrict__ c,        // (m, n)
    int m, int n, int k, int transa, int transb) {
  __shared__ __align__(16) float As[KC][LD];  // op(A) chunk, k-major
  __shared__ __align__(16) float Bs[KC][LD];  // op(B)^T chunk, k-major

  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % (TILE / TN);
  const int ty = tid / (TILE / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    stage<TA, ROUND_BF16>(As, a, transa != 0, m0, m, k0, k, tid);
    // op(B)[q][col] is op(B)^T[col][q]: B stored (n, k) is op(B)^T untransposed
    stage<TB, ROUND_BF16>(Bs, b, transb == 0, n0, n, k0, k, tid);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      const float4 av = *reinterpret_cast<const float4*>(&As[q][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[q][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < n) store(&c[static_cast<size_t>(r) * n + col], acc[i][j]);
    }
  }
}

template <typename TA, typename TB, typename TC>
void launch_typed(const void* a, const void* b, void* c, int m, int n, int k, int transa,
                  int transb, int round_bf16, cudaStream_t stream) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  const auto* va = static_cast<const TA*>(a);
  const auto* vb = static_cast<const TB*>(b);
  auto* vc = static_cast<TC*>(c);
  if (round_bf16) {
    gemm_kernel<TA, TB, TC, true><<<grid, NT, 0, stream>>>(va, vb, vc, m, n, k, transa,
                                                           transb);
  } else {
    gemm_kernel<TA, TB, TC, false><<<grid, NT, 0, stream>>>(va, vb, vc, m, n, k, transa,
                                                            transb);
  }
}

template <typename TA, typename TB>
int launch_out(const void* a, const void* b, void* c, int c_dtype, int m, int n, int k,
               int transa, int transb, int round_bf16, cudaStream_t stream) {
  if (c_dtype == 0) {
    launch_typed<TA, TB, float>(a, b, c, m, n, k, transa, transb, round_bf16, stream);
  } else if (c_dtype == 1) {
    launch_typed<TA, TB, __nv_bfloat16>(a, b, c, m, n, k, transa, transb, round_bf16,
                                        stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. Launches on `stream` (PyTorch's current stream) and does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gemm(const void* a, int a_dtype, const void* b, int b_dtype, void* c,
                    int c_dtype, int m, int n, int k, int transa, int transb,
                    int round_bf16, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + TILE - 1) / TILE > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (a_dtype == 0 && b_dtype == 0) {
    rc = launch_out<float, float>(a, b, c, c_dtype, m, n, k, transa, transb, round_bf16, s);
  } else if (a_dtype == 0 && b_dtype == 1) {
    rc = launch_out<float, __nv_bfloat16>(a, b, c, c_dtype, m, n, k, transa, transb,
                                          round_bf16, s);
  } else if (a_dtype == 1 && b_dtype == 0) {
    rc = launch_out<__nv_bfloat16, float>(a, b, c, c_dtype, m, n, k, transa, transb,
                                          round_bf16, s);
  } else if (a_dtype == 1 && b_dtype == 1) {
    rc = launch_out<__nv_bfloat16, __nv_bfloat16>(a, b, c, c_dtype, m, n, k, transa,
                                                  transb, round_bf16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
