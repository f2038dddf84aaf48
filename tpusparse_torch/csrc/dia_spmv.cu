// Wide-DIA SpMV for NVIDIA Hopper (sm_90a): y = A·x for a banded operator
// stored as a diagonal plane, the matvec of the AMG hierarchy's wide levels
// (tpusparse_torch/kernels/dia.py: PackedDIA, dia_spmv, ops.dia_spmm on one
// column past 128 diagonals).
//
// Replaces the TPU kernel tpusparse/kernels/dia.py:57 _dia_spmv_kernel
// (_dia_spmv_jit l.113, pallas_call l.123; behind dia_spmv_pallas l.217,
// dia_spmv l.302 and PackedDIA.mv l.352). The TPU has no vector gather, so
// that kernel kept the whole x in VMEM as 128-lane rows, built one shifted
// copy of x per lane remainder with two lane rolls and a select, and read
// each diagonal's window as a sublane slice of it; the plane was padded to
// (8, 128) tiles with 256 entries of slack. None of that carries over: a
// GPU thread reads x[i + off] directly, and neighbouring threads read
// neighbouring addresses, so every load is coalesced across the warp.
//
// Contract. data (nd, m) fp32 or bf16, row-major; offsets (nd,) int32; x
// (k,) fp32 or bf16; y (m,) fp32. For each row i < m:
//   y[i] = sum over d = 0 .. nd-1, in that order, of P(data[d, i], X(i + off_d)),
// summed in fp32 from 0.0f with each add rounded on its own (__fadd_rn),
// where X(j) = x[j] for 0 <= j < k and 0 otherwise (the TPU wrapper's
// zero-padded x: a slot past the edge multiplies a zero, it is not skipped,
// so an inf or NaN stored there gives NaN, as in JAX), and P is the product
// rounded to the type JAX's promotion gives it: bf16 when data and x are
// both bf16, else fp32 (__fmul_rn; no FMA contraction). The row order of
// the plane is the caller's: PackedDIA keeps JAX's plane order (sorted by
// lane remainder, then offset), so the sum runs in the order of the TPU
// kernel, and the plain version (dia.py: _dia_spmv_plain) repeats it op
// for op: the two are bitwise equal.
//
// What bounds it: bytes. It reads the plane once (nd·m values), x and the
// offsets, and writes y: at the laplace3d_64 AMG level 1 (2105 diagonals x
// 31,868 rows, fp32) that is 268 MB, 0.080 ms at 3.35 TB/s. The design: one
// thread a row, a 64-thread block per 64 rows, the diagonals walked in
// chunks of 32 whose loads are all issued before the chunk's first add (x
// read at a clamped index and the value selected, so no branch separates
// the loads), so a thread keeps 64 loads in flight (a branch per diagonal
// around its x load leaves about one load pair in flight: the compiler does
// not move loads across it). The parallelism is the row count:
// at 31,868 rows that is ~7.5 warps an SM, at 2,861 rows (level 2) under
// one warp an SM, so the small level runs latency-bound, far from its
// bound. Splitting a row's diagonals over several threads would fill the
// card but changes the summation order (and so the bitwise contract);
// staging x and the plane through shared memory with TMA, and several rows
// a thread, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 64;
constexpr int CHUNK = 32;  // diagonals whose loads are issued together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the product in JAX's promoted type: bf16 x bf16 rounds to bf16
template <typename TD, typename TX>
__device__ __forceinline__ float product(float d, float x) {
  return __fmul_rn(d, x);
}
template <>
__device__ __forceinline__ float product<__nv_bfloat16, __nv_bfloat16>(float d, float x) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(d, x)));
}

// One chunk of n <= CHUNK diagonals from d0: every load is issued before the
// first add (no branch between them: x is read at a clamped index and the
// value selected), so a thread keeps 2·n loads in flight; then the adds, in
// order. FULL drops the n test for whole chunks.
template <typename TD, typename TX, bool FULL>
__device__ __forceinline__ float chunk(const TD* __restrict__ data,
                                       const int* __restrict__ offsets,
                                       const TX* __restrict__ x, float acc, int d0, int n,
                                       int i, int m, int k) {
  int j[CHUNK];
  float dv[CHUNK], xv[CHUNK];
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    if (FULL || u < n) j[u] = i + __ldg(offsets + d0 + u);
  }
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    if (FULL || u < n) dv[u] = to_f32(data[static_cast<long long>(d0 + u) * m + i]);
  }
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    if (FULL || u < n) {
      const float v = to_f32(x[min(max(j[u], 0), k - 1)]);
      xv[u] = (j[u] >= 0 && j[u] < k) ? v : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    if (FULL || u < n) acc = __fadd_rn(acc, product<TD, TX>(dv[u], xv[u]));
  }
  return acc;
}

template <typename TD, typename TX>
__global__ void __launch_bounds__(THREADS)
    dia_spmv_kernel(const TD* __restrict__ data, const int* __restrict__ offsets,
                    const TX* __restrict__ x, float* __restrict__ y, int nd, int m, int k) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  float acc = 0.f;
  int d0 = 0;
  for (; d0 + CHUNK <= nd; d0 += CHUNK) {
    acc = chunk<TD, TX, true>(data, offsets, x, acc, d0, CHUNK, i, m, k);
  }
  if (d0 < nd) acc = chunk<TD, TX, false>(data, offsets, x, acc, d0, nd - d0, i, m, k);
  y[i] = acc;
}

template <typename TD, typename TX>
int launch(const void* data, const int* offsets, const void* x, float* y, int nd, int m, int k,
           cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((m + THREADS - 1) / THREADS);
  dia_spmv_kernel<TD, TX><<<grid, THREADS, 0, s>>>(static_cast<const TD*>(data), offsets,
                                                   static_cast<const TX*>(x), y, nd, m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. data_dtype and x_dtype: 0 =
// float32, 1 = bfloat16; k >= 1 (the wrapper passes a one-element zero x
// for an empty one, which gives the same products). Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dia_spmv(const void* data, const void* offsets, const void* x, void* y,
                        int data_dtype, int x_dtype, int nd, int m, int k, int device,
                        void* stream) {
  if (m <= 0 || nd < 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(offsets);
  auto out = static_cast<float*>(y);
  if (data_dtype == 0 && x_dtype == 0) return launch<float, float>(data, o, x, out, nd, m, k, s);
  if (data_dtype == 0 && x_dtype == 1)
    return launch<float, __nv_bfloat16>(data, o, x, out, nd, m, k, s);
  if (data_dtype == 1 && x_dtype == 0)
    return launch<__nv_bfloat16, float>(data, o, x, out, nd, m, k, s);
  if (data_dtype == 1 && x_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(data, o, x, out, nd, m, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
