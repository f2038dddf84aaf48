// Windowed gather and windowed segment sum for NVIDIA Hopper (sm_90a): the
// two index operations of a host window plan (tpusparse_torch/kernels/
// windowed.py), whose canonical client is the SpGEMM schedule
// (tpusparse_torch/spgemm.py: the gather of A's values, the gather of dC in
// the backward, and the accumulation of the products into C's slots).
//
// Replaces the TPU kernels tpusparse/kernels/windowed.py:148 _gather_kernel
// (pallas_call l.175, behind windowed_gather l.207) and :314 _segsum_kernel
// (pallas_call l.348, behind windowed_segment_sum l.383). The TPU has no
// vector gather, so those kernels held the whole table (or y) in VMEM and
// swept each 128-index span's window with a one-hot compare-and-sum over
// (8, 128) blocks. Nothing of that carries over: the GPU gathers, so the
// gather reads its one element; the segment sum stages each span's window
// of y in shared memory, which is bounded by the window (at most 4096, the
// plan's cap), not by y.
//
// Contract of windowed_gather. table (table_len) fp32, bf16 or fp16; rel
// (>= n) int32, the index minus its span's start, with the window W as the
// pad marker; starts (>= ceil(n / 128)) int32, one per 128-position span.
// For p < n: out[p] = T(0.0f + float(table[starts[p / 128] + rel[p]])) when
// 0 <= rel[p] < W and that index lies in the table, else 0. The sum that
// starts at 0.0f is the TPU kernel's own (its fp32 accumulator starts at 0),
// so a stored -0.0 comes out as +0.0 and the result equals JAX's bit for
// bit. Positions at or past n (the plan's padded tail) are never written.
//
// Contract of windowed_segsum. y (n_in) fp32, bf16 or fp16; seg (n_in)
// int32, the segment of each entry, -1 where the plan sends the entry down
// its exception path; starts (>= ceil(num_segments / 128)) int32, the
// 128-aligned start of each 128-segment span's window of y. For
// o < num_segments, with s = o / 128:
//   out[o] = T(sum over j in [starts[s], starts[s] + W), j < n_in, seg[j] == o
//              of float(y[j])),
// summed in fp32 from 0.0f in ascending j. Positions past n_in count as
// id -1 (the TPU wrapper pads y with zeros and seg with -1 instead); an
// entry whose id is not o adds nothing, whatever its value.
//
// What bounds them. Both move little and compute less: the gather reads
// rel and one table element a position and writes out (fp32: 12 bytes a
// position); the segment sum reads seg and y once over its windows and
// writes out once. At the SpGEMM shapes (1.1 M products) that is ~13 MB,
// ~4 us at 3.35 TB/s: launch overhead and the gather's scattered reads
// dominate. Design: the gather is one thread a position, reads coalesced
// in rel and out, and goes to L2 for the table (a span's indices lie within
// one window, so neighbouring threads read neighbouring lines). The segment
// sum is one 128-thread block a span, one thread a segment: the block
// stages its window in 128-entry chunks of (seg, y) in shared memory, and
// every thread walks each chunk in order, adding the entries whose id is
// its own. The walk is W compares a thread (broadcast reads, no bank
// conflicts), deterministic, with no atomics. A warp-per-span segmented
// reduction over the sorted schedule would do a compare per entry instead
// of per entry and segment; that is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SPAN = 128;         // positions (gather) or segments (sum) per span
constexpr int GATHER_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
    windowed_gather_kernel(const T* __restrict__ table, const int* __restrict__ rel,
                           const int* __restrict__ starts, T* __restrict__ out, int n,
                           int table_len, int window) {
  const int p = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (p >= n) return;
  const int r = rel[p];
  float acc = 0.f;
  if (r >= 0 && r < window) {
    const long long t = static_cast<long long>(starts[p / SPAN]) + r;
    if (t < table_len) acc = __fadd_rn(acc, to_f32(table[t]));  // 0.0f + x: -0.0 -> +0.0
  }
  out[p] = from_f32<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(SPAN)
    windowed_segsum_kernel(const T* __restrict__ y, const int* __restrict__ seg,
                           const int* __restrict__ starts, T* __restrict__ out, int n_in,
                           int num_segments, int window) {
  __shared__ int s_seg[SPAN];
  __shared__ float s_y[SPAN];
  const int span = blockIdx.x;
  const int o = span * SPAN + threadIdx.x;
  const long long st = starts[span];
  float acc = 0.f;
  for (int c = 0; c < window; c += SPAN) {
    const long long j = st + c + threadIdx.x;
    int id = -1;
    float v = 0.f;
    if (j >= 0 && j < n_in) {
      id = seg[j];
      v = to_f32(y[j]);
    }
    s_seg[threadIdx.x] = id;
    s_y[threadIdx.x] = v;
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < SPAN; ++t) {
      if (s_seg[t] == o) acc = __fadd_rn(acc, s_y[t]);
    }
    __syncthreads();
  }
  if (o < num_segments) out[o] = from_f32<T>(acc);
}

template <typename T>
int launch_gather(const void* table, const int* rel, const int* starts, void* out, int n,
                  int table_len, int window, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n + GATHER_THREADS - 1) / GATHER_THREADS);
  windowed_gather_kernel<T><<<grid, GATHER_THREADS, 0, s>>>(
      static_cast<const T*>(table), rel, starts, static_cast<T*>(out), n, table_len, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segsum(const void* y, const int* seg, const int* starts, void* out, int n_in,
                  int num_segments, int window, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((num_segments + SPAN - 1) / SPAN);
  windowed_segsum_kernel<T><<<grid, SPAN, 0, s>>>(static_cast<const T*>(y), seg, starts,
                                                  static_cast<T*>(out), n_in, num_segments,
                                                  window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (the table's, or y's, and the output's). Each launches on
// `stream` (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int windowed_gather(const void* table, const void* rel, const void* starts, void* out,
                               int dtype, int n, int table_len, int window, int device,
                               void* stream) {
  if (n <= 0 || table_len < 0 || window <= 0 || window % SPAN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const int*>(rel);
  auto st = static_cast<const int*>(starts);
  if (dtype == 0) return launch_gather<float>(table, r, st, out, n, table_len, window, s);
  if (dtype == 1) return launch_gather<__nv_bfloat16>(table, r, st, out, n, table_len, window, s);
  if (dtype == 2) return launch_gather<__half>(table, r, st, out, n, table_len, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int windowed_segsum(const void* y, const void* seg, const void* starts, void* out,
                               int dtype, int n_in, int num_segments, int window, int device,
                               void* stream) {
  if (num_segments <= 0 || n_in < 0 || window <= 0 || window % SPAN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto sg = static_cast<const int*>(seg);
  auto st = static_cast<const int*>(starts);
  if (dtype == 0) return launch_segsum<float>(y, sg, st, out, n_in, num_segments, window, s);
  if (dtype == 1)
    return launch_segsum<__nv_bfloat16>(y, sg, st, out, n_in, num_segments, window, s);
  if (dtype == 2) return launch_segsum<__half>(y, sg, st, out, n_in, num_segments, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
