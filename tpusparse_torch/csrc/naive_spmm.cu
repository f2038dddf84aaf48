// Naive ELL SpMM with reducers for NVIDIA Hopper (sm_90a): for each output
// row i and column c, the reduce over row i's stored entries j of
// A[i, j] * B[j, c], with sum, mean, max, min, mul or div, and for max and
// min optionally the index of the first entry that attains the extremum.
//
// Replaces the TPU kernel tpusparse/kernels/naive_spmm.py:68 _naive_kernel
// (pallas_call l.233, behind naive_spmm_pallas l.142), itself the analog of
// the reference library's warp-per-row CSR kernel and its reducer functors.
// The TPU kernel prefetched the ELL index and value streams into SMEM and
// walked an (8-row tile, n tile) grid with B's column strip resident in
// VMEM; its SMEM budget guard is a TPU limit and has no counterpart here.
// Here a group of W lanes owns one output row and W of its columns at a
// time, and walks the row's slots itself; nothing carries between blocks and
// there are no atomics, so runs repeat bit for bit.
//
// Contract. col_idx (m, L) int32 and vals (m, L) fp32, the ELL pack of A
// (padded slots at column 0, value 0, never visited); nnz_per_row (m) int32;
// row_base (m) int32, the CSR offset of each row's first entry (read only
// with the arg output); b (k, n) fp32 or bf16, row-major. Outputs out (m, n)
// fp32 and, with the arg output, arg (m, n) int32. For each (i, c):
//   - the loop runs over the row's `count` slots in slot order, from the
//     reducer's identity (0 for sum and mean, -inf for max, +inf for min,
//     1 for mul and div), with x = v * b[col, c] rounded on its own;
//   - sum/mean: acc = acc + x, rounded on its own (no FMA contraction), and
//     mean divides by max(count, 1) after the loop;
//   - max/min: acc = x where x > acc (x < acc for min) or x is NaN, so a NaN
//     propagates; an empty row writes 0, not the identity;
//   - mul: acc = acc * x; div: acc = acc / x, a running division from 1,
//     IEEE division (the build has no --use_fast_math);
//   - arg (max/min only): the update is strict (x > acc, x < acc), so a tie
//     keeps the first entry and a NaN never moves it; arg starts at
//     nnz_fill (the matrix's nnz) and is row_base[i] + l when slot l
//     improves. Such rows' value follows the same strict rule (a row whose
//     products are all -inf keeps -inf for max, and arg = nnz_fill).
// Every operation rounds exactly as the plain PyTorch version's elementwise
// ops do (tpusparse_torch/kernels/naive_spmm.py), so the two are bitwise
// equal for every reducer.
//
// What bounds it. At ogbn-arxiv's size (m = k = 169,343, nnz ~ 2.5 M,
// n = 256 fp32) the compulsory traffic is B once (173 MB), C once (173 MB)
// and the ELL arrays (~54 MB padded): ~0.12 ms at 3.35 TB/s, while
// 2 nnz n = 1.3 GFLOP is negligible. Each entry gathers a whole B row
// (1 KB), ~2.5 GB in all, and B does not fit the 50 MB L2, so this gather
// design sits near 0.76 ms of HBM traffic, not near the bound. The design
// does what it can for a first version: a group's W lanes read W
// consecutive columns of the gathered B row (coalesced), W is the next power
// of two of n up to 256, so narrow outputs (n = 1, 7, 8, 40) pack several
// rows into a warp instead of idling lanes, and each row loops only to its
// own count, so one long row does not make the others walk the ELL width.
// Reordering rows for B reuse in L2 and a CSR (not ELL) stream are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;  // threads per block

enum Reduce { SUM = 0, MEAN = 1, MAX = 2, MIN = 3, MUL = 4, DIV = 5 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int R>
__device__ __forceinline__ float identity() {
  if constexpr (R == MAX) return -INFINITY;
  if constexpr (R == MIN) return INFINITY;
  if constexpr (R == MUL || R == DIV) return 1.f;
  return 0.f;
}

template <int R, bool ARG, typename T>
__global__ void __launch_bounds__(NT) naive_spmm_kernel(
    const int* __restrict__ col_idx, const float* __restrict__ vals,
    const int* __restrict__ nnz_per_row, const int* __restrict__ row_base,
    const T* __restrict__ b, float* __restrict__ out, int* __restrict__ arg_out, int m, int n,
    int L, int W, int nnz_fill) {
  const int rows_per_block = NT / W;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / W;
  if (row >= m) return;
  const int lane = threadIdx.x % W;
  const int count = nnz_per_row[row];
  const int* ci = col_idx + static_cast<size_t>(row) * L;
  const float* vv = vals + static_cast<size_t>(row) * L;
  const int base = ARG ? row_base[row] : 0;
  for (int c = lane; c < n; c += W) {
    float acc = identity<R>();
    int arg = nnz_fill;
    for (int l = 0; l < count; ++l) {
      const float x = __fmul_rn(vv[l], to_f32(b[static_cast<size_t>(ci[l]) * n + c]));
      if constexpr (ARG) {
        const bool better = R == MAX ? x > acc : x < acc;
        if (better) {
          acc = x;
          arg = base + l;
        }
      } else if constexpr (R == SUM || R == MEAN) {
        acc = __fadd_rn(acc, x);
      } else if constexpr (R == MAX) {
        acc = (x > acc || isnan(x)) ? x : acc;
      } else if constexpr (R == MIN) {
        acc = (x < acc || isnan(x)) ? x : acc;
      } else if constexpr (R == MUL) {
        acc = __fmul_rn(acc, x);
      } else {
        acc = __fdiv_rn(acc, x);
      }
    }
    if constexpr (R == MEAN) acc = __fdiv_rn(acc, static_cast<float>(max(count, 1)));
    if constexpr (R == MAX || R == MIN) {
      if (count == 0) acc = 0.f;
    }
    const size_t o = static_cast<size_t>(row) * n + c;
    out[o] = acc;
    if constexpr (ARG) arg_out[o] = arg;
  }
}

template <int R, bool ARG, typename T>
int launch(const int* col_idx, const float* vals, const int* nnz_per_row, const int* row_base,
           const void* b, float* out, int* arg, int m, int n, int L, int nnz_fill,
           cudaStream_t stream) {
  int W = 1;
  while (W < n && W < NT) W *= 2;
  const int rows_per_block = NT / W;
  const unsigned grid = static_cast<unsigned>((m + rows_per_block - 1) / rows_per_block);
  naive_spmm_kernel<R, ARG, T><<<grid, NT, 0, stream>>>(
      col_idx, vals, nnz_per_row, row_base, static_cast<const T*>(b), out, arg, m, n, L, W,
      nnz_fill);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int reduce, int return_arg, const int* col_idx, const float* vals,
             const int* nnz_per_row, const int* row_base, const void* b, float* out, int* arg,
             int m, int n, int L, int nnz_fill, cudaStream_t s) {
  if (return_arg) {
    if (reduce == MAX)
      return launch<MAX, true, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                  nnz_fill, s);
    if (reduce == MIN)
      return launch<MIN, true, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                  nnz_fill, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (reduce) {
    case SUM:
      return launch<SUM, false, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                   nnz_fill, s);
    case MEAN:
      return launch<MEAN, false, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                    nnz_fill, s);
    case MAX:
      return launch<MAX, false, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                   nnz_fill, s);
    case MIN:
      return launch<MIN, false, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                   nnz_fill, s);
    case MUL:
      return launch<MUL, false, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                   nnz_fill, s);
    case DIV:
      return launch<DIV, false, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, n, L,
                                   nnz_fill, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. reduce: 0 sum, 1 mean, 2 max,
// 3 min, 4 mul, 5 div; return_arg only with max or min (row_base and arg
// then non-null). b_dtype: 0 = float32, 1 = bfloat16. Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int naive_spmm(const void* col_idx, const void* vals, const void* nnz_per_row,
                          const void* row_base, const void* b, void* out, void* arg,
                          int b_dtype, int reduce, int return_arg, int m, int n, int L,
                          int nnz_fill, int device, void* stream) {
  if (m <= 0 || n <= 0 || L <= 0 || (return_arg && (row_base == nullptr || arg == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto ci = static_cast<const int*>(col_idx);
  auto vv = static_cast<const float*>(vals);
  auto cnt = static_cast<const int*>(nnz_per_row);
  auto rb = static_cast<const int*>(row_base);
  auto o = static_cast<float*>(out);
  auto a = static_cast<int*>(arg);
  if (b_dtype == 0)
    return dispatch<float>(reduce, return_arg, ci, vv, cnt, rb, b, o, a, m, n, L, nnz_fill, s);
  if (b_dtype == 1)
    return dispatch<__nv_bfloat16>(reduce, return_arg, ci, vv, cnt, rb, b, o, a, m, n, L,
                                   nnz_fill, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
