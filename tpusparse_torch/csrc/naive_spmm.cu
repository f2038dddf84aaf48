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
// Here a group of lanes owns one output row and one strip of its columns,
// and walks the row's slots itself; nothing carries between blocks and
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
// 2 nnz n = 1.3 GFLOP is negligible. Each stored entry gathers a whole row
// of B (1 KB), ~2.5 GB in all, and B does not fit the 50 MB L2, so a design
// that gathers whole rows sits at the HBM gather floor (~0.76 ms), not near
// the bound. This one walks B in column strips, as the TPU kernel walked
// its (8-row, n-tile) grid with B's strip resident in VMEM: the strip is on
// blockIdx.y and the row groups on blockIdx.x, so the card runs every row
// of strip 0 before strip 1, and a strip (at most L2_STRIP_BYTES of B:
// 32 of 256 fp32 columns at arxiv, 21.7 MB) stays in L2 while every row
// gathers from it. HBM then reads B once and writes C once, the ELL
// streams once a strip; the gathers come from L2. A lane owns V
// consecutive columns of a row's strip (one 16-byte load: 4 fp32 or 8
// bf16) where B's rows are whole 16-byte chunks, one column otherwise;
// lanes / row is the next power of two of the row's strip up to 32, so
// narrow outputs (n = 1, 7, 8, 40) pack several rows into a warp. Each
// lane issues the gathers of U slots before it uses the first and applies
// the products in slot order, so unrolling changes no rounding; each row
// loops only to its own count. Rows are not reordered: results come out
// in row order, and the arg is a CSR index. On an H100 SXM at 700 W, at
// arxiv n 256 fp32, it takes 0.486 ms, the gathers (2.55 GB) at 5.2 TB/s
// from L2, against 0.887 for the whole-row design; strips of 16 and 64
// columns took 0.784 and 0.544 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;  // threads per block
// slots whose gathers a lane has in flight at once: more hold more
// registers a lane and fewer warps an SM (8 and 16 were slower on an H100)
constexpr int U = 4;
// the most bytes of B a strip spans: it stays in the 50 MB L2 beside the
// ELL streams and C's writes while every row gathers from it
constexpr size_t L2_STRIP_BYTES = size_t{32} << 20;

enum Reduce { SUM = 0, MEAN = 1, MAX = 2, MIN = 3, MUL = 4, DIV = 5 };

template <int R>
__device__ __forceinline__ float identity() {
  if constexpr (R == MAX) return -INFINITY;
  if constexpr (R == MIN) return INFINITY;
  if constexpr (R == MUL || R == DIV) return 1.f;
  return 0.f;
}

// Columns a lane owns: one 16-byte load of B's row (VEC), or one element.
template <typename T, bool VEC>
__host__ __device__ constexpr int cols() {
  return VEC ? static_cast<int>(16 / sizeof(T)) : 1;
}

// V columns of B from p, in fp32 (bf16 widened exactly).
template <typename T, bool VEC, int V>
__device__ __forceinline__ void load_cols(float (&x)[V], const T* __restrict__ p) {
  if constexpr (!VEC) {
    if constexpr (sizeof(T) == 4) {
      x[0] = p[0];
    } else {
      x[0] = __bfloat162float(p[0]);
    }
  } else if constexpr (sizeof(T) == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(u[j] << 16);
      x[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// acc (and arg) after one more product x of slot position pos, rounded as
// the contract says.
template <int R, bool ARG>
__device__ __forceinline__ void update(float& acc, int& arg, float x, int pos) {
  if constexpr (ARG) {
    const bool better = R == MAX ? x > acc : x < acc;
    if (better) {
      acc = x;
      arg = pos;
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

// `lanes` lanes own a row (NT / lanes rows a block, on blockIdx.x) and the
// strip of lanes * V columns on blockIdx.y.
template <int R, bool ARG, typename T, bool VEC>
__global__ void __launch_bounds__(NT) naive_spmm_kernel(
    const int* __restrict__ col_idx, const float* __restrict__ vals,
    const int* __restrict__ nnz_per_row, const int* __restrict__ row_base,
    const T* __restrict__ b, float* __restrict__ out, int* __restrict__ arg_out, int m, int n,
    int L, int lanes, int strips, int nnz_fill) {
  constexpr int V = cols<T, VEC>();
  const int row = blockIdx.x * (NT / lanes) + threadIdx.x / lanes;
  if (row >= m) return;
  const int count = nnz_per_row[row];
  const int* ci = col_idx + static_cast<size_t>(row) * L;
  const float* vv = vals + static_cast<size_t>(row) * L;
  const int base = ARG ? row_base[row] : 0;
  for (int strip = blockIdx.y; strip < strips; strip += gridDim.y) {
    const int c = (strip * lanes + threadIdx.x % lanes) * V;  // the lane's first column
    if (c >= n) continue;  // VEC: n is a whole number of V-column chunks
    float acc[V];
    int arg[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[j] = identity<R>();
      arg[j] = nnz_fill;
    }
    for (int l0 = 0; l0 < count; l0 += U) {
      // the gathers of U slots in flight, then their updates in slot order
      float w[U], x[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        w[u] = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) x[u][j] = 0.f;
        if (l0 + u < count) {
          w[u] = vv[l0 + u];
          load_cols<T, VEC>(x[u], b + static_cast<size_t>(ci[l0 + u]) * n + c);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (l0 + u >= count) break;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          update<R, ARG>(acc[j], arg[j], __fmul_rn(w[u], x[u][j]), base + l0 + u);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (R == MEAN) acc[j] = __fdiv_rn(acc[j], static_cast<float>(max(count, 1)));
      if constexpr (R == MAX || R == MIN) {
        if (count == 0) acc[j] = 0.f;
      }
    }
    const size_t o = static_cast<size_t>(row) * n + c;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        *reinterpret_cast<float4*>(out + o + j) =
            make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        if constexpr (ARG) {
          *reinterpret_cast<int4*>(arg_out + o + j) =
              make_int4(arg[j], arg[j + 1], arg[j + 2], arg[j + 3]);
        }
      }
    } else {
      out[o] = acc[0];
      if constexpr (ARG) arg_out[o] = arg[0];
    }
  }
}

template <int R, bool ARG, typename T, bool VEC>
int launch_cols(const int* col_idx, const float* vals, const int* nnz_per_row,
                const int* row_base, const void* b, float* out, int* arg, int m, int k, int n,
                int L, int nnz_fill, int strip_cols, cudaStream_t stream) {
  constexpr int V = cols<T, VEC>();
  int lanes = 1;
  if (strip_cols > 0) {
    lanes = strip_cols / V;
    if (strip_cols % V != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    while (lanes < 32 && lanes * V < n) lanes *= 2;  // a row's columns, up to 32 lanes
    // the widest strip whose columns of B stay within L2_STRIP_BYTES
    while (lanes > 1 &&
           static_cast<size_t>(k) * std::min(n, lanes * V) * sizeof(T) > L2_STRIP_BYTES) {
      lanes /= 2;
    }
  }
  const int strips = (n + lanes * V - 1) / (lanes * V);
  const dim3 grid(static_cast<unsigned>((m + NT / lanes - 1) / (NT / lanes)),
                  static_cast<unsigned>(std::min(strips, 65535)));
  naive_spmm_kernel<R, ARG, T, VEC><<<grid, NT, 0, stream>>>(
      col_idx, vals, nnz_per_row, row_base, static_cast<const T*>(b), out, arg, m, n, L, lanes,
      strips, nnz_fill);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte path where every row of B is whole 16-byte chunks from an
// aligned base; one column a lane otherwise.
template <int R, bool ARG, typename T>
int launch(const int* col_idx, const float* vals, const int* nnz_per_row, const int* row_base,
           const void* b, float* out, int* arg, int m, int k, int n, int L, int nnz_fill,
           int strip_cols, cudaStream_t stream) {
  const bool vec = static_cast<size_t>(n) * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return vec ? launch_cols<R, ARG, T, true>(col_idx, vals, nnz_per_row, row_base, b, out, arg,
                                            m, k, n, L, nnz_fill, strip_cols, stream)
             : launch_cols<R, ARG, T, false>(col_idx, vals, nnz_per_row, row_base, b, out, arg,
                                             m, k, n, L, nnz_fill, strip_cols, stream);
}

#define NAIVE_LAUNCH(R, ARG) \
  launch<R, ARG, T>(col_idx, vals, nnz_per_row, row_base, b, out, arg, m, k, n, L, nnz_fill, \
                    strip_cols, s)

template <typename T>
int dispatch(int reduce, int return_arg, const int* col_idx, const float* vals,
             const int* nnz_per_row, const int* row_base, const void* b, float* out, int* arg,
             int m, int k, int n, int L, int nnz_fill, int strip_cols, cudaStream_t s) {
  if (return_arg) {
    if (reduce == MAX) return NAIVE_LAUNCH(MAX, true);
    if (reduce == MIN) return NAIVE_LAUNCH(MIN, true);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (reduce) {
    case SUM:
      return NAIVE_LAUNCH(SUM, false);
    case MEAN:
      return NAIVE_LAUNCH(MEAN, false);
    case MAX:
      return NAIVE_LAUNCH(MAX, false);
    case MIN:
      return NAIVE_LAUNCH(MIN, false);
    case MUL:
      return NAIVE_LAUNCH(MUL, false);
    case DIV:
      return NAIVE_LAUNCH(DIV, false);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. reduce: 0 sum, 1 mean, 2 max,
// 3 min, 4 mul, 5 div; return_arg only with max or min (row_base and arg
// then non-null). b_dtype: 0 = float32, 1 = bfloat16; b is (k, n).
// strip_cols: the columns of B a strip spans (lanes a row times the
// columns a lane owns, a power of two of lanes up to 32), or 0 for the
// widest strip that stays within L2_STRIP_BYTES. Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int naive_spmm(const void* col_idx, const void* vals, const void* nnz_per_row,
                          const void* row_base, const void* b, void* out, void* arg,
                          int b_dtype, int reduce, int return_arg, int m, int k, int n, int L,
                          int nnz_fill, int strip_cols, int device, void* stream) {
  if (m <= 0 || k < 0 || n <= 0 || L <= 0 || strip_cols < 0 ||
      (return_arg && (row_base == nullptr || arg == nullptr))) {
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
  if (b_dtype == 0) {
    return dispatch<float>(reduce, return_arg, ci, vv, cnt, rb, b, o, a, m, k, n, L, nnz_fill,
                           strip_cols, s);
  }
  if (b_dtype == 1) {
    return dispatch<__nv_bfloat16>(reduce, return_arg, ci, vv, cnt, rb, b, o, a, m, k, n, L,
                                   nnz_fill, strip_cols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
