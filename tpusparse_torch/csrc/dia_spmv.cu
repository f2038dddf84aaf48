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
// What bounds it: bytes, and only the plane's occupied bytes. A wide AMG
// level's plane is mostly padding: laplace3d_64's level 1 is 2105 diagonals
// x 31,868 rows (268 MB fp32) for 947,896 entries, and only 9.06 % of its
// 32-row tiles (one row d, 32 consecutive i) hold a nonzero. So the kernel
// can take a tile list (dia.py: dia_tile_list, built once per PackedDIA):
// for each 32-row tile t, the ascending plane rows d whose data[d, 32t ..
// 32t + 31] are not all ±0 (NaN and Inf count as nonzero), as CSR
// (tile_ptr, tile_rows), with each entry's offset (tile_offs) and its 32
// values (tile_vals, a compact copy of the occupied tiles in list order,
// the last tile zero-padded). The walk reads only those: ~26 MB at level
// 1, a 10x cut, and reads them in order, a block's tile as one contiguous
// run, where the plane's occupied tiles lie 128 KB apart and read in place
// came nowhere near the card's byte rate. Without a list (the stateless
// entry points, which see a new plane every call) the same body walks every
// row d of the plane.
//
// Why skipping is exact. A skipped term is P(±0, X). The sum starts at
// +0.0f and never becomes -0 (round-to-nearest gives +0 for x + (-x) and
// for +0 + -0), so adding ±0 to it changes no bit; and when X is finite,
// or past the edge (0), P(±0, X) is ±0. Only a nonfinite x[j] that a
// skipped term meets turns the plain version's row into NaN (0 · Inf and
// 0 · NaN are NaN, and NaN stays NaN). So with a list the C entry first
// launches x_nonfinite_kernel, which writes one flag per slice of x (a
// second launch, which the wrapper counts as 'dia_nonfinite';
// dia_x_nonfinite launches it alone). The walk reads the flags after its
// own sum, and only if one is set walks its tile's skipped rows (no value
// is read for them) and, where one meets a nonfinite x, adds P(0, Inf) =
// NaN to the row: on the card every NaN that leaves an fp32 add is the
// canonical one, so the row's bits are the plain version's. The walk is launched with programmatic dependent launch, so it
// starts beside the check and waits for it (griddepcontrol.wait) only
// before it reads the flags.
//
// The walk: one block of eight warps a 32-row tile, one lane a row. The
// block takes its tile's entries in rounds of 128, 16 a warp: each warp
// loads its 16 entries' values (one 128-byte line a warp each, for fp32)
// and x values (read at a clamped index and selected, so no branch
// separates the loads), forms the 16 products and stores them in shared
// memory; then warp 0 adds the round's 128 products in list order while
// all eight warps' loads for the next round are in flight. A product is
// the same wherever it is formed, and only warp 0 adds, in order, so the
// sum is the plain version's. Each warp holds the offsets of the round
// after next, one a lane. The parallelism is the tile count: 996 blocks at
// level 1, 90 at level 2 (2,861 rows). Splitting a row's sum over several
// threads would fill the card faster but changes the summation order, so
// it is out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 32;    // rows of a tile: one lane a row
constexpr int WARPS = 8;    // warps of a block, which takes one tile
constexpr int SLICE = 16;   // list entries a warp loads a round
constexpr int ROUND = WARPS * SLICE;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int CHECK_THREADS = 256;
constexpr int CHECK_PER_BLOCK = 1024;  // x entries a check block reads, up to MAX_FLAGS blocks
constexpr int MAX_FLAGS = 32;          // check blocks: one flag a lane of the walk's warp

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

// flags[b] = 1 when block b's slice of x (`per` entries) holds a NaN or an
// Inf, else 0
template <typename TX>
__global__ void __launch_bounds__(CHECK_THREADS)
    x_nonfinite_kernel(const TX* __restrict__ x, int k, int per, int* __restrict__ flags) {
  // let the walk launch now: it reads the flags only after griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int lo = blockIdx.x * per;
  const int hi = min(k, lo + per);
  int bad = 0;
  for (int j = lo + threadIdx.x; j < hi; j += CHECK_THREADS) bad |= !isfinite(to_f32(x[j]));
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) flags[blockIdx.x] = bad;
}

// Start the loads of n <= SLICE entries q0 .. q0 + n - 1: entry q's value
// for this lane's row is vals[q * ld + col], and lane u holds entry u's
// offset in oc; every load starts before any value is used.
template <typename TD, typename TX>
__device__ __forceinline__ void load_slice(const TD* __restrict__ vals, int ld, int col,
                                           const TX* __restrict__ x, int q0, int oc, int n, int i,
                                           int k, float (&dv)[SLICE], float (&xv)[SLICE]) {
#pragma unroll
  for (int u = 0; u < SLICE; ++u) {
    if (u < n) dv[u] = to_f32(vals[static_cast<long long>(q0 + u) * ld + col]);
  }
#pragma unroll
  for (int u = 0; u < SLICE; ++u) {
    const int j = i + __shfl_sync(FULL_MASK, oc, u);
    if (u < n) {
      const float v = to_f32(__ldg(x + min(max(j, 0), k - 1)));
      xv[u] = (j >= 0 && j < k) ? v : 0.f;
    }
  }
}

// One block a 32-row tile. LIST: walk the tile's list (tile_ptr; the
// occupied tiles' values in tile_vals, their offsets in tile_offs) and then
// apply the nonfinite rule from the check's flags (tile_rows: the skipped
// rows); else walk every plane row d of data with offsets[d].
template <typename TD, typename TX, bool LIST>
__global__ void __launch_bounds__(WARPS * TILE)
    dia_spmv_kernel(const TD* __restrict__ data, const int* __restrict__ offsets,
                    const TX* __restrict__ x, float* __restrict__ y, int nd, int m, int k,
                    const int* __restrict__ tile_ptr, const int* __restrict__ tile_rows,
                    const int* __restrict__ tile_offs, const TD* __restrict__ tile_vals,
                    const int* flags, int nflags) {
  __shared__ float s_prod[ROUND][TILE];  // a round's products, list order x row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int i_row = t * TILE + lane;
  const int i = min(i_row, m - 1);  // a row past m walks row m - 1 and is not written
  const int p_lo = LIST ? tile_ptr[t] : 0;
  const int p_hi = LIST ? tile_ptr[t + 1] : nd;
  const TD* vals = LIST ? tile_vals : data;  // entry q's row: vals[q * ld + col]
  const int ld = LIST ? TILE : m;
  const int col = LIST ? lane : i;
  const int* offs = LIST ? tile_offs : offsets;
  const int mine = warp * SLICE + lane;  // this lane's entry within a round
  // offsets of this warp's entries in the loading round (oc) and the next (on)
  const int oc0 = p_lo + mine < p_hi ? offs[p_lo + mine] : 0;
  int on = p_lo + ROUND + mine < p_hi ? offs[p_lo + ROUND + mine] : 0;
  float dv[SLICE], xv[SLICE];
  load_slice<TD, TX>(vals, ld, col, x, p_lo + warp * SLICE, oc0, p_hi - p_lo - warp * SLICE, i,
                     k, dv, xv);
  float acc = 0.f;
  for (int p = p_lo; p < p_hi; p += ROUND) {
    const int n = p_hi - p - warp * SLICE;  // this warp's entries this round (may be <= 0)
#pragma unroll
    for (int u = 0; u < SLICE; ++u) {
      if (u < n) s_prod[warp * SLICE + u][lane] = product<TD, TX>(dv[u], xv[u]);
    }
    __syncthreads();
    if (p + ROUND < p_hi) {  // the next round's loads fly while warp 0 adds this one
      const int oc = on;
      const int q = p + 2 * ROUND + mine;
      if (q < p_hi) on = offs[q];
      load_slice<TD, TX>(vals, ld, col, x, p + ROUND + warp * SLICE, oc, n - ROUND, i, k, dv,
                         xv);
    }
    if (warp == 0) {
      const int nr = min(ROUND, p_hi - p);
#pragma unroll 8
      for (int e = 0; e < nr; ++e) acc = __fadd_rn(acc, s_prod[e][lane]);
    }
    __syncthreads();
  }
  if (warp != 0) return;
  if (LIST) {
    // the check kernel's flags are complete and visible after this wait
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int f = lane < nflags ? flags[lane] : 0;
    if (__any_sync(FULL_MASK, f)) {
      // the skipped rows d are those between the list's entries
      bool nan = false;
      int q = p_lo;
      for (int d = 0; d < nd; ++d) {
        if (q < p_hi && tile_rows[q] == d) {
          ++q;
          continue;
        }
        const int j = i + offsets[d];
        if (j >= 0 && j < k && !isfinite(to_f32(x[j]))) nan = true;
      }
      if (nan) acc = __fadd_rn(acc, __fmul_rn(0.f, __int_as_float(0x7f800000)));
    }
  }
  if (i_row < m) y[i_row] = acc;
}

// the check's grid: one block (and one flag) a slice of up to
// CHECK_PER_BLOCK entries of x, at most MAX_FLAGS of them
int check_blocks(int k) { return min(MAX_FLAGS, (k + CHECK_PER_BLOCK - 1) / CHECK_PER_BLOCK); }

template <typename TX>
int launch_check(const TX* x, int k, int* flags, cudaStream_t s) {
  const int nflags = check_blocks(k);
  const int per = (k + nflags - 1) / nflags;
  x_nonfinite_kernel<TX><<<nflags, CHECK_THREADS, 0, s>>>(x, k, per, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TX>
int launch(const void* data, const int* offsets, const void* x, float* y, int nd, int m, int k,
           const int* tile_ptr, const int* tile_rows, const int* tile_offs, const void* tile_vals,
           int* flags, cudaStream_t s) {
  const unsigned ntiles = static_cast<unsigned>((m + TILE - 1) / TILE);
  auto d = static_cast<const TD*>(data);
  auto xx = static_cast<const TX*>(x);
  if (tile_ptr == nullptr) {
    dia_spmv_kernel<TD, TX, false><<<ntiles, WARPS * TILE, 0, s>>>(
        d, offsets, xx, y, nd, m, k, nullptr, nullptr, nullptr, nullptr, nullptr, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int nflags = check_blocks(k);
  cudaError_t err = static_cast<cudaError_t>(launch_check<TX>(xx, k, flags, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntiles);
  cfg.blockDim = dim3(WARPS * TILE);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int* flags_c = flags;
  err = cudaLaunchKernelEx(&cfg, dia_spmv_kernel<TD, TX, true>, d, offsets, xx, y, nd, m, k,
                           tile_ptr, tile_rows, tile_offs, static_cast<const TD*>(tile_vals),
                           flags_c, nflags);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. data_dtype and x_dtype: 0 =
// float32, 1 = bfloat16; k >= 1 (the wrapper passes a one-element zero x
// for an empty one, which gives the same products). tile_ptr (m/32 + 1),
// tile_rows and tile_offs (nocc) int32 and tile_vals (nocc, 32) in the
// plane's dtype: the plane's tile list, or all four null to walk every
// diagonal; flags: int32 scratch of 32 entries when a list is given.
// Launches on `stream` (PyTorch's current stream), does not synchronise,
// and returns cudaGetLastError() after the launches (0 = launched).
extern "C" int dia_spmv(const void* data, const void* offsets, const void* x, void* y,
                        int data_dtype, int x_dtype, int nd, int m, int k, const void* tile_ptr,
                        const void* tile_rows, const void* tile_offs, const void* tile_vals,
                        void* flags, int device, void* stream) {
  if (m <= 0 || nd < 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_ptr != nullptr && (tile_rows == nullptr || tile_offs == nullptr ||
                              tile_vals == nullptr || flags == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(offsets);
  auto out = static_cast<float*>(y);
  auto tp = static_cast<const int*>(tile_ptr);
  auto tr = static_cast<const int*>(tile_rows);
  auto to = static_cast<const int*>(tile_offs);
  auto fl = static_cast<int*>(flags);
  if (data_dtype == 0 && x_dtype == 0)
    return launch<float, float>(data, o, x, out, nd, m, k, tp, tr, to, tile_vals, fl, s);
  if (data_dtype == 0 && x_dtype == 1)
    return launch<float, __nv_bfloat16>(data, o, x, out, nd, m, k, tp, tr, to, tile_vals, fl, s);
  if (data_dtype == 1 && x_dtype == 0)
    return launch<__nv_bfloat16, float>(data, o, x, out, nd, m, k, tp, tr, to, tile_vals, fl, s);
  if (data_dtype == 1 && x_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(data, o, x, out, nd, m, k, tp, tr, to, tile_vals,
                                                fl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The nonfinite check alone (dia.py: x_nonfinite_kernel), as dia_spmv
// launches it before a walk of a tile list: flags[b] = 1 when slice b of x
// holds a NaN or an Inf, for the min(32, ceil(k / 1024)) slices of
// ceil(k / slices) entries. x_dtype: 0 = float32, 1 = bfloat16; k >= 1;
// flags: int32, one per slice. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch.
extern "C" int dia_x_nonfinite(const void* x, int x_dtype, int k, void* flags, int device,
                               void* stream) {
  if (k < 1 || flags == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto fl = static_cast<int*>(flags);
  if (x_dtype == 0) return launch_check<float>(static_cast<const float*>(x), k, fl, s);
  if (x_dtype == 1) {
    return launch_check<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), k, fl, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
