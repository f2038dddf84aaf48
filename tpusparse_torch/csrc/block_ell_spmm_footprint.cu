// Footprint block SpMM for NVIDIA Hopper (sm_90a): C = A @ B, where A is
// given by a FootprintPlan. S consecutive row-blocks form a super-row; a
// super's occupied slots are sorted by (column, row-block), so the slots that
// read one B tile are adjacent. Per super s and slot l < nslots[s]:
// lrow (row-block within the super), bslot (ordinal of its distinct column)
// and newcol (1 where a new column starts); ucols (ns, Lu) lists the
// distinct columns. Values (ns * Ls, bm, bk); B (k, n), C (m, n), row-major.
//
// Replaces tpusparse/kernels/tiled_spmm.py:1344 _footprint_kernel (behind
// footprint_spmm_pallas, pallas_call l.1487), the TPU form of the reference
// inspector's footprint compression: each distinct B tile is fetched once per
// super-row and used by every block of the super in that column. Here a
// thread block owns (super-row, n-tile of NTILE columns) and walks the
// super's slots: where a new column starts it stages that column's B tile
// (bk x NTILE, fp32) in shared memory once, then applies it to each slot of
// the column, adding into the accumulator of the slot's row-block. The
// accumulators of all S row-blocks, S * bm * NTILE fp32, stay in shared
// memory for the whole walk, so the n-tile is sized by the caller to fit the
// 227 KB a block may have (NTILE 16 at S 16, bm 128: 128 KB); the wrapper
// raises when even NTILE 8 does not fit.
//
// Contract: C rows of row-block s*S + lrow[s*Ls + l] += vals[s*Ls + l] @
// B[ucols[s*Lu + bslot[s*Ls + l]]*bk : +bk, :]; fp32 sums; C in its own
// type; a row-block with no slot is written as zeros. Each thread owns a 4x4
// piece of a slot's (rows-per-pass x NTILE) tile; it loads that piece of the
// row-block's accumulator into registers, adds the slot's products in
// ascending k with `acc = fmaf(a, b, acc)` over 16-wide chunks (operands
// rounded to bf16 on staging in the 'default' tier), and stores it back.
// The slots of a row-block come in ascending column order, so every output
// element sees the same chain of roundings as in block_ell_spmm.cu, and C
// is bitwise equal to block_ell_spmm on the plan the footprint plan was
// derived from.
//
// What bounds it: the FFMA work 2 * nblocks * bm * bk * n (~0.41 ms at the
// 16384^2 headline); the design saves B traffic (ntiles tile fetches per
// n-tile instead of nblocks), which the H100's L2 largely saved already.
// It pays for that with a narrow n-tile: each A block is read n / NTILE
// times, and at bm 128 a block runs 128 threads, one per SM. wgmma with the
// accumulators in registers of several warpgroups, TMA for the B tiles and
// the A blocks, and a wider n-tile are later work.

#include "block_tiles.cuh"

using namespace tiles;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may have

size_t smem_bytes(int S, int bm, int bk, int ntile, int rp) {
  const size_t bk_pad = (static_cast<size_t>(bk) + BK_T - 1) / BK_T * BK_T;
  return 4 * (static_cast<size_t>(S) * bm * ntile + bk_pad * ntile +
              static_cast<size_t>(BK_T) * (rp + 4));
}

template <typename TA, typename TB, typename TC, bool ROUND_BF16>
__global__ void __launch_bounds__(MAX_THREADS) footprint_spmm_kernel(
    const TA* __restrict__ vals,          // (ns * Ls, bm, bk)
    const TB* __restrict__ b,             // (k, n)
    TC* __restrict__ c,                   // (m, n)
    const int* __restrict__ ucols,        // (ns * Lu)
    const int* __restrict__ nslots,       // (ns)
    const int* __restrict__ lrow,         // (ns * Ls)
    const int* __restrict__ bslot,        // (ns * Ls)
    const int* __restrict__ newcol,       // (ns * Ls)
    int m, int k, int n, int bm, int bk, int nbr, int S, int Ls, int Lu, int ntile,
    int rp) {
  extern __shared__ __align__(16) float smem[];
  const int bk_pad = (bk + BK_T - 1) / BK_T * BK_T;
  float* acc_s = smem;                                          // (S * bm, ntile)
  float* bt = acc_s + static_cast<size_t>(S) * bm * ntile;      // (bk_pad, ntile)
  float* as = bt + static_cast<size_t>(bk_pad) * ntile;         // (BK_T, rp + 4)
  const int a_ld = rp + 4;

  const int sup = blockIdx.x;
  const int n0 = blockIdx.y * ntile;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int txn = ntile / TN;
  const int tx = tid % txn, ty = tid / txn;
  const size_t acc_len = static_cast<size_t>(S) * bm * ntile;

  for (size_t e = tid; e < acc_len; e += nthr) acc_s[e] = 0.f;
  __syncthreads();

  const int nvalid = nslots[sup];
  for (int l = 0; l < nvalid; ++l) {
    const size_t slot = static_cast<size_t>(sup) * Ls + l;
    if (newcol[slot]) {  // stage the column's B tile once
      const int kb = ucols[static_cast<size_t>(sup) * Lu + bslot[slot]] * bk;
      __syncthreads();  // every reader of the previous tile is done
      for (int e = tid; e < bk_pad * ntile; e += nthr) {
        const int q = e / ntile, col = e % ntile;
        const int kr = kb + q, cn = n0 + col;
        float v = 0.f;
        if (q < bk && kr < k && cn < n) {
          v = tier<ROUND_BF16>(to_f32(b[static_cast<size_t>(kr) * n + cn]));
        }
        bt[e] = v;
      }
    }
    float* acc_rb = acc_s + static_cast<size_t>(lrow[slot]) * bm * ntile;
    const TA* blk = vals + slot * bm * static_cast<size_t>(bk);
    for (int r0 = 0; r0 < bm; r0 += rp) {
      const int rows = min(rp, bm - r0);
      float acc[TM][TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int r = ty * TM + a;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[a][j] = r < rows ? acc_rb[static_cast<size_t>(r0 + r) * ntile + tx * TN + j]
                               : 0.f;
        }
      }
      for (int k0 = 0; k0 < bk; k0 += BK_T) {
        __syncthreads();  // the B tile is staged; the last A chunk is consumed
        for (int e = tid; e < rp * BK_T; e += nthr) {
          const int r = e / BK_T, q = e % BK_T;
          float v = 0.f;
          if (r < rows && k0 + q < bk) {
            v = tier<ROUND_BF16>(to_f32(blk[static_cast<size_t>(r0 + r) * bk + k0 + q]));
          }
          as[q * a_ld + r] = v;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < BK_T; ++q) {
          const float4 av = *reinterpret_cast<const float4*>(&as[q * a_ld + ty * TM]);
          const float4 bv = *reinterpret_cast<const float4*>(
              &bt[static_cast<size_t>(k0 + q) * ntile + tx * TN]);
          const float ar[TM] = {av.x, av.y, av.z, av.w};
          const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int a = 0; a < TM; ++a)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[a][j] = fmaf(ar[a], br[j], acc[a][j]);
        }
      }
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int r = ty * TM + a;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_rb[static_cast<size_t>(r0 + r) * ntile + tx * TN + j] = acc[a][j];
        }
      }
    }
  }
  __syncthreads();

  const size_t rb_len = static_cast<size_t>(bm) * ntile;
  for (size_t e = tid; e < acc_len; e += nthr) {
    const int lr = static_cast<int>(e / rb_len);
    const int rem = static_cast<int>(e % rb_len);
    const int r = rem / ntile, col = rem % ntile;
    const int rb = sup * S + lr;
    const int grow = rb * bm + r, cn = n0 + col;
    if (rb < nbr && grow < m && cn < n) store(&c[static_cast<size_t>(grow) * n + cn], acc_s[e]);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. ntile (8, 16, 32 or 64) and tyn (thread rows; the block
// runs ntile / 4 * tyn threads, at most 256, a multiple of 32) are chosen by
// the caller so that the shared memory fits. Launches on `stream` and does
// not synchronise; returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int footprint_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                              void* c, int c_dtype, const void* ucols, const void* nslots,
                              const void* lrow, const void* bslot, const void* newcol, int m,
                              int k, int n, int bm, int bk, int nbr, int S, int Ls, int Lu,
                              int ntile, int tyn, int round_bf16, int device, void* stream) {
  const int nthr = ntile / TN * tyn;
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || S <= 0 || Ls <= 0 ||
      Lu <= 0 || (ntile != 8 && ntile != 16 && ntile != 32 && ntile != 64) || tyn <= 0 ||
      nthr > MAX_THREADS || nthr % 32 != 0 || (n + ntile - 1) / ntile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rp = tyn * TM;
  const size_t smem = smem_bytes(S, bm, bk, ntile, rp);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ns = (nbr + S - 1) / S;
  const dim3 grid(static_cast<unsigned>(ns), (n + ntile - 1) / ntile);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t attr = cudaSuccess;
  const int rc = dispatch(vals_dtype, b_dtype, c_dtype, round_bf16,
                          [&](auto ta, auto tb, auto tc, auto rnd) {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    using TC = typename decltype(tc)::type;
    auto* kern = footprint_spmm_kernel<TA, TB, TC, decltype(rnd)::value>;
    attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
    if (attr != cudaSuccess) return;
    kern<<<grid, nthr, smem, s>>>(
        static_cast<const TA*>(vals), static_cast<const TB*>(b), static_cast<TC*>(c),
        static_cast<const int*>(ucols), static_cast<const int*>(nslots),
        static_cast<const int*>(lrow), static_cast<const int*>(bslot),
        static_cast<const int*>(newcol), m, k, n, bm, bk, nbr, S, Ls, Lu, ntile, rp);
  });
  if (rc != 0) return rc;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return static_cast<int>(cudaGetLastError());
}
