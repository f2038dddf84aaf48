// Dense GEMM for NVIDIA Hopper (sm_90a) on the tensor cores (wgmma):
// C = op(A) @ op(B) for 2-D row-major operands, where op transposes when its
// flag is set.
//
// Replaces the TPU kernel tpusparse/kernels/gemm.py:31 _gemm_kernel
// (pallas_call l.130, behind gemm_pallas): the blocked (M/bm, N/bn, K/bk)
// grid with a VMEM accumulator carried across the sequential K axis. Here
// one thread block owns one (64 * WGS) x 128 tile of C and runs the whole K
// loop itself, so nothing carries between blocks. The TPU wrapper padded A
// and B to its tiles and sliced C; here the ragged m, n and k edges are
// masked in the loads and the store. The transpose flags are read by the
// kernel, so the backward's transposed products copy nothing.
//
// Contract: A is stored (m, k), or (k, m) when transa; B is stored (k, n),
// or (n, k) when transb; C (m, n); any m, n, k. Operands fp32 or bf16, sums
// fp32, C written in its own type. Precision tiers (never plain TF32):
//   - 'high'/'highest' with an fp32 operand: 3xTF32. Each value x is split
//     into x_hi = tf32(x) and x_lo = tf32(x - x_hi) (round to nearest) as it
//     is staged, and C sums a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, three tf32
//     wgmma passes: fp32-class (the dropped a_lo.b_lo term and lo's rounding
//     are ~2^-21 of a product). A k-chunk's 3 x 4 products go into a fresh
//     register sum, which is then added to the running fp32 sum in IEEE
//     arithmetic, so the tensor cores' own accumulation only ever adds 32
//     products.
//   - bf16 operands in any tier: one bf16 wgmma pass (products of bf16
//     values are exact in fp32).
//   - 'default' with fp32 operands: both rounded to bf16 (RTN) as they are
//     staged, then one bf16 pass.
// Determinism: no atomics, no split-K; every block sums its k-chunks in
// ascending order, so two identical calls give identical bits.
//
// What bounds it. At 4096^3 the work is 2 * 4096^3 = 137.4 GFLOP: 3 passes
// at the H100's 495 TFLOP/s tf32 rate take 0.833 ms ('high'), one at 989
// TFLOP/s bf16 0.139 ms ('default'), against 201 MB of compulsory traffic
// (0.06 ms at 3.35 TB/s). The FFMA kernel this replaces was bounded at 2.05
// ms (67 TFLOP/s) and ran 6.97. Design:
//   - A block of WGS warpgroups; warpgroup w issues the m64n128 wgmmas of C
//     rows 64 w .. 64 w + 63. The C entry point takes the block height
//     (`block_m`: 64, WGS = 1, or 128, WGS = 2); 0 picks WGS = 2 where the
//     grid of 128 x 128 tiles has at least two blocks an SM, else 1 (the
//     MLP's m = 32 shapes). Both heights sum every element's k-chunks in the
//     same order, so they give the same bits; `autotune_gemm`
//     (kernels/gemm.py) times them. No wider tile: a 3xTF32 tile 256 columns
//     wide would hold 2 x 128 fp32 sums a thread (the running sum and a
//     chunk's fresh one), over the 255 registers a thread may have.
//   - Operands are staged through registers, and not by TMA: tf32 wgmma
//     reads only K-major tiles, yet B stored (k, n) and A stored (k, m) are
//     not K-major, and every fp32 tier splits or rounds each value first.
//     The staging and the K loop are wgmma_tiles.cuh's (`Staged`, `k_loop`),
//     which the block SpMM and the SDDMM share: a k-chunk of 128 bytes a row
//     (32 fp32 or 64 bf16 values) of op(A) and op(B) is loaded into
//     registers, converted, and stored K-major in the 128-byte swizzle
//     (wgmma.cuh). Two paths load it: 16-byte vectors where the operand's
//     rows run along k and are 16-byte aligned (row stride and base), else
//     one element a load, coalesced along whichever axis is contiguous (k =
//     33 gives 132-byte rows, n = 10 40-byte rows). Both are in this kernel;
//     neither falls back.
//   - Two stages in shared memory: the next chunk's loads are issued before
//     this chunk's wgmmas and stored into the other stage while they run;
//     one barrier a chunk. So one chunk's loads are in flight at a time, and
//     8 warps an SM hide little of their L2 latency: the tensor cores idle
//     much of each chunk ('high'), and 'default' reads its fp32 operands
//     through L2 at 128 x 128 tiles (4.3 GB at 4096^3). Three variants were
//     slower on the H100: a cp.async copy two chunks ahead into a raw slot
//     with a separate conversion pass, a second register set (which
//     spills), and 64-column 3xTF32 tiles at two blocks an SM. Warp
//     specialisation, TMA multicast and persistence are later work.

#include "wgmma_tiles.cuh"

namespace {

using namespace wt;

constexpr int BN = 128;  // columns of C a block: one wgmma's n

// For an operand whose rows run across k: the offsets along a row of the
// stored operand of the thread's rows (NMAJ places) of a tile at row r0.
// Made at each load, not held in registers through the K loop.
template <class S>
__device__ __forceinline__ void nmaj_offsets(size_t (&off)[S::V], int r0) {
#pragma unroll
  for (int p = 0; p < S::V; ++p) {
    int row, cc;
    S::at(p, NMAJ, row, cc);
    off[p] = static_cast<size_t>(r0) + row;
  }
}

template <typename TA, typename TB, typename TC, class G>
__global__ void __launch_bounds__(G::NT) gemm_kernel(
    const TA* __restrict__ a,  // (m, k), or (k, m) when transa
    const TB* __restrict__ b,  // (k, n), or (n, k) when transb
    TC* __restrict__ c,        // (m, n)
    int m, int n, int k, int transa, int transb, int vec_a, int vec_b) {
  using SA = Staged<TA, G::BM, G::NT, G::E>;
  using SB = Staged<TB, G::BN, G::NT, G::E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);

  const bool kma = transa == 0;  // A's rows run along k
  const bool kmb = transb != 0;  // B stored (n, k): op(B)^T's rows run along k
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  const int nk = (k + G::KC - 1) / G::KC;
  float ra[SA::V][G::E], rb[SB::V][G::E];
  int k0 = 0;  // the next chunk's first k
  auto load = [&]() {
    if (kma) {
      SA::load_k(ra, a + static_cast<size_t>(m0) * k + k0, k, m - m0, k - k0, vec_a != 0);
    } else {
      size_t off[SA::V];
      nmaj_offsets<SA>(off, m0);
      SA::load_n(ra, a + static_cast<size_t>(k0) * m, m, off, m - m0, k - k0);
    }
    if (kmb) {
      SB::load_k(rb, b + static_cast<size_t>(n0) * k + k0, k, n - n0, k - k0, vec_b != 0);
    } else {
      size_t off[SB::V];
      nmaj_offsets<SB>(off, n0);
      SB::load_n(rb, b + static_cast<size_t>(k0) * n, n, off, n - n0, k - k0);
    }
    k0 += G::KC;
  };
  auto store = [&](uint8_t* stage) {
    SA::template store<G::X3>(G::a_at(stage, 0), G::a_at(stage, G::PARTS - 1), ra,
                              kma ? KMAJ : NMAJ);
    SB::template store<G::X3>(G::b_at(stage, 0), G::b_at(stage, G::PARTS - 1), rb,
                              kmb ? KMAJ : NMAJ);
  };
  float acc[G::NACC];
  k_loop<G>(acc, sm, nk, load, store);

  const bool pair = n % 2 == 0;
  for_pairs(acc, [&](int r, int q, float v0, float v1) {
    const int row = m0 + r, col = n0 + q;
    if (row >= m || col >= n) return;
    store_pair(c + static_cast<size_t>(row) * n + col, v0, v1, col + 1 < n, pair);
  });
}

template <typename TA, typename TB, typename TC, class G>
int launch(const void* a, const void* b, void* c, int m, int n, int k, int transa, int transb,
           cudaStream_t stream) {
  auto kern = gemm_kernel<TA, TB, TC, G>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // vector loads for an operand whose rows run along k, where every row
  // starts 16-byte aligned and holds whole chunks of E values
  auto vec = [k](const void* p, size_t size, bool kmaj) {
    return kmaj && k % G::E == 0 && (static_cast<size_t>(k) * size) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const dim3 grid((n + G::BN - 1) / G::BN, (m + G::BM - 1) / G::BM);
  kern<<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<TC*>(c), m, n, k,
      transa, transb, vec(a, sizeof(TA), transa == 0), vec(b, sizeof(TB), transb != 0));
  return 0;
}

// The block height that block_m = 0 picks for an (m, n) C: 128 rows where
// the grid of 128 x 128 tiles has at least two blocks an SM, else 64.
int default_block_m(int m, int n) {
  const long long tiles = static_cast<long long>((m + 127) / 128) * ((n + BN - 1) / BN);
  return tiles >= 2 * 132 ? 128 : 64;
}

// The tier's pass (3xTF32 or bf16, with_tier) and the block height.
template <typename TA, typename TB, typename TC>
int launch_tier(const void* a, const void* b, void* c, int m, int n, int k, int transa,
                int transb, int round_bf16, int block_m, cudaStream_t stream) {
  const bool two = (block_m == 0 ? default_block_m(m, n) : block_m) == 128;
  return with_tier<TA, TB>(round_bf16 != 0, [&](auto x3) -> int {
    constexpr bool X3 = decltype(x3)::value;
    return two ? launch<TA, TB, TC, Geometry<X3, 2, 128, BN>>(a, b, c, m, n, k, transa, transb,
                                                             stream)
               : launch<TA, TB, TC, Geometry<X3, 1, 64, BN>>(a, b, c, m, n, k, transa, transb,
                                                            stream);
  });
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. block_m: the rows of C a thread block (64 or 128), or 0 for
// default_block_m. Launches on `stream` (PyTorch's current stream) and does
// not synchronise; returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int gemm(const void* a, int a_dtype, const void* b, int b_dtype, void* c,
                    int c_dtype, int m, int n, int k, int transa, int transb,
                    int round_bf16, int block_m, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + 63) / 64 > 65535 ||
      (block_m != 0 && block_m != 64 && block_m != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = with_types(a_dtype, b_dtype, [&](auto ta, auto tb) -> int {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    if (c_dtype == 0) {
      return launch_tier<TA, TB, float>(a, b, c, m, n, k, transa, transb, round_bf16, block_m, s);
    }
    if (c_dtype == 1) {
      return launch_tier<TA, TB, __nv_bfloat16>(a, b, c, m, n, k, transa, transb, round_bf16,
                                                block_m, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The block height that block_m = 0 picks for an (m, n) C.
extern "C" int gemm_default_block_m(int m, int n) { return default_block_m(m, n); }
