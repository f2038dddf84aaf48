// int8 GEMM for NVIDIA Hopper (sm_90a): C = A @ B for int8 A (m, k) and
// int8 B (k, n) with exact int32 sums, C (m, n) int32 row-major.
//
// Replaces the TPU kernel tpusparse/kernels/gemm.py:298 _gemm_s8_kernel
// (pallas_call l.355, behind gemm_int8_pallas): the blocked (M/bm, N/bn,
// K/bk) grid with an int32 VMEM accumulator carried across the sequential K
// axis. Here one thread block runs a tile's whole K loop itself, so nothing
// carries between blocks. The TPU's block-size knobs are not carried. The
// caller owns dequantization.
//
// Operands. wgmma takes 8-bit operands K-major only (the PTX transpose flags
// exist for 16-bit types), so B comes as bt (n, ldt) = B^T, written once a
// call by int8_kmajor (block_ell_spmm_int8.cu) with ldt = k rounded up to
// 128, so that each chunk TMA reads is one aligned 128-byte line; and A as
// stored, (m, lda). TMA needs a row stride of a multiple of 16 bytes and a
// 16-byte-aligned base, so the wrapper (kernels/gemm.py) passes A itself
// where k % 16 == 0 and its base is aligned, and otherwise a copy
// zero-padded to lda = ldt. Both are read through TMA tensor maps of k
// columns: k past k and rows past m or n arrive as zeros, so the ragged
// edges cost no code in the loop.
//
// Exactness: every s8 x s8 product and every int32 sum is exact while the
// sums stay inside int32, that is while 127^2 * k < 2^31 (k < ~133,000), as
// on the TPU; past that they wrap (no .satfinite), and no guard is added.
//
// What bounds it. At 4096^3 the work is 2 * 4096^3 = 137.4 G int8 ops,
// 0.0694 ms at the H100's 1,979 TOPS int8 datasheet rate, against 100.7 MB
// of compulsory traffic (A, B and the int32 C: 0.030 ms at 3.35 TB/s): the
// operations bound it. The first design reached 7.3 % of that bound; this one
// answers each of its four limits:
//   - legacy tensor cores (mma.sync m16n8k32): the products run on
//     wgmma.mma_async m64nNk32 s8 from shared memory (wgmma.cuh), the only
//     way to the full tensor-core rate;
//   - no pipeline (one 32-deep chunk between two barriers): a producer warp
//     keeps a ring of STAGES chunks of 128 k bytes in flight by TMA
//     (cp.async.bulk.tensor, written in wgmma's 128-byte swizzle, one
//     mbarrier a stage counting the bytes), and the consumer warpgroups
//     release a stage by an mbarrier once the wgmmas that read it retired
//     (wgmma.wait<1>: a chunk's products are issued before the last chunk's
//     are waited for). No __syncthreads in the loop;
//   - B transposed by every block (64 times at 4096^3): it is made K-major
//     once a call by int8_kmajor, ~34 MB moved at 4096^2;
//   - a small tile (64 x 128: 85 operations a byte from L2): a block owns a
//     128 x 256 tile of C, two consumer warpgroups of m64n256 with 128 int32
//     sums a thread, 171 operations a byte; and two blocks of a cluster, on
//     the same 256 columns and neighbouring rows, each load half the B tile
//     and multicast it to both (TMA .multicast::cluster), 256 operations a
//     byte. At the int8 peak, 132 SMs of 128 x 256 tiles alone would read
//     ~11 TB/s from L2, about twice what it gives. A stage is free once the
//     consumers of both blocks released it, each arriving on both blocks'
//     barriers with the default (CTA-scope) release: on an NVIDIA H100 80GB
//     HBM3 at 700 W the cluster took 4096^3 from 0.121 to 0.107 ms, and with
//     cluster-scope releases it ran 0.208.
// Epilogue: the grid is persistent, as many blocks as the card holds at
// once walking the tiles, so the producer loads the next tile's chunks
// while the consumers store this tile's sums (registers to device memory, 8
// bytes a store; the ragged m and n edges masked there): 0.103 ms at
// 4096^3 against 0.112 for a tile a block on the same card
// (compare_trees.py gemm_s8). Narrow or short C (the entry point picks the
// tile width, `tile_n`) runs 128 x 128 tiles, two blocks an SM, no cluster:
// 0.014-0.016 ms against 0.023-0.028 for 128 x 256 at (4096, 4096, n), n 8
// to 512 (128 x 64 ran no faster). A C under 64 rows still runs the
// 128-row tile, rows past m zero.
// The tensor maps are built on the host each call by cuTensorMapEncodeTiled,
// taken from the driver through cudaGetDriverEntryPoint, so nothing links
// libcuda. What does not change between calls (the SM count, the raised
// shared memory limit, the clusters the card holds at once) is read at the
// first call on each device.
//
// Determinism: no atomics; each output element is summed by one warpgroup
// in ascending k (integer sums are exact in any order anyway).

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int BM = 128;             // rows of C a tile: two consumer warpgroups of 64
constexpr int KB = 128;             // k bytes a stage: one 128-byte swizzle row, 4 k-steps
constexpr int CONSUMERS = 256;      // the two consumer warpgroups
constexpr int NT = CONSUMERS + 32;  // and one producer warp

// A tile BM x BN of C and its ring: STAGES stages of A (BM x KB) and B^T
// (BN x KB), each 1024-byte aligned, then STAGES "full" and STAGES "empty"
// mbarriers. 128 x 256 takes four stages (192 KB) and one block an SM, in
// clusters of CLUSTER blocks on the same columns of C and neighbouring rows,
// each block loading 1 / CLUSTER of the B tile and multicasting it to all;
// 128 x 128 three stages and two blocks an SM (registers: 288 threads x
// 112), no cluster.
template <int BN>
struct Cfg {
  static constexpr int TILE_A = BM * KB;
  static constexpr int STAGE = TILE_A + BN * KB;
  static constexpr int BLOCKS_PER_SM = BN == 256 ? 1 : 2;
  static constexpr int CLUSTER = BN == 256 ? 2 : 1;
  static constexpr int B_ROWS = BN / CLUSTER;  // rows of B^T a block loads
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 2 * 8 * STAGES + 1024;  // + alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins until the phase of parity `parity` of the mbarrier at `bar` has
// completed (a fresh barrier counts its phase "-1", parity 1, as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster (none may have exited).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrives on the mbarrier at the shared address `bar` of block `cta` of the
// cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// TMA: the box of `map` at (x = k byte, y = row) into shared memory at dst;
// its bytes complete a transaction on the mbarrier at bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// The same box into dst of every block of the cluster in `mask`, each
// block's mbarrier at bar completing its transaction.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int x, int y, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(x), "r"(y)
      : "memory");
}

// C = A . (B^T)^T. The grid's clusters of CLUSTER blocks walk units
// cid, cid + clusters, ... (cid = blockIdx.x / CLUSTER); unit u holds the
// tiles at columns BN (u % tiles_n) and rows 128 (CLUSTER (u / tiles_n) +
// rank), rank the block's place in its cluster; nkc chunks of KB k bytes.
template <int BN>
__global__ void __launch_bounds__(NT, Cfg<BN>::BLOCKS_PER_SM)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, int32_t* __restrict__ c, int m,
                   int n, int nkc, int tiles_n, int units) {
  using G = Cfg<BN>;
  constexpr int CL = G::CLUSTER;
  extern __shared__ uint8_t raw[];
  uint8_t* sm = raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
  const uint32_t base = wg::smem_addr(sm);
  const uint32_t full = base + G::STAGES * G::STAGE;  // stage s loaded: full + 8 s
  const uint32_t empty = full + 8 * G::STAGES;        // stage s free: empty + 8 s
  const int rank = CL > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int first = blockIdx.x / CL, step = gridDim.x / CL;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's expect_tx
      mbar_init(empty + 8 * s, 2 * CL);  // each consumer warpgroup of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL > 1) cluster_sync();  // the peers' barriers exist before any multicast

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int u = first; u < units; u += step) {
        const int m0 = (CL * (u / tiles_n) + rank) * BM;
        const int n0 = (u % tiles_n) * BN + rank * G::B_ROWS;  // this block's part of B
        for (int kc = 0; kc < nkc; ++kc) {
          // free in every block of the cluster: this block's part of B lands in all
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t stage = base + s * G::STAGE;
          mbar_expect_tx(full + 8 * s, G::STAGE);
          tma_load(stage, &map_a, full + 8 * s, kc * KB, m0);
          const uint32_t b_dst = stage + G::TILE_A + rank * G::B_ROWS * KB;
          if constexpr (CL > 1) {
            tma_load_multicast(b_dst, &map_b, full + 8 * s, kc * KB, n0, (1u << CL) - 1);
          } else {
            tma_load(b_dst, &map_b, full + 8 * s, kc * KB, n0);
          }
          if (++s == G::STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {
    // the consumers: warpgroup w holds rows 64 w .. 64 w + 63 of the tile
    const int w = threadIdx.x / 128, t = threadIdx.x % 128;
    // a stage is released for the warpgroup by lane 0 of its warp r, to
    // block r of the cluster
    auto release = [&](int stage) {
      if constexpr (CL > 1) {
        if (t % 32 == 0 && t / 32 < CL) mbar_arrive_cluster(empty + 8 * stage, t / 32);
      } else {
        if (t == 0) mbar_arrive(empty + 8 * stage);
      }
    };
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int s = 0;
    uint32_t phase = 0;
    for (int u = first; u < units; u += step) {
      int prev = 0;
      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t a = base + s * G::STAGE + w * 64 * KB;
        const uint32_t b = base + s * G::STAGE + G::TILE_A;
        wg::fence();
        wg::fence_regs(acc);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wg::mma_s8<BN>(acc, wg::desc_k_sw128(a + 32 * ks), wg::desc_k_sw128(b + 32 * ks),
                         kc > 0 || ks > 0);
        }
        wg::commit();
        wg::wait<1>();  // the last chunk's wgmmas have retired: its stage is free
        wg::fence_regs(acc);
        if (kc > 0) release(prev);
        prev = s;
        if (++s == G::STAGES) s = 0, phase ^= 1;
      }
      wg::wait<0>();
      wg::fence_regs(acc);
      release(prev);

      // the store, in wgmma.cuh's accumulator layout: pairs of columns
      const int tm = CL * (u / tiles_n) + rank;
      const int row0 = tm * BM + 64 * w + 16 * (t / 32) + (t % 32) / 4;
      const int col0 = (u % tiles_n) * BN + 2 * (t % 4);
      const bool pairs = n % 2 == 0;  // then every pair is 8-byte aligned
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= m || col >= n) continue;
          int32_t* p = c + static_cast<size_t>(row) * n + col;
          const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (pairs) {
            *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
          } else {
            p[0] = v0;
            if (col + 1 < n) p[1] = v1;
          }
        }
      }
    }
  }
  // no block leaves while a peer may still arrive on its barriers
  if constexpr (CL > 1) {
    __syncwarp();
    cluster_sync();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded; null if absent.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of an int8 matrix of `rows` rows of `cols` bytes at row stride ld
// (a multiple of 16, base 16-byte aligned), read in boxes of KB bytes x
// box_rows rows in the 128-byte swizzle; reads past the edges give 0.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* p, int rows, int cols, int ld,
              int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {KB, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The width of C's tiles: 256, which reads the fewest bytes a product from
// L2, unless n fits in 128 (columns past n would cost products) or the
// 256-wide tiles number fewer than the card's SMs; then 128.
int tile_n(int m, int n, int sms) {
  const long long tiles_256 = static_cast<long long>((m + BM - 1) / BM) * ((n + 255) / 256);
  return n > 128 && tiles_256 >= sms ? 256 : 128;
}

constexpr int MAX_DEVICES = 64;

// The device's SM count, read once.
cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> known[MAX_DEVICES];
  *sms = known[device].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) known[device].store(*sms, std::memory_order_relaxed);
  return err;
}

// The clusters of instance BN the device holds at once: its shared memory
// limit raised and the occupancy read at the first call on each device, both
// fixed for the process.
template <int BN>
cudaError_t resident_clusters(int device, cudaLaunchConfig_t cfg, int* most) {
  using G = Cfg<BN>;
  static std::atomic<int> known[MAX_DEVICES];
  *most = known[device].load(std::memory_order_relaxed);
  if (*most > 0) return cudaSuccess;
  auto* kern = gemm_s8_kernel<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  if constexpr (G::CLUSTER > 1) {
    cfg.gridDim = dim3(G::CLUSTER);
    err = cudaOccupancyMaxActiveClusters(most, kern, &cfg);
  } else {
    err = sm_count(device, most);
    *most *= G::BLOCKS_PER_SM;
  }
  if (err != cudaSuccess) return err;
  if (*most <= 0) return cudaErrorInvalidConfiguration;
  known[device].store(*most, std::memory_order_relaxed);
  return cudaSuccess;
}

// One launch of instance BN on a persistent grid: as many clusters as the
// card holds at once, or one a unit where there are fewer units.
template <int BN>
int launch(EncodeTiled encode, const void* a, const void* bt, int32_t* c, int m, int n, int k,
           int lda, int ldt, int device, cudaStream_t stream) {
  using G = Cfg<BN>;
  constexpr int CL = G::CLUSTER;
  const int tiles_n = (n + BN - 1) / BN;
  const long long units = static_cast<long long>((m + BM * CL - 1) / (BM * CL)) * tiles_n;
  if (units * CL > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!make_map(encode, &map_a, a, m, k, lda, BM) ||
      !make_map(encode, &map_b, bt, n, k, ldt, G::B_ROWS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CL;
  cluster[0].val.clusterDim.y = cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  int most = 0;
  cudaError_t err = resident_clusters<BN>(device, cfg, &most);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long clusters = most < units ? most : units;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * CL));
  auto* kern = gemm_s8_kernel<BN>;
  err = cudaLaunchKernelEx(&cfg, kern, map_a, map_b, c, m, n, (k + KB - 1) / KB, tiles_n,
                           static_cast<int>(units));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes: the width of C's tiles that
// gemm_s8 takes for an (m, n) C on `device`, 128 or 256; a negative CUDA
// error where the device cannot be read.
extern "C" int gemm_s8_tile_n(int m, int n, int device) {
  if (m <= 0 || n <= 0 || device < 0 || device >= MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  return err == cudaSuccess ? tile_n(m, n, sms) : -static_cast<int>(err);
}

// Plain C entry point, loaded with ctypes. C (m, n) int32 = A @ bt^T for A
// (m, lda) and bt (n, ldt) int8, k <= lda, ldt, both multiples of 16 and
// both bases 16-byte aligned; tiles 128 x gemm_s8_tile_n(m, n, device), on
// a persistent grid. Launches on `stream` (PyTorch's current stream) and
// does not synchronise; returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int gemm_s8(const void* a, const void* bt, void* c, int m, int n, int k, int lda,
                       int ldt, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || lda < k || ldt < k || lda % 16 != 0 || ldt % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(bt) % 16 != 0 ||
      device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* cc = static_cast<int32_t*>(c);
  auto st = static_cast<cudaStream_t>(stream);
  if (tile_n(m, n, sms) == 256) {
    return launch<256>(encode, a, bt, cc, m, n, k, lda, ldt, device, st);
  }
  return launch<128>(encode, a, bt, cc, m, n, k, lda, ldt, device, st);
}
