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
//   - A block of WGS warpgroups (WGS = 2 where the grid of 128 x 128 tiles
//     has at least two blocks an SM, else 1, for the MLP's m = 32 shapes);
//     warpgroup w issues the m64n128 wgmmas of C rows 64 w .. 64 w + 63.
//   - Operands are staged through registers, and not by TMA: tf32 wgmma
//     reads only K-major tiles, yet B stored (k, n) and A stored (k, m) are
//     not K-major, and every fp32 tier splits or rounds each value first. So
//     the staging pass loads a k-chunk of 128 bytes a row (32 fp32 or 64 bf16
//     values) of op(A) and op(B), converts it, and stores it K-major in the
//     128-byte swizzle (wgmma.cuh). Two paths load it: 16-byte vectors where
//     the operand's rows run along k and are 16-byte aligned (row stride and
//     base), else one element a load, coalesced along whichever axis is
//     contiguous (k = 33 gives 132-byte rows, n = 10 40-byte rows). Both
//     are in this kernel; neither falls back.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int BN = 128;        // columns of C a block: one wgmma's n
constexpr int ROW_BYTES = 128; // bytes of k a staged row (one swizzle row)
constexpr int KSTEPS = 4;      // wgmma k-steps a staged row, 32 bytes each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// E consecutive values at p, 16-byte aligned, as 8- or 16-byte loads.
template <int E>
__device__ __forceinline__ void load_vec(float (&v)[E], const float* p) {
#pragma unroll
  for (int h = 0; h < E / 4; ++h) {
    const float4 f = reinterpret_cast<const float4*>(p)[h];
    v[4 * h] = f.x, v[4 * h + 1] = f.y, v[4 * h + 2] = f.z, v[4 * h + 3] = f.w;
  }
}

template <int E>
__device__ __forceinline__ void load_vec(float (&v)[E], const __nv_bfloat16* p) {
#pragma unroll
  for (int h = 0; h < E / 4; ++h) {
    const uint2 u = reinterpret_cast<const uint2*>(p)[h];
    const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[4 * h] = f0.x, v[4 * h + 1] = f0.y, v[4 * h + 2] = f1.x, v[4 * h + 3] = f1.y;
  }
}

// One operand's staged tile: ROWS rows (of op(A) or of op(B)^T) x one k-chunk
// of 8 16-byte chunks, E values each; NT threads stage V chunks each. Chunk p
// of a thread is v = tid + NT p: (row v / 8, chunk v % 8) when the source's
// rows run along k (8 threads read a row's 128 contiguous bytes), (row v %
// ROWS, chunk v / ROWS) when they run along the rows (a warp reads 32
// neighbouring rows at each k). Either way a warp's 16-byte shared stores
// are conflict-free in the swizzle.
template <typename T, int ROWS, int NT, int E>
struct Operand {
  static constexpr int V = ROWS * 8 / NT;

  __device__ static void at(int p, bool kmaj, int& row, int& c) {
    const int v = static_cast<int>(threadIdx.x) + NT * p;
    row = kmaj ? v / 8 : v % ROWS;
    c = kmaj ? v % 8 : v / ROWS;
  }

  // op(X)[r0 + row][k0 + c E + e] into r[p][e]; 0 past R rows or K. x is
  // stored (R, K) when kmaj, else (K, R); vec: 16-byte loads (kmaj only).
  __device__ static void load(float (&r)[V][E], const T* __restrict__ x, bool kmaj, bool vec,
                              int r0, int R, int k0, int K) {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      int row, c;
      at(p, kmaj, row, c);
      const int gr = r0 + row, kb = k0 + c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) r[p][e] = 0.f;
      if (gr >= R || kb >= K) continue;
      if (kmaj) {
        const T* src = x + static_cast<size_t>(gr) * K + kb;
        if (vec) {  // K % E == 0: the chunk lies wholly inside the row
          load_vec<E>(r[p], src);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (kb + e < K) r[p][e] = to_f32(src[e]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (kb + e < K) r[p][e] = to_f32(x[static_cast<size_t>(kb + e) * R + gr]);
        }
      }
    }
  }

  // The staged chunks, K-major in the swizzle: 3xTF32 stores x_hi at hi and
  // x_lo at lo (4 fp32 a chunk); otherwise bf16 (RTN) at hi (8 a chunk).
  template <bool X3>
  __device__ static void store_tile(uint8_t* hi, uint8_t* lo, const float (&r)[V][E],
                                    bool kmaj) {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      int row, c;
      at(p, kmaj, row, c);
      const int off = wg::sw128(row, c);
      if constexpr (X3) {
        float h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = wg::tf32_rna(r[p][e]);
          l[e] = wg::tf32_rna(r[p][e] - h[e]);
        }
        *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(r[p][2 * e], r[p][2 * e + 1]);
          w[e] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

template <bool X3, int WGS>
struct Geometry {
  static constexpr int NT = 128 * WGS;
  static constexpr int BM = 64 * WGS;
  static constexpr int E = X3 ? 4 : 8;  // staged values a 16-byte chunk
  static constexpr int KC = 8 * E;      // k a chunk: 32 fp32 or 64 bf16
  static constexpr int TILE_A = BM * ROW_BYTES;
  static constexpr int TILE_B = BN * ROW_BYTES;
  static constexpr int PARTS = X3 ? 2 : 1;  // hi and lo, or the bf16 tile
  static constexpr int STAGE = PARTS * (TILE_A + TILE_B);
  static constexpr int SMEM = 2 * STAGE + 1024;  // two stages, 1024-byte alignment slack
};

template <typename TA, typename TB, typename TC, bool X3, int WGS>
__global__ void __launch_bounds__(128 * WGS) gemm_kernel(
    const TA* __restrict__ a,  // (m, k), or (k, m) when transa
    const TB* __restrict__ b,  // (k, n), or (n, k) when transb
    TC* __restrict__ c,        // (m, n)
    int m, int n, int k, int transa, int transb, int vec_a, int vec_b) {
  using G = Geometry<X3, WGS>;
  using OA = Operand<TA, G::BM, G::NT, G::E>;
  using OB = Operand<TB, BN, G::NT, G::E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = wg::smem_addr(sm);
  // stage s: A hi [, A lo], B hi [, B lo]
  auto a_at = [&](int s, int part) { return sm + s * G::STAGE + part * G::TILE_A; };
  auto b_at = [&](int s, int part) {
    return sm + s * G::STAGE + G::PARTS * G::TILE_A + part * G::TILE_B;
  };

  const bool kma = transa == 0;  // A's rows run along k
  const bool kmb = transb != 0;  // B stored (n, k): op(B)^T's rows run along k
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * BN;
  const int nk = (k + G::KC - 1) / G::KC;

  float ra[OA::V][G::E], rb[OB::V][G::E];
  OA::load(ra, a, kma, vec_a, m0, m, 0, k);
  OB::load(rb, b, kmb, vec_b, n0, n, 0, k);
  OA::template store_tile<X3>(a_at(0, 0), a_at(0, G::PARTS - 1), ra, kma);
  OB::template store_tile<X3>(b_at(0, 0), b_at(0, G::PARTS - 1), rb, kmb);
  wg::fence_async_smem();
  __syncthreads();

  const int w = threadIdx.x / 128;  // this warpgroup: C rows 64 w ..
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    const bool more = kc + 1 < nk;
    if (more) {  // the next chunk's loads, in flight during this chunk's wgmmas
      OA::load(ra, a, kma, vec_a, m0, m, (kc + 1) * G::KC, k);
      OB::load(rb, b, kmb, vec_b, n0, n, (kc + 1) * G::KC, k);
    }
    const uint32_t ah = sbase + buf * G::STAGE + w * 64 * ROW_BYTES;
    const uint32_t bh = sbase + buf * G::STAGE + G::PARTS * G::TILE_A;
    wg::fence();
    if constexpr (X3) {
      wg::fence_regs(part);
      const uint32_t al = ah + G::TILE_A, bl = bh + G::TILE_B;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {  // the small products first
        const uint32_t o = 32 * s;
        wg::mma_tf32(part, wg::desc_k_sw128(al + o), wg::desc_k_sw128(bh + o), s > 0);
        wg::mma_tf32(part, wg::desc_k_sw128(ah + o), wg::desc_k_sw128(bl + o), 1);
        wg::mma_tf32(part, wg::desc_k_sw128(ah + o), wg::desc_k_sw128(bh + o), 1);
      }
    } else {
      wg::fence_regs(acc);
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const uint32_t o = 32 * s;
        wg::mma_bf16(acc, wg::desc_k_sw128(ah + o), wg::desc_k_sw128(bh + o), 1);
      }
    }
    wg::commit();
    if (more) {  // into the other stage, whose last readers waited before the last barrier
      OA::template store_tile<X3>(a_at(buf ^ 1, 0), a_at(buf ^ 1, G::PARTS - 1), ra, kma);
      OB::template store_tile<X3>(b_at(buf ^ 1, 0), b_at(buf ^ 1, G::PARTS - 1), rb, kmb);
      wg::fence_async_smem();
    }
    wg::wait<0>();
    if constexpr (X3) {
      wg::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    } else {
      wg::fence_regs(acc);
    }
    __syncthreads();
  }

  // the accumulator layout of wgmma.cuh: d[4 j + 2 h + e] is row 16 warp +
  // lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of the warpgroup's tile
  const int t = threadIdx.x % 128;
  const int row0 = m0 + 64 * w + 16 * (t / 32) + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * h, col = col0 + 8 * j + e;
        if (row < m && col < n) store(&c[static_cast<size_t>(row) * n + col], acc[4 * j + 2 * h + e]);
      }
}

template <typename TA, typename TB, typename TC, bool X3, int WGS>
int launch(const void* a, const void* b, void* c, int m, int n, int k, int transa, int transb,
           cudaStream_t stream) {
  using G = Geometry<X3, WGS>;
  auto kern = gemm_kernel<TA, TB, TC, X3, WGS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // vector loads for an operand whose rows run along k, where every row
  // starts 16-byte aligned and holds whole chunks of E values
  auto vec = [k](const void* p, size_t size, bool kmaj) {
    return kmaj && k % G::E == 0 && (static_cast<size_t>(k) * size) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const dim3 grid((n + BN - 1) / BN, (m + G::BM - 1) / G::BM);
  kern<<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<TC*>(c), m, n, k,
      transa, transb, vec(a, sizeof(TA), transa == 0), vec(b, sizeof(TB), transb != 0));
  return 0;
}

// The tier's pass (3xTF32 or bf16) and the block height for these shapes.
template <typename TA, typename TB, typename TC>
int launch_tier(const void* a, const void* b, void* c, int m, int n, int k, int transa,
                int transb, int round_bf16, cudaStream_t stream) {
  const bool two = static_cast<long long>((m + 127) / 128) * ((n + BN - 1) / BN) >= 2 * 132;
  constexpr bool both_bf16 =
      sizeof(TA) == sizeof(__nv_bfloat16) && sizeof(TB) == sizeof(__nv_bfloat16);
  if constexpr (!both_bf16) {
    if (!round_bf16) {
      return two ? launch<TA, TB, TC, true, 2>(a, b, c, m, n, k, transa, transb, stream)
                 : launch<TA, TB, TC, true, 1>(a, b, c, m, n, k, transa, transb, stream);
    }
  }
  return two ? launch<TA, TB, TC, false, 2>(a, b, c, m, n, k, transa, transb, stream)
             : launch<TA, TB, TC, false, 1>(a, b, c, m, n, k, transa, transb, stream);
}

template <typename TA, typename TB>
int launch_out(const void* a, const void* b, void* c, int c_dtype, int m, int n, int k,
               int transa, int transb, int round_bf16, cudaStream_t stream) {
  if (c_dtype == 0) {
    return launch_tier<TA, TB, float>(a, b, c, m, n, k, transa, transb, round_bf16, stream);
  }
  if (c_dtype == 1) {
    return launch_tier<TA, TB, __nv_bfloat16>(a, b, c, m, n, k, transa, transb, round_bf16,
                                              stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. Launches on `stream` (PyTorch's current stream) and does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gemm(const void* a, int a_dtype, const void* b, int b_dtype, void* c,
                    int c_dtype, int m, int n, int k, int transa, int transb,
                    int round_bf16, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + 63) / 64 > 65535) {
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
    rc = launch_out<__nv_bfloat16, __nv_bfloat16>(a, b, c, c_dtype, m, n, k, transa, transb,
                                                  round_bf16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
