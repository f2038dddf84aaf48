// The wgmma tile of the dense GEMM (gemm.cu), the block SpMM
// (block_ell_spmm.cuh: the 2-D, batched and compact executors) and the
// SDDMM (sddmm.cu) for NVIDIA Hopper (sm_90a): a thread block of WGS
// warpgroups owns a (64 WGS) x BN tile of its output (BN = 128, 64 or 32),
// or in the SpMM's n-major form the transpose of a BM x (64 WGS) tile (BM a
// multiple of 8 under 64), and runs a K loop over chunks of 128 bytes of k,
// which the kernel's own loader brings into registers and stages. The
// staging was gemm.cu's first, generalised to a tile that starts anywhere
// in its operand and ends at limits of its own (a block's edge, a matrix's
// edge, a split's end):
//   - a chunk is loaded into registers a row of 128 bytes at a time, by
//     16-byte vectors where the operand's rows run along k and are 16-byte
//     aligned, else one element a load, coalesced along whichever axis is
//     contiguous; values past a limit are 0;
//   - each value is split into tf32 hi and lo (3xTF32) or rounded to bf16
//     (RTN) as it is stored, K-major in the 128-byte swizzle of wgmma.cuh;
//   - two stages: the next chunk's loads are issued before this chunk's
//     wgmmas and stored into the other stage while they run, one barrier a
//     chunk (`k_loop`);
//   - or, for fp32 operands whose rows keep 16-byte alignment, a ring of
//     two raw chunks ahead of the stages (`k_loop_async`): chunk kc + 2 is
//     copied by cp.async while chunk kc's wgmmas run and chunk kc + 1 is
//     converted from its raw copy into the other stage. Each thread
//     converts only the bytes it copied itself, so the ring needs no barrier
//     of its own. With one chunk's loads in flight in registers, their
//     latency took 0.16 of the headline SpMM's 0.43 ms on an NVIDIA H100
//     80GB HBM3 at 700 W; the ring took it to 0.37.
// Tiers (never plain TF32): 3xTF32 for fp32 'high'/'highest' (a chunk's
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi products go into a fresh register sum,
// which is then added to the running fp32 sum in IEEE arithmetic, so the
// tensor cores' own accumulation only ever adds 32 products); one bf16 pass
// for bf16 operand pairs and for 'default' (fp32 rounded to bf16 as staged).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace wt {

constexpr int ROW_BYTES = 128;  // bytes of k a staged row (one swizzle row)
constexpr int KSTEPS = 4;       // wgmma k-steps a staged row, 32 bytes each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// E consecutive values at p, 16-byte aligned (8 for bf16 with E = 4).
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

// A thread block of WGS warpgroups and its tile: BM rows of the A side
// (a row-block's rows, or dC's) by BN of the B side (columns of C, or of a
// block), both staged K-major. Row-major (NMAJ false): wgmma's 64-row side
// runs over BM = 64 WGS rows, a warpgroup's 64 each, and its N side over BN
// (128, 64 or 32). n-major (NMAJ, the block SpMM's row-blocks under 64
// rows): its 64-row side runs over BN = 64 WGS columns of C and its N side
// over BM, a multiple of 8, so the tile computes C's transpose and no
// product row is spent on rows past a short row-block.
template <bool X3_, int WGS_, int BM_, int BN_, bool NMAJ_ = false>
struct Geometry {
  static constexpr bool X3 = X3_;
  static constexpr int WGS = WGS_;
  static constexpr bool NMAJ = NMAJ_;
  static constexpr int NT = 128 * WGS;
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static_assert(NMAJ ? BN == 64 * WGS && BM % 8 == 0 && BM <= 64 : BM == 64 * WGS,
                "64 rows of the wgmma side a warpgroup");
  static constexpr int MMA_N = NMAJ ? BM : BN;  // wgmma's N
  static constexpr int E = X3 ? 4 : 8;  // staged values a 16-byte chunk
  static constexpr int KC = 8 * E;      // k a chunk: 32 fp32 or 64 bf16
  static constexpr int TILE_A = BM * ROW_BYTES;
  static constexpr int TILE_B = BN * ROW_BYTES;
  static constexpr int PARTS = X3 ? 2 : 1;  // hi and lo, or the bf16 tile
  static constexpr int STAGE = PARTS * (TILE_A + TILE_B);
  static constexpr int SMEM = 2 * STAGE + 1024;  // two stages, 1024-byte alignment slack
  static constexpr int NACC = MMA_N / 2;         // fp32 sums a thread
  // k_loop_async's raw ring: two slots of a chunk of fp32 A rows (BM x KC)
  // and B (BN x KC K-major, or KC x BN), after the two stages (a third slot
  // ran no faster on the H100)
  static constexpr int RAW = (BM + BN) * KC * 4;
  static constexpr int SMEM_ASYNC = 2 * STAGE + 2 * RAW + 1024;
  // a stage: A hi [, A lo], B hi [, B lo]
  __device__ static uint8_t* a_at(uint8_t* stage, int part) { return stage + part * TILE_A; }
  __device__ static uint8_t* b_at(uint8_t* stage, int part) {
    return stage + PARTS * TILE_A + part * TILE_B;
  }
  __device__ static float* raw_a(uint8_t* sm, int slot) {
    return reinterpret_cast<float*>(sm + 2 * STAGE + slot * RAW);
  }
  __device__ static float* raw_b(uint8_t* sm, int slot) { return raw_a(sm, slot) + BM * KC; }
};

// How a thread's staged 16-byte chunks p < V map onto (row, chunk c) of a
// tile, v = tid + NT p: KMAJ (row v / 8, chunk v % 8) where the source's rows
// run along k, 8 threads a row's 128 bytes; NMAJ (row v % ROWS, chunk v /
// ROWS) where they run across k, a warp on 32 neighbouring rows at each k;
// NGROUP (row V (tid / 8) + p, chunk tid % 8) for a thread that holds V
// neighbouring rows (a 16-byte group of a row-major source) of one chunk.
// Each keeps a warp's 16-byte shared stores conflict-free in the swizzle.
// A tile of fewer than NT chunks (the n-major tile's short A side) is
// staged in the KMAJ places by its first ROWS * 8 threads, and one whose
// chunks do not divide among NT threads leaves the last p of some threads
// empty (`has`).
enum Map { KMAJ, NMAJ, NGROUP };

// One operand's staged chunk: ROWS rows x 8 16-byte chunks of E values; NT
// threads stage up to V chunks each, placed by a Map.
template <typename T, int ROWS, int NT, int E>
struct Staged {
  static constexpr int V = (ROWS * 8 + NT - 1) / NT;
  static constexpr bool EVEN = V * NT == ROWS * 8;  // every thread stages V chunks

  // Does this thread stage a chunk p? (Always, where EVEN; NMAJ and NGROUP
  // tiles are.)
  __device__ static bool has(int p) {
    return EVEN || static_cast<int>(threadIdx.x) + NT * p < ROWS * 8;
  }

  __device__ static void at(int p, Map map, int& row, int& c) {
    const int t = static_cast<int>(threadIdx.x), v = t + NT * p;
    row = map == KMAJ ? v / 8 : map == NMAJ ? v % ROWS : V * (t / 8) + p;
    c = map == KMAJ ? v % 8 : map == NMAJ ? v / ROWS : t % 8;
  }

  // r[p][e] = x[row * ld + c E + e] (rows along k), 0 at row >= R or k >= K.
  // vec: 16-byte loads; x and ld keep every row's chunks aligned and K % E == 0.
  __device__ static void load_k(float (&r)[V][E], const T* __restrict__ x, size_t ld, int R,
                                int K, bool vec) {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      int row, c;
      at(p, KMAJ, row, c);
      const int kb = c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) r[p][e] = 0.f;
      if (!has(p) || row >= R || kb >= K) continue;
      const T* src = x + static_cast<size_t>(row) * ld + kb;
      if (vec) {
        load_vec<E>(r[p], src);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (kb + e < K) r[p][e] = to_f32(src[e]);
        }
      }
    }
  }

  // r[p][e] = x[(c E + e) * ld + off[p]] (rows across k, the thread's row
  // p at offset off[p] along a row of x), 0 at row >= R or k >= K.
  __device__ static void load_n(float (&r)[V][E], const T* __restrict__ x, size_t ld,
                                const size_t (&off)[V], int R, int K) {
    static_assert(EVEN, "NMAJ tiles stage V chunks a thread");
#pragma unroll
    for (int p = 0; p < V; ++p) {
      int row, c;
      at(p, NMAJ, row, c);
      const int kb = c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) r[p][e] = 0.f;
      if (row >= R || kb >= K) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (kb + e < K) r[p][e] = to_f32(x[static_cast<size_t>(kb + e) * ld + off[p]]);
      }
    }
  }

  // The staged chunks, K-major in the swizzle: 3xTF32 stores x_hi at hi and
  // x_lo at lo (4 fp32 a chunk); otherwise bf16 (RTN) at hi (8 a chunk).
  template <bool X3>
  __device__ static void store(uint8_t* hi, uint8_t* lo, const float (&r)[V][E], Map map) {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      if (!has(p)) continue;
      int row, c;
      at(p, map, row, c);
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

// The 1024-byte-aligned start of the dynamic shared memory.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
}

// Issues this warpgroup's wgmmas of the chunk staged in stage `buf` and
// commits them: 3xTF32 into a fresh sum `part` (the small products first),
// or one bf16 pass into acc. The warpgroup's 64 rows of the wgmma side are
// rows of the A tile, or in an n-major tile rows of the B tile, which then
// takes the A tile as its N side: a product of the A side's part x and the
// B side's part y is the same in both.
template <class G>
__device__ __forceinline__ void issue_mmas(float (&acc)[G::NACC], float (&part)[G::NACC],
                                           uint32_t sbase, int buf) {
  const uint32_t wg_rows = (threadIdx.x / 128) * 64 * ROW_BYTES;
  const uint32_t ah = sbase + buf * G::STAGE + (G::NMAJ ? 0 : wg_rows);
  const uint32_t bh = sbase + buf * G::STAGE + G::PARTS * G::TILE_A + (G::NMAJ ? wg_rows : 0);
  auto mma = [&](float (&d)[G::NACC], uint32_t a, uint32_t b, int o, int scale_d) {
    const uint64_t da = wg::desc_k_sw128(a + o), db = wg::desc_k_sw128(b + o);
    if constexpr (G::NMAJ) {
      wg::mma<G::MMA_N, !G::X3>(d, db, da, scale_d);
    } else {
      wg::mma<G::MMA_N, !G::X3>(d, da, db, scale_d);
    }
  };
  wg::fence();
  if constexpr (G::X3) {
    wg::fence_regs(part);
    const uint32_t al = ah + G::TILE_A, bl = bh + G::TILE_B;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const int o = 32 * s;
      mma(part, al, bh, o, s > 0);
      mma(part, ah, bl, o, 1);
      mma(part, ah, bh, o, 1);
    }
  } else {
    wg::fence_regs(acc);
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) mma(acc, ah, bh, 32 * s, 1);
  }
  wg::commit();
}

// Waits for the chunk's wgmmas and adds a 3xTF32 chunk's fresh sum to acc
// in IEEE arithmetic.
template <class G>
__device__ __forceinline__ void retire_mmas(float (&acc)[G::NACC], float (&part)[G::NACC]) {
  wg::wait<0>();
  if constexpr (G::X3) {
    wg::fence_regs(part);
#pragma unroll
    for (int i = 0; i < G::NACC; ++i) acc[i] += part[i];
  } else {
    wg::fence_regs(acc);
  }
}

// acc = the sum over nk chunks of A_kc . B_kc^T for this thread block's tile;
// load() brings the next chunk (0, 1, ...) into registers and store(stage)
// stages the last one loaded. Every thread of the block calls it with the
// same nk.
template <class G, class Load, class Store>
__device__ __forceinline__ void k_loop(float (&acc)[G::NACC], uint8_t* sm, int nk, Load&& load,
                                       Store&& store) {
#pragma unroll
  for (int i = 0; i < G::NACC; ++i) acc[i] = 0.f;
  if (nk <= 0) return;
  const uint32_t sbase = wg::smem_addr(sm);
  load();
  store(sm);
  wg::fence_async_smem();
  __syncthreads();

  float part[G::NACC];
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    const bool more = kc + 1 < nk;
    if (more) load();  // chunk kc + 1, in flight during this chunk's wgmmas
    issue_mmas<G>(acc, part, sbase, buf);
    if (more) {  // into the other stage, whose last readers waited before the last barrier
      store(sm + (buf ^ 1) * G::STAGE);
      wg::fence_async_smem();
    }
    retire_mmas<G>(acc, part);
    __syncthreads();
  }
}

// k_loop with the raw ring: issue(slot) starts the cp.async copies of the
// next chunk (0, 1, ...) into raw slot `slot` and commits a group (an empty
// one past the last chunk); convert(slot, stage) stages the raw chunk in
// `slot` from the copies this thread made. Chunk kc's raw slot is kc % 2.
template <class G, class Issue, class Convert>
__device__ __forceinline__ void k_loop_async(float (&acc)[G::NACC], uint8_t* sm, int nk,
                                             Issue&& issue, Convert&& convert) {
#pragma unroll
  for (int i = 0; i < G::NACC; ++i) acc[i] = 0.f;
  if (nk <= 0) return;
  const uint32_t sbase = wg::smem_addr(sm);
  issue(0);
  issue(1);
  mma16::cp_async_wait<1>();  // chunk 0's copies
  convert(0, sm);
  wg::fence_async_smem();
  __syncthreads();

  float part[G::NACC];
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    issue(buf);  // chunk kc + 2, into the slot that chunk kc was converted from
    issue_mmas<G>(acc, part, sbase, buf);
    if (kc + 1 < nk) {  // chunk kc + 1's copies (chunk kc + 2's may still be in flight)
      mma16::cp_async_wait<1>();
      convert(buf ^ 1, sm + (buf ^ 1) * G::STAGE);
      wg::fence_async_smem();
    }
    retire_mmas<G>(acc, part);
    __syncthreads();
  }
}

// f(row, col, v0, v1) for each pair of neighbouring columns (col even) of
// the tile that this thread holds, in wgmma.cuh's accumulator layout.
template <int NACC, class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[NACC], F&& f) {
  const int t = threadIdx.x % 128, w = threadIdx.x / 128;
  const int row0 = 64 * w + 16 * (t / 32) + (t % 32) / 4;
  const int col0 = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f(row0 + 8 * h, col0 + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// p[0] = v0 and, where `two`, p[1] = v1; one 8- or 4-byte store where `two`
// and `pair` (p is 2-element aligned).
__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1, bool two,
                                           bool pair) {
  if (two && pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (two) p[1] = __float2bfloat16_rn(v1);
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<TA>, Tag<TB>) for the dtype codes (0 = float32, 1 = bfloat16) of
// the two operands; cudaErrorInvalidValue for an unknown code.
template <class F>
int with_types(int a_dtype, int b_dtype, F&& f) {
  auto on_b = [&](auto ta) -> int {
    if (b_dtype == 0) return f(ta, Tag<float>{});
    if (b_dtype == 1) return f(ta, Tag<__nv_bfloat16>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (a_dtype == 0) return on_b(Tag<float>{});
  if (a_dtype == 1) return on_b(Tag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(std::bool_constant<X3>{}): 3xTF32 unless both operands are bf16 or the
// tier rounds to bf16.
template <typename TA, typename TB, class F>
int with_tier(bool round_bf16, F&& f) {
  constexpr bool both_bf16 =
      sizeof(TA) == sizeof(__nv_bfloat16) && sizeof(TB) == sizeof(__nv_bfloat16);
  if constexpr (!both_bf16) {
    if (!round_bf16) return f(std::true_type{});
  }
  return f(std::false_type{});
}

// f(Geometry<X3, WGS, 64 WGS, BN>{}) for a row-major tile of an output with
// `rows` rows and `cols` columns a tile (a row-block's or an output
// block's): the tier by with_tier; two warpgroups (128 rows) for more than
// 64 rows, else one; BN 128 for more than 64 columns (two warpgroups only:
// one warpgroup's 128-column 3xTF32 tile stages 8 chunks a thread of B and
// spills), 64 for more than 32, else 32.
template <typename TA, typename TB, class F>
int with_geometry(bool round_bf16, int rows, int cols, F&& f) {
  return with_tier<TA, TB>(round_bf16, [&](auto x3) -> int {
    constexpr bool X3 = decltype(x3)::value;
    auto on_wgs = [&](auto wgs) -> int {
      constexpr int WGS = decltype(wgs)::value;
      constexpr int BM = 64 * WGS;
      if constexpr (WGS == 2) {
        if (cols > 64) return f(Geometry<X3, WGS, BM, 128>{});
      }
      if (cols > 32) return f(Geometry<X3, WGS, BM, 64>{});
      return f(Geometry<X3, WGS, BM, 32>{});
    };
    return rows > 64 ? on_wgs(std::integral_constant<int, 2>{})
                     : on_wgs(std::integral_constant<int, 1>{});
  });
}

}  // namespace wt
