// The block SpMM body for NVIDIA Hopper (sm_90a) on the tensor cores
// (wgmma), shared by three C entry points, each an instance of it:
//   block_ell_spmm.cu          an ELL plan, B (k, n)           (rows 1-2)
//   block_ell_spmm_batched.cu  an ELL plan, B (batch, k, n)    (row 3)
//   block_ell_spmm_compact.cu  a compact plan, B (k, n)        (row 6)
// C = A @ B, A given by a plan and its packed values (slots, bm, bk); B and
// C row-major, C (batch, m, n) in fp32 or bf16.
//
// Contract, for each batch element g, row-block i and each of its slots s
// in ascending order:
//   C[g, i*bm : (i+1)*bm, :] += vals[s] @ B[g, cols[s]*bk : +bk, :]
// where a walk names row-block i's slots, always a contiguous run of the
// values and of `cols`: the ELL walk (`EllWalk`) the slots i*L .. i*L +
// nslots[i] - 1, pad slots skipped; the compact walk (`CompactWalk`)
// row_base[i] .. row_base[i+1] - 1. The compact plan keeps the ELL plan's
// ascending column order, and one chooser picks the tile from bm and the
// (folded) width, so on the same operands the entry points give the same
// bits: row 3 on B is row 1 on B folded to (k, batch n), row 6 on its plan
// is row 1 on the plan it came from. A row-block with no slot is written as
// zeros. Sums are fp32. Any (bm, bk) is taken; the ragged m, k and n edges
// are masked here, B is never padded or copied. Tiers (never plain TF32):
// 3xTF32 for fp32 'high'/'highest', one bf16 pass for bf16 operand pairs
// and for 'default' (fp32 rounded to bf16, RTN, as staged): wgmma_tiles.cuh.
// Determinism: no atomics and no split over slots; every output element is
// summed by one thread in one fixed order (slots ascending, then k
// ascending), so two identical calls give identical bits.
//
// Design: gemm.cu's tile, its K loop walking a row-block's slots.
//   - Row-blocks of 57 rows or more: a thread block of WGS warpgroups owns
//     64 WGS rows of one row-block (WGS = 2 where bm > 64, rows past bm
//     masked) and a BN-column tile of C: BN = 128 where n > 64 (two
//     warpgroups), 64 where n > 32, else 32.
//   - Row-blocks of at most NMAJOR_MAX_BM rows: the n-major tile. A
//     64-row product tile would spend 64 - bm of its rows on nothing (7/8 of
//     it at bm 8), so one warpgroup computes C's transpose, 64 columns of C
//     on wgmma's 64-row side and the row-block's bm rows, rounded up to a
//     multiple of 8, on its N side (m64n8 .. m64n48). The staging is the
//     same: A's rows and B's columns, both K-major; the two tiles only swap
//     their places in the product, and the store writes the transpose back.
//   - The K loop walks the row-block's slots in ascending order, each in
//     ceil(bk / 32) chunks of 128 bytes of k (fp32 tiers) or ceil(bk / 64)
//     (bf16), k past bk zero. A's chunk rows are value rows, already
//     K-major: 16-byte loads where bk keeps them aligned. B's chunk is the
//     rows cols[slot] * bk + q of B[g], transposed to K-major as it is
//     staged.
//   - fp32 operands with bk and n multiples of 4, in tiles of 128 columns
//     (64 for one warpgroup, the n-major tile's among them), take the raw
//     ring of wgmma_tiles.cuh: A's rows and B's 16-byte column groups
//     copied by cp.async two chunks ahead, B transposed as each thread
//     converts its own copies. Other operands and tiles stage through
//     registers.
//   - Row-blocks start in the order of their slot counts, most first
//     (`order`, from the plan), with a row-block's n-tiles together, so the
//     last wave is short and a row-block's values are read from device
//     memory once and from L2 by its other n-tiles.
//   - A batch of B is folded into columns, (k, batch n), inside the kernel:
//     column J of a tile is column J % n of B[J / n], read and written in
//     place at B's and C's strides, so the tiles are those of the 2-D
//     executor on the folded operand, with no transposing copy, in the same
//     order (a row-block's n-tiles of every batch element together: an
//     n-tile's row-blocks together, or a batch element's at a time, ran
//     slower at the block-sparse batched shape on an NVIDIA H100 80GB HBM3
//     at 700 W, and no faster at bert4d's).

#pragma once

#include "wgmma_tiles.cuh"

namespace wt {

// Row-blocks of at most this many rows take the n-major tile, the rest the
// 64-row tile. On an NVIDIA H100 80GB HBM3 at 700 W (4096^2 at 1 %, n 256)
// the n-major tile ran 1.1-1.7x faster than the 64-row tile at bm 8, 16, 32
// and 48, and slower at bm 56.
constexpr int NMAJOR_MAX_BM = 48;

// The slots of row-block i: first .. first + count - 1 of the values and of
// `cols`, from the walk's index array.
struct EllWalk {  // index: nslots (nbr); L slots a row-block
  __device__ static void range(const int* __restrict__ index, int L, int i, int& first,
                               int& count) {
    first = i * L;
    count = index[i];
  }
};

struct CompactWalk {  // index: row_base (nbr + 1)
  __device__ static void range(const int* __restrict__ index, int, int i, int& first,
                               int& count) {
    first = index[i];
    count = index[i + 1] - first;
  }
};

__device__ __forceinline__ void store_one(void* c, int c_bf16, size_t off, float v) {
  if (c_bf16) {
    static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(c)[off] = v;
  }
}

template <typename TA, typename TB, class G, bool ASYNC, class W, bool FOLD>
__global__ void __launch_bounds__(G::NT) block_spmm_kernel(
    const TA* __restrict__ vals,          // (slots, bm, bk)
    const TB* __restrict__ b,             // (batch, k, n)
    void* __restrict__ c, int c_bf16,     // (batch, m, n), fp32 or bf16
    const int* __restrict__ cols,         // (slots) column-block of each slot
    const int* __restrict__ index,        // the walk's: nslots or row_base
    const int* __restrict__ order,        // (nbr) row-blocks, most slots first
    int m, int k, int n, int nf, int bm, int bk, int L, int m_sub, int n_tiles, int vec_a) {
  using SA = Staged<TA, G::BM, G::NT, G::E>;
  using SB = Staged<TB, G::BN, G::NT, G::E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);

  const int nt = blockIdx.x % n_tiles;
  const int rs = blockIdx.x / n_tiles;
  const int i = order[rs / m_sub];             // row-block
  const int r0 = (rs % m_sub) * G::BM;         // first row inside the row-block
  const int rows = min(G::BM, bm - r0);        // rows of this slice
  const int n0 = nt * G::BN;                   // first column of the (folded) tile
  // Column J < nf of the folded operand is column J % n of batch element
  // J / n: its offset in row 0 of B (height k) or C (height m).
  auto col_at = [&](int J, int height) -> size_t {
    if constexpr (FOLD) return static_cast<size_t>(J / n) * height * n + J % n;
    return static_cast<size_t>(J);
  };

  // The chunks in order: the row-block's slots ascending, each in
  // ceil(bk / KC) chunks; the loader walks them with a slot pointer and k0.
  int first, count;
  W::range(index, L, i, first, count);
  const TA* a_slot = vals + static_cast<size_t>(first) * bm * bk + static_cast<size_t>(r0) * bk;
  const int* col = cols + first;
  const int nk = count * ((bk + G::KC - 1) / G::KC);
  int k0 = 0;
  auto next = [&]() {
    k0 += G::KC;
    if (k0 >= bk) {
      k0 = 0;
      a_slot += static_cast<size_t>(bm) * bk;
      ++col;
    }
  };
  float acc[G::NACC];
  if constexpr (ASYNC) {
    // fp32 operands, bk and n multiples of 4, 16-byte aligned. The raw
    // chunk: A's rows as they are (KMAJ), B's KC rows of BN columns, the
    // 16-byte column group q of raw row kq at group q ^ (kq / E % 8), so
    // that the 8 threads that read one group's E rows each hit other banks.
    // A group lies in one batch element, since n % 4 == 0.
    static_assert(SB::V == 4, "B's raw chunk in 16-byte column groups");
    const int t = threadIdx.x, q = t / 8, c8 = t % 8;
    // b_n0 + 4 q is the first column of the thread's group q (b + n0 + 4 q
    // in a batch of one). Each copy's source is b_n0 plus an offset, or b_n0
    // itself, and a batch of one guards on n: with a choice between two
    // pointers there, or the guard on nf, the 64-row tile ran 11-16 %
    // slower at bm 56 and the n-major tile up to 24 % slower at bm 48 (an
    // NVIDIA H100 80GB HBM3 at 700 W).
    const bool q_in = n0 + 4 * q < nf;
    const TB* b_n0 = FOLD ? b + (q_in ? col_at(n0 + 4 * q, k) - 4 * q : 0) : b + n0;
    int issued = 0;
    auto issue = [&](int slot) {
      if (issued++ < nk) {
        float* ra = G::raw_a(sm, slot);
#pragma unroll
        for (int p = 0; p < SA::V; ++p) {
          if (!SA::has(p)) continue;
          int row, cc;
          SA::at(p, KMAJ, row, cc);
#pragma unroll
          for (int h = 0; h < G::E / 4; ++h) {
            const int kk = k0 + cc * G::E + 4 * h;
            const bool ok = row < rows && kk < bk;
            mma16::cp_async16(ra + row * G::KC + cc * G::E + 4 * h,
                              ok ? a_slot + static_cast<size_t>(row) * bk + kk : a_slot,
                              ok ? 16 : 0);
          }
        }
        float* rb = G::raw_b(sm, slot);
#pragma unroll
        for (int e = 0; e < G::E; ++e) {
          const int kq = c8 * G::E + e, kr = *col * bk + k0 + kq;
          const bool ok = k0 + kq < bk && kr < k && n0 + 4 * q < (FOLD ? nf : n);
          mma16::cp_async16(rb + kq * G::BN + 4 * (q ^ c8),
                            ok ? b_n0 + static_cast<size_t>(kr) * n + 4 * q : b_n0,
                            ok ? 16 : 0);
        }
        next();
      }
      mma16::cp_async_commit();
    };
    auto convert = [&](int slot, uint8_t* stage) {
      const float* raw = G::raw_a(sm, slot);
      float ra[SA::V][G::E], rb[SB::V][G::E];
#pragma unroll
      for (int p = 0; p < SA::V; ++p) {
        if (!SA::has(p)) continue;
        int row, cc;
        SA::at(p, KMAJ, row, cc);
        load_vec<G::E>(ra[p], raw + row * G::KC + cc * G::E);
      }
      raw = G::raw_b(sm, slot);
#pragma unroll
      for (int e = 0; e < G::E; ++e) {
        const float4 v =
            *reinterpret_cast<const float4*>(raw + (c8 * G::E + e) * G::BN + 4 * (q ^ c8));
        rb[0][e] = v.x, rb[1][e] = v.y, rb[2][e] = v.z, rb[3][e] = v.w;
      }
      SA::template store<G::X3>(G::a_at(stage, 0), G::a_at(stage, G::PARTS - 1), ra, KMAJ);
      SB::template store<G::X3>(G::b_at(stage, 0), G::b_at(stage, G::PARTS - 1), rb, NGROUP);
    };
    k_loop_async<G>(acc, sm, nk, issue, convert);
  } else {
    float ra[SA::V][G::E], rb[SB::V][G::E];
    size_t off[SB::V];  // the offsets of the thread's B columns (NMAJ rows) along a row
#pragma unroll
    for (int p = 0; p < SB::V; ++p) {
      int row, cc;
      SB::at(p, NMAJ, row, cc);
      off[p] = n0 + row < nf ? col_at(n0 + row, k) : 0;
    }
    auto load = [&]() {
      SA::load_k(ra, a_slot + k0, bk, rows, bk - k0, vec_a != 0);
      const int kr = *col * bk + k0;
      SB::load_n(rb, b + static_cast<size_t>(kr) * n, n, off, nf - n0, min(bk - k0, k - kr));
      next();
    };
    auto store = [&](uint8_t* stage) {
      SA::template store<G::X3>(G::a_at(stage, 0), G::a_at(stage, G::PARTS - 1), ra, KMAJ);
      SB::template store<G::X3>(G::b_at(stage, 0), G::b_at(stage, G::PARTS - 1), rb, NMAJ);
    };
    k_loop<G>(acc, sm, nk, load, store);
  }

  const int row0 = i * bm + r0;
  const int lane = threadIdx.x % 128;
  if constexpr (G::NMAJ) {  // the tile holds C's transpose: (column, row) pairs of rows
    // the thread's two columns, cl0 and cl0 + 8 (for_pairs's layout)
    const int cl0 = 64 * (threadIdx.x / 128) + 16 * (lane / 32) + lane % 32 / 4;
    const size_t at0 = col_at(min(n0 + cl0, nf - 1), m), at8 = col_at(min(n0 + cl0 + 8, nf - 1), m);
    for_pairs(acc, [&](int cl, int r, float v0, float v1) {
      if (n0 + cl >= nf) return;
      const size_t off = (cl == cl0 ? at0 : at8) + static_cast<size_t>(row0 + r) * n;
      if (r < rows && row0 + r < m) store_one(c, c_bf16, off, v0);
      if (r + 1 < rows && row0 + r + 1 < m) store_one(c, c_bf16, off + n, v1);
    });
  } else {
    // (J, J + 1) are neighbours in one batch element where n is even. A
    // tile inside one batch element (every tile without FOLD) stores at
    // offsets linear in its columns; one across batch elements keeps a
    // cursor: the pairs come in ascending groups of 8 columns, and column
    // cl_at is column jj of batch element gg (no division a pair).
    const bool pair = n % 2 == 0;
    const bool linear = !FOLD || n0 % n + G::BN <= n;
    const size_t c_lin = col_at(n0, m);  // column n0's offset in row 0
    int cl_at = 2 * (lane % 4), jj = n0 + cl_at;
    size_t gg = 0;
    if constexpr (FOLD) gg = jj / n, jj %= n;
    for_pairs(acc, [&](int r, int cl, float v0, float v1) {
      if (FOLD && !linear) {
        for (; cl_at < cl; cl_at += 8) {
          for (jj += 8; jj >= n; jj -= n) ++gg;
        }
      }
      const int grow = row0 + r, J = n0 + cl;
      if (r >= rows || grow >= m || J >= nf) return;
      const size_t off = linear ? c_lin + static_cast<size_t>(grow) * n + cl
                                : (gg * m + grow) * n + jj;
      const bool two = J + 1 < nf;
      if (!pair && two && !linear) {  // J + 1 may start the next batch element
        store_one(c, c_bf16, off, v0);
        store_one(c, c_bf16, jj + 1 == n ? ((gg + 1) * m + grow) * n : off + 1, v1);
      } else if (c_bf16) {
        store_pair(static_cast<__nv_bfloat16*>(c) + off, v0, v1, two, pair);
      } else {
        store_pair(static_cast<float*>(c) + off, v0, v1, two, pair);
      }
    });
  }
}

// f(G{}) for the tile of a row-block of bm rows and a B of n columns: the
// n-major tile of one warpgroup at bm <= NMAJOR_MAX_BM, its N side bm
// rounded up to 8; else with_geometry's row-major tile. The tier by
// with_tier.
template <typename TA, typename TB, class F>
int with_spmm_geometry(bool round_bf16, int bm, int n, F&& f) {
  static_assert(NMAJOR_MAX_BM <= 48, "n-major tiles up to N 48");
  if (bm > NMAJOR_MAX_BM) {
    return with_geometry<TA, TB>(round_bf16, bm, n, f);
  }
  return with_tier<TA, TB>(round_bf16, [&](auto x3) -> int {
    constexpr bool X3 = decltype(x3)::value;
    switch ((bm + 7) / 8) {
      case 1: return f(Geometry<X3, 1, 8, 64, true>{});
      case 2: return f(Geometry<X3, 1, 16, 64, true>{});
      case 3: return f(Geometry<X3, 1, 24, 64, true>{});
      case 4: return f(Geometry<X3, 1, 32, 64, true>{});
      case 5: return f(Geometry<X3, 1, 40, 64, true>{});
      default: return f(Geometry<X3, 1, 48, 64, true>{});
    }
  });
}

// Launches W's kernel on `stream` for `batch` elements of B (k, n) and C
// (m, n); does not synchronise. FOLD (the batched entry point): the tiles
// run over the batch folded into columns, (k, batch n), in place (a tile
// may span two batch elements); else batch is 1, and the kernel is built
// without the fold's column arithmetic and its second store path (with
// them, a batch of one ran 2 % slower at the 16384^2 headline and 12 %
// slower at the MLP's n = 32 on an NVIDIA H100 80GB HBM3 at 700 W).
// Returns cudaGetLastError() after the launch (0 = launched).
template <class W, bool FOLD>
int launch_block_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype, void* c,
                      int c_dtype, const void* cols, const void* index, const void* order,
                      int batch, int m, int k, int n, int bm, int bk, int nbr, int L,
                      int round_bf16, int device, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 ||
      (c_dtype != 0 && c_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nf = static_cast<long long>(batch) * n;  // columns of the folded B
  if (nf > 2147483647LL || (!FOLD && batch != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = with_types(vals_dtype, b_dtype, [&](auto ta, auto tb) -> int {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    return with_spmm_geometry<TA, TB>(round_bf16 != 0, bm, static_cast<int>(nf),
                                      [&](auto geo) -> int {
      using G = decltype(geo);
      const int m_sub = (bm + G::BM - 1) / G::BM;
      const int n_tiles = static_cast<int>((nf + G::BN - 1) / G::BN);
      const long long blocks = static_cast<long long>(nbr) * m_sub * n_tiles;
      if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
      // 16-byte loads of A's rows: whole chunks of E values, every row aligned
      const bool vec_a = bk % G::E == 0 && (static_cast<size_t>(bk) * sizeof(TA)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(vals) % 16 == 0;
      auto run = [&](auto kern, int smem) -> int {
        cudaError_t e =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        kern<<<static_cast<unsigned>(blocks), G::NT, smem, s>>>(
            static_cast<const TA*>(vals), static_cast<const TB*>(b), c, c_dtype,
            static_cast<const int*>(cols), static_cast<const int*>(index),
            static_cast<const int*>(order), m, k, n, static_cast<int>(nf), bm, bk, L, m_sub,
            n_tiles, vec_a);
        return 0;
      };
      // the raw ring: fp32 operands in 16-byte groups (A's rows, B's
      // columns), a B tile of 16-byte column groups, one a thread and chunk
      // (4- and 8-byte groups for narrower tiles ran slower than the
      // staging through registers)
      if constexpr (std::is_same_v<TA, float> && std::is_same_v<TB, float> &&
                    G::BN * 2 == G::NT) {
        if (bk % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(b) % 16 == 0) {
          return run(block_spmm_kernel<TA, TB, G, true, W, FOLD>, G::SMEM_ASYNC);
        }
      }
      return run(block_spmm_kernel<TA, TB, G, false, W, FOLD>, G::SMEM);
    });
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wt
