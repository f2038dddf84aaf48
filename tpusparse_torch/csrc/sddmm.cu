// Block-pattern SDDMM for NVIDIA Hopper (sm_90a) on the tensor cores
// (wgmma): for every ELL slot of an inspector plan, the dense (bm, bk)
// block of dC @ B^T that the slot's block of A occupies. This is the
// dA = dC @ B^T gradient of C = A @ B, restricted to A's block pattern.
//
// Replaces the TPU kernel tpusparse/kernels/sddmm.py:35 _sddmm_kernel
// (pallas_call l.114, behind sddmm_pallas). The TPU kernel walked a
// sequential (row-block, slot, n-tile) grid and carried the sum over n-tiles
// in a VMEM scratch; here a thread block owns one output tile of a slot and
// a range of n, so nothing carries between blocks, and a second pass adds
// the ranges' partial tiles where n is split.
//
// Contract. Inputs: block_cols (nbr * L) and nslots (nbr) from the plan,
// dC (m, n) and B (k, n), row-major. Output out (nbr * L, bm, bk) in dC's
// type (fp32 or bf16). For each row-block i and each valid slot
// l < nslots[i], with s = i * L + l:
//   out[s] = dC[i*bm : i*bm + bm, :] @ B[block_cols[s]*bk : +bk, :]^T
// summed over n in fp32. Pad slots (l >= nslots[i]) are exactly 0, and so
// are the rows past m and the columns past k inside a block (the TPU
// wrapper zero-pads dC and B, sddmm.py:81-84); here those edges are masked
// in the loads, and dC and B are never padded or copied. Tiers (never plain
// TF32): 3xTF32 for fp32 'high'/'highest', one bf16 pass for bf16 operand
// pairs and for 'default' (fp32 rounded to bf16, RTN, as staged):
// wgmma_tiles.cuh. Determinism: no atomics. A tile's range of n is summed
// in ascending chunks by one thread an element, and the S ranges' partials
// are added in ascending range order, so for a given S runs repeat bit for
// bit.
//
// What bounds it. At the 16384^2 headline (1,669 blocks of 128x128,
// n = 512) the work is 2 * nblocks * bm * bk * n = 28.0 GFLOP: 3xTF32 at
// the H100's 495 TFLOP/s tf32 rate takes 0.170 ms, against ~176 MB of
// compulsory traffic (34 MB dC, 34 MB B, 109 MB of written blocks), 0.053
// ms at 3.35 TB/s. bert4d's batched dA folds the batch into n (16 blocks
// of 128x128, n = 4096 * 64 = 262,144): 137 GFLOP, 0.833 ms on 3xTF32. The
// FFMA kernel this replaces ran 1.19 ms at the headline and 41.3 ms at
// bert4d (64 thread blocks on 132 SMs); on an NVIDIA H100 80GB HBM3 at
// 700 W this kernel runs 0.436 ms queued at the headline (64 TFLOP/s, 0.39
// of the bound; 16-chunk tiles, so each tile's prologue and store weigh
// more than in the SpMM) and 1.76 ms at bert4d (S = 33, 78 TFLOP/s, 0.47).
//
// Design: gemm.cu's tile with transb set.
//   - A thread block of WGS warpgroups owns 64 WGS rows (WGS = 2 where
//     bm > 64) and BN columns of one slot's block (BN = 128 where bk > 64,
//     64 for one warpgroup; 64 where bk > 32, else 32); its K loop walks n
//     in chunks of 128 bytes. Both operands run along n: fp32 ones with n a
//     multiple of 4 take the raw ring of wgmma_tiles.cuh (cp.async two
//     chunks ahead), others the 16-byte loads where n keeps their rows
//     aligned.
//   - Pad slots load nothing; they write zeros (or leave them to the
//     second pass).
//   - The split over n: where the valid tiles cannot fill the card, the
//     wrapper asks for S > 1 ranges (kernels/sddmm.py `sddmm_splits`). Range
//     s covers the 64-value units [s U / S, (s + 1) U / S) of n, U = ceil(n /
//     64). Each thread block writes its fp32 partial tile to a workspace
//     (S, nbr * L, bm, bk); `sddmm_reduce_kernel` then adds the S partials
//     of each element in ascending s and writes out, zeros at pad slots.

#include <algorithm>

#include "wgmma_tiles.cuh"

namespace {

using namespace wt;

constexpr int SPLIT_UNIT = 64;  // n-values a unit of a split range

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TD, typename TB, class G, bool ASYNC>
__global__ void __launch_bounds__(G::NT) sddmm_kernel(
    const TD* __restrict__ dc,            // (m, n)
    const TB* __restrict__ b,             // (k, n)
    TD* __restrict__ out,                 // (nbr * L, bm, bk)
    float* __restrict__ ws,               // (splits, nbr * L, bm, bk) where splits > 1
    const int* __restrict__ block_cols,   // (nbr * L)
    const int* __restrict__ nslots,       // (nbr)
    int m, int k, int n, int bm, int bk, int L, int num_slots, int m_sub, int c_sub,
    int splits, int vec_d, int vec_b) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);

  int id = blockIdx.x;
  const int split = id % splits;
  id /= splits;
  const int cs = id % c_sub;
  id /= c_sub;
  const int ms = id % m_sub;
  const int slot = id / m_sub;
  const int i = slot / L;
  const int r0 = ms * G::BM, c0 = cs * G::BN;  // the tile's first row and column in the block
  const int rows = min(G::BM, bm - r0), cols = min(G::BN, bk - c0);
  const size_t blk = static_cast<size_t>(bm) * bk;
  const bool valid = slot % L < nslots[i];
  if (!valid) {  // pad slots: zeros, here or in the second pass
    if (splits == 1) {
      TD* o = out + slot * blk;
      for (int e = threadIdx.x; e < G::BM * G::BN; e += G::NT) {
        const int r = e / G::BN, q = e % G::BN;
        if (r < rows && q < cols) store1(&o[static_cast<size_t>(r0 + r) * bk + c0 + q], 0.f);
      }
    }
    return;
  }

  const int units = (n + SPLIT_UNIT - 1) / SPLIT_UNIT;
  const int row0 = i * bm + r0;                 // first dC row of the tile
  const int col0 = block_cols[slot] * bk + c0;  // first B row of the tile
  const int n_lo = static_cast<int>(static_cast<long long>(split) * units / splits) * SPLIT_UNIT;
  const int n_hi =
      min(n, static_cast<int>(static_cast<long long>(split + 1) * units / splits) * SPLIT_UNIT);
  const int drows = min(rows, m - row0);  // rows inside the block and the matrix
  const int brows = min(cols, k - col0);
  using SA = Staged<TD, G::BM, G::NT, G::E>;
  using SB = Staged<TB, G::BN, G::NT, G::E>;
  const TD* d_at = dc + static_cast<size_t>(row0) * n + n_lo;  // the next chunk's first value
  const TB* b_at = b + static_cast<size_t>(col0) * n + n_lo;
  int left = n_hi - n_lo;                                      // n-values from there on
  const int nk = (n_hi - n_lo + G::KC - 1) / G::KC;
  float acc[G::NACC];
  if constexpr (ASYNC) {
    // fp32 operands, n a multiple of 4, 16-byte aligned: both raw chunks
    // are rows along n, copied and converted in the KMAJ places
    int issued = 0;
    // x: the chunk's first value, base: a valid address for the copies
    // that read nothing (zero-filled rows and n past the range)
    auto copy = [&](auto tag, float* raw, const float* x, const float* base, int nrows) {
      using S = typename decltype(tag)::type;
#pragma unroll
      for (int p = 0; p < S::V; ++p) {
        int row, cc;
        S::at(p, KMAJ, row, cc);
#pragma unroll
        for (int h = 0; h < G::E / 4; ++h) {
          const int kk = cc * G::E + 4 * h;
          const bool ok = row < nrows && kk < left;
          mma16::cp_async16(raw + row * G::KC + kk,
                            ok ? x + static_cast<size_t>(row) * n + kk : base, ok ? 16 : 0);
        }
      }
    };
    auto issue = [&](int slot) {
      if (issued++ < nk) {
        copy(Tag<SA>{}, G::raw_a(sm, slot), d_at, dc, drows);
        copy(Tag<SB>{}, G::raw_b(sm, slot), b_at, b, brows);
        d_at += G::KC, b_at += G::KC, left -= G::KC;
      }
      mma16::cp_async_commit();
    };
    auto convert = [&](int slot, uint8_t* stage) {
      float ra[SA::V][G::E], rb[SB::V][G::E];
      auto back = [&](auto tag, auto& r, const float* raw) {
        using S = typename decltype(tag)::type;
#pragma unroll
        for (int p = 0; p < S::V; ++p) {
          int row, cc;
          S::at(p, KMAJ, row, cc);
          load_vec<G::E>(r[p], raw + row * G::KC + cc * G::E);
        }
      };
      back(Tag<SA>{}, ra, G::raw_a(sm, slot));
      back(Tag<SB>{}, rb, G::raw_b(sm, slot));
      SA::template store<G::X3>(G::a_at(stage, 0), G::a_at(stage, G::PARTS - 1), ra, KMAJ);
      SB::template store<G::X3>(G::b_at(stage, 0), G::b_at(stage, G::PARTS - 1), rb, KMAJ);
    };
    k_loop_async<G>(acc, sm, nk, issue, convert);
  } else {
    float ra[SA::V][G::E], rb[SB::V][G::E];
    auto load = [&]() {
      SA::load_k(ra, d_at, n, drows, left, vec_d != 0);
      SB::load_k(rb, b_at, n, brows, left, vec_b != 0);
      d_at += G::KC, b_at += G::KC, left -= G::KC;
    };
    auto store = [&](uint8_t* stage) {
      SA::template store<G::X3>(G::a_at(stage, 0), G::a_at(stage, G::PARTS - 1), ra, KMAJ);
      SB::template store<G::X3>(G::b_at(stage, 0), G::b_at(stage, G::PARTS - 1), rb, KMAJ);
    };
    k_loop<G>(acc, sm, nk, load, store);
  }

  const bool pair = bk % 2 == 0;
  if (splits == 1) {
    TD* o = out + slot * blk;
    for_pairs(acc, [&](int r, int q, float v0, float v1) {
      if (r >= rows || q >= cols) return;
      store_pair(o + static_cast<size_t>(r0 + r) * bk + c0 + q, v0, v1, q + 1 < cols, pair);
    });
  } else {
    float* o = ws + (static_cast<size_t>(split) * num_slots + slot) * blk;
    for_pairs(acc, [&](int r, int q, float v0, float v1) {
      if (r >= rows || q >= cols) return;
      store_pair(o + static_cast<size_t>(r0 + r) * bk + c0 + q, v0, v1, q + 1 < cols, pair);
    });
  }
}

// out[e] = ws[0][e] + ws[1][e] + ... + ws[splits - 1][e], added in that
// order, for the elements of valid slots; 0 at pad slots.
template <typename TD>
__global__ void __launch_bounds__(256) sddmm_reduce_kernel(
    const float* __restrict__ ws, TD* __restrict__ out, const int* __restrict__ nslots,
    int L, size_t blk, size_t total, int splits) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t slot = e / blk;
    float v = 0.f;
    if (static_cast<int>(slot % L) < nslots[slot / L]) {
      v = ws[e];
      for (int s = 1; s < splits; ++s) v += ws[static_cast<size_t>(s) * total + e];
    }
    store1(out + e, v);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16; the output has dC's type. splits >= 1 ranges of n; where
// splits > 1, ws is an fp32 workspace of splits * nbr * L * bm * bk values
// and a second kernel adds its partials (one launch of this entry). Launches
// on `stream` (PyTorch's current stream) and does not synchronise; returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int sddmm(const void* dc, int dc_dtype, const void* b, int b_dtype, void* out,
                     void* ws, const void* block_cols, const void* nslots, int m, int k, int n,
                     int bm, int bk, int nbr, int L, int splits, int round_bf16, int device,
                     void* stream) {
  const long long num_slots = static_cast<long long>(nbr) * L;
  if (m <= 0 || k <= 0 || n <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || L <= 0 ||
      num_slots > 2147483647LL || splits < 1 ||
      static_cast<long long>(splits) > (n + SPLIT_UNIT - 1) / SPLIT_UNIT ||
      (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = with_types(dc_dtype, b_dtype, [&](auto td, auto tb) -> int {
    using TD = typename decltype(td)::type;
    using TB = typename decltype(tb)::type;
    return with_geometry<TD, TB>(round_bf16 != 0, bm, bk, [&](auto g) -> int {
      using G = decltype(g);
      const int m_sub = (bm + G::BM - 1) / G::BM;
      const int c_sub = (bk + G::BN - 1) / G::BN;
      const long long blocks = num_slots * m_sub * c_sub * splits;
      if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
      // 16-byte loads along n: whole chunks of E values, every row aligned
      auto vec = [n](const void* p, size_t size) {
        return n % G::E == 0 && (static_cast<size_t>(n) * size) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(p) % 16 == 0;
      };
      auto run = [&](auto kern, int smem) -> int {
        cudaError_t e =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        kern<<<static_cast<unsigned>(blocks), G::NT, smem, s>>>(
            static_cast<const TD*>(dc), static_cast<const TB*>(b), static_cast<TD*>(out),
            static_cast<float*>(ws), static_cast<const int*>(block_cols),
            static_cast<const int*>(nslots), m, k, n, bm, bk, L, static_cast<int>(num_slots),
            m_sub, c_sub, splits, vec(dc, sizeof(TD)), vec(b, sizeof(TB)));
        return 0;
      };
      int rc = -1;
      if constexpr (std::is_same_v<TD, float> && std::is_same_v<TB, float>) {
        if (n % 4 == 0 && reinterpret_cast<uintptr_t>(dc) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(b) % 16 == 0) {  // the raw ring
          rc = run(sddmm_kernel<TD, TB, G, true>, G::SMEM_ASYNC);
        }
      }
      if (rc < 0) rc = run(sddmm_kernel<TD, TB, G, false>, G::SMEM);
      if (rc != 0) return rc;
      if (splits > 1) {
        const size_t blk = static_cast<size_t>(bm) * bk;
        const size_t total = static_cast<size_t>(num_slots) * blk;
        const size_t grid = std::min<size_t>((total + 255) / 256, 132 * 16);
        sddmm_reduce_kernel<TD><<<static_cast<unsigned>(grid), 256, 0, s>>>(
            static_cast<const float*>(ws), static_cast<TD*>(out),
            static_cast<const int*>(nslots), L, blk, total, splits);
      }
      return 0;
    });
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
