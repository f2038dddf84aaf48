// Block-ELL SpMM executor for NVIDIA Hopper (sm_90a) on the tensor cores
// (wgmma): C = A @ B, where A is given by an inspector plan (block_cols,
// nslots) and its packed values block_vals (nbr * L, bm, bk), and B is
// dense (k, n), row-major.
//
// Replaces the two TPU kernels of tpusparse/kernels/tiled_spmm.py:
//   _executor_kernel (l.43, the DMA-ring executor behind tiled_spmm_pallas)
//   _resident_kernel (l.210, the resident-B-panel executor behind
//                     resident_spmm_pallas).
// Both computed the same thing in the same slot order; the ring and the
// resident panel were answers to the TPU's DMA latency and VMEM size. One
// CUDA kernel serves both entry points, so their outputs are bitwise equal.
//
// Contract, for each row-block i and each valid slot l < nslots[i]:
//   C[i*bm:(i+1)*bm, :] += block_vals[i*L + l] @ B[block_cols[i*L + l]*bk : +bk, :]
// in ascending l. Padded slots (l >= nslots[i]) are skipped; a row-block
// with no slot is written as zeros. Sums are fp32; C is written in its own
// type (fp32 or bf16). Any (bm, bk) is taken; the ragged m, k and n edges
// are masked here, B is never padded or copied. Tiers (never plain TF32):
// 3xTF32 for fp32 'high'/'highest', one bf16 pass for bf16 operand pairs
// and for 'default' (fp32 rounded to bf16, RTN, as staged): wgmma_tiles.cuh.
// Determinism: no atomics and no split over slots; every output element is
// summed by one thread in one fixed order (slots ascending, k ascending),
// so two identical calls give identical bits.
//
// What bounds it. At the 16384^2 headline (10% of the 128x128 blocks
// occupied: 1,669 blocks, 27.3 M nonzeros, n = 512) the work is 28.0 GFLOP:
// 3xTF32's three passes at the H100's 495 TFLOP/s tf32 rate take 0.170 ms,
// against ~176 MB of compulsory traffic (109 MB of block values, 34 MB of
// B, 34 MB of C), 0.053 ms at 3.35 TB/s. The FFMA kernel this replaces
// (bounded at 0.418 ms by 67 TFLOP/s) ran 1.44 ms. On an NVIDIA H100 80GB
// HBM3 at 700 W this kernel runs 0.376 ms (queued; 74 TFLOP/s, 0.45 of the
// bound); the transpose plan's dB 0.380, 'default' 0.179. Of the 0.376,
// the tensor-core loop with its barrier a chunk takes 0.217 (a variant
// with no loads and no shared stores); the staging takes the rest.
//
// Design: gemm.cu's tile, its K loop walking a row-block's slots.
//   - A thread block of WGS warpgroups owns 64 WGS rows of one row-block
//     (WGS = 2 where bm > 64, rows past bm masked) and a BN-column tile of
//     C: BN = 128 where n > 64 (64 for one warpgroup), 64 where n > 32,
//     else 32 (the MLP's n = 32 runs m64n32 products).
//   - The K loop walks the row-block's valid slots in ascending l, each in
//     ceil(bk / 32) chunks of 128 bytes of k (fp32 tiers) or ceil(bk / 64)
//     (bf16), k past bk zero. A's chunk rows are block_vals rows, already
//     K-major: 16-byte loads where bk keeps them aligned. B's chunk is the
//     rows block_cols[slot] * bk + q of (k, n), transposed to K-major as it
//     is staged (a warp reads 32 neighbouring columns at each k).
//   - fp32 operands with bk and n multiples of 4, in tiles of 128 columns
//     (64 for one warpgroup), take the raw ring of wgmma_tiles.cuh: A's
//     rows and B's 16-byte column groups copied by cp.async two chunks
//     ahead, B transposed as each thread converts its own copies (the
//     headline and its dB). Other operands and tiles (the MLP's n = 32)
//     stage through registers.
//   - Row-blocks start in the order of their slot counts, most first
//     (`order`, from the plan), with a row-block's n-tiles together, so the
//     last wave is short and a row-block's values are read from device
//     memory once and from L2 by its other n-tiles.

#include "wgmma_tiles.cuh"

namespace {

using namespace wt;

template <typename TA, typename TB, class G, bool ASYNC>
__global__ void __launch_bounds__(G::NT) block_ell_spmm_kernel(
    const TA* __restrict__ vals,          // (nbr * L, bm, bk)
    const TB* __restrict__ b,             // (k, n)
    void* __restrict__ c, int c_bf16,     // (m, n), fp32 or bf16
    const int* __restrict__ block_cols,   // (nbr * L)
    const int* __restrict__ nslots,       // (nbr)
    const int* __restrict__ order,        // (nbr) row-blocks, most slots first
    int m, int k, int n, int bm, int bk, int L, int m_sub, int n_tiles, int vec_a) {
  using SA = Staged<TA, G::BM, G::NT, G::E>;
  using SB = Staged<TB, G::BN, G::NT, G::E>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);

  const int nt = blockIdx.x % n_tiles;
  const int rs = blockIdx.x / n_tiles;
  const int i = order[rs / m_sub];             // row-block
  const int r0 = (rs % m_sub) * G::BM;         // first row inside the row-block
  const int rows = min(G::BM, bm - r0);        // rows of this slice
  const int n0 = nt * G::BN;

  // The chunks in order: the row-block's valid slots ascending, each in
  // ceil(bk / KC) chunks; the loader walks them with a slot pointer and k0.
  const TA* a_slot = vals + static_cast<size_t>(i) * L * bm * bk + static_cast<size_t>(r0) * bk;
  const int* col = block_cols + static_cast<size_t>(i) * L;
  const TB* b_n0 = b + n0;
  const int nk = nslots[i] * ((bk + G::KC - 1) / G::KC);
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
    static_assert(SB::V == 4, "B's raw chunk in 16-byte column groups");
    const int t = threadIdx.x, q = t / 8, c = t % 8;
    int issued = 0;
    auto issue = [&](int slot) {
      if (issued++ < nk) {
        float* ra = G::raw_a(sm, slot);
#pragma unroll
        for (int p = 0; p < SA::V; ++p) {
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
          const int kq = c * G::E + e, kr = *col * bk + k0 + kq;
          const bool ok = k0 + kq < bk && kr < k && n0 + 4 * q < n;
          mma16::cp_async16(rb + kq * G::BN + 4 * (q ^ c),
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
        int row, cc;
        SA::at(p, KMAJ, row, cc);
        load_vec<G::E>(ra[p], raw + row * G::KC + cc * G::E);
      }
      raw = G::raw_b(sm, slot);
#pragma unroll
      for (int e = 0; e < G::E; ++e) {
        const float4 v =
            *reinterpret_cast<const float4*>(raw + (c * G::E + e) * G::BN + 4 * (q ^ c));
        rb[0][e] = v.x, rb[1][e] = v.y, rb[2][e] = v.z, rb[3][e] = v.w;
      }
      SA::template store<G::X3>(G::a_at(stage, 0), G::a_at(stage, G::PARTS - 1), ra, KMAJ);
      SB::template store<G::X3>(G::b_at(stage, 0), G::b_at(stage, G::PARTS - 1), rb, NGROUP);
    };
    k_loop_async<G>(acc, sm, nk, issue, convert);
  } else {
    float ra[SA::V][G::E], rb[SB::V][G::E];
    auto load = [&]() {
      SA::load_k(ra, a_slot + k0, bk, rows, bk - k0, vec_a != 0);
      const int kr = *col * bk + k0;
      SB::load_n(rb, b_n0 + static_cast<size_t>(kr) * n, n, n - n0, min(bk - k0, k - kr));
      next();
    };
    auto store = [&](uint8_t* stage) {
      SA::template store<G::X3>(G::a_at(stage, 0), G::a_at(stage, G::PARTS - 1), ra, KMAJ);
      SB::template store<G::X3>(G::b_at(stage, 0), G::b_at(stage, G::PARTS - 1), rb, NMAJ);
    };
    k_loop<G>(acc, sm, nk, load, store);
  }

  const int row0 = i * bm + r0;
  const bool pair = n % 2 == 0;
  for_pairs(acc, [&](int r, int cl, float v0, float v1) {
    const int grow = row0 + r, gc = n0 + cl;
    if (r >= rows || grow >= m || gc >= n) return;
    const size_t off = static_cast<size_t>(grow) * n + gc;
    if (c_bf16) {
      store_pair(static_cast<__nv_bfloat16*>(c) + off, v0, v1, gc + 1 < n, pair);
    } else {
      store_pair(static_cast<float*>(c) + off, v0, v1, gc + 1 < n, pair);
    }
  });
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16. order (nbr) int32: the row-blocks by slot count, most
// first. Launches on `stream` (PyTorch's current stream) and does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int block_ell_spmm(const void* vals, int vals_dtype, const void* b, int b_dtype,
                              void* c, int c_dtype, const void* block_cols, const void* nslots,
                              const void* order, int m, int k, int n, int bm, int bk, int nbr,
                              int L, int round_bf16, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || L <= 0 ||
      (c_dtype != 0 && c_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = with_types(vals_dtype, b_dtype, [&](auto ta, auto tb) -> int {
    using TA = typename decltype(ta)::type;
    using TB = typename decltype(tb)::type;
    return with_geometry<TA, TB>(round_bf16 != 0, bm, n, [&](auto g) -> int {
      using G = decltype(g);
      const int m_sub = (bm + G::BM - 1) / G::BM;
      const int n_tiles = (n + G::BN - 1) / G::BN;
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
            static_cast<const int*>(block_cols), static_cast<const int*>(nslots),
            static_cast<const int*>(order), m, k, n, bm, bk, L, m_sub, n_tiles, vec_a);
        return 0;
      };
      // the raw ring: fp32 operands in 16-byte groups (A's rows, B's
      // columns), a B tile of 16-byte column groups, one a thread and chunk
      if constexpr (std::is_same_v<TA, float> && std::is_same_v<TB, float> &&
                    G::BN * 2 == G::NT) {
        if (bk % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(b) % 16 == 0) {
          return run(block_ell_spmm_kernel<TA, TB, G, true>, G::SMEM_ASYNC);
        }
      }
      return run(block_ell_spmm_kernel<TA, TB, G, false>, G::SMEM);
    });
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
