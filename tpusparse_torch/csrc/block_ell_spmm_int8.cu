// int8 block-ELL SpMM executor for NVIDIA Hopper (sm_90a), the serving
// tier's w8a8 product: C = (sum_l s_a[l] * (Qa[l] @ Qb[col_l])) * t.
//
// Replaces the two TPU kernels of tpusparse/kernels/tiled_spmm.py:
//   _resident_int8_kernel (l.643, pallas_call l.804, behind
//                          resident_spmm_int8_pallas)
//   _tiled_int8_kernel    (l.845, pallas_call l.994, behind
//                          tiled_spmm_int8_pallas)
// The two differ only in how the TPU fed B (a resident VMEM panel or a DMA
// ring); they consume the slots in the same order and are bitwise equal.
// One CUDA entry point serves both, so theirs are too.
//
// Contract, for each row-block i and each valid slot l < nslots[i]
// (padded slots are skipped; their scale is 0 as well):
//   P_l  = qvals[i*L + l] @ b_q[block_cols[i*L + l]*bk : +bk, :]   exact int32
//   acc  = acc + s_a[i*L + l] * float(P_l)                         fp32, in l order
//   C[i*bm : (i+1)*bm, :] = acc * t                                 fp32
// qvals (nbr * L, bm, bk) int8; scales (nbr * L,) fp32; t (n,) fp32; C (m,
// n) fp32. B comes K-major: bt (n, ldt) int8, bt[j][r] = b_q[r][j] for r < k
// and 0 up to ldt (a multiple of 16, at least nbc * bk), written once a call
// by int8_kmajor_kernel below from b_q (k, n). Each multiply and each add of
// the epilogue rounds on its own (__fmul_rn, __fadd_rn: no FMA contraction),
// as the plain PyTorch version and the JAX kernel do, so the result is
// bitwise equal to the plain version. int32 holds a slot's product while
// 127^2 * bk < 2^31. A row-block with no slot writes zeros.
//
// What bounds it. At the 16384^2 headline (1,669 valid 128x128 blocks,
// n = 512) the work is 28.0 G int8 ops (0.014 ms at the H100's 1,979 TOPS
// int8 datasheet rate) against 69 MB of compulsory traffic (27.3 MB of
// valid blocks, 8.4 MB of b_q, 33.6 MB of C: 0.021 ms at 3.35 TB/s): bytes
// bound it, and C's fp32 write is half of them. The first design staged
// one 32-deep chunk of a 64-row slice between two barriers, with B
// transposed by byte permutes on every staging, and ran at 20x the bound on
// an H100.
//
// Design (spmm_int8_tc_kernel, for bm a multiple of 64 and bk one of 32 below
// 256):
//   - The s8 tensor cores take both operands K-major (mma.sync m16n8k32,
//     row.col: A's rows and B's columns each 4 consecutive k bytes a
//     register), and b_q is stored (k, n). So B is made K-major once a
//     call, by int8_kmajor_kernel (8.4 MB each way at the headline), and
//     every staging after that is a plain copy: no permutes, no registers.
//   - A thread block owns a TM x TN piece of C inside one row-block: 128 x
//     128 where bm is a multiple of 128, else 64 x 256. Sixteen warps, each
//     a 32 x 32 piece: 2 x 4 mma tiles, 32 int32 and 32 fp32 accumulators a
//     thread. (Eight warps of 32 x 64 hold 64 + 64 and reach 255 registers,
//     and two warps a scheduler left the latency of every load, ldmatrix and
//     store exposed.)
//   - A step is one slot's chunk of 128 k bytes (32 where bk is not a
//     multiple of 128; the whole 128-deep block at the headline): the A rows
//     and the TN rows of bt, copied by
//     16-byte cp.async into a ring of as many stages as fit (six at 128 x
//     128), five steps in flight while one computes, one barrier a step: a
//     step computes in well under the device memory's latency, so a
//     shallow ring left the tensor cores waiting. Operands are read by
//     ldmatrix from rows padded to 144 bytes (the eight rows of a matrix
//     land on distinct banks); a 128-deep step is four k-steps of 8 mma
//     a warp.
//   - Each slot's product P_l is an exact int32 sum in its own
//     accumulators, reset at the slot's first chunk and folded into the
//     fp32 sum at its last, in slot order, as the contract says. The sums
//     start at the bit pattern of 1.5 * 2^23 (MAGIC_BITS), so the exact
//     int -> fp32 conversion of the fold is one FADD, not an I2F at an
//     eighth of its rate (64 a thread a slot).
//   - The grid walks the n-tiles of a row-block slice together, so a block
//     of qvals is read from device memory once and from L2 by the others;
//     the 8.4 MB bt stays in L2. Row-blocks start in the order of their
//     slot counts, most first (`order`, from the plan), so the last of the
//     grid's four waves at the headline holds the lightest (slots per
//     row-block vary about 13 +- 3 there).
// Other blocksizes run the first design (block_ell_spmm_int8_kernel, one
// 32-deep chunk of a 64 x 128 tile at a time, int8_tiles.cuh), reading the
// same bt. Both are bitwise equal to the plain version. No atomics: each
// output element is summed by one thread in one fixed order.

#include "int8_tiles.cuh"
#include "mma_sync.cuh"

namespace {

// -- B made K-major -----------------------------------------------------------

constexpr int TT = 64;  // a transpose tile: 64 k rows x 64 n columns

// bt[j][r] = bq[r][j] for r < k, 0 for k <= r < ldt; j < n. A block loads a
// 64 x 64 tile as words of 4 n bytes, then each thread turns a 4 x 4 byte
// block around with byte permutes and writes 4 words of 4 k bytes: both
// sides move whole words, neighbouring threads on neighbouring addresses.
__global__ void __launch_bounds__(256) int8_kmajor_kernel(const int8_t* __restrict__ bq,
                                                          int8_t* __restrict__ bt, int k, int n,
                                                          int ldt) {
  __shared__ uint32_t tile[TT][TT / 4 + 1];  // [k row][4 n bytes], padded
  const int k0 = blockIdx.x * TT, n0 = blockIdx.y * TT;
  for (int e = threadIdx.x; e < TT * (TT / 4); e += blockDim.x) {
    const int r = e / (TT / 4), w = e % (TT / 4), col = n0 + 4 * w;
    tile[r][w] = i8::load4(bq + static_cast<size_t>(k0 + r) * n + col,
                           k0 + r < k ? n - col : 0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (TT / 4) * (TT / 4); e += blockDim.x) {
    const int kw = e % (TT / 4), nw = e / (TT / 4);  // k bytes 4 kw.., n columns 4 nw..
    const uint32_t r0 = tile[4 * kw][nw], r1 = tile[4 * kw + 1][nw];
    const uint32_t r2 = tile[4 * kw + 2][nw], r3 = tile[4 * kw + 3][nw];
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
    const uint32_t w[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
    if (k0 + 4 * kw >= ldt) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = n0 + 4 * nw + c;
      if (j < n) *reinterpret_cast<uint32_t*>(bt + static_cast<size_t>(j) * ldt + k0 + 4 * kw) = w[c];
    }
  }
}

// -- the pipelined tensor-core executor ---------------------------------------

namespace tc {

constexpr int NT = 512;       // sixteen warps
constexpr int KS = 128;       // the deepest chunk a stage holds, in k bytes
constexpr int LDS = KS + 16;  // bytes a staged row: ldmatrix rows on distinct banks
constexpr int WM = 32, WN = 32;  // a warp's piece of C
constexpr int NJ = WN / 8;       // its n-tiles
// The int32 sums start at 1.5 * 2^23 as an fp32 bit pattern: while |P| <
// 2^22 (128^2 * bk < 2^22: bk < 256), bits(1.5 * 2^23) + P is the bit
// pattern of the fp32 1.5 * 2^23 + P, so float(P) is one exact fp32
// subtraction, where I2F runs at an eighth of the FADD rate.
constexpr int MAGIC_BITS = 0x4B400000;
constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23

template <int TM>
struct Shape {
  static constexpr int TN = 16384 / TM;  // 128 or 256 columns
  static constexpr int WROWS = TM / WM;  // warps along m
  static constexpr size_t stage = static_cast<size_t>(TM + TN) * LDS;  // A rows, then B rows
  // the ring: as many stages as fit, NSTAGE - 1 steps in flight while one
  // computes (six of 36 KB at 128 x 128, five of 45 KB at 64 x 256)
  static constexpr int NSTAGE = static_cast<int>(227 * 1024 / stage);
  static constexpr size_t bytes = NSTAGE * stage;
};

// KC: the k bytes a step (128, or 32 where bk is not a multiple of 128).
template <int TM, int KC>
__global__ void __launch_bounds__(NT, 1) spmm_int8_tc_kernel(
    const int8_t* __restrict__ qvals, const float* __restrict__ scales,
    const int8_t* __restrict__ bt, const float* __restrict__ t, float* __restrict__ c,
    const int* __restrict__ block_cols, const int* __restrict__ nslots,
    const int64_t* __restrict__ order, int m, int n, int bm, int bk, int L, int ldt,
    int n_tiles) {
  using S = Shape<TM>;
  constexpr int NSTAGE = S::NSTAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  const int m_sub = bm / TM;
  const int nt = blockIdx.x % n_tiles;  // n-tiles of a slice run together
  const int rs = blockIdx.x / n_tiles;
  // row-block (the ones with the most slots first), first row inside it
  const int i = static_cast<int>(order[rs / m_sub]), r0 = (rs % m_sub) * TM;
  const int n0 = nt * S::TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % S::WROWS, wn = warp / S::WROWS;
  const int cps = bk / KC;  // chunks a slot
  const int nsteps = nslots[i] * cps;

  // step st (slot st / cps, chunk st % cps) into stage st % NSTAGE
  auto issue = [&](int st) {
    unsigned char* As = smem + (st % NSTAGE) * S::stage;
    unsigned char* Bs = As + TM * LDS;
    const size_t slot = static_cast<size_t>(i) * L + st / cps;
    const int kk = (st % cps) * KC;
    const int8_t* a = qvals + (slot * bm + r0) * bk + kk;
    const int8_t* b = bt + static_cast<size_t>(block_cols[slot]) * bk + kk;
    constexpr int cw = KC / 16;  // 16-byte pieces a row
    for (int e = threadIdx.x; e < TM * cw; e += NT) {
      const int r = e / cw, q = e % cw;
      mma16::cp_async16(As + r * LDS + 16 * q, a + static_cast<size_t>(r) * bk + 16 * q, 16);
    }
    for (int e = threadIdx.x; e < S::TN * cw; e += NT) {
      const int r = e / cw, q = e % cw;
      const bool in = n0 + r < n;
      mma16::cp_async16(Bs + r * LDS + 16 * q,
                        in ? b + static_cast<size_t>(n0 + r) * ldt + 16 * q : bt, in ? 16 : 0);
    }
  };

  float acc[2][NJ][4];
  int part[2][NJ][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < nsteps) issue(st);
    mma16::cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    mma16::cp_async_wait<NSTAGE - 2>();  // step st has landed
    // ... and is visible to every warp; every reader of step st - 1's stage
    // is done, so step st + NSTAGE - 1 may stream into it
    __syncthreads();
    if (st + NSTAGE - 1 < nsteps) issue(st + NSTAGE - 1);
    mma16::cp_async_commit();
    if (st % cps == 0) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[a][j][e] = MAGIC_BITS;
    }
    const unsigned char* As = smem + (st % NSTAGE) * S::stage;
    const unsigned char* Bs = As + TM * LDS;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t a[2][4], b[NJ / 2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma16::ldsm_x4(a[mi], As + (WM * wm + 16 * mi + lane % 16) * LDS + 32 * ks +
                                  16 * (lane / 16));
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np)
        mma16::ldsm_x4(b[np], Bs + (WN * wn + 16 * np + lane % 8 + 8 * (lane / 16)) * LDS +
                                  32 * ks + 16 * ((lane / 8) % 2));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          mma16::mma_s8(part[mi][2 * np], a[mi], b[np][0], b[np][1]);
          mma16::mma_s8(part[mi][2 * np + 1], a[mi], b[np][2], b[np][3]);
        }
    }
    if (st % cps == cps - 1) {  // the slot's product is complete: fold it in
      const float s = scales[static_cast<size_t>(i) * L + st / cps];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pf = __fsub_rn(__int_as_float(part[a][j][e]), MAGIC);
            acc[a][j][e] = __fadd_rn(acc[a][j][e], __fmul_rn(s, pf));
          }
    }
  }

  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i * bm + r0 + WM * wm + 16 * a + g + 8 * h;
      if (row >= m) continue;
      float* crow = c + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + WN * wn + 8 * j + 2 * tq;
        if (col + 1 < n && n % 2 == 0) {
          *reinterpret_cast<float2*>(crow + col) =
              make_float2(__fmul_rn(acc[a][j][2 * h], t[col]),
                          __fmul_rn(acc[a][j][2 * h + 1], t[col + 1]));
        } else {
          if (col < n) crow[col] = __fmul_rn(acc[a][j][2 * h], t[col]);
          if (col + 1 < n) crow[col + 1] = __fmul_rn(acc[a][j][2 * h + 1], t[col + 1]);
        }
      }
    }
}

template <int TM>
int launch(const int8_t* qvals, const float* scales, const int8_t* bt, const float* t, float* c,
           const int* block_cols, const int* nslots, const int64_t* order, int m, int n, int bm,
           int bk, int nbr, int L, int ldt, cudaStream_t stream) {
  using S = Shape<TM>;
  const int n_tiles = (n + S::TN - 1) / S::TN;
  const long long blocks = static_cast<long long>(nbr) * (bm / TM) * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = bk % 128 == 0 ? spmm_int8_tc_kernel<TM, 128> : spmm_int8_tc_kernel<TM, 32>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(blocks), NT, S::bytes, stream>>>(
      qvals, scales, bt, t, c, block_cols, nslots, order, m, n, bm, bk, L, ldt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// -- the first design, for the other blocksizes ---------------------------------

using namespace i8;

// bt's rows [n0, n0 + TN), k bytes [k0, k0 + KC) of a slot, into Bs as
// mma_chunk reads it (Bs[j][w] = 4 k bytes of column n0 + j); bytes at or
// past the slot's depth kmax and rows at or past n are 0.
__device__ __forceinline__ void stage_bt(uint32_t* Bs, const int8_t* __restrict__ b, size_t ldb,
                                         int kmax, int n, int k0, int n0) {
  for (int e = threadIdx.x; e < TN * (KC / 4); e += NT) {
    const int j = e / (KC / 4), w = e % (KC / 4);
    const int col = k0 + 4 * w;
    Bs[j * LDW + w] = load4(b + (n0 + j) * ldb + col, n0 + j < n ? kmax - col : 0);
  }
}

__global__ void __launch_bounds__(NT) block_ell_spmm_int8_kernel(
    const int8_t* __restrict__ qvals,    // (nbr * L, bm, bk)
    const float* __restrict__ scales,    // (nbr * L)
    const int8_t* __restrict__ bt,       // (n, ldt)
    const float* __restrict__ t,         // (n)
    float* __restrict__ c,               // (m, n)
    const int* __restrict__ block_cols,  // (nbr * L)
    const int* __restrict__ nslots,      // (nbr)
    int m, int n, int bm, int bk, int L, int ldt, int m_sub) {
  __shared__ __align__(16) uint32_t As[TM * LDW];
  __shared__ __align__(16) uint32_t Bs[TN * LDW];

  const int i = blockIdx.x / m_sub;            // row-block
  const int r0 = (blockIdx.x % m_sub) * TM;    // first row inside the row-block
  const int rows = min(TM, bm - r0);           // rows of this slice
  const int n0 = blockIdx.y * TN;

  float acc[2][4][4];
  Acc part;
  for_each([&](int a, int j, int e, int, int) { acc[a][j][e] = 0.f; });

  const int nvalid = nslots[i];
  for (int l = 0; l < nvalid; ++l) {
    const size_t slot = static_cast<size_t>(i) * L + l;
    const int8_t* a_blk = qvals + (slot * bm + r0) * static_cast<size_t>(bk);
    const int8_t* b_blk = bt + static_cast<size_t>(block_cols[slot]) * bk;
    for_each([&](int a, int j, int e, int, int) { part[a][j][e] = 0; });
    for (int k0 = 0; k0 < bk; k0 += KC) {
      stage_a(As, a_blk, bk, rows, bk, k0);
      stage_bt(Bs, b_blk, ldt, bk, n, k0, n0);
      __syncthreads();
      mma_chunk(part, As, Bs);
      __syncthreads();
    }
    const float s = scales[slot];
    for_each([&](int a, int j, int e, int, int) {
      acc[a][j][e] = __fadd_rn(acc[a][j][e], __fmul_rn(s, __int2float_rn(part[a][j][e])));
    });
  }

  for_each([&](int a, int j, int e, int r, int col) {
    const int grow = i * bm + r0 + r, gcol = n0 + col;
    if (r < rows && grow < m && gcol < n) {
      c[static_cast<size_t>(grow) * n + gcol] = __fmul_rn(acc[a][j][e], t[gcol]);
    }
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`
// (PyTorch's current stream) and does not synchronise; returns
// cudaGetLastError() after the launch (0 = launched).

// bt (n, ldt) = b_q (k, n) K-major, zero past k; ldt a multiple of 16, >= k.
extern "C" int int8_kmajor(const void* bq, void* bt, int k, int n, int ldt, int device,
                           void* stream) {
  if (k <= 0 || n <= 0 || ldt < k || ldt % 16 != 0 || (n + TT - 1) / TT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ldt + TT - 1) / TT, (n + TT - 1) / TT);
  int8_kmajor_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bq), static_cast<int8_t*>(bt), k, n, ldt);
  return static_cast<int>(cudaGetLastError());
}

// C from the quantized plan and bt; the pipelined executor where bm is a
// multiple of 64, bk a multiple of 32 below 256 (so |P_l| < 2^22, MAGIC)
// and qvals is 16-byte aligned, else the first design. order (nbr,) int64:
// the row-blocks by slot count, most first, the order the pipelined
// executor starts them in (the last wave then holds the lightest).
extern "C" int block_ell_spmm_int8(const void* qvals, const void* scales, const void* bt,
                                   const void* t, void* c, const void* block_cols,
                                   const void* nslots, const void* order, int m, int n, int bm,
                                   int bk, int nbr, int L, int ldt, int device, void* stream) {
  if (m <= 0 || n <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || L <= 0 || ldt % 16 != 0 ||
      (n + TN - 1) / TN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qv = static_cast<const int8_t*>(qvals);
  const auto* sc = static_cast<const float*>(scales);
  const auto* b = static_cast<const int8_t*>(bt);
  const auto* tt = static_cast<const float*>(t);
  auto* cc = static_cast<float*>(c);
  const auto* cols = static_cast<const int*>(block_cols);
  const auto* ns = static_cast<const int*>(nslots);
  if (bm % 64 == 0 && bk % 32 == 0 && bk < 256 && reinterpret_cast<uintptr_t>(qvals) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(bt) % 16 == 0) {
    const auto* ord = static_cast<const int64_t*>(order);
    if (bm % 128 == 0) {
      return tc::launch<128>(qv, sc, b, tt, cc, cols, ns, ord, m, n, bm, bk, nbr, L, ldt, st);
    }
    return tc::launch<64>(qv, sc, b, tt, cc, cols, ns, ord, m, n, bm, bk, nbr, L, ldt, st);
  }
  const int m_sub = (bm + TM - 1) / TM;
  const dim3 grid(static_cast<unsigned>(nbr) * m_sub, (n + TN - 1) / TN);
  block_ell_spmm_int8_kernel<<<grid, NT, 0, st>>>(qv, sc, b, tt, cc, cols, ns, m, n, bm, bk, L,
                                                  ldt, m_sub);
  return static_cast<int>(cudaGetLastError());
}
