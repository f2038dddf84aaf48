// Block-pattern SDDMM for NVIDIA Hopper (sm_90a): for every ELL slot of an
// inspector plan, the dense (bm, bk) block of dC @ B^T that the slot's block
// of A occupies. This is the dA = dC @ B^T gradient of C = A @ B, restricted
// to A's block pattern.
//
// Replaces the TPU kernel tpusparse/kernels/sddmm.py:35 _sddmm_kernel
// (pallas_call l.114, behind sddmm_pallas). The TPU kernel walked a
// sequential (row-block, slot, n-tile) grid and carried the sum over n-tiles
// in a VMEM scratch; here one thread block owns one 64x64 tile of one slot's
// output and runs the whole sum over n itself, so nothing carries between
// blocks.
//
// Contract. Inputs: block_cols (nbr * L) and nslots (nbr) from the plan,
// dC (m, n) and B (k, n), row-major. Output out (nbr * L, bm, bk) in dC's
// type (fp32 or bf16). For each row-block i and each valid slot
// l < nslots[i], with s = i * L + l:
//   out[s] = dC[i*bm : i*bm + bm, :] @ B[block_cols[s]*bk : +bk, :]^T
// summed over n in fp32. Pad slots (l >= nslots[i]) are exactly 0, and so
// are the rows past m and the columns past k inside a block (the TPU
// wrapper zero-pads dC and B, sddmm.py:81-84); here those edges are masked
// in the loads, and dC and B are never padded or copied.
// Precision tiers: fp32 FFMA ('high'/'highest', never TF32); with
// ROUND_BF16 ('default') both operands are rounded to bf16 (RTN) on load,
// their products are exact in fp32, and the sums are fp32.
// Determinism: no atomics. Each output element is summed by one thread, in
// ascending n, so runs repeat bit for bit.
//
// What bounds it. At the 16384^2 headline (10% of the 128x128 blocks,
// nblocks ~ 1,669, n = 512) the work is 2 * nblocks * bm * bk * n ~ 28 GFLOP,
// ~0.42 ms at the H100's ~67 TFLOP/s fp32 FFMA datasheet rate, against
// ~176 MB of compulsory traffic (34 MB dC, 34 MB B, 109 MB of written
// blocks), ~0.05 ms at 3.35 TB/s. So an FFMA kernel is compute-bound, and
// the design spends its effort on FFMA issue: a 4x4 register tile per
// thread, fed from shared memory by two 16-byte loads per 16 FFMAs; the dC
// and B rows of a slot are re-read out of L2 by the tiles that share them.
// At the MLP's n = 32 the kernel is latency-bound (a few dozen blocks). A
// tensor-core (3xTF32 or bf16 wgmma) design, double-buffered staging and a
// persistent schedule are later work.
//
// Design (first version, simple and deterministic): grid (slot, 64-row
// tile, 64-column tile); each block loops over n in ascending 16-wide
// chunks, stages the dC chunk and the B chunk transposed (n-major) in
// shared memory, and accumulates in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 64;  // output rows and columns per thread block
constexpr int NC = 16;    // n-chunk staged in shared memory
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int NT = (TILE / TM) * (TILE / TN);  // 256 threads
constexpr int LD = TILE + 4;                   // padded row of a staged chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool ROUND_BF16>
__device__ __forceinline__ float tier(float x) {
  if constexpr (ROUND_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TD, typename TB, bool ROUND_BF16>
__global__ void __launch_bounds__(NT) sddmm_kernel(
    const TD* __restrict__ dc,            // (m, n)
    const TB* __restrict__ b,             // (k, n)
    TD* __restrict__ out,                 // (nbr * L, bm, bk)
    const int* __restrict__ block_cols,   // (nbr * L)
    const int* __restrict__ nslots,       // (nbr)
    int m, int k, int n, int bm, int bk, int L) {
  __shared__ __align__(16) float Ds[NC][LD];  // dC chunk, n-major
  __shared__ __align__(16) float Bs[NC][LD];  // B chunk, n-major

  const int slot = blockIdx.x;
  const int i = slot / L;
  const int l = slot % L;
  const int r0 = blockIdx.y * TILE;  // first row of the tile inside the block
  const int c0 = blockIdx.z * TILE;  // first column of the tile inside the block
  const int tid = threadIdx.x;
  const int tx = tid % (TILE / TN);
  const int ty = tid / (TILE / TN);
  TD* o_blk = out + static_cast<size_t>(slot) * bm * bk;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[a][q] = 0.f;

  if (l < nslots[i]) {  // pad slots skip the loads and write zeros
    const int row0 = i * bm + r0;                 // first dC row of the tile
    const int col0 = block_cols[slot] * bk + c0;  // first B row of the tile
    // rows of dC and of B that this tile may read: inside the block and
    // inside the matrix
    const int drows = min(min(TILE, bm - r0), m - row0);
    const int brows = min(min(TILE, bk - c0), k - col0);
    for (int n0 = 0; n0 < n; n0 += NC) {
      for (int e = tid; e < TILE * NC; e += NT) {
        const int r = e / NC, q = e % NC;
        const int cn = n0 + q;
        float dv = 0.f, bv = 0.f;
        if (cn < n) {
          if (r < drows) dv = tier<ROUND_BF16>(to_f32(dc[static_cast<size_t>(row0 + r) * n + cn]));
          if (r < brows) bv = tier<ROUND_BF16>(to_f32(b[static_cast<size_t>(col0 + r) * n + cn]));
        }
        Ds[q][r] = dv;
        Bs[q][r] = bv;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float4 dv = *reinterpret_cast<const float4*>(&Ds[q][ty * TM]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[q][tx * TN]);
        const float dr[TM] = {dv.x, dv.y, dv.z, dv.w};
        const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[a][j] = fmaf(dr[a], br[j], acc[a][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = r0 + ty * TM + a;
    if (r >= bm) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx * TN + j;
      if (c < bk) store(&o_blk[static_cast<size_t>(r) * bk + c], acc[a][j]);
    }
  }
}

template <typename TD, typename TB>
void launch_typed(const void* dc, const void* b, void* out, const int* cols,
                  const int* nslots, int m, int k, int n, int bm, int bk,
                  int num_slots, int L, int round_bf16, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(num_slots), (bm + TILE - 1) / TILE,
                  (bk + TILE - 1) / TILE);
  const auto* vd = static_cast<const TD*>(dc);
  const auto* vb = static_cast<const TB*>(b);
  auto* vo = static_cast<TD*>(out);
  if (round_bf16) {
    sddmm_kernel<TD, TB, true><<<grid, NT, 0, stream>>>(vd, vb, vo, cols, nslots, m, k,
                                                        n, bm, bk, L);
  } else {
    sddmm_kernel<TD, TB, false><<<grid, NT, 0, stream>>>(vd, vb, vo, cols, nslots, m,
                                                         k, n, bm, bk, L);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16; the output has dC's type. Launches on `stream` (PyTorch's
// current stream) and does not synchronise; returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int sddmm(const void* dc, int dc_dtype, const void* b, int b_dtype, void* out,
                     const void* block_cols, const void* nslots, int m, int k, int n,
                     int bm, int bk, int nbr, int L, int round_bf16, int device,
                     void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || bm <= 0 || bk <= 0 || nbr <= 0 || L <= 0 ||
      (bm + TILE - 1) / TILE > 65535 || (bk + TILE - 1) / TILE > 65535 ||
      static_cast<long long>(nbr) * L > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* cols = static_cast<const int*>(block_cols);
  const auto* ns = static_cast<const int*>(nslots);
  const int num_slots = nbr * L;
  if (dc_dtype == 0 && b_dtype == 0) {
    launch_typed<float, float>(dc, b, out, cols, ns, m, k, n, bm, bk, num_slots, L,
                               round_bf16, s);
  } else if (dc_dtype == 0 && b_dtype == 1) {
    launch_typed<float, __nv_bfloat16>(dc, b, out, cols, ns, m, k, n, bm, bk, num_slots,
                                       L, round_bf16, s);
  } else if (dc_dtype == 1 && b_dtype == 0) {
    launch_typed<__nv_bfloat16, float>(dc, b, out, cols, ns, m, k, n, bm, bk, num_slots,
                                       L, round_bf16, s);
  } else if (dc_dtype == 1 && b_dtype == 1) {
    launch_typed<__nv_bfloat16, __nv_bfloat16>(dc, b, out, cols, ns, m, k, n, bm, bk,
                                               num_slots, L, round_bf16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
