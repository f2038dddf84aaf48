// Fused attention over an int8 K/V cache for NVIDIA Hopper (sm_90a), the
// serving tier's forward: o = softmax(q (ks Kq)^T sm_scale) (vs Vq). The
// (s, s) score matrix never reaches device memory, and K and V are read as
// int8, half the bytes of bf16.
//
// Replaces the TPU kernel tpusparse/kernels/flash_attention.py:1434
// _flash_q8_kernel (pallas_call l.1558, behind flash_attention_q8). One
// thread block of eight warps owns one 128-row q-tile of one (batch, head),
// each warp 16 of its rows, and runs the whole loop over the 64-key k-tiles
// itself;
// no atomics, so runs repeat bit for bit. Forward only, as on the TPU.
//
// Contract. q: (bh, s, d) fp32 or bf16; kq, vq: (bh, s, d) int8; ks, vs:
// (bh,) fp32, the per-(batch, head) scales of `quantize_kv`; o: (bh, s, d)
// in q's type. Any d: up to 256 the whole row is held (instances DMAX 64,
// 128, 256); a wider d runs the WIDE instance (256-wide output chunks on
// blockIdx.z, the scores recomputed per chunk over d in 256-wide pieces).
// The ragged s and d edges are masked in the loads and stores.
//   - The products are at the 'default' tier, as Precision.DEFAULT runs on
//     the TPU: q is rounded to bf16 (RTN) on load and p to bf16 before p.v;
//     int8 K and V are exact in bf16, so every product is exact in fp32 and
//     every sum is fp32.
//   - The K scale folds into the score scale: s = (q . kq) * (sm_scale * ks)
//     after the product (tpusparse l.1461-1463), not into q. The V scale
//     folds into the epilogue: o = acc / l * vs (l.1499-1501). l is summed
//     from the fp32 p.
//   - Masking on global positions, as the flash forward: key j of a row i
//     is visible when j < s and, if causal, kv_off + j <= q_off + i; masked
//     scores are -1e30 and their probabilities exactly 0; whole tiles above
//     the diagonal are skipped. A row that sees no key gets o = 0. (The TPU
//     kernel gives 0 only where it skips every tile of the row; where it
//     visits a tile whose keys are all masked for the row, it gives the mean
//     of vs * vq over that tile, since exp(-1e30 - (-1e30)) = 1.)
//
// What bounds it. At the serving shape (b, h, s, d) = (8, 16, 512, 64),
// causal, the scores on or below the diagonal take ~4 bh s^2 d / 2 = 4.3
// GFLOP (0.004 ms at the 989 TFLOP/s bf16 tensor rate), against ~42 MB of
// compulsory traffic (fp32 q and o, int8 K and V: 0.0125 ms at 3.35 TB/s):
// bytes bound it. The first port ran both products on the FFMA pipe (its
// own bound 0.064 ms) and took 0.292 ms. This design:
//   - Both products on the bf16 tensor cores with `mma.sync.m16n8k16` and
//     fp32 accumulators (attention_mma.cuh). That contract is the 'default'
//     tier's exactly. `wgmma` was not taken: at d 64 a k-tile is 64 x 64 x 64
//     per product, the tensor-core time is a small part of the bound, and
//     mma.sync keeps S, P and O in one warp's registers with no warpgroup
//     synchronisation.
//   - The online-softmax state and the output accumulator live in
//     registers. The S accumulators, rounded to bf16 pair by pair, are the
//     A fragments of p.v: that rounding is the contract's "p rounded to
//     bf16", and P never touches shared memory.
//   - K and V tiles are staged as int8 with cp.async in two stages, so tile
//     kt + 1 streams in while tile kt computes (d % 16 == 0 and 16-byte
//     aligned operands; other d load synchronously). The eight warps then
//     widen the tile once, cooperatively, to bf16 in shared memory
//     (int8x4_to_bf16: exact, eleven ALU operations for four values) and
//     read their operands with `ldmatrix`: K untransposed as the B operand
//     of q.k^T, V with `ldmatrix.trans` as the k-major B operand of p.v.
//     Widening per warp from int8 would repeat the conversion eight times;
//     128 q rows a block (and not 64) halve the widening a q row pays.
//   - The softmax masks only the tiles that hold a masked key for some row
//     of the warp (the diagonal, the ragged s edge), and takes exp2 of the
//     scaled difference (ex2.approx, one MUFU op) where the first port took
//     expf; a tile that needs no mask runs a softmax without one.
//   - At d <= 64 the instance is held to 128 registers, two blocks (16
//     warps) a SM; capped for three blocks it spilled and ran slower.
//   - Causal blocks run heaviest first (the grid's slow axis is the q-tile,
//     in reverse order), so the long rows do not trail the grid.

#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace {

using attn::NEG;
using attn::store;
using attn::to_f32;
using namespace mma16;

// Shared memory: Qs (BQ, LD) bf16; NB buffers of the bf16 K and V tiles,
// (BK, LD) each; without WIDE, two int8 stages of K and of V, (BK, DMAX)
// each. NB = 2 (d <= 128) lets the next tile widen while this one computes,
// one barrier a tile; the 256 instance has room for one (two barriers).
template <int DMAX, bool WIDE>
struct Smem {
  static constexpr int LD = DMAX + 8;  // bf16 row, padded: ldmatrix rows hit distinct banks
  static constexpr int NB = !WIDE && DMAX <= 128 ? 2 : 1;
  static constexpr size_t tiles = static_cast<size_t>(BQ + 2 * BK * NB) * LD * 2;
  static constexpr size_t stage = static_cast<size_t>(BK) * DMAX;  // one int8 tile
  static constexpr size_t bytes = tiles + (WIDE ? 0 : 4 * stage);
};

// dst (NR rows of LD bf16) = src rows [r0, r0 + NR), columns [c0, c0 + cw)
// of a (rows, d) row-major matrix, rounded to bf16; rows at or past `rows`
// and columns at or past d are 0. A batch of loads a thread (16 at d <= 64,
// 4 where the wider instances' accumulators fill the registers) is issued
// before its stores, so a tile costs a few memory latencies, not one a value.
template <int LD, int NR, int DMAX, typename T>
__device__ __forceinline__ void load_bf16(__nv_bfloat16* dst, const T* __restrict__ src, int r0,
                                          int rows, int d, int c0, int cw) {
  constexpr int PER = NR * DMAX / NTHR, BATCH = DMAX <= 64 ? 16 : 4;
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = threadIdx.x + (i0 + j) * NTHR, r = e / DMAX, c = e % DMAX;
      x[j] = 0.f;
      if (c < cw && r0 + r < rows && c0 + c < d) {
        x[j] = to_f32(src[static_cast<size_t>(r0 + r) * d + c0 + c]);
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = threadIdx.x + (i0 + j) * NTHR, r = e / DMAX, c = e % DMAX;
      if (c < cw) dst[r * LD + c] = __float2bfloat16_rn(x[j]);
    }
  }
}

// One int8 k-tile (64 rows of d bytes from row r0) into a stage of 64 rows
// of DMAX bytes, 16 bytes a cp.async; rows at or past s are zero-filled.
template <int DMAX>
__device__ __forceinline__ void stage_int8(int8_t* dst, const int8_t* __restrict__ src, int r0,
                                           int s, int d) {
  for (int e = threadIdx.x; e < BK * DMAX / 16; e += NTHR) {
    const int r = e / (DMAX / 16), c = e % (DMAX / 16);
    if (16 * c >= d) continue;
    const bool in = r0 + r < s;
    const int8_t* p = src + (in ? static_cast<size_t>(r0 + r) * d + 16 * c : 0);
    cp_async16(dst + r * DMAX + 16 * c, p, in ? 16 : 0);
  }
}

// A staged int8 tile (64 rows of kd <= DMAX bytes) widened to bf16.
template <int DMAX, int LD>
__device__ __forceinline__ void widen(__nv_bfloat16* dst, const int8_t* src, int kd) {
  for (int e = threadIdx.x; e < BK * DMAX / 4; e += NTHR) {
    const int r = e / (DMAX / 4), c = 4 * (e % (DMAX / 4));
    if (c >= kd) continue;
    *reinterpret_cast<uint2*>(dst + r * LD + c) =
        int8x4_to_bf16(*reinterpret_cast<const uint32_t*>(src + r * DMAX + c));
  }
}

template <int DMAX, typename T, bool WIDE>
__global__ void __launch_bounds__(NTHR, DMAX <= 64 ? 2 : 1) flash_q8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
    const float* __restrict__ ks, const float* __restrict__ vs, T* __restrict__ o, int s,
    int d, float sm_scale, int causal, int q_off, int kv_off, int async_kv) {
  using SM = Smem<DMAX, WIDE>;
  constexpr int LD = SM::LD, NO = DMAX / 8;
  constexpr bool DB = SM::NB == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // (BQ, LD) q rounded to bf16
  // buffer i: K tile (BK, LD) at KV + 2 i BK LD, V tile after it; exact in bf16
  __nv_bfloat16* KV = Qs + BQ * LD;
  int8_t* K8 = reinterpret_cast<int8_t*>(smem + SM::tiles);  // 2 stages of kq, then of vq
  int8_t* V8 = K8 + 2 * SM::stage;

  // the (batch, head) on x, the q-tile on y in reverse: blocks start in the
  // order of their linear index, so every heavy causal q-tile starts first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr0 = 16 * warp;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const float scale_s = sm_scale * ks[bh];  // fp32, as the TPU kernel's sm_scale * ks[b]
  const float scale_v = vs[bh];
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;             // first output column
  const int kd_out = min(DMAX, (d - c_out + 15) / 16 * 16);  // output columns, padded to 16
  const int8_t* kb = kq + base;
  const int8_t* vb = vq + base;

  if constexpr (!WIDE) load_bf16<LD, BQ, DMAX>(Qs, q + base, q0, s, d, 0, kd_out);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[nt][c] = 0.f;

  const int nk = visited_k_tiles(s, q0, causal, q_off, kv_off);
  // stage tile j of K and V (int8, cp.async) into stage j % 2, or widen a
  // staged tile / load it synchronously into bf16 buffer i
  auto stage_kv = [&](int j) {
    stage_int8<DMAX>(K8 + (j % 2) * SM::stage, kb, j * BK, s, d);
    stage_int8<DMAX>(V8 + (j % 2) * SM::stage, vb, j * BK, s, d);
    cp_async_commit();
  };
  auto fill_kv = [&](int i, int j) {
    __nv_bfloat16* kbuf = KV + 2 * i * BK * LD;
    if (async_kv) {
      widen<DMAX, LD>(kbuf, K8 + (j % 2) * SM::stage, kd_out);
      widen<DMAX, LD>(kbuf + BK * LD, V8 + (j % 2) * SM::stage, kd_out);
    } else {
      load_bf16<LD, BK, DMAX>(kbuf, kb, j * BK, s, d, 0, kd_out);
      load_bf16<LD, BK, DMAX>(kbuf + BK * LD, vb, j * BK, s, d, 0, kd_out);
    }
  };
  if (!WIDE && nk > 0) {
    if (async_kv) stage_kv(0);
    if constexpr (DB) {  // tile 0 widened into buffer 0, tile 1 in flight
      if (async_kv) cp_async_wait_all();
      __syncthreads();
      fill_kv(0, 0);
      if (async_kv && nk > 1) stage_kv(1);
    }
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // under causal masking, a tile whose keys all lie past the warp's last
    // row adds nothing to it (p = 0, corr = 1): the warp skips its products
    const bool dead = causal && static_cast<long long>(kv_off) + k0 >
                                    static_cast<long long>(q_off) + q0 + wr0 + 15;
    const __nv_bfloat16* Kb = KV + 2 * (DB ? kt % 2 : 0) * BK * LD;  // this tile's K
    const __nv_bfloat16* Vb = Kb + BK * LD;                          // and V
    float sacc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[nt][c] = 0.f;
    if constexpr (WIDE) {
      for (int c0 = 0; c0 < d; c0 += DMAX) {
        const int kc = min(DMAX, (d - c0 + 15) / 16 * 16);
        __syncthreads();  // the last readers of Qs, Kb (and Vb) are done
        load_bf16<LD, BQ, DMAX>(Qs, q + base, q0, s, d, c0, kc);
        load_bf16<LD, BK, DMAX>(KV, kb, k0, s, d, c0, kc);
        if (c0 + DMAX >= d) load_bf16<LD, BK, DMAX>(KV + BK * LD, vb, k0, s, d, c_out, kd_out);
        __syncthreads();
        if (!dead) score_tile<DMAX, LD>(sacc, Qs, Kb, kc, wr0, lane);
      }
    } else if constexpr (DB) {
      if (async_kv) cp_async_wait_all();  // tile kt + 1 is staged
      // buffer kt % 2 is widened; every reader of buffer (kt + 1) % 2 (tile
      // kt - 1) and of stage kt % 2 (widened last step) is done
      __syncthreads();
      if (kt + 1 < nk) {
        if (async_kv && kt + 2 < nk) stage_kv(kt + 2);
        fill_kv((kt + 1) % 2, kt + 1);
      }
      if (!dead) score_tile<DMAX, LD>(sacc, Qs, Kb, kd_out, wr0, lane);
    } else {
      if (async_kv) cp_async_wait_all();
      __syncthreads();  // tile kt is staged; every reader of Kb, Vb and of stage kt+1 is done
      if (async_kv && kt + 1 < nk) stage_kv(kt + 1);
      fill_kv(0, kt);
      __syncthreads();
      if (!dead) score_tile<DMAX, LD>(sacc, Qs, Kb, kd_out, wr0, lane);
    }
    if (dead) continue;

    // a tile whose every key is visible to every row of the warp skips the
    // mask (rows past s are never stored)
    const bool full = k0 + BK <= s &&
        (!causal || static_cast<long long>(kv_off) + k0 + BK - 1 <=
                        static_cast<long long>(q_off) + q0 + wr0);
    if (full) {
      softmax_tile<false>(sacc, oacc, m, l, scale_s, 0, {0, 0});
    } else {
      const int row = q0 + wr0 + g;
      softmax_tile<true>(sacc, oacc, m, l, scale_s, k0 + 2 * t,
                         {key_limit(row, s, causal, q_off, kv_off),
                          key_limit(row + 8, s, causal, q_off, kv_off)});
    }
    pv_tile<DMAX, LD>(oacc, sacc, Vb, kd_out, lane);
  }

  T* ob = o + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + wr0 + g + 8 * h;
    if (qp >= s) continue;
    const float den = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c_out + 8 * nt + 2 * t + c;
        if (8 * nt < kd_out && col < d) {
          store(&ob[static_cast<size_t>(qp) * d + col], (oacc[nt][2 * h + c] / den) * scale_v);
        }
      }
  }
}

template <int DMAX, typename T, bool WIDE>
int q8_typed(const void* q, const void* kq, const void* vq, const void* ks, const void* vs,
             void* o, int bh, int s, int d, float sm_scale, int causal, int q_off, int kv_off,
             cudaStream_t stream) {
  const bool aligned = d % 16 == 0 && reinterpret_cast<uintptr_t>(kq) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vq) % 16 == 0;
  const size_t smem = Smem<DMAX, WIDE>::bytes;
  auto* kern = flash_q8_kernel<DMAX, T, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s + BQ - 1) / BQ, WIDE ? (d + DMAX - 1) / DMAX : 1);
  kern<<<grid, NTHR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<T*>(o), s, d,
      sm_scale, causal, q_off, kv_off, static_cast<int>(aligned));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. q_dtype: 0 = float32, 1 =
// bfloat16 (o shares it); kq, vq int8; ks, vs fp32. Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_q8(const void* q, const void* kq, const void* vq, const void* ks,
                        const void* vs, void* o, int q_dtype, int bh, int s, int d,
                        float sm_scale, int causal, int q_off, int kv_off, int device,
                        void* stream) {
  if (bh <= 0 || s <= 0 || d <= 0 || (s + BQ - 1) / BQ > 65535 ||
      static_cast<long long>(bh) * s * d > (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
#define Q8_CALL(DMAX, T, WIDE) \
  q8_typed<DMAX, T, WIDE>(q, kq, vq, ks, vs, o, bh, s, d, sm_scale, causal, q_off, kv_off, st)
  if (q_dtype == 0) {
    if (d <= 64) return Q8_CALL(64, float, false);
    if (d <= 128) return Q8_CALL(128, float, false);
    if (d <= 256) return Q8_CALL(256, float, false);
    return Q8_CALL(256, float, true);
  }
  if (q_dtype == 1) {
    if (d <= 64) return Q8_CALL(64, __nv_bfloat16, false);
    if (d <= 128) return Q8_CALL(128, __nv_bfloat16, false);
    if (d <= 256) return Q8_CALL(256, __nv_bfloat16, false);
    return Q8_CALL(256, __nv_bfloat16, true);
  }
#undef Q8_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
