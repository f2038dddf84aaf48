// Fused attention over an int8 K/V cache for NVIDIA Hopper (sm_90a), the
// serving tier's forward: o = softmax(q (ks Kq)^T sm_scale) (vs Vq). The
// (s, s) score matrix never reaches device memory, and K and V are read as
// int8, half the bytes of bf16.
//
// Replaces the TPU kernel tpusparse/kernels/flash_attention.py:1434
// _flash_q8_kernel (pallas_call l.1558, behind flash_attention_q8). As in
// flash_attention.cu, one thread block owns one 64-row q-tile of one
// (batch, head) and runs the whole loop over the k-tiles itself, keeping
// the online-softmax state in registers; no atomics, so runs repeat bit for
// bit. Forward only, as on the TPU.
//
// Contract. q: (bh, s, d) fp32 or bf16; kq, vq: (bh, s, d) int8; ks, vs:
// (bh,) fp32, the per-(batch, head) scales of `quantize_kv`; o: (bh, s, d)
// in q's type. Any d: d <= 64 and d <= 128 hold a whole row in a tile
// (DMAX 64, 128), a wider d runs the WIDE instance of attention_tiles.cuh
// (128-wide output chunks on blockIdx.z, the scores recomputed per chunk
// over d staged in 128-wide pieces); the ragged s and d edges are masked in
// the loads and stores (the TPU wrapper padded them).
//   - The products are at the 'default' tier, as Precision.DEFAULT runs on
//     the TPU: q is rounded to bf16 on load and p to bf16 before p.v; int8 K
//     and V are exact in bf16, so every product is exact in fp32 and every
//     sum is fp32.
//   - The K scale folds into the score scale: s = (q . kq) * (sm_scale * ks)
//     after the product (tpusparse l.1461-1463), not into q. The V scale
//     folds into the epilogue: o = acc / l * vs (l.1499-1501).
//   - Masking on global positions, as the flash forward: key j of a row i
//     is visible when j < s and, if causal, kv_off + j <= q_off + i; masked
//     scores are -1e30 and their probabilities exactly 0; whole tiles above
//     the diagonal are skipped. A row that sees no key gets o = 0. (The TPU
//     kernel gives 0 only where it skips every tile of the row; where it
//     visits a tile whose keys are all masked for the row, it gives the mean
//     of vs * vq over that tile, since exp(-1e30 - (-1e30)) = 1.)
//
// What bounds it. At the serving shape (b, h, s, d) = (8, 16, 512, 64),
// causal, the scores on or below the diagonal take ~2 bh s^2 d = 4.3 GFLOP
// (0.004 ms at the 989 TFLOP/s bf16 tensor rate), against ~42 MB of compulsory traffic (fp32 q and o, int8 K and V:
// 0.013 ms at 3.35 TB/s): bytes bound it on the datasheet. This first design
// is the FFMA tile loop of flash_attention.cu (attention_tiles.cuh), whose
// own bound is 2 bh s^2 d / 67 TFLOP/s = 0.064 ms at that shape: it is
// compute-bound on the FFMA pipe. bf16 mma (or wgmma) on the int8-converted
// tiles is later work.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

template <int DMAX>
constexpr size_t q8_smem() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (DMAX + 4) + BQ * LDP);
}

template <int DMAX, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) flash_q8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
    const float* __restrict__ ks, const float* __restrict__ vs, T* __restrict__ o, int s,
    int d, float sm_scale, int causal, int q_off, int kv_off) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // (BQ, LD) q rounded to bf16
  float* Ks = Qs + BQ * LD;    // (BK, LD) kq as float (exact)
  float* Vs = Ks + BK * LD;    // (BK, LD) vq as float (exact)
  float* Ps = Vs + BK * LD;    // (BQ, LDP) p of this k-tile, rounded to bf16
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const float scale_s = sm_scale * ks[bh];  // fp32, as the TPU kernel's sm_scale * ks[b]
  const float scale_v = vs[bh];
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) load_tile<DMAX, true>(Qs, q + base, q0, s, d, 1.f);
  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int nk = visited_k_tiles(s, q0, causal, q_off, kv_off);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    if constexpr (WIDE) {
      mma_nt_chunked<DMAX, true, false>(sc, Qs, Ks, q + base, q0, s, 1.f, kq + base, k0, s, 1.f,
                                        d, ty, tx);
      load_chunk<DMAX, false>(Vs, vq + base, k0, s, d, c_out, 1.f);
    } else {
      __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
      load_tile<DMAX, false>(Ks, kq + base, k0, s, d, 1.f);
      load_tile<DMAX, false>(Vs, vq + base, k0, s, d, 1.f);
      __syncthreads();
      mma_nt<LD>(sc, Qs, Ks, kd, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool vis[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = causal_visible(qp, k0 + tx + 16 * j, s, causal, q_off, kv_off);
        sc[i][j] = vis[j] ? sc[i][j] * scale_s : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = rnd_bf16(p);
      }
      l[i] = corr * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    mma_nn<DMAX>(acc, Ps, Vs, ty, tx);
  }

  T* ob = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) {
          store(&ob[static_cast<size_t>(qp) * d + col], (acc[i][4 * g + c] / den) * scale_v);
        }
      }
  }
}

template <int DMAX, typename T, bool WIDE>
int q8_typed(const void* q, const void* kq, const void* vq, const void* ks, const void* vs,
             void* o, int bh, int s, int d, float sm_scale, int causal, int q_off, int kv_off,
             cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, bh, out_chunks<DMAX, WIDE>(d));
  return launch(flash_q8_kernel<DMAX, T, WIDE>, q8_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const int8_t*>(kq),
                static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
                static_cast<const float*>(vs), static_cast<T*>(o), s, d, sm_scale, causal, q_off,
                kv_off);
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
  if (bh <= 0 || s <= 0 || d <= 0 || bh > 65535 ||
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
    return Q8_CALL(128, float, true);
  }
  if (q_dtype == 1) {
    if (d <= 64) return Q8_CALL(64, __nv_bfloat16, false);
    if (d <= 128) return Q8_CALL(128, __nv_bfloat16, false);
    return Q8_CALL(128, __nv_bfloat16, true);
  }
#undef Q8_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
