// Fused attention for NVIDIA Hopper (sm_90a): the forward
// o = softmax(q k^T sm_scale) v with its per-row logsumexp, and the two
// backward kernels that recompute the probabilities from that logsumexp,
// dq and (dk, dv). The (s, s) score matrix never reaches device memory.
//
// Replaces three TPU kernels of tpusparse/kernels/flash_attention.py:
//   flash_fwd  <- :53  _flash_kernel      (pallas_call l.283)
//   flash_dq   <- :495 _flash_dq_kernel   (pallas_call l.684)
//   flash_dkv  <- :538 _flash_dkv_kernel  (pallas_call l.704)
// The TPU grids ran (bh, q-tile, k-tile) in order and carried the running
// max, denominator and accumulator from one k step to the next in VMEM
// scratch. Here one thread block owns one 64-row q-tile (flash_fwd,
// flash_dq) or one 64-row k-tile (flash_dkv) of one (batch, head) and runs
// the whole sequential loop over the other axis itself, keeping its
// accumulators in registers. Nothing carries between blocks and there are
// no atomics: every output element is summed by one thread in ascending
// tile order, so runs repeat bit for bit.
//
// Contract. q, k, v, do: (bh, s, d) row-major, one type (fp32 or bf16);
// lse and delta: (bh, s) fp32. Any d: d <= 64 and d <= 128 run the instances
// that hold a whole row in a tile (DMAX 64, 128), a wider d the WIDE
// instances (attention_tiles.cuh: 128-wide output chunks on blockIdx.z, the
// scores recomputed per chunk over d staged in 128-wide pieces); the TPU
// wrapper padded d to a multiple of 128 and s to its tile, here both ragged
// edges are masked in the loads and stores.
//   - q is pre-scaled on load: q * scale_q, where scale_q is sm_scale in
//     q's type, rounded to q's type (tpusparse l.239, l.662).
//   - ROUND ('default' tier, or bf16 inputs): q (pre-scaled), k, v and do
//     are rounded to bf16 on load, and so are p before p.v (forward), dS
//     before dS.k (dq) and p, dS before p^T.do, dS^T.q (dk, dv); products
//     of bf16 values are exact in fp32 and every sum is fp32. Without it
//     ('high', 'highest' on fp32 inputs) everything is fp32 FFMA, never
//     TF32.
//   - Masking on global positions: key j of a row i is visible when
//     j < s and, if causal, kv_off + j <= q_off + i. Masked scores are
//     -1e30 and their probabilities exactly 0; whole tiles above the
//     diagonal are skipped. A row that sees no key gets o = 0,
//     lse = -1e30 and no gradient (the TPU kernel gives such a row the
//     mean of v over the tiles it visits: exp(-1e30 - (-1e30)) = 1).
//   - flash_fwd: o in q's type, lse = m + log(l) in fp32.
//   - flash_dq: dq = sm_scale * sum_k P o (dP - delta) . k, with
//     P = exp(q k^T - lse), dP = do v^T; dq in q's type.
//   - flash_dkv: dv = sum_q P^T do, dk = sum_q dS^T (scaled q); padded q
//     rows (i >= s) contribute nothing (tpusparse l.484).
//
// What bounds them. At BERT-base (bh = 96, s = 512, d = 64) the forward
// does 4 bh s^2 d = 6.4 GFLOP (~0.096 ms at the H100's ~67 TFLOP/s fp32
// FFMA datasheet rate) against ~50 MB of compulsory traffic (~0.015 ms at
// 3.35 TB/s); dq does 6 bh s^2 d and dk/dv 8 bh s^2 d for about 1.4x and
// 1.7x that traffic. All three are compute-bound for an FFMA design, with
// expf per score on top. So the design spends its effort on FFMA issue:
// each thread owns a 4x4 tile of the 64x64 score block (rows ty + 16a,
// columns tx + 16j, so the 16-byte shared loads of both operands are free
// of bank conflicts) and a 4 x d/16 slice of the output accumulator on the
// same rows, so the row max and sum of the online softmax are four
// shuffles inside a half-warp and the rescale touches only registers.
// Tiles are staged row-major with padded rows; the score loop runs over d
// rounded up to 4, not DMAX. The tile helpers live in attention_tiles.cuh,
// shared with the block-pattern kernels. Double-buffered staging (cp.async or TMA),
// tensor cores (3xTF32 or bf16 wgmma) and a persistent schedule are later
// work.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

template <int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (DMAX + 4) + BQ * LDP);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int d, float scale_q, int causal,
    int q_off, int kv_off) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // (BQ, LD) pre-scaled q
  float* Ks = Qs + BQ * LD;    // (BK, LD)
  float* Vs = Ks + BK * LD;    // (BK, LD)
  float* Ps = Vs + BK * LD;    // (BQ, LDP) probabilities of this k-tile
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) load_tile<DMAX, ROUND>(Qs, q + base, q0, s, d, scale_q);
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
      mma_nt_chunked<DMAX, ROUND, ROUND>(sc, Qs, Ks, q + base, q0, s, scale_q, k + base, k0, s,
                                         1.f, d, ty, tx);
      load_chunk<DMAX, ROUND>(Vs, v + base, k0, s, d, c_out, 1.f);
    } else {
      __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
      load_tile<DMAX, ROUND>(Ks, k + base, k0, s, d, 1.f);
      load_tile<DMAX, ROUND>(Vs, v + base, k0, s, d, 1.f);
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
        if (!vis[j]) sc[i][j] = NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = tier<ROUND>(p);
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
        if (col < d) store(&ob[static_cast<size_t>(qp) * d + col], acc[i][4 * g + c] / den);
      }
    if (tx == 0 && c_out == 0)
      lse[static_cast<size_t>(bh) * s + qp] = l[i] > 0.f ? m[i] + logf(l[i]) : NEG;
  }
}

template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BQ + 2 * BK) * (DMAX + 4) + BQ * LDP);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int s, int d, float scale_q,
    float sm_scale, int causal, int q_off, int kv_off) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // (BQ, LD) pre-scaled q
  float* dOs = Qs + BQ * LD;    // (BQ, LD)
  float* Ks = dOs + BQ * LD;    // (BK, LD)
  float* Vs = Ks + BK * LD;     // (BK, LD)
  float* dSs = Vs + BK * LD;    // (BQ, LDP)
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) {
    load_tile<DMAX, ROUND>(Qs, q + base, q0, s, d, scale_q);
    load_tile<DMAX, ROUND>(dOs, dout + base, q0, s, d, 1.f);
  }
  float lse_r[4], delta_r[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    lse_r[i] = qp < s ? lse[static_cast<size_t>(bh) * s + qp] : 0.f;
    delta_r[i] = qp < s ? delta[static_cast<size_t>(bh) * s + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int nk = visited_k_tiles(s, q0, causal, q_off, kv_off);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    if constexpr (WIDE) {
      mma_nt_chunked<DMAX, ROUND, ROUND>(sc, Qs, Ks, q + base, q0, s, scale_q, k + base, k0, s,
                                         1.f, d, ty, tx);
      mma_nt_chunked<DMAX, ROUND, ROUND>(dp, dOs, Vs, dout + base, q0, s, 1.f, v + base, k0, s,
                                         1.f, d, ty, tx);
      __syncthreads();  // the score product's readers of Ks are done
      load_chunk<DMAX, ROUND>(Ks, k + base, k0, s, d, c_out, 1.f);
    } else {
      __syncthreads();
      load_tile<DMAX, ROUND>(Ks, k + base, k0, s, d, 1.f);
      load_tile<DMAX, ROUND>(Vs, v + base, k0, s, d, 1.f);
      __syncthreads();
      mma_nt<LD>(sc, Qs, Ks, kd, ty, tx);
      mma_nt<LD>(dp, dOs, Vs, kd, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = causal_visible(qp, k0 + tx + 16 * j, s, causal, q_off, kv_off);
        const float p = vis ? expf(sc[i][j] - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = tier<ROUND>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();
    mma_nn<DMAX>(acc, dSs, Ks, ty, tx);
  }

  T* out = dq + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) store(&out[static_cast<size_t>(qp) * d + col], acc[i][4 * g + c] * sm_scale);
      }
  }
}

template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (static_cast<size_t>(2 * BQ + 2 * BK) * (DMAX + 4) + 2 * BK * LDP + 2 * BQ);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s, int d,
    float scale_q, int causal, int q_off, int kv_off) {
  constexpr int LD = DMAX + 4, G = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // (BK, LD)
  float* Vs = Ks + BK * LD;     // (BK, LD)
  float* Qs = Vs + BK * LD;     // (BQ, LD) pre-scaled q
  float* dOs = Qs + BQ * LD;    // (BQ, LD)
  float* Ps = dOs + BQ * LD;    // (BK, LDP): p^T of this q-tile, keys by queries
  float* dSs = Ps + BK * LDP;   // (BK, LDP): dS^T
  float* lse_s = dSs + BK * LDP;  // (BQ)
  float* delta_s = lse_s + BQ;    // (BQ)
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = static_cast<size_t>(bh) * s * d;
  const int kd = (d + 3) & ~3;
  const int c_out = WIDE ? blockIdx.z * DMAX : 0;  // first output column

  if constexpr (!WIDE) {
    load_tile<DMAX, ROUND>(Ks, k + base, k0, s, d, 1.f);
    load_tile<DMAX, ROUND>(Vs, v + base, k0, s, d, 1.f);
  }
  float acc_k[4][4 * G], acc_v[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nq = (s + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    // q-tiles whose last row sees no key of this k-tile (uniform per block)
    if (causal && static_cast<long long>(q_off) + q0 + BQ - 1 < static_cast<long long>(kv_off) + k0)
      continue;
    float st[4][4], dpt[4][4];  // rows: keys ty + 16a; columns: queries tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    if constexpr (WIDE) {
      mma_nt_chunked<DMAX, ROUND, ROUND>(st, Ks, Qs, k + base, k0, s, 1.f, q + base, q0, s,
                                         scale_q, d, ty, tx);
      mma_nt_chunked<DMAX, ROUND, ROUND>(dpt, Vs, dOs, v + base, k0, s, 1.f, dout + base, q0, s,
                                         1.f, d, ty, tx);
      __syncthreads();  // the score products' readers of Qs, dOs are done
      load_chunk<DMAX, ROUND>(Qs, q + base, q0, s, d, c_out, scale_q);
      load_chunk<DMAX, ROUND>(dOs, dout + base, q0, s, d, c_out, 1.f);
    } else {
      __syncthreads();
      load_tile<DMAX, ROUND>(Qs, q + base, q0, s, d, scale_q);
      load_tile<DMAX, ROUND>(dOs, dout + base, q0, s, d, 1.f);
    }
    if (threadIdx.x < BQ) {
      const int qp = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qp < s ? lse[static_cast<size_t>(bh) * s + qp] : 0.f;
      delta_s[threadIdx.x] = qp < s ? delta[static_cast<size_t>(bh) * s + qp] : 0.f;
    }
    __syncthreads();
    if constexpr (!WIDE) {
      mma_nt<LD>(st, Ks, Qs, kd, ty, tx);
      mma_nt<LD>(dpt, Vs, dOs, kd, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j;
        const bool vis = causal_visible(q0 + qj, kp, s, causal, q_off, kv_off);
        const float p = vis ? expf(st[i][j] - lse_s[qj]) : 0.f;
        Ps[(ty + 16 * i) * LDP + qj] = tier<ROUND>(p);
        dSs[(ty + 16 * i) * LDP + qj] = tier<ROUND>(p * (dpt[i][j] - delta_s[qj]));
      }
    }
    __syncthreads();
    mma_nn<DMAX>(acc_v, Ps, dOs, ty, tx);
    mma_nn<DMAX>(acc_k, dSs, Qs, ty, tx);
  }

  T* dkb = dk + base;
  T* dvb = dv + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= s) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c_out + 64 * g + 4 * tx + c;
        if (col < d) {
          store(&dkb[static_cast<size_t>(kp) * d + col], acc_k[i][4 * g + c]);
          store(&dvb[static_cast<size_t>(kp) * d + col], acc_v[i][4 * g + c]);
        }
      }
  }
}

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || s <= 0 || d <= 0 || bh > 65535 ||
         static_cast<long long>(bh) * s * d > (1LL << 40);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int fwd_typed(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
              int d, float scale_q, int causal, int q_off, int kv_off, cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, bh, out_chunks<DMAX, WIDE>(d));
  return launch(flash_fwd_kernel<DMAX, ROUND, T, WIDE>, fwd_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), s, d, scale_q, causal, q_off,
                kv_off);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dq_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int bh, int s, int d, float scale_q, float sm_scale,
             int causal, int q_off, int kv_off, cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, bh, out_chunks<DMAX, WIDE>(d));
  return launch(flash_dq_kernel<DMAX, ROUND, T, WIDE>, dq_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), s, d, scale_q, sm_scale,
                causal, q_off, kv_off);
}

template <int DMAX, bool ROUND, typename T, bool WIDE>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int bh, int s, int d, float scale_q,
              int causal, int q_off, int kv_off, cudaStream_t stream) {
  const dim3 grid((s + BK - 1) / BK, bh, out_chunks<DMAX, WIDE>(d));
  return launch(flash_dkv_kernel<DMAX, ROUND, T, WIDE>, dkv_smem<DMAX>(), grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s,
                d, scale_q, causal, q_off, kv_off);
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype codes: 0 = float32,
// 1 = bfloat16 (q, k, v, do and the outputs o, dq, dk, dv share it); lse
// and delta are fp32. round_bf16 selects the 'default' tier for fp32
// inputs. Each launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int bh, int s, int d, float scale_q, int causal, int q_off,
                         int kv_off, int round_bf16, int device, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(fwd_typed, q, k, v, o, lse, bh, s, d, scale_q, causal, q_off, kv_off, st);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int dtype, int bh, int s,
                        int d, float scale_q, float sm_scale, int causal, int q_off, int kv_off,
                        int round_bf16, int device, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(dq_typed, q, k, v, dout, lse, delta, dq, bh, s, d, scale_q, sm_scale, causal,
                 q_off, kv_off, st);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int dtype,
                         int bh, int s, int d, float scale_q, int causal, int q_off, int kv_off,
                         int round_bf16, int device, void* stream) {
  if (bad_shape(bh, s, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  ATTN_DISPATCH(dkv_typed, q, k, v, dout, lse, delta, dk, dv, bh, s, d, scale_q, causal, q_off,
                 kv_off, st);
}
