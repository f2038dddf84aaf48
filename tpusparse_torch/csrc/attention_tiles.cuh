// What the fused attention kernels (flash_attention.cu,
// flash_attention_q8.cu, block_flash_attention.cu) share beside the
// tensor-core tiles of attention_mma.cuh, for NVIDIA Hopper (sm_90a): the
// masked score, the type conversions and the dispatch over dtype, tier and
// head dim.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

constexpr float NEG = -1e30f;  // the TPU kernels' masked score

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Calls FN<DMAX, ROUND, T, WIDE>(args...) for the instance that serves
// (dtype, d, round_bf16): bf16 inputs always round (their p and dS are
// rounded to bf16 in every tier, as on the TPU's non-3-pass tiers). A head
// dim up to 64 takes the 64 instance, up to 128 the 128 instance, and any
// wider one WIDE = true: the wide tensor-core kernels, which pick their own
// instances (d <= 256, d <= 512, and 512-wide chunks of the output above).
#define ATTN_DISPATCH_ONE(FN, ROUND, T, ...)                                   \
  do {                                                                         \
    if (d <= 64) return FN<64, ROUND, T, false>(__VA_ARGS__);                  \
    if (d <= 128) return FN<128, ROUND, T, false>(__VA_ARGS__);                \
    return FN<128, ROUND, T, true>(__VA_ARGS__);                               \
  } while (0)

#define ATTN_DISPATCH(FN, ...)                                                   \
  do {                                                                           \
    if (dtype == 0 && !round_bf16) ATTN_DISPATCH_ONE(FN, false, float, __VA_ARGS__); \
    if (dtype == 0) ATTN_DISPATCH_ONE(FN, true, float, __VA_ARGS__);             \
    if (dtype == 1) ATTN_DISPATCH_ONE(FN, true, __nv_bfloat16, __VA_ARGS__);     \
    return static_cast<int>(cudaErrorInvalidValue);                              \
  } while (0)

}  // namespace attn
