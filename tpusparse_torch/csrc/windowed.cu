// Windowed gather and windowed segment sum for NVIDIA Hopper (sm_90a): the
// two index operations of a host window plan (tpusparse_torch/kernels/
// windowed.py), whose canonical client is the SpGEMM schedule
// (tpusparse_torch/spgemm.py: the gather of A's values, the gather of dC in
// the backward, and the accumulation of the products into C's slots).
//
// Replaces the TPU kernels tpusparse/kernels/windowed.py:148 _gather_kernel
// (pallas_call l.175, behind windowed_gather l.207) and :314 _segsum_kernel
// (pallas_call l.348, behind windowed_segment_sum l.383). The TPU has no
// vector gather, so those kernels held the whole table (or y) in VMEM and
// swept each 128-index span's window with a one-hot compare-and-sum over
// (8, 128) blocks. Nothing of that carries over: the GPU gathers, so the
// gather reads its one element; the segment sum groups each span's window
// of y in shared memory, a chunk at a time, so its shared memory is bounded
// by the chunk, not by the window or by y.
//
// Contract of windowed_gather. table (table_len) fp32, bf16 or fp16; rel
// (>= n) int32, the index minus its span's start, with the window W as the
// pad marker; starts (>= ceil(n / 128)) int32, one per 128-position span.
// For p < n: out[p] = T(0.0f + float(table[starts[p / 128] + rel[p]])) when
// 0 <= rel[p] < W and that index lies in the table, else 0. The sum that
// starts at 0.0f is the TPU kernel's own (its fp32 accumulator starts at 0),
// so a stored -0.0 comes out as +0.0 and the result equals JAX's bit for
// bit. Positions at or past n (the plan's padded tail) are never written.
//
// Contract of windowed_segsum. y (n_in) fp32, bf16 or fp16; seg (n_in)
// int32, the segment of each entry, -1 where the plan sends the entry down
// its exception path; starts (>= ceil(num_segments / 128)) int32, the
// 128-aligned start of each 128-segment span's window of y. For
// o < num_segments, with s = o / 128:
//   out[o] = T(sum over j in [starts[s], starts[s] + W), j < n_in, seg[j] == o
//              of float(y[j])),
// summed in fp32 from 0.0f in ascending j. Positions past n_in count as
// id -1 (the TPU wrapper pads y with zeros and seg with -1 instead); an
// entry whose id is not o adds nothing, whatever its value.
//
// What bounds them. Both move little and compute less: the gather reads
// rel and one table element a position and writes out (fp32: 12 bytes a
// position); the segment sum reads seg and y once over its windows and
// writes out once. At the SpGEMM shapes (1.1 M products) that is ~13 MB,
// ~4 us at 3.35 TB/s: launch overhead and the gather's scattered reads
// dominate. Design: the gather is one thread a position, reads coalesced
// in rel and out, and goes to L2 for the table (a span's indices lie within
// one window, so neighbouring threads read neighbouring lines).
//
// The segment sum is one block a 128-segment span and groups its window by
// segment once, in O(W), with a stable counting sort in shared memory; the
// maps need not be sorted (AMG's aggregation maps are not). The window is
// taken in chunks of 8 positions a thread (a block of 1, 2 or 4 warps for
// windows up to 256, 512 or 1,024, else 16: chunks of 256 to 4,096), and
// the next chunk's ids and values are loaded while the block sorts and adds
// the current one (y is read whatever the id, so no load waits on another).
// Warp w owns a contiguous run of the chunk's 32-position groups, so
// positions ascend with (warp, group, lane). For each entry of the span
// (local id seg - 128 span in [0, 128); any other id, -1 included, is
// dropped) the block
//   1. counts it in cnt[id][w]: __match_any_sync finds the lanes of a group
//      with the same id, and the lowest of them adds their number (plain
//      integer adds: each warp owns its column);
//   2. scans cnt in (id, warp) order into each pair's first slot (and
//      zeroes cnt for the next chunk: four barriers a chunk in all);
//   3. places its value at that slot plus its rank among the group's equal
//      ids below its lane, and the warp advances the slot by the group's
//      count: a stable sort, so each id's values lie in ascending position;
//   4. adds each id's run, in order, to the id's fp32 sum from 0.0f (one
//      thread an id, or 2 or 4 in a smaller block; carried across chunks,
//      which ascend).
// That is ascending position within each segment, the order the plain
// version (windowed.py: _segsum_plain) repeats, so the two are bitwise
// equal; there are no float atomics. A sorted chunk skips steps 1-3: while
// every chunk of the span so far had its ids in nondecreasing order (ids
// below the span first, above it last; SpGEMM's maps are sorted), each
// id's entries already lie together in ascending position, so the block
// finds each run's ends from the neighbouring ids and adds it in place. The
// first unsorted chunk sends the span down steps 1-4 for good, and windows
// past 1,024 (the 16-warp block) always take them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SPAN = 128;         // positions (gather) or segments (sum) per span
constexpr int GATHER_THREADS = 256;
constexpr int SEG_PER_THREAD = 8;  // window positions a segment-sum thread holds a pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
    windowed_gather_kernel(const T* __restrict__ table, const int* __restrict__ rel,
                           const int* __restrict__ starts, T* __restrict__ out, int n,
                           int table_len, int window) {
  const int p = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (p >= n) return;
  const int r = rel[p];
  float acc = 0.f;
  if (r >= 0 && r < window) {
    const long long t = static_cast<long long>(starts[p / SPAN]) + r;
    if (t < table_len) acc = __fadd_rn(acc, to_f32(table[t]));  // 0.0f + x: -0.0 -> +0.0
  }
  out[p] = from_f32<T>(acc);
}

// Start the loads of one chunk of a span's window: this warp's groups of 32
// positions from c0, raw ids (PAST outside [0, n_in) or past the chunk) and
// values (y is read whatever the id, so no load waits for another).
constexpr int PAST = 0x7fffffff;

template <typename T, int WARPS>
__device__ __forceinline__ void load_chunk(const T* __restrict__ y, const int* __restrict__ seg,
                                           long long st, int c0, int window, int n_in, int warp,
                                           int lane, int (&id)[SEG_PER_THREAD],
                                           float (&val)[SEG_PER_THREAD]) {
  const int len = min(WARPS * 32 * SEG_PER_THREAD, window - c0);
  const int per_warp = ((len + 31) / 32 + WARPS - 1) / WARPS;
#pragma unroll
  for (int s = 0; s < SEG_PER_THREAD; ++s) {
    const int c = (warp * per_warp + s) * 32 + lane;
    const long long j = st + c0 + c;
    const bool in = s < per_warp && c < len && j >= 0 && j < n_in;
    id[s] = in ? seg[j] : PAST;
    val[s] = in ? to_f32(y[j]) : 0.f;
  }
}

template <typename T, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    windowed_segsum_kernel(const T* __restrict__ y, const int* __restrict__ seg,
                           const int* __restrict__ starts, T* __restrict__ out, int n_in,
                           int num_segments, int window) {
  constexpr int THREADS = WARPS * 32;
  constexpr int CHUNK = THREADS * SEG_PER_THREAD;  // window positions a pass
  constexpr int NCNT = SPAN * WARPS;               // (id, warp) counters
  constexpr int CNT_PER_THREAD = NCNT / THREADS;   // 4
  constexpr int IDS = (SPAN + THREADS - 1) / THREADS;  // ids a thread sums
  __shared__ float s_val[CHUNK];          // the chunk's kept values, grouped by id
  __shared__ unsigned char s_rank[CHUNK];  // each position's id + 1, 0 below the span
  __shared__ int s_cnt[NCNT];             // [id * WARPS + warp]: counts
  __shared__ int s_slot[NCNT];            // the next free place of each (id, warp)
  __shared__ int s_run[SPAN + 1];         // where each id's run starts
  __shared__ int s_wsum[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int seg0 = blockIdx.x * SPAN;
  const long long st = starts[blockIdx.x];
  for (int e = threadIdx.x; e < NCNT; e += THREADS) s_cnt[e] = s_slot[e] = 0;
  for (int e = threadIdx.x; e <= SPAN; e += THREADS) s_run[e] = 0;
  int id[SEG_PER_THREAD];
  float val[SEG_PER_THREAD];
  load_chunk<T, WARPS>(y, seg, st, 0, window, n_in, warp, lane, id, val);
  float acc[IDS];
#pragma unroll
  for (int r = 0; r < IDS; ++r) acc[r] = 0.f;
  // look for a sorted chunk while every chunk so far was one; not in the
  // 16-warp block (windows past 1,024, AMG's unsorted maps), which runs
  // faster without the sorted path's registers
  bool check = WARPS < 16;
  for (int c0 = 0; c0 < window; c0 += CHUNK) {
    // this warp's groups of the chunk (warp-uniform)
    const int groups = ((min(CHUNK, window - c0) + 31) / 32 + WARPS - 1) / WARPS;
    int key[SEG_PER_THREAD];  // the local id, SPAN when dropped
    float kept[SEG_PER_THREAD];
    unsigned peers[SEG_PER_THREAD];
    int rank[SEG_PER_THREAD];  // 0 below the span, id + 1 in it, SPAN + 1 above
#pragma unroll
    for (int s = 0; s < SEG_PER_THREAD; ++s) {
      const int o = id[s] - seg0;
      key[s] = (id[s] >= 0 && o >= 0 && o < SPAN) ? o : SPAN;
      rank[s] = id[s] < seg0 ? 0 : min(o, SPAN) + 1;
      kept[s] = val[s];
      peers[s] = 0u;
    }
    // the next chunk's loads fly while this one is sorted and added
    if (c0 + CHUNK < window) {
      load_chunk<T, WARPS>(y, seg, st, c0 + CHUNK, window, n_in, warp, lane, id, val);
    }
    if (check) {
      // sorted: each id's entries lie together, in ascending position, so
      // its run is found from its neighbours and nothing needs to move. The
      // warp checks its own groups first; an unsorted map stops there.
      bool ok = true;
#pragma unroll
      for (int s = 0; s < SEG_PER_THREAD; ++s) {
        const int up = __shfl_up_sync(0xffffffffu, rank[s], 1);
        const int last = __shfl_sync(0xffffffffu, rank[s > 0 ? s - 1 : 0], 31);
        if (s < groups) ok = ok && (lane > 0 ? up : (s > 0 ? last : 0)) <= rank[s];
      }
      check = __syncthreads_and(ok);  // also: the counters zero, the last chunk added
      if (check) {
#pragma unroll
        for (int s = 0; s < SEG_PER_THREAD; ++s) {
          if (s < groups) {
            s_rank[(warp * groups + s) * 32 + lane] = static_cast<unsigned char>(rank[s]);
          }
        }
        __syncthreads();
        const int c = warp * groups * 32;  // where this warp's groups meet the last warp's
        check = __syncthreads_and(warp == 0 || groups == 0 || s_rank[c - 1] <= s_rank[c]);
      }
    }
    if (check) {
      const int npos = groups * WARPS * 32;
#pragma unroll
      for (int s = 0; s < SEG_PER_THREAD; ++s) {
        const int c = (warp * groups + s) * 32 + lane;
        if (s < groups && key[s] < SPAN) {
          s_val[c] = kept[s];
          if (c == 0 || s_rank[c - 1] != s_rank[c]) s_run[key[s]] = c;
          if (c + 1 == npos || s_rank[c + 1] != s_rank[c]) s_slot[key[s]] = c + 1;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < IDS; ++r) {
        const int l = threadIdx.x + r * THREADS;
        if (l < SPAN) {
          const int lo = s_run[l], hi = s_slot[l];  // hi <= lo when l has none
          for (int q = lo; q < hi; ++q) acc[r] = __fadd_rn(acc[r], s_val[q]);
          s_run[l] = s_slot[l] = 0;
        }
      }
      continue;
    }
    // 1. each id of this warp's groups; __match_any_sync finds the lanes of
    // a group with the same id, the lowest of them counts them
#pragma unroll
    for (int s = 0; s < SEG_PER_THREAD; ++s) {
      if (s < groups) {
        peers[s] = __match_any_sync(0xffffffffu, key[s]);
        if (key[s] < SPAN && (peers[s] & below) == 0u) {
          s_cnt[key[s] * WARPS + warp] += __popc(peers[s]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // 2. exclusive scan of the counters in (id, warp) order; each thread
    // zeroes the counters it read, for the next chunk
    {
      const int b = threadIdx.x * CNT_PER_THREAD;
      int v[CNT_PER_THREAD];
      int tot = 0;
#pragma unroll
      for (int e = 0; e < CNT_PER_THREAD; ++e) {
        v[e] = s_cnt[b + e];
        s_cnt[b + e] = 0;
        tot += v[e];
      }
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (lane == 31) s_wsum[warp] = incl;
      __syncthreads();
      int ex = incl - tot;
      for (int w = 0; w < warp; ++w) ex += s_wsum[w];
#pragma unroll
      for (int e = 0; e < CNT_PER_THREAD; ++e) {
        if ((b + e) % WARPS == 0) s_run[(b + e) / WARPS] = ex;
        s_slot[b + e] = ex;
        ex += v[e];
      }
      if (threadIdx.x == THREADS - 1) s_run[SPAN] = ex;
    }
    __syncthreads();
    // 3. stable placement: a value goes to its (id, warp) slot plus its rank
    // among the group's equal ids below its lane
#pragma unroll
    for (int s = 0; s < SEG_PER_THREAD; ++s) {
      if (s < groups) {
        const int slot = key[s] * WARPS + warp;
        if (key[s] < SPAN) s_val[s_slot[slot] + __popc(peers[s] & below)] = kept[s];
        __syncwarp();
        if (key[s] < SPAN && (peers[s] & below) == 0u) s_slot[slot] += __popc(peers[s]);
        __syncwarp();
      }
    }
    __syncthreads();
    // 4. each id's run, in ascending position
#pragma unroll
    for (int r = 0; r < IDS; ++r) {
      const int l = threadIdx.x + r * THREADS;
      if (l < SPAN) {
        const int hi = s_run[l + 1];
        for (int q = s_run[l]; q < hi; ++q) acc[r] = __fadd_rn(acc[r], s_val[q]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < IDS; ++r) {
    const int l = threadIdx.x + r * THREADS;
    if (l < SPAN && seg0 + l < num_segments) out[seg0 + l] = from_f32<T>(acc[r]);
  }
}

template <typename T>
int launch_gather(const void* table, const int* rel, const int* starts, void* out, int n,
                  int table_len, int window, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n + GATHER_THREADS - 1) / GATHER_THREADS);
  windowed_gather_kernel<T><<<grid, GATHER_THREADS, 0, s>>>(
      static_cast<const T*>(table), rel, starts, static_cast<T*>(out), n, table_len, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segsum(const void* y, const int* seg, const int* starts, void* out, int n_in,
                  int num_segments, int window, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((num_segments + SPAN - 1) / SPAN);
  auto yy = static_cast<const T*>(y);
  auto o = static_cast<T*>(out);
  // the block whose chunk (8 positions a thread) first covers the window,
  // up to 16 warps: more, smaller blocks fill the card for narrow windows
  if (window <= 256) {
    windowed_segsum_kernel<T, 1><<<grid, 32, 0, s>>>(yy, seg, starts, o, n_in, num_segments,
                                                     window);
  } else if (window <= 512) {
    windowed_segsum_kernel<T, 2><<<grid, 64, 0, s>>>(yy, seg, starts, o, n_in, num_segments,
                                                     window);
  } else if (window <= 1024) {
    windowed_segsum_kernel<T, 4><<<grid, 128, 0, s>>>(yy, seg, starts, o, n_in, num_segments,
                                                      window);
  } else {
    windowed_segsum_kernel<T, 16><<<grid, 512, 0, s>>>(yy, seg, starts, o, n_in,
                                                       num_segments, window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (the table's, or y's, and the output's). Each launches on
// `stream` (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int windowed_gather(const void* table, const void* rel, const void* starts, void* out,
                               int dtype, int n, int table_len, int window, int device,
                               void* stream) {
  if (n <= 0 || table_len < 0 || window <= 0 || window % SPAN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const int*>(rel);
  auto st = static_cast<const int*>(starts);
  if (dtype == 0) return launch_gather<float>(table, r, st, out, n, table_len, window, s);
  if (dtype == 1) return launch_gather<__nv_bfloat16>(table, r, st, out, n, table_len, window, s);
  if (dtype == 2) return launch_gather<__half>(table, r, st, out, n, table_len, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int windowed_segsum(const void* y, const void* seg, const void* starts, void* out,
                               int dtype, int n_in, int num_segments, int window, int device,
                               void* stream) {
  if (num_segments <= 0 || n_in < 0 || window <= 0 || window % SPAN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto sg = static_cast<const int*>(seg);
  auto st = static_cast<const int*>(starts);
  if (dtype == 0) return launch_segsum<float>(y, sg, st, out, n_in, num_segments, window, s);
  if (dtype == 1)
    return launch_segsum<__nv_bfloat16>(y, sg, st, out, n_in, num_segments, window, s);
  if (dtype == 2) return launch_segsum<__half>(y, sg, st, out, n_in, num_segments, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
