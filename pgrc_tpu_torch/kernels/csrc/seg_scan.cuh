// seg_scan.cuh — the device-wide scan that kernels E (join_carry.cu) and F
// (sweep_pair_claim.cu) share: one pass over the entries, with decoupled
// look-back, and each kernel's epilogue in the same pass.
//
// A block of kThreads threads takes one tile of kTile consecutive entries.
// Tiles are numbered by an atomic counter, not by blockIdx, so a tile only
// ever waits on tiles that started before it. Warp w of the block takes the
// w-th run of kWarpRun entries in kItems rounds of 32 consecutive entries:
// each round's loads are coalesced, the round is scanned with warp
// shuffles and carried into the next, and every entry's warp-local
// inclusive state stays in registers. One shared-memory step combines the
// warps' aggregates. Thread 0 publishes the tile's aggregate, looks back
// over the earlier tiles' descriptors until it meets an inclusive prefix,
// and publishes the tile's own inclusive prefix. The caller then runs its
// epilogue on each entry's final state, so no scan value goes to device
// memory.
//
// The state is two int64 words; an Op gives identity() and combine(a, b)
// (a before b, associative).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace seg_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kWarpRun = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // 2048 entries
constexpr unsigned kFull = 0xFFFFFFFFu;

struct State {
  long long a, b;
};

// The scratch the wrapper allocates with torch.zeros (int64 words): word 0
// counts the tiles handed out; tile t's descriptor is the kDescWords words
// from kHeadWords + kDescWords * t: [status, agg.a, agg.b, inc.a, inc.b],
// status 0 = nothing yet, 1 = aggregate published, 2 = inclusive prefix
// published. Descriptors are read and written through volatile pointers
// (L2, never a stale L1 line) and a value is fenced before its status.
constexpr int64_t kHeadWords = 8;
constexpr int64_t kDescWords = 8;

__host__ __device__ inline int64_t tiles_for(int64_t m) { return (m + kTile - 1) / kTile; }
__host__ __device__ inline int64_t scratch_words(int64_t m) {
  return kHeadWords + kDescWords * tiles_for(m);
}

__device__ __forceinline__ State shfl_up(State v, int d) {
  return {__shfl_up_sync(kFull, v.a, d), __shfl_up_sync(kFull, v.b, d)};
}

__device__ __forceinline__ State shfl(State v, int lane) {
  return {__shfl_sync(kFull, v.a, lane), __shfl_sync(kFull, v.b, lane)};
}

// Inclusive scan of one state per lane across the warp (Kogge-Stone).
template <typename Op>
__device__ __forceinline__ State warp_scan(State v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const State o = shfl_up(v, d);
    if (lane >= d) v = Op::combine(o, v);
  }
  return v;
}

// The block's tile id, from the counter in scratch word 0.
__device__ __forceinline__ int64_t next_tile(long long* scratch) {
  __shared__ long long s_tile;
  if (threadIdx.x == 0)
    s_tile = (long long)atomicAdd((unsigned long long*)scratch, 1ull);
  __syncthreads();
  return s_tile;
}

__device__ __forceinline__ void publish(volatile long long* desc, State s, int status) {
  if (status == 1) {
    desc[1] = s.a;
    desc[2] = s.b;
  } else {
    desc[3] = s.a;
    desc[4] = s.b;
  }
  __threadfence();
  desc[0] = status;
}

// The combined state of tiles [0, tile): walk back over the descriptors,
// folding aggregates, until an inclusive prefix ends the walk.
template <typename Op>
__device__ State look_back(volatile long long* descs, int64_t tile) {
  State acc = Op::identity();
  for (int64_t p = tile - 1; p >= 0; --p) {
    volatile long long* d = descs + p * kDescWords;
    long long st;
    while ((st = d[0]) == 0) __nanosleep(20);
    __threadfence();
    if (st == 2) return Op::combine(State{d[3], d[4]}, acc);
    acc = Op::combine(State{d[1], d[2]}, acc);
  }
  return acc;
}

// Called by every thread of the block with its warp's aggregate (the warp's
// last warp-local inclusive state, the same in every lane): returns the
// warp's exclusive prefix in the device-wide scan.
template <typename Op>
__device__ State warp_prefix(State warp_agg, long long* scratch, int64_t tile) {
  __shared__ State s_agg[kWarps];
  __shared__ State s_pre[kWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s_agg[warp] = warp_agg;
  __syncthreads();
  if (threadIdx.x == 0) {
    State agg = s_agg[0];
    for (int w = 1; w < kWarps; ++w) agg = Op::combine(agg, s_agg[w]);
    volatile long long* descs = (volatile long long*)(scratch + kHeadWords);
    State pre = Op::identity();
    if (tile == 0) {
      publish(descs, agg, 2);
    } else {
      publish(descs + tile * kDescWords, agg, 1);
      pre = look_back<Op>(descs, tile);
      publish(descs + tile * kDescWords, Op::combine(pre, agg), 2);
    }
    for (int w = 0; w < kWarps; ++w) {
      s_pre[w] = pre;
      pre = Op::combine(pre, s_agg[w]);
    }
  }
  __syncthreads();
  return s_pre[warp];
}

}  // namespace seg_scan
