// seg_scan.cuh — the device-wide scan that kernels E (join_carry.cu), F
// (sweep_pair_claim.cu), D (sweep_round.cu) and H (sweep_compact.cu) share:
// one pass over the entries, with decoupled look-back, and each kernel's
// epilogue in the same pass. E and F stage their sorted inputs as below; D
// and H, which compact, count active entries and write them out.
//
// A block of kThreads threads takes one tile of kTile consecutive entries.
// Tiles are numbered by an atomic counter, not by blockIdx, so a tile only
// ever waits on tiles that started before it. The block first copies its
// tile's sorted inputs into shared memory with cp.async (16-byte copies,
// coalesced, no registers held while they fly); thread t then takes the
// kItems consecutive entries from t * kItems, reading them two at a time
// from shared memory, which a swizzle keeps free of bank conflicts. Each
// kernel issues its gathers for all of a thread's entries before the scan.
// The thread folds its entries serially into one aggregate; a warp scan of
// the aggregates, one shared-memory step across the warps and the
// look-back give each thread its exclusive prefix. The caller folds its
// entries again from that prefix and runs its epilogue on each entry's
// final state, so no scan value goes to device memory.
//
// The look-back is warp-wide: warp 0 reads the descriptors of the 32
// preceding tiles at once, one per lane, polling their status with acquire
// loads; it folds them with shuffles up to the nearest tile that has
// published its inclusive prefix, and steps back 32 tiles while none has.
// A tile publishes its aggregate, then its inclusive prefix, each value
// stored before its status word with a release store.
//
// The state is two int64 words; an Op gives identity() and combine(a, b)
// (a before b). combine must be associative — the window and the warp scans
// fold in tree order, not left to right — and identity() a two-sided
// identity on the states the kernel makes. JoinOp (a max, and a segmented
// max reset by the first word), PairOp (two maxima) and the compactions'
// CountOp (two sums) are all three.
//
// The geometry was chosen by timing on an H100 at the inputs of an SE 2M
// encode's first join and first sweep round: 256 threads x 8 entries, in
// shared memory, beat 8 entries in registers, 16 entries a thread, 1024-
// and 4096-entry tiles, and a persistent double-buffered form (PERF.md).
// E, F and D use it. H, whose tile stages ~70-90 bytes a row, has tiles of
// its own size: the tile counts (tiles_for, scratch_words, zero_scratch)
// take the tile, and thread_prefix the block's warps, with E's, F's and D's
// geometry as the default.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace seg_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 entries
constexpr int kChunks = kTile / 2;        // 16-byte chunks of one input's tile
// blocks each SM must hold at once (__launch_bounds__, at most 85 registers
// a thread): the scans wait on dependent loads, so resident warps are what
// keeps bytes in flight
constexpr int kMinBlocks = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct State {
  long long a, b;
};

// The scratch (int64 words), which the wrapper allocates and each kernel's
// entry point zeroes on its stream before the launch (zero_scratch: a
// memset, not a fill kernel): word 0 counts the tiles handed out; tile t's
// descriptor is the kDescWords words from kHeadWords + kDescWords * t:
// [status, -, agg.a, agg.b, inc.a, inc.b, -, -], status 0 = nothing yet,
// 1 = aggregate published, 2 = inclusive prefix published. The values are
// read with L2-coherent loads after an acquire of the status.
constexpr int64_t kHeadWords = 8;
constexpr int64_t kDescWords = 8;
// Head words from kTotalsWord on: the totals that a compacting scan (D,
// sweep_round.cu; H, sweep_compact.cu) writes from its last tile, which the
// host reads in one copy.
constexpr int kTotalsWord = 1;
// The compacting scans' op: two independent sums.
struct CountOp {
  __device__ static State identity() { return {0, 0}; }
  __device__ static State combine(State a, State b) { return {a.a + b.a, a.b + b.b}; }
};
constexpr int kAggWord = 2;
constexpr int kIncWord = 4;

__host__ __device__ inline int64_t tiles_for(int64_t m, int64_t tile = kTile) {
  return (m + tile - 1) / tile;
}
__host__ __device__ inline int64_t scratch_words(int64_t m, int64_t tile = kTile) {
  return kHeadWords + kDescWords * tiles_for(m, tile);
}

// Zero the scratch of a scan over m entries in tiles of `tile` on `stream`.
inline cudaError_t zero_scratch(void* scratch, int64_t m, cudaStream_t stream,
                               int64_t tile = kTile) {
  return cudaMemsetAsync(scratch, 0, scratch_words(m, tile) * sizeof(long long), stream);
}

__device__ __forceinline__ State shfl_up(State v, int d) {
  return {__shfl_up_sync(kFull, v.a, d), __shfl_up_sync(kFull, v.b, d)};
}

__device__ __forceinline__ State shfl_down(State v, int d) {
  return {__shfl_down_sync(kFull, v.a, d), __shfl_down_sync(kFull, v.b, d)};
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

// Shared-memory slot of 16-byte chunk k of a staged tile: thread t reads its
// chunks t * kItems / 2 + c, and eight threads that read (or copy) at once
// land on eight distinct 16-byte bank groups.
static_assert(kItems == 8 || kItems == 16, "the swizzle spreads 4 or 8 chunks a thread");
__device__ __forceinline__ int swz(int k) { return k ^ ((k >> 3) & (kItems / 2 - 1)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem) : "memory");
}

// Start copying tile `tile` of p (m entries; past m: pad) into s (kTile
// words, swizzled by chunk). The ragged end is stored directly.
__device__ __forceinline__ void stage_tile(const long long* __restrict__ p, int64_t m,
                                           int64_t tile, long long pad, long long* s) {
  const int64_t base = tile * kTile;
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  for (int k = threadIdx.x; k < kChunks; k += kThreads) {
    const int64_t e = base + 2 * k;
    long long* dst = s + 2 * swz(k);
    if (e + 2 <= m) {
      if (aligned) {
        cp_async16(dst, p + e);
      } else {
        cp_async8(dst, p + e);
        cp_async8(dst + 1, p + e + 1);
      }
    } else {
      dst[0] = e < m ? p[e] : pad;
      dst[1] = e + 1 < m ? p[e + 1] : pad;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Start copying `bytes` bytes from src (device memory) to dst (shared
// memory, 16-byte aligned), the block's threads striped over them: cp.async
// 16-byte chunks where src is 16-byte aligned, plain byte copies for the
// ragged end (and for all of an unaligned src). Commits no group.
__device__ __forceinline__ void copy_async(void* dst, const void* __restrict__ src, int bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int chunks = (reinterpret_cast<uintptr_t>(s) & 15) == 0 ? bytes >> 4 : 0;
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) cp_async16(d + 16 * k, s + 16 * k);
  for (int i = 16 * chunks + threadIdx.x; i < bytes; i += blockDim.x) d[i] = s[i];
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

// Start copying `cols` columns of `rows` <= kRowsMax 32-bit words, column c
// from src + c * ld (device memory: a column-major table, core/packed.py
// `empty_cols`) to dst + c * kRowsMax (shared memory, 16-byte aligned), the
// block's threads striped over the columns' chunks (kRowsMax a power of two
// and a multiple of 4, so a chunk's column and place are shifts): 16-byte
// cp.async copies where every column starts 16-byte aligned (the table's
// storage rounds its stride up to 32 words), 4-byte ones otherwise and for
// a column's ragged end. Commits no group.
template <int kRowsMax>
__device__ __forceinline__ void copy_cols_async(uint32_t* dst, const uint32_t* __restrict__ src,
                                                int64_t ld, int cols, int rows) {
  static_assert(kRowsMax % 4 == 0 && (kRowsMax & (kRowsMax - 1)) == 0, "a power of two");
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)(4 * ld)) & 15) == 0) {
    constexpr int kPer = kRowsMax / 4;   // chunks a column
    for (int k = threadIdx.x; k < cols * kPer; k += blockDim.x) {
      const int c = k / kPer, w = 4 * (k % kPer);
      if (w >= rows) continue;
      const uint32_t* s = src + c * ld + w;
      uint32_t* d = dst + c * kRowsMax + w;
      if (w + 4 <= rows) {
        cp_async16(d, s);
      } else {
        for (int j = 0; j < rows - w; ++j) cp_async4(d + j, s + j);
      }
    }
  } else {
    for (int k = threadIdx.x; k < cols * kRowsMax; k += blockDim.x) {
      const int c = k / kRowsMax, r = k % kRowsMax;
      if (r < rows) cp_async4(dst + c * kRowsMax + r, src + c * ld + r);
    }
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this thread's latest copy groups are in
// flight; the caller syncs the block before it reads what they staged.
template <int pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// Wait for this block's staged copies; then every thread may read them.
__device__ __forceinline__ void staged_wait() {
  wait_copies<0>();
  __syncthreads();
}

// This thread's entries 2c and 2c + 1 of a staged tile.
__device__ __forceinline__ longlong2 pair_of(const long long* s, int c) {
  return reinterpret_cast<const longlong2*>(s)[swz(threadIdx.x * (kItems / 2) + c)];
}

// Entry i of a staged tile.
__device__ __forceinline__ long long staged(const long long* s, int i) {
  return s[2 * swz(i >> 1) + (i & 1)];
}

// The block's tile id, from the counter in scratch word 0.
__device__ __forceinline__ int64_t next_tile(long long* scratch) {
  __shared__ long long s_tile;
  if (threadIdx.x == 0)
    s_tile = (long long)atomicAdd((unsigned long long*)scratch, 1ull);
  __syncthreads();
  return s_tile;
}

__device__ __forceinline__ long long ld_acquire(const long long* p) {
  long long v;
  asm volatile("ld.acquire.gpu.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(long long* p, long long v) {
  asm volatile("st.release.gpu.s64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One thread publishes s as the tile's aggregate (status 1) or inclusive
// prefix (status 2): the value first, then the status with release order.
__device__ __forceinline__ void publish(long long* desc, State s, int status) {
  *reinterpret_cast<longlong2*>(desc + (status == 1 ? kAggWord : kIncWord)) =
      make_longlong2(s.a, s.b);
  st_release(desc, status);
}

// Called by all of warp 0: the combined state of tiles [0, tile), in every
// lane. Lane l reads tile top - l of the window; the window is folded with
// later tiles on the right, up to its nearest inclusive prefix.
template <typename Op>
__device__ State look_back(long long* descs, int64_t tile, int lane) {
  State acc = Op::identity();
  for (int64_t top = tile - 1;; top -= 32) {
    const int64_t p = top - lane;
    const long long* d = descs + p * kDescWords;
    long long st;
    for (;;) {
      st = p >= 0 ? ld_acquire(d) : 2;
      if (__all_sync(kFull, st != 0)) break;
      __nanosleep(32);
    }
    const unsigned inc = __ballot_sync(kFull, st == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    State v = Op::identity();
    if (lane <= stop && p >= 0) {
      const longlong2 w = __ldcg(reinterpret_cast<const longlong2*>(
          d + (st == 2 ? kIncWord : kAggWord)));
      v = {w.x, w.y};
    }
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const State o = shfl_down(v, s);
      if (lane + s < 32) v = Op::combine(o, v);
    }
    acc = Op::combine(shfl(v, 0), acc);
    if (inc) return acc;
  }
}

// Called by every thread of the block (kBlockWarps warps) with the
// aggregate of its entries: returns the thread's exclusive prefix in the
// device-wide scan.
template <typename Op, int kBlockWarps = kWarps>
__device__ State thread_prefix(State agg, long long* scratch, int64_t tile) {
  static_assert(kBlockWarps <= 32, "warp 0 scans one state a warp");
  __shared__ State s_warp[kBlockWarps];
  __shared__ State s_pre[kBlockWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const State inc = warp_scan<Op>(agg, lane);
  State excl = shfl_up(inc, 1);
  if (lane == 0) excl = Op::identity();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const State w = warp_scan<Op>(lane < kBlockWarps ? s_warp[lane] : Op::identity(), lane);
    const State block = shfl(w, kBlockWarps - 1);
    State wex = shfl_up(w, 1);
    if (lane == 0) wex = Op::identity();
    long long* descs = scratch + kHeadWords;
    State pre = Op::identity();
    if (tile == 0) {
      if (lane == 0) publish(descs, block, 2);
    } else {
      if (lane == 0) publish(descs + tile * kDescWords, block, 1);
      pre = look_back<Op>(descs, tile, lane);
      if (lane == 0) publish(descs + tile * kDescWords, Op::combine(pre, block), 2);
    }
    if (lane < kBlockWarps) s_pre[lane] = Op::combine(pre, wex);
  }
  __syncthreads();
  return Op::combine(s_pre[warp], excl);
}

}  // namespace seg_scan
