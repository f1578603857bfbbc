// Kernel H: sweep_compact — the sweep table's compaction at a segment end.
//
// Replaces pgrc_tpu/overlap/greedy_scs.py `_build_compact_fn.compact_fn`
// (:488-528: a stable partition of the rows with a_s | a_p to the front by
// one sort, then a take of every per-row array) and the host's count
// readback that decides it (:391-397, :816-823). Rows with keep = a_s | a_p
// move, in row order, to the front of the output arrays: the lanes
// [n, ld_lanes] and N-mask [n, ld_nmask] rows (int32 words), ids (int32),
// the four rolled hashes h, p, h2, p2 (int64) and a_s, a_p (bool). The
// output arrays are sized n (the caller's choice, PERF.md section 5); the
// kept rows fill their first k. Dropped rows have written their links
// already, so compaction moves rows and never changes a link (:824-826).
//
// The same pass writes three totals to scratch words kTotalsWord.. (see
// seg_scan.cuh): the kept rows k, the active suffixes and the active
// prefixes. The host reads the three in one copy: the sweep stops when
// either side has none left (the reference's test, :818-819) and else
// takes the first k rows of each output.
//
// What bounds H on the card: memory, the flags of every row (2 B) and each
// kept row's ~72 B (at L = 100) read once and written once. What the
// design does about it: one pass — the keep flags of a thread's eight
// consecutive rows go through seg_scan.cuh's count scan (one segment, the
// warp-wide decoupled look-back; the state carries the kept count and the
// two side counts packed in one word), each row's output slot goes to
// shared memory, and the copies run striped over the tile so that
// consecutive threads read consecutive words (a warp copies whole lane
// rows, 32 / ld of them a pass).
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::State;

// Copy the words of the tile's kept rows of a row-major [n, ld] int32
// matrix (ld <= 32: at most 17 lane words at L <= 255): a warp copies
// 32 / ld whole rows a pass, lane l word l mod ld, so a pass reads one
// contiguous run of the source and no index is divided in the loop.
__device__ __forceinline__ void copy_rows(const int32_t* __restrict__ src,
                                          int32_t* __restrict__ dst, int ld, int64_t first,
                                          long long base, const int* s_slot) {
  const int lane = threadIdx.x & 31, per = 32 / ld;
  const int sub = lane / ld, w = lane - sub * ld;
  if (sub >= per) return;
  for (int row = (threadIdx.x >> 5) * per + sub; row < seg_scan::kTile;
       row += seg_scan::kWarps * per) {
    const int d = s_slot[row];
    if (d >= 0) dst[(base + d) * ld + w] = src[(first + row) * ld + w];
  }
}

__global__ void __launch_bounds__(seg_scan::kThreads, seg_scan::kMinBlocks)
sweep_compact_kernel(int64_t n, const int32_t* __restrict__ lanes, int ld_lanes,
                     const int32_t* __restrict__ nmask, int ld_nmask,
                     const int32_t* __restrict__ ids, const long long* __restrict__ h,
                     const long long* __restrict__ p, const long long* __restrict__ h2,
                     const long long* __restrict__ p2, const bool* __restrict__ a_s,
                     const bool* __restrict__ a_p, int32_t* __restrict__ o_lanes,
                     int32_t* __restrict__ o_nmask, int32_t* __restrict__ o_ids,
                     long long* __restrict__ o_h, long long* __restrict__ o_p,
                     long long* __restrict__ o_h2, long long* __restrict__ o_p2,
                     bool* __restrict__ o_as, bool* __restrict__ o_ap, long long* scratch) {
  using namespace seg_scan;
  __shared__ int s_slot[kTile];   // the row's output slot in the tile's run, or -1
  __shared__ long long s_base;
  const int64_t tile = next_tile(scratch);
  const int64_t first = tile * kTile;
  const int mine = threadIdx.x * kItems;

  // keep flags of the thread's kItems consecutive rows; State: (kept,
  // active suffixes + active prefixes << 32), each below 2^30
  unsigned keep = 0;
  long long suf = 0, pref = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = first + mine + j;
    if (r < n) {
      const bool s = a_s[r], pr = a_p[r];
      keep |= (unsigned)(s | pr) << j;
      suf += s;
      pref += pr;
    }
  }
  const long long cnt = __popc(keep);
  const State pre = thread_prefix<CountOp>({cnt, suf + (pref << 32)}, scratch, tile);
  if (threadIdx.x == 0) s_base = pre.a;
  __syncthreads();
  int slot = (int)(pre.a - s_base);
#pragma unroll
  for (int j = 0; j < kItems; ++j) s_slot[mine + j] = (keep >> j) & 1 ? slot++ : -1;
  if (threadIdx.x == kThreads - 1 && tile == tiles_for(n) - 1) {
    const long long sides = pre.b + suf + (pref << 32);
    scratch[kTotalsWord] = pre.a + cnt;
    scratch[kTotalsWord + 1] = sides & 0xFFFFFFFFll;
    scratch[kTotalsWord + 2] = sides >> 32;
  }
  __syncthreads();
  const long long base = s_base;

  // the kept rows, striped
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const int d = s_slot[idx];
    if (d >= 0) {
      const int64_t r = first + idx, o = base + d;
      o_ids[o] = ids[r];
      o_h[o] = h[r];
      o_p[o] = p[r];
      o_h2[o] = h2[r];
      o_p2[o] = p2[r];
      o_as[o] = a_s[r];
      o_ap[o] = a_p[r];
    }
  }
  copy_rows(lanes, o_lanes, ld_lanes, first, base, s_slot);
  if (nmask != nullptr) copy_rows(nmask, o_nmask, ld_nmask, first, base, s_slot);
}

}  // namespace

// Inputs [n] (lanes [n, ld_lanes], nmask [n, ld_nmask] or null), outputs of
// the same shapes; scratch: seg_scan::scratch_words(n) int64 words, zeroed
// here; the totals (kept, active suffixes, active prefixes) land in
// scratch[kTotalsWord ..].
extern "C" int pgrc_sweep_compact(int device, void* stream, int64_t n, const void* lanes,
                                  int ld_lanes, const void* nmask, int ld_nmask, const void* ids,
                                  const void* h, const void* p, const void* h2, const void* p2,
                                  const void* a_s, const void* a_p, void* o_lanes,
                                  void* o_nmask, void* o_ids, void* o_h, void* o_p, void* o_h2,
                                  void* o_p2, void* o_as, void* o_ap, void* scratch,
                                  int64_t scratch_words) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (scratch_words < seg_scan::scratch_words(n) || ld_lanes > 32 || ld_nmask > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = seg_scan::zero_scratch(scratch, n, s);
  if (err != cudaSuccess || n == 0) return (int)err;
  sweep_compact_kernel<<<(unsigned)seg_scan::tiles_for(n), seg_scan::kThreads, 0, s>>>(
      n, (const int32_t*)lanes, ld_lanes, (const int32_t*)nmask, ld_nmask,
      (const int32_t*)ids, (const long long*)h, (const long long*)p, (const long long*)h2,
      (const long long*)p2, (const bool*)a_s, (const bool*)a_p, (int32_t*)o_lanes,
      (int32_t*)o_nmask, (int32_t*)o_ids, (long long*)o_h, (long long*)o_p, (long long*)o_h2,
      (long long*)o_p2, (bool*)o_as, (bool*)o_ap, (long long*)scratch);
  return (int)cudaGetLastError();
}
