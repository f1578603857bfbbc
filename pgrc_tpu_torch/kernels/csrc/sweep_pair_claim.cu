// Kernel F: sweep_pair_claim — an overlap round's ranks, pairing, claim and
// link writes, after its sort.
//
// Replaces pgrc_tpu/overlap/greedy_scs.py `_build_seg_fn.round_fn`'s ranks
// and pairing (:267-322: the seg_start and first-suffix cummaxes, the
// sort-2 pairing and the sort-3 route back to rows) and the link flush
// (:381-385). The port pairs by index instead of by sort: inside a run of
// equal hashes the prefixes come first (entries are built in (side, gid)
// order and sorted stably), so the suffix of rank r counted from the run's
// first suffix pairs with the prefix at seg_start + r, when the run has
// more than r prefixes.
//
// Input: the round's stable-sorted order keys ks [m] and entry indices ent
// [m] into the table's 2n entries (kernel D's order: entry r < n is row
// r's prefix, entry n + r row r's suffix), the table's ids [n] and rolled
// confirm hashes p2, h2 [n]. An entry's side is ent >= n, its row ent mod
// n, its gid ids[row] and its confirm hash p2[row] (prefix) or h2[row]
// (suffix): nothing is gathered per entry. In place: succ_g / ovl_g
// (global links), a_s / a_p (the table's active flags).
//
// The scan carries two plain maxima: seg_start (an entry contributes its
// index where a run starts, else 0) and fs (its index where a run of
// suffixes starts — a suffix whose left neighbour is a prefix or lies in
// another run — else -1). In the epilogue a suffix at e has rank
// e - fs and pairs when rank < fs - seg_start; its partner's entry
// pe = ent[seg_start + rank] is a prefix, so pe is the partner's row. A
// pair whose gids differ and whose confirm hashes agree links:
// succ_g[ids[row]] = ids[pe], ovl_g[...] = L - i, a_s[row] = 0. Every
// paired suffix clears a_p[pe], confirmed or not: the reference's
// conservative claim (:314-318). Each suffix pairs at most once and each
// prefix with at most one suffix, so every write lands on its own element:
// no atomics.
//
// What bounds it on the card: memory. Each entry's key and index are read
// once (16 B); a pair reads ids and p2 of its prefix and ids and h2 of its
// suffix and clears a_p (25 B); a link writes succ, ovl and a_s (9 B). What
// the design does about it: one pass (seg_scan.cuh), the keys and indices
// staged in shared memory by cp.async, side and row computed from the
// index, the partners' entries loaded for all of a thread's pairs before
// their gathers, no scan value in device memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::State;

struct PairOp {
  __device__ static State identity() { return {0, -1}; }
  __device__ static State combine(State a, State b) {
    return {a.a > b.a ? a.a : b.a, a.b > b.b ? a.b : b.b};
  }
};

// An entry's contribution: (its index if it starts a run, else 0; its
// index if it starts a run of suffixes, else -1).
__device__ __forceinline__ State entry_state(int64_t e, int64_t m, int64_t n, long long key,
                                             long long en, long long prev_key,
                                             long long prev_en) {
  if (e >= m) return PairOp::identity();
  const bool boundary = e == 0 || key != prev_key;
  const bool first_suf = en >= n && (prev_en < n || boundary);
  return {boundary ? e : 0, first_suf ? e : -1};
}

__global__ void __launch_bounds__(seg_scan::kThreads, seg_scan::kMinBlocks)
sweep_pair_claim_kernel(int64_t m, int64_t n, const long long* __restrict__ ks,
                        const long long* __restrict__ ent, const int32_t* __restrict__ ids,
                        const int64_t* __restrict__ p2, const int64_t* __restrict__ h2,
                        int32_t* __restrict__ succ_g, int32_t* __restrict__ ovl_g,
                        bool* __restrict__ a_s, bool* __restrict__ a_p, int ovl,
                        long long* scratch) {
  using namespace seg_scan;
  __shared__ __align__(16) long long s_ks[kTile];
  __shared__ __align__(16) long long s_en[kTile];
  const int64_t tile = next_tile(scratch);
  stage_tile(ks, m, tile, 0, s_ks);
  stage_tile(ent, m, tile, 0, s_en);
  const int64_t first = tile * kTile + (int64_t)threadIdx.x * kItems;
  // key and index left of the thread's first entry: thread 0 reads them
  // while the tile is copied, the others from the tile
  long long left_key = 0, left_en = 0;
  if (threadIdx.x == 0 && first > 0) {
    left_key = ks[first - 1];
    left_en = ent[first - 1];
  }
  staged_wait();
  if (threadIdx.x > 0) {
    left_key = staged(s_ks, threadIdx.x * kItems - 1);
    left_en = staged(s_en, threadIdx.x * kItems - 1);
  }

  State agg = PairOp::identity();
  long long pk = left_key, pn = left_en;
#pragma unroll
  for (int c = 0; c < kItems / 2; ++c) {
    const longlong2 k = pair_of(s_ks, c), en = pair_of(s_en, c);
    const int64_t e = first + 2 * c;
    agg = PairOp::combine(agg, entry_state(e, m, n, k.x, en.x, pk, pn));
    agg = PairOp::combine(agg, entry_state(e + 1, m, n, k.y, en.y, k.x, en.x));
    pk = k.y;
    pn = en.y;
  }
  State acc = thread_prefix<PairOp>(agg, scratch, tile);
  // each paired suffix's partner position, then its partner's entry (-1:
  // not a paired suffix); every partner load is issued before the gathers
  long long part[kItems];
  pk = left_key;
  pn = left_en;
#pragma unroll
  for (int c = 0; c < kItems / 2; ++c) {
    const longlong2 k = pair_of(s_ks, c), en = pair_of(s_en, c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t e = first + 2 * c + h;
      const long long key = h ? k.y : k.x, me = h ? en.y : en.x;
      acc = PairOp::combine(acc, entry_state(e, m, n, key, me, h ? k.x : pk, h ? en.x : pn));
      const long long rank = e - acc.b;
      part[2 * c + h] = (e < m && me >= n && rank < acc.b - acc.a) ? acc.a + rank : -1;
    }
    pk = k.y;
    pn = en.y;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) part[j] = part[j] >= 0 ? ent[part[j]] : -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long pe = part[j];
    if (pe < 0) continue;
    const int64_t srow = staged(s_en, threadIdx.x * kItems + j) - n;
    const int32_t gid_p = ids[pe], gid_s = ids[srow];
    if (gid_p != gid_s && p2[pe] == h2[srow]) {
      succ_g[gid_s] = gid_p;
      ovl_g[gid_s] = ovl;
      a_s[srow] = false;
    }
    a_p[pe] = false;
  }
}

}  // namespace

extern "C" int pgrc_sweep_pair_claim(int device, void* stream, int64_t m, int64_t n,
                                     const void* ks, const void* ent, const void* ids,
                                     const void* p2, const void* h2, void* succ_g,
                                     void* ovl_g, void* a_s, void* a_p, int ovl,
                                     void* scratch, int64_t scratch_words) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  if (scratch_words < seg_scan::scratch_words(m)) return (int)cudaErrorInvalidValue;
  err = seg_scan::zero_scratch(scratch, m, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  sweep_pair_claim_kernel<<<(unsigned)seg_scan::tiles_for(m), seg_scan::kThreads, 0,
                            (cudaStream_t)stream>>>(
      m, n, (const long long*)ks, (const long long*)ent, (const int32_t*)ids,
      (const int64_t*)p2, (const int64_t*)h2, (int32_t*)succ_g, (int32_t*)ovl_g,
      (bool*)a_s, (bool*)a_p, ovl, (long long*)scratch);
  return (int)cudaGetLastError();
}
