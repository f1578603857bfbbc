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
// [m] (into the 2n entries of kernel D), and kernel D's unsorted k2, v2 and
// orig [2n], read through ent. In place: succ_g / ovl_g (global links),
// a_s / a_p (the table's active flags).
//
// The scan carries two plain maxima: seg_start (an entry contributes its
// index where a run starts, else 0) and fs (its index where a run of
// suffixes starts — a suffix whose left neighbour is a prefix or lies in
// another run — else -1). In the epilogue a suffix at e has rank
// e - fs and pairs when rank < fs - seg_start. A pair whose gids differ
// and whose confirm hashes v2 agree links: succ_g[ids[row]] = partner's
// gid, ovl_g[...] = L - i, a_s[row] = 0. Every paired suffix clears a_p of
// its partner, confirmed or not: the reference's conservative claim
// (:314-318). Each suffix pairs at most once and each prefix with at most
// one suffix, so every write lands on its own element: no atomics.
//
// What bounds it on the card: memory. Each entry's key and index are read
// once (16 B) and its k2 gathered (8 B); a paired suffix gathers its
// partner's ent, k2, v2 and orig and its own v2 and orig (~40 B) and a
// link writes ~13 B. What the design does about it: one pass
// (seg_scan.cuh), the sorted keys and indices read coalesced, the
// neighbour's side and key taken by warp shuffles, no gathered copies of
// k2, v2 or orig and no scan value in device memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::State;

constexpr long long kSuffixBit = 0x80000000ll;
constexpr long long kGidMask = 0x7FFFFFFFll;

struct PairOp {
  __device__ static State identity() { return {0, -1}; }
  __device__ static State combine(State a, State b) {
    return {a.a > b.a ? a.a : b.a, a.b > b.b ? a.b : b.b};
  }
};

__global__ void __launch_bounds__(seg_scan::kThreads)
sweep_pair_claim_kernel(int64_t m, int64_t n, const int64_t* __restrict__ ks,
                        const int64_t* __restrict__ ent, const int64_t* __restrict__ k2,
                        const int64_t* __restrict__ v2, const int32_t* __restrict__ orig,
                        const int32_t* __restrict__ ids, int32_t* __restrict__ succ_g,
                        int32_t* __restrict__ ovl_g, bool* __restrict__ a_s,
                        bool* __restrict__ a_p, int ovl, long long* scratch) {
  using namespace seg_scan;
  const int64_t tile = next_tile(scratch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = tile * kTile + (int64_t)warp * kWarpRun;
  State loc[kItems];
  int64_t entry[kItems];
  long long key2[kItems];
  State carry = PairOp::identity();
  // key and side of the entry left of this lane's entry in round 0, lane 0
  long long left_key = 0;
  bool left_suf = false;
  if (base > 0 && base - 1 < m) {
    left_key = ks[base - 1];
    left_suf = k2[ent[base - 1]] >= kSuffixBit;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t e = base + k * 32 + lane;
    const bool in = e < m;
    const long long key = in ? ks[e] : 0;
    const int64_t en = in ? ent[e] : 0;
    const long long kv = in ? k2[en] : 0;
    const bool suf = kv >= kSuffixBit;
    const long long up_key = __shfl_up_sync(kFull, key, 1);
    const bool up_suf = __shfl_up_sync(kFull, (int)suf, 1) != 0;
    const bool boundary = e == 0 || key != (lane == 0 ? left_key : up_key);
    const bool prev_suf = lane == 0 ? left_suf : up_suf;
    left_key = __shfl_sync(kFull, key, 31);
    left_suf = __shfl_sync(kFull, (int)suf, 31) != 0;
    const bool first_suf = suf && (!prev_suf || boundary);
    State v = in ? State{boundary ? e : 0, first_suf ? e : -1} : PairOp::identity();
    v = PairOp::combine(carry, warp_scan<PairOp>(v, lane));
    carry = shfl(v, 31);
    loc[k] = v;
    entry[k] = en;
    key2[k] = in ? kv : 0;
  }
  const State pre = warp_prefix<PairOp>(carry, scratch, tile);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (key2[k] < kSuffixBit) continue;  // prefixes and lanes past m
    const int64_t e = base + k * 32 + lane;
    const State f = PairOp::combine(pre, loc[k]);
    const long long rank = e - f.b;
    if (rank >= f.b - f.a) continue;
    const int64_t pe = ent[f.a + rank];
    const long long gid_p = k2[pe] & kGidMask;
    if (gid_p != (key2[k] & kGidMask) && v2[pe] == v2[entry[k]]) {
      const int64_t srow = (int64_t)orig[entry[k]] - n;
      const int32_t dst = ids[srow];
      succ_g[dst] = (int32_t)gid_p;
      ovl_g[dst] = ovl;
      a_s[srow] = false;
    }
    a_p[orig[pe]] = false;
  }
}

}  // namespace

extern "C" int pgrc_sweep_pair_claim(int device, void* stream, int64_t m, int64_t n,
                                     const void* ks, const void* ent, const void* k2,
                                     const void* v2, const void* orig, const void* ids,
                                     void* succ_g, void* ovl_g, void* a_s, void* a_p,
                                     int ovl, void* scratch, int64_t scratch_words) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  if (scratch_words < seg_scan::scratch_words(m)) return (int)cudaErrorInvalidValue;
  sweep_pair_claim_kernel<<<(unsigned)seg_scan::tiles_for(m), seg_scan::kThreads, 0,
                            (cudaStream_t)stream>>>(
      m, n, (const int64_t*)ks, (const int64_t*)ent, (const int64_t*)k2,
      (const int64_t*)v2, (const int32_t*)orig, (const int32_t*)ids, (int32_t*)succ_g,
      (int32_t*)ovl_g, (bool*)a_s, (bool*)a_p, ovl, (long long*)scratch);
  return (int)cudaGetLastError();
}
