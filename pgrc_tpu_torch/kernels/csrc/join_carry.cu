// Kernel E: join_carry — the sort-merge join's carry and route, after its
// sort.
//
// Replaces pgrc_tpu/align/matcher.py `_make_probe.probe_fn`'s carry and
// route (:239-260): the run boundary, the seg_start cummax, the pack of
// (seg_start, POS_MASK - pos) for index entries, its cummax, the confirm
// test and the route of each probe's result back to probe order (the
// reference's third sort, the port's former dump-slot scatter).
//
// Input: the sorted composed keys skey [m2] (high half: hash - 2^31, low
// half: key2 = 0 for an index entry, 1..P for probe p-1, U32INV for an
// inert entry) and the sort's perm [m2]; ipos [M] (int32, or int64 for
// wide pgs). Output: res [P], zeroed by the caller, for each probe 1 + the
// lowest position of an index entry of its hash, or 0 (left as it is).
//
// The scan carries (seg, segmax): the start of the current run of equal
// hashes and the largest POS_MASK - pos over its index entries so far (0:
// none). This is the reference's pack seg_start << 35 | (POS_MASK - pos)
// and its cummax taken apart: the cummax is confirmed exactly when its
// seg_start field is the probe's own run, and then its low field is the
// run's segmax. An entry contributes (its index if it starts a run, else
// -1; POS_MASK - pos if it is an index entry, else 0), and
// combine(a, b) = (max(a.seg, b.seg), b.seg >= 0 ? b.segmax
// : max(a.segmax, b.segmax)). Index entries sort before the probes of
// their run (key2 = 0), so a probe's inclusive state holds its run's
// whole index side.
//
// What bounds it on the card: memory. Each entry's key is read once (8
// B), perm and the gathered ipos only for index entries (8 + 4 or 8 B), and
// each probe's result is written once (8 B); a few integer operations per
// entry. The route is a scatter to probe order, and a random 8-byte write
// costs a whole sector and its DRAM row: writing every probe's result so
// took 2.0 of 3.1 ms at SE 2M's first join on an H100 (80GB HBM3, 700 W).
// So the wrapper zeroes res (one coalesced fill) and the kernel writes only
// the probes whose run has an index entry (18% there). ipos[perm[e]] is one random sector per index
// entry; only a further sort could remove it. What the design does about
// the rest: one pass (seg_scan.cuh), the keys staged in shared memory by
// cp.async, each thread's perm and ipos loads issued for all its index
// entries before the scan, the scan state kept in registers, a warp-wide
// look-back, and the route written straight from the epilogue — no scan
// value, no pack and no dump slot in device memory. Every probe appears
// once in the sort, so no two writes meet.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::State;

constexpr long long kPosMask = (1ll << 35) - 1;
constexpr uint32_t kInert = 0xFFFFFFFFu;

struct JoinOp {
  __device__ static State identity() { return {-1, 0}; }
  __device__ static State combine(State a, State b) {
    return {a.a > b.a ? a.a : b.a, b.a >= 0 ? b.b : (a.b > b.b ? a.b : b.b)};
  }
};

// An entry's contribution: (its index if it starts a run of equal hashes,
// else -1; POS_MASK - pos for an index entry, else 0).
__device__ __forceinline__ State entry_state(int64_t e, int64_t m2, long long key,
                                             long long prev_key, long long x) {
  if (e >= m2) return JoinOp::identity();
  const bool boundary = e == 0 || (key >> 32) != (prev_key >> 32);
  return {boundary ? e : -1, x};
}

template <typename PosT>
__global__ void __launch_bounds__(seg_scan::kThreads, seg_scan::kMinBlocks)
join_carry_kernel(int64_t m2, const long long* __restrict__ skey,
                  const int64_t* __restrict__ perm, const PosT* __restrict__ ipos,
                  int64_t* __restrict__ res, long long* scratch) {
  using namespace seg_scan;
  __shared__ __align__(16) long long s_key[kTile];
  const int64_t tile = next_tile(scratch);
  stage_tile(skey, m2, tile, -1, s_key);
  const int64_t first = tile * kTile + (int64_t)threadIdx.x * kItems;
  // the hash left of the thread's first entry: thread 0 reads it while the
  // tile is copied, the others from the tile
  long long left = (threadIdx.x == 0 && first > 0) ? skey[first - 1] : 0;
  staged_wait();
  if (threadIdx.x > 0) left = staged(s_key, threadIdx.x * kItems - 1);
  // perm, then ipos, of every index entry of the thread, all issued at once
  long long x[kItems];
#pragma unroll
  for (int c = 0; c < kItems / 2; ++c) {
    const longlong2 k = pair_of(s_key, c);
    const int64_t e = first + 2 * c;
    x[2 * c] = (e < m2 && (uint32_t)k.x == 0) ? perm[e] : -1;
    x[2 * c + 1] = (e + 1 < m2 && (uint32_t)k.y == 0) ? perm[e + 1] : -1;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    x[j] = x[j] >= 0 ? kPosMask - (long long)ipos[x[j]] : 0;

  State agg = JoinOp::identity();
  long long prev = left;
#pragma unroll
  for (int c = 0; c < kItems / 2; ++c) {
    const longlong2 k = pair_of(s_key, c);
    const int64_t e = first + 2 * c;
    agg = JoinOp::combine(agg, entry_state(e, m2, k.x, prev, x[2 * c]));
    agg = JoinOp::combine(agg, entry_state(e + 1, m2, k.y, k.x, x[2 * c + 1]));
    prev = k.y;
  }
  State acc = thread_prefix<JoinOp>(agg, scratch, tile);
  prev = left;
#pragma unroll
  for (int c = 0; c < kItems / 2; ++c) {
    const longlong2 k = pair_of(s_key, c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t e = first + 2 * c + h;
      const long long key = h ? k.y : k.x;
      acc = JoinOp::combine(acc, entry_state(e, m2, key, h ? k.x : prev, x[2 * c + h]));
      const uint32_t k2 = (uint32_t)key;
      if (e < m2 && k2 >= 1 && k2 != kInert && acc.b > 0) res[k2 - 1] = kPosMask - acc.b + 1;
    }
    prev = k.y;
  }
}

}  // namespace

// ipos_bytes: 4 (int32 positions) or 8 (int64, the wide probe).
extern "C" int pgrc_join_carry(int device, void* stream, int64_t m2,
                               const void* skey, const void* perm,
                               const void* ipos, int ipos_bytes, void* res,
                               void* scratch, int64_t scratch_words) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m2 == 0) return 0;
  if (scratch_words < seg_scan::scratch_words(m2) || (ipos_bytes != 4 && ipos_bytes != 8))
    return (int)cudaErrorInvalidValue;
  err = seg_scan::zero_scratch(scratch, m2, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)seg_scan::tiles_for(m2);
  if (ipos_bytes == 8)
    join_carry_kernel<int64_t><<<grid, seg_scan::kThreads, 0, (cudaStream_t)stream>>>(
        m2, (const long long*)skey, (const int64_t*)perm, (const int64_t*)ipos,
        (int64_t*)res, (long long*)scratch);
  else
    join_carry_kernel<int32_t><<<grid, seg_scan::kThreads, 0, (cudaStream_t)stream>>>(
        m2, (const long long*)skey, (const int64_t*)perm, (const int32_t*)ipos,
        (int64_t*)res, (long long*)scratch);
  return (int)cudaGetLastError();
}
