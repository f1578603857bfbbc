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
// wide pgs). Output: res [P], for each probe 1 + the lowest position of an
// index entry of its hash, or 0.
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
// each probe's result is written once (8 B, scattered to probe order);
// a few integer operations per entry. What the design does about it: one
// pass (seg_scan.cuh) with the keys read coalesced, the scan state kept in
// registers, the boundary's left neighbour taken by a warp shuffle, and the
// route written straight from the epilogue — no scan value, no pack and
// no dump slot in device memory. Every probe appears once in the sort, so
// each res element is written exactly once and needs no initialisation.
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

template <typename PosT>
__global__ void __launch_bounds__(seg_scan::kThreads)
join_carry_kernel(int64_t m2, const int64_t* __restrict__ skey,
                  const int64_t* __restrict__ perm, const PosT* __restrict__ ipos,
                  int64_t* __restrict__ res, long long* scratch) {
  using namespace seg_scan;
  const int64_t tile = next_tile(scratch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = tile * kTile + (int64_t)warp * kWarpRun;
  State loc[kItems];
  uint32_t key2[kItems];
  State carry = JoinOp::identity();
  // the hash of the entry left of this lane's entry in round 0, lane 0
  long long left = (base > 0 && base - 1 < m2) ? (skey[base - 1] >> 32) : 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t e = base + k * 32 + lane;
    const bool in = e < m2;
    const long long key = in ? skey[e] : -1;
    const long long hi = key >> 32;  // arithmetic: only equality matters
    const long long up = __shfl_up_sync(kFull, hi, 1);
    const bool boundary = e == 0 || hi != (lane == 0 ? left : up);
    left = __shfl_sync(kFull, hi, 31);
    const uint32_t k2 = in ? (uint32_t)key : kInert;
    long long x = 0;
    if (k2 == 0) x = kPosMask - (long long)ipos[perm[e]];
    State v = in ? State{boundary ? e : -1, x} : JoinOp::identity();
    v = JoinOp::combine(carry, warp_scan<JoinOp>(v, lane));
    carry = shfl(v, 31);
    loc[k] = v;
    key2[k] = k2;
  }
  const State pre = warp_prefix<JoinOp>(carry, scratch, tile);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t k2 = key2[k];
    if (k2 >= 1 && k2 != kInert) {
      const long long segmax = JoinOp::combine(pre, loc[k]).b;
      res[k2 - 1] = segmax > 0 ? kPosMask - segmax + 1 : 0;
    }
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
  const unsigned grid = (unsigned)seg_scan::tiles_for(m2);
  if (ipos_bytes == 8)
    join_carry_kernel<int64_t><<<grid, seg_scan::kThreads, 0, (cudaStream_t)stream>>>(
        m2, (const int64_t*)skey, (const int64_t*)perm, (const int64_t*)ipos,
        (int64_t*)res, (long long*)scratch);
  else
    join_carry_kernel<int32_t><<<grid, seg_scan::kThreads, 0, (cudaStream_t)stream>>>(
        m2, (const int64_t*)skey, (const int64_t*)perm, (const int32_t*)ipos,
        (int64_t*)res, (long long*)scratch);
  return (int)cudaGetLastError();
}
