// sweep_record.cuh — the entry record of the sharded overlap round, which
// kernel D's sharded form writes (sweep_round.cu) and kernel F's sharded
// form reads (sweep_pair_claim.cu) after the ranks' entries are gathered.
//
// On one device an entry is its index into the table's 2n entries, and F
// finds its side, gid and confirm hash from the table. Under a mesh the
// entries of all ranks are gathered and sorted on every rank, so an entry
// carries what F needs: three int64 words [key, record, confirm hash], the
// record packing the side (bit 62: 1 = suffix), the global read id (bits
// 31-61) and the row in its owner's table (bits 0-30). The sweep caps ids
// at 2^30 (greedy_scs.py), so both fields fit. Records sort by (side, gid),
// the order the reference's entries take inside a run of equal keys
// (pgrc_tpu/overlap/greedy_scs.py:251-258).
#pragma once
#include <cstdint>

namespace sweep_record {

constexpr int kWords = 3;  // key, record, confirm hash
constexpr int kSideShift = 62;
constexpr int kGidShift = 31;
constexpr long long kMask31 = (1ll << 31) - 1;

__device__ __forceinline__ long long pack(bool suffix, int32_t gid, int64_t row) {
  return ((long long)suffix << kSideShift) | ((long long)gid << kGidShift) | row;
}
__device__ __forceinline__ bool suffix(long long rec) { return (rec >> kSideShift) & 1; }
__device__ __forceinline__ int32_t gid(long long rec) {
  return (int32_t)((rec >> kGidShift) & kMask31);
}
__device__ __forceinline__ int64_t row(long long rec) { return rec & kMask31; }

}  // namespace sweep_record
