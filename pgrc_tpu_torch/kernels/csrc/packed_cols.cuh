// packed_cols.cuh — a read's symbols from the sweep table's column-major
// lanes, for the sweep's round (kernel D, sweep_round.cu).
//
// Layout (core/packed.py `empty_cols`): lane word c of row r at
// lanes[c * ld + r], the column stride ld at least the rows (a compacted
// table is a view of larger storage); symbol t of a row sits at bits
// 2 * (15 - t % 16) of lane t / 16, N packed as A; the N mask holds bit
// 31 - t % 32 of its word t / 32, at nmask[(t / 32) * ld_nmask + r]. A
// symbol's value is its 2-bit code + 4 * its N bit
// (pgrc_tpu/overlap/greedy_scs.py `_col_vals`, :149-162).
#pragma once
#include <cstdint>

namespace packed_cols {

// Column t of every row: the lane and N-mask words that hold it, and where.
// A round reads one column a side, the same for all its rows, so a warp's
// consecutive rows read consecutive words of one column: one 128-byte line.
struct Column {
  const uint32_t* lane;   // the column's lane words, row r at lane[r]
  const uint32_t* n;      // its N-mask words, or null (no N in the set)
  int shift, nshift;

  __device__ __forceinline__ uint64_t val(int64_t r) const {
    uint64_t c = (__ldg(lane + r) >> shift) & 3u;
    if (n != nullptr) c += (uint64_t)((__ldg(n + r) >> nshift) & 1u) << 2;
    return c;
  }
};

__device__ __forceinline__ Column column(const uint32_t* __restrict__ lanes, int64_t ld_lanes,
                                         const uint32_t* __restrict__ nmask, int64_t ld_nmask,
                                         int t) {
  return {lanes + (t >> 4) * ld_lanes, nmask == nullptr ? nullptr : nmask + (t >> 5) * ld_nmask,
          2 * (15 - (t & 15)), 31 - (t & 31)};
}

}  // namespace packed_cols
