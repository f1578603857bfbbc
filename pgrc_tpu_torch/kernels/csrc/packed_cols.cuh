// packed_cols.cuh — a read's symbols from the packed lanes, for the sweep's
// round (kernel D, sweep_round.cu).
//
// Layout (core/packed.py): symbol t of a row sits at bits 2 * (15 - t % 16)
// of lane t / 16, N packed as A; the N mask holds bit 31 - t % 32 of lane
// t / 32. A symbol's value is its 2-bit code + 4 * its N bit
// (pgrc_tpu/overlap/greedy_scs.py `_col_vals`, :149-162).
#pragma once
#include <cstdint>

namespace packed_cols {

// Value of column t of row r; nmask may be null (no N in the set).
__device__ __forceinline__ uint64_t col_val(const uint32_t* __restrict__ lanes, int ld_lanes,
                                            const uint32_t* __restrict__ nmask, int ld_nmask,
                                            int64_t r, int t) {
  uint64_t c = (lanes[r * ld_lanes + (t >> 4)] >> (2 * (15 - (t & 15)))) & 3u;
  if (nmask != nullptr)
    c += (uint64_t)((nmask[r * ld_nmask + (t >> 5)] >> (31 - (t & 31))) & 1u) << 2;
  return c;
}

}  // namespace packed_cols
