// 2-bit lane packing of read code matrices (native fast path).
//
// Packs [n, L] uint8 value codes (0..4, 4 = N) into [n, WP] uint32 lanes
// (16 symbols per lane, earlier symbols in higher bits, tail zero-padded)
// plus an optional [n, NP] N-position bitmask (bit 31-j%32 of lane j/32).
// With `rows`, row r of the output packs row rows[r] of `codes` (a gather
// by id, so the caller needs no gathered copy of the matrix). Either
// output may be null; the return value counts the packed rows that hold
// an N, so one pass without a mask tells whether a mask is needed.
// The numpy fallback lives in core/packed_host.py (pack_lanes);
// this loop exists because the hot matrices are 10-200 MB and the numpy
// version materialises [n, W, 16] intermediates.
#include <cstdint>

extern "C" {

int64_t pack_lanes_u32(const uint8_t *codes, const int64_t *rows, int64_t n,
                       int64_t L, int64_t WP, uint32_t *out,
                       int64_t NP, uint32_t *nmask) {
    int64_t with_n = 0;
    for (int64_t r = 0; r < n; r++) {
        const uint8_t *row = codes + (rows ? rows[r] : r) * L;
        if (out) {
            uint32_t *o = out + r * WP;
            for (int64_t w = 0; w < WP; w++) o[w] = 0;
            for (int64_t j = 0; j < L; j++) {
                o[j >> 4] |= (uint32_t)(row[j] & 0x3) << (2 * (15 - (j & 15)));
            }
        }
        uint8_t any_n = 0;
        for (int64_t j = 0; j < L; j++) any_n |= row[j] > 3;
        with_n += any_n;
        if (nmask) {
            uint32_t *m = nmask + r * NP;
            for (int64_t w = 0; w < NP; w++) m[w] = 0;
            if (!any_n) continue;
            for (int64_t j = 0; j < L; j++) {
                if (row[j] > 3) m[j >> 5] |= 1u << (31 - (j & 31));
            }
        }
    }
    return with_n;
}

}  // extern "C"
