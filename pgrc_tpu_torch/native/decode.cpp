// Fused read-line reconstruction: pg window copy + reverse-complement +
// mismatch application + ASCII conversion + newline, one pass per read,
// threaded. Replaces the decoder's separate numpy gather / rc / scatter /
// format passes — on this host memory bandwidth dominates, so touching the
// 1-byte-per-base output exactly once is the decode speed-of-light.
//
// Mirrors the roles of SeparatedPseudoGenome::getRead (pseudogenome/
// SeparatedPseudoGenome.cpp:74-130) and writeAllReadsIn*Mode chunk loops
// (pgrc/pgrc-decoder.cpp:137-527).
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {
const uint8_t VAL2SYM_D[5] = {'A', 'C', 'G', 'T', 'N'};
const uint8_t COMPL_D[5] = {3, 2, 1, 0, 4};
}  // namespace

extern "C" {

// pg:      [pg_len] symbol codes (0..4)
// pos:     [n] int64 window starts (0 <= pos[i] <= pg_len - L)
// rc:      [n] uint8 (0/1) or nullptr
// mis_cum: [n+1] int64, mis_sym/mis_off: flat streams (uint8) or nullptr
// dec_lut: [5*4] uint8 (window value, exclusive code) -> value, or nullptr
//          (then mis_sym low nibble IS the read value: cxt code)
// out:     [n * (L + 1)] ASCII lines with trailing '\n'
// Returns 0, or -1 on a malformed offset.
int64_t reconstruct_lines_mt(const uint8_t *pg, int64_t pg_len,
                             const int64_t *pos, int64_t n, int64_t L,
                             const uint8_t *rc, const int64_t *mis_cum,
                             const uint8_t *mis_sym, const uint8_t *mis_off,
                             const uint8_t *dec_lut, uint8_t *out) {
    if (L > 4096) return -1;
    int64_t nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n < 16384) nthreads = 1;
    std::vector<int64_t> errs((size_t)nthreads, 0);

    auto work = [&](int64_t t, int64_t lo, int64_t hi) {
        uint8_t buf[4096];
        for (int64_t r = lo; r < hi; r++) {
            // a corrupt/adversarial archive must fail cleanly, not read OOB
            if (pos[r] < 0 || pos[r] > pg_len - L) {
                errs[(size_t)t] = -1;
                return;
            }
            const uint8_t *w = pg + pos[r];
            bool flip = rc && rc[r];
            if (flip) {
                for (int64_t i = 0; i < L; i++) {
                    uint8_t v = w[L - 1 - i];
                    buf[i] = v < 4 ? COMPL_D[v] : (uint8_t)4;
                }
            } else {
                std::memcpy(buf, w, (size_t)L);
            }
            if (mis_cum) {
                for (int64_t j = mis_cum[r]; j < mis_cum[r + 1]; j++) {
                    int64_t o = mis_off[j];
                    if (o >= L) { errs[(size_t)t] = -1; return; }
                    uint8_t code = mis_sym[j];
                    uint8_t cur = buf[o];
                    buf[o] = dec_lut ? dec_lut[(cur > 4 ? 4 : cur) * 4 + (code & 3)]
                                     : (uint8_t)(code & 0x0F);
                }
            }
            uint8_t *dst = out + r * (L + 1);
            for (int64_t i = 0; i < L; i++)
                dst[i] = VAL2SYM_D[buf[i] > 4 ? 4 : buf[i]];
            dst[L] = '\n';
        }
    };
    if (nthreads == 1) {
        work(0, 0, n);
    } else {
        std::vector<std::thread> ts;
        for (int64_t t = 0; t < nthreads; t++)
            ts.emplace_back(work, t, n * t / nthreads, n * (t + 1) / nthreads);
        for (auto &th : ts) th.join();
    }
    for (auto e : errs)
        if (e) return e;
    return 0;
}

// Encoder-side mismatch extraction for matched reads (the vector form of
// fillEntryWithMismatches, matching/ReadsMatchers.cpp:40-51): for each row,
// rebuild the pg window (with optional reverse-complement, matching the
// final-output orientation), compare to the read codes, and emit cxt codes
// ((pg_value<<4)|read_value) + offsets. One threaded pass instead of the
// numpy gather + revcomp + nonzero chain.
//
// codes: [n, L] read codes in final orientation; pg/pos/rc as above.
// mis_cnt: [n] uint8 out; sym/off: [n * max_mis] uint8 out (flat, packed
// contiguously per row at r*max_mis; caller compacts via mis_cnt).
// Returns total mismatches, or -1 if a row exceeds max_mis.
int64_t extract_mismatches_mt(const uint8_t *pg, const int64_t *pos,
                              const uint8_t *rc, const uint8_t *codes,
                              int64_t n, int64_t L, int64_t max_mis,
                              uint8_t *mis_cnt, uint8_t *sym, uint8_t *off) {
    if (L > 4096) return -1;
    int64_t nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n < 16384) nthreads = 1;
    std::vector<int64_t> totals((size_t)nthreads, 0);

    auto work = [&](int64_t t, int64_t lo, int64_t hi) {
        uint8_t buf[4096];
        int64_t total = 0;
        for (int64_t r = lo; r < hi; r++) {
            const uint8_t *w = pg + pos[r];
            if (rc && rc[r]) {
                for (int64_t i = 0; i < L; i++) {
                    uint8_t v = w[L - 1 - i];
                    buf[i] = v < 4 ? COMPL_D[v] : (uint8_t)4;
                }
            } else {
                std::memcpy(buf, w, (size_t)L);
            }
            const uint8_t *c = codes + r * L;
            int64_t m = 0;
            for (int64_t i = 0; i < L; i++) {
                if (buf[i] != c[i]) {
                    if (m >= max_mis) { totals[(size_t)t] = -1; return; }
                    sym[r * max_mis + m] = (uint8_t)((buf[i] << 4) | c[i]);
                    off[r * max_mis + m] = (uint8_t)i;
                    m++;
                }
            }
            mis_cnt[r] = (uint8_t)m;
            total += m;
        }
        totals[(size_t)t] += total;
    };
    if (nthreads == 1) {
        work(0, 0, n);
    } else {
        std::vector<std::thread> ts;
        for (int64_t t = 0; t < nthreads; t++)
            ts.emplace_back(work, t, n * t / nthreads, n * (t + 1) / nthreads);
        for (auto &th : ts) th.join();
    }
    int64_t total = 0;
    for (auto v : totals) {
        if (v < 0) return -1;
        total += v;
    }
    return total;
}

}  // extern "C"
