// Static order-0 rANS byte coder — the FSE/FiniteStateEntropy role
// (reference coders/FSECoder.cpp + vendored coders/fse/*) as an OWN
// component: a table-driven asymmetric-numeral-system coder with 12-bit
// normalized frequencies, 32-bit state and byte renormalization.
//
// Stream layout (little-endian):
//   u16 n_syms | n_syms x (u8 symbol, u16 freq) | u32 final_state |
//   payload bytes (renormalization stream, decoder reads forward)
// Frequencies are normalized to sum 2^12 with every present symbol >= 1.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr uint32_t SCALE_BITS = 12;
constexpr uint32_t SCALE = 1u << SCALE_BITS;
constexpr uint32_t RANS_L = 1u << 23;  // state lower bound

// normalize counts to sum SCALE, all present symbols >= 1
void normalize(const uint64_t *counts, uint64_t total, uint16_t *freq) {
    uint32_t assigned = 0;
    int maxi = 0;
    for (int s = 0; s < 256; s++) {
        if (!counts[s]) { freq[s] = 0; continue; }
        uint64_t f = counts[s] * SCALE / total;
        if (f == 0) f = 1;
        freq[s] = (uint16_t)f;
        assigned += (uint32_t)f;
        if (counts[s] > counts[maxi]) maxi = s;
    }
    // fix the rounding drift on the most frequent symbol
    int32_t drift = (int32_t)SCALE - (int32_t)assigned;
    int32_t nf = (int32_t)freq[maxi] + drift;
    if (nf < 1) {  // pathological: steal from other symbols
        freq[maxi] = 1;
        drift = nf - 1;
        for (int s = 0; s < 256 && drift; s++) {
            if (s == maxi || freq[s] <= 1) continue;
            int32_t take = (int32_t)freq[s] - 1;
            if (take > -drift) take = -drift;
            freq[s] -= (uint16_t)take;
            drift += take;
        }
    } else {
        freq[maxi] = (uint16_t)nf;
    }
}
}  // namespace

extern "C" {

// Returns output length, or -1 when out_cap is too small.
int64_t rans_encode(const uint8_t *data, int64_t n, uint8_t *out,
                    int64_t out_cap) {
    uint64_t counts[256] = {0};
    for (int64_t i = 0; i < n; i++) counts[data[i]]++;
    uint16_t freq[256];
    uint32_t cum[257];
    int n_syms = 0;
    if (n > 0) {
        normalize(counts, (uint64_t)n, freq);
        for (int s = 0; s < 256; s++) if (freq[s]) n_syms++;
    } else {
        memset(freq, 0, sizeof(freq));
    }
    cum[0] = 0;
    for (int s = 0; s < 256; s++) cum[s + 1] = cum[s] + freq[s];

    int64_t hdr = 2 + 3 * n_syms + 4;
    if (hdr > out_cap) return -1;
    out[0] = (uint8_t)(n_syms & 0xFF);
    out[1] = (uint8_t)(n_syms >> 8);
    int64_t op = 2;
    for (int s = 0; s < 256; s++) {
        if (!freq[s]) continue;
        out[op++] = (uint8_t)s;
        out[op++] = (uint8_t)(freq[s] & 0xFF);
        out[op++] = (uint8_t)(freq[s] >> 8);
    }
    int64_t state_at = op;  // u32 final state patched after encoding
    op += 4;

    // encode back-to-front into a scratch; payload is then reversed so
    // the decoder reads forward
    std::vector<uint8_t> scratch;
    scratch.reserve((size_t)n + 16);
    uint32_t state = RANS_L;
    for (int64_t i = n - 1; i >= 0; i--) {
        uint32_t f = freq[data[i]];
        // renormalize: keep state < x_max so decode inverts exactly
        uint32_t x_max = ((RANS_L >> SCALE_BITS) << 8) * f;
        while (state >= x_max) {
            scratch.push_back((uint8_t)(state & 0xFF));
            state >>= 8;
        }
        state = ((state / f) << SCALE_BITS) + (state % f) + cum[data[i]];
    }
    out[state_at + 0] = (uint8_t)(state & 0xFF);
    out[state_at + 1] = (uint8_t)((state >> 8) & 0xFF);
    out[state_at + 2] = (uint8_t)((state >> 16) & 0xFF);
    out[state_at + 3] = (uint8_t)((state >> 24) & 0xFF);
    if (op + (int64_t)scratch.size() > out_cap) return -1;
    for (int64_t i = (int64_t)scratch.size() - 1; i >= 0; i--)
        out[op++] = scratch[(size_t)i];
    return op;
}

// Returns count, or -1 on malformed input.
int64_t rans_decode(const uint8_t *buf, int64_t len, int64_t count,
                    uint8_t *out) {
    if (len < 2) return count == 0 ? 0 : -1;
    int n_syms = buf[0] | (buf[1] << 8);
    if (n_syms > 256 || 2 + 3 * n_syms + 4 > len) return -1;
    uint16_t freq[256];
    memset(freq, 0, sizeof(freq));
    int64_t p = 2;
    for (int i = 0; i < n_syms; i++) {
        uint8_t s = buf[p];
        freq[s] = (uint16_t)(buf[p + 1] | (buf[p + 2] << 8));
        p += 3;
    }
    uint32_t cum[257];
    cum[0] = 0;
    for (int s = 0; s < 256; s++) cum[s + 1] = cum[s] + freq[s];
    if (count > 0 && cum[256] != SCALE) return -1;
    // slot -> symbol lookup
    std::vector<uint8_t> slot2sym(SCALE);
    for (int s = 0; s < 256; s++)
        for (uint32_t j = cum[s]; j < cum[s + 1]; j++) slot2sym[j] = (uint8_t)s;
    uint32_t state = (uint32_t)buf[p] | ((uint32_t)buf[p + 1] << 8) |
                     ((uint32_t)buf[p + 2] << 16) | ((uint32_t)buf[p + 3] << 24);
    p += 4;
    for (int64_t i = 0; i < count; i++) {
        uint32_t slot = state & (SCALE - 1);
        uint8_t sym = slot2sym[slot];
        out[i] = sym;
        state = freq[sym] * (state >> SCALE_BITS) + slot - cum[sym];
        while (state < RANS_L) {
            if (p >= len) return -1;
            state = (state << 8) | buf[p++];
        }
    }
    return count;
}

}  // extern "C"
