// Static order-0 rANS byte decoder — the FSE/FiniteStateEntropy role
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
}  // namespace

extern "C" {

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
