// Pair-order walk decode — the sequential scan that reconstructs the
// joined-list index order from pair offsets (the inverse of
// encode_pair_order; reference decompressReadsOrder walk,
// pseudogenome/persistence/SeparatedPseudoGenomePersistence.cpp:341-443).
//
// order[2p]   = p-th unclaimed list position (scanning left to right)
// order[2p+1] = order[2p] + offs[p], which becomes claimed.
#include <cstdint>
#include <vector>

extern "C" {

// offs: [n_pairs] offsets, order: out buffer [2*n_pairs].
// Returns 0 on success, -1 on malformed input (offset out of range).
int32_t pair_walk_decode(const int64_t *offs, int64_t n_pairs, int64_t *order) {
    const int64_t r = n_pairs * 2;
    std::vector<uint8_t> done(r, 0);
    int64_t i = 0;
    for (int64_t p = 0; p < n_pairs; p++) {
        while (i < r && done[i]) i++;
        if (i >= r) return -1;
        const int64_t j = i + offs[p];
        if (j <= i || j >= r) return -1;
        order[2 * p] = i;
        order[2 * p + 1] = j;
        done[j] = 1;
        i++;
    }
    return 0;
}

}  // extern "C"
