// Successor-chain post-processing: cycle removal + chain layout + pg
// assembly in one sequential O(n) pass (native fast path).
//
// Mirrors the roles of AbstractOverlapPseudoGenomeGenerator.cpp:6-41
// (cut the min-overlap edge of every cycle) and :181-219 (chain walk
// assembly); the numpy pointer-doubling fallback lives in
// pgrc_tpu/overlap/greedy_scs.py and defines the exact semantics this
// must reproduce: chains laid out consecutively in increasing head-read
// order, read position = head_start + sum(L - overlap) over predecessors.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Cut the minimum-(overlap, node) edge of every cycle in the successor
// graph (in place). Components are chains or pure cycles (each node has at
// most one predecessor by construction). Returns the number of cuts.
int64_t cut_cycles(int32_t *succ, int32_t *ovl, int64_t n) {
    std::vector<uint8_t> has_pred(n, 0);
    for (int64_t i = 0; i < n; i++)
        if (succ[i] >= 0) {
            if (succ[i] >= n) return -1;
            has_pred[succ[i]] = 1;
        }
    std::vector<uint8_t> visited(n, 0);
    for (int64_t i = 0; i < n; i++) {
        if (has_pred[i]) continue;
        for (int64_t x = i; x >= 0 && !visited[x]; x = succ[x]) visited[x] = 1;
    }
    int64_t cuts = 0;
    for (int64_t i = 0; i < n; i++) {
        if (visited[i]) continue;
        int64_t best = i;
        visited[i] = 1;
        for (int64_t x = succ[i]; x != i; x = succ[x]) {
            visited[x] = 1;
            if (ovl[x] < ovl[best] || (ovl[x] == ovl[best] && x < best)) best = x;
        }
        succ[best] = -1;
        ovl[best] = 0;
        cuts++;
    }
    return cuts;
}

// succ/ovl: [n] int32 ACYCLIC links (run cut_cycles first). codes: [n, L]
// uint8. Outputs: pos [n] int64, order [n] int32 (read ids in pg order),
// pg [exactly n*L - sum(linked overlaps)] uint8. Returns pg length or -1.
int64_t chain_walk_assemble(const int32_t *succ, const int32_t *ovl,
                            const uint8_t *codes, int64_t n, int64_t L,
                            int64_t *pos, int32_t *order, uint8_t *pg) {
    if (n == 0) return 0;
    std::vector<uint8_t> has_pred(n, 0);
    for (int64_t i = 0; i < n; i++)
        if (succ[i] >= 0) {
            if (succ[i] >= n) return -1;
            has_pred[succ[i]] = 1;
        }
    int64_t pg_len = 0;
    int64_t emitted = 0;
    for (int64_t head = 0; head < n; head++) {
        if (has_pred[head]) continue;
        int64_t p = pg_len;
        int64_t prev = -1;
        for (int64_t x = head; x >= 0; x = succ[x]) {
            if (prev >= 0) p += L - ovl[prev];
            pos[x] = p;
            order[emitted++] = (int32_t)x;
            // write only the non-overlapped suffix bytes (earlier bytes
            // already agree by construction)
            int64_t skip = (prev >= 0) ? ovl[prev] : 0;
            std::memcpy(pg + p + skip, codes + (int64_t)x * L + skip, L - skip);
            prev = x;
        }
        pg_len = p + L;
    }
    if (emitted != n) return -1;  // corrupt links (uncut cycle)
    return pg_len;
}

}  // extern "C"
