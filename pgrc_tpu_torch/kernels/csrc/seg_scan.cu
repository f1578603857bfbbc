// seg_scan.cu — the geometry of the one-pass scans (seg_scan.cuh) for the
// host: the wrappers size their scratch from these entries, so the tile
// size and the scratch layout are stated once, in the header.
#include <cstdint>

#include "seg_scan.cuh"

// Entries per tile.
extern "C" int64_t pgrc_seg_scan_tile() { return seg_scan::kTile; }

// int64 words of scratch (tile counter and look-back descriptors) for a
// scan over m entries.
extern "C" int64_t pgrc_seg_scan_scratch_words(int64_t m) {
  return seg_scan::scratch_words(m);
}
