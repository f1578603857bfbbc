// sweep_record.cuh — the entries of the sharded overlap round: the send
// buffer that kernel D's sharded form writes (sweep_round.cu), and the map
// from a position of the gathered entries to its row in the gathered
// buffer, which the key layout and kernel F's sharded form read
// (sweep_pair_claim.cu).
//
// On one device an entry is its index into the table's 2n entries, and F
// finds its side, gid and confirm hash from the table. Under a mesh the
// entries of all ranks are gathered and sorted on every rank, so an entry
// carries what F needs: its key, and a 16-byte payload [record, confirm
// hash], the record packing the side (bit 62: 1 = suffix), the global read
// id (bits 31-61) and the row in its owner's table (bits 0-30). The sweep
// caps ids at 2^30 (greedy_scs.py), so both fields fit. The key is the
// rolled hash with bit 63 flipped (signed order = unsigned order).
//
// The send buffer: a rank's active entries d = 0 .. m-1, its mp active
// prefixes first (row order), then its suffixes (row order), in chunks of
// kChunk entries of kChunkWords int64 words each: the chunk's kChunk keys,
// then its kChunk payloads. So the keys lie apart from the payloads (the
// key layout reads them in runs of 256 bytes), every payload sits on 16
// bytes (one 16-byte load, one 32-byte sector), and the buffer's first
// ceil(m / kChunk) chunks hold all m entries: the gather sends that head,
// 24 bytes an entry plus at most one chunk.
//
// The gathered buffer is every rank's head of `chunks` chunks, rank after
// rank (rank_words = chunks * kChunkWords int64 words apart). Its entries
// are read in (side, rank) order: every rank's prefixes, rank after rank,
// then every rank's suffixes; in a run of equal keys the stable sort then
// keeps (side, gid) order, the reference's (pgrc_tpu/overlap/greedy_scs.py
// :251-258), since a rank's rows are a block of ids in row order. The
// kernels that read it take the ranks' counts as the count gather left
// them on the card, [ranks, (m, active prefixes)] int64, and build from
// them in shared memory the table of 2 * ranks + 1 prefix sums: table[s]
// is the first position of segment s, segment r < ranks rank r's
// prefixes, segment ranks + r its suffixes, table[2 * ranks] the count of
// all entries and table[ranks] the count of all prefixes. So nothing is
// uploaded for them.
#pragma once
#include <cstdint>

namespace sweep_record {

constexpr int kSideShift = 62;
constexpr int kGidShift = 31;
constexpr long long kMask31 = (1ll << 31) - 1;
constexpr int kChunk = 32;                 // entries a chunk
constexpr int kChunkWords = 3 * kChunk;    // kChunk keys, then kChunk payloads
constexpr int kMaxRanks = 256;             // the table lives in shared memory

__device__ __forceinline__ long long pack(bool suffix, int32_t gid, int64_t row) {
  return ((long long)suffix << kSideShift) | ((long long)gid << kGidShift) | row;
}
__device__ __forceinline__ int32_t gid(long long rec) {
  return (int32_t)((rec >> kGidShift) & kMask31);
}
__device__ __forceinline__ int64_t row(long long rec) { return rec & kMask31; }

// Words of entry d's key and payload from the start of its rank's buffer.
__host__ __device__ __forceinline__ int64_t key_word(int64_t d) {
  return d / kChunk * kChunkWords + d % kChunk;
}
__host__ __device__ __forceinline__ int64_t payload_word(int64_t d) {
  return d / kChunk * kChunkWords + kChunk + 2 * (d % kChunk);
}

// Position j's entry in the gathered buffer: its rank's first word and
// its row there, from the table (in shared memory).
struct Row {
  int64_t base, d;
};
__device__ __forceinline__ Row gathered_row(const long long* table, int ranks,
                                            int64_t rank_words, int64_t j) {
  // the last segment s with table[s] <= j (empty segments precede it)
  int lo = 0, hi = 2 * ranks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid] <= j) lo = mid; else hi = mid - 1;
  }
  const int r = lo < ranks ? lo : lo - ranks;
  // a rank's suffixes follow its prefixes in its buffer
  return {r * rank_words, j - table[lo] + (lo < ranks ? 0 : table[r + 1] - table[r])};
}

// The table of `ranks` ranks' counts into shared memory s_table, through
// s_counts (2 * ranks words): called by the whole block; the caller syncs
// before reading the table.
__device__ __forceinline__ void load_table(const long long* __restrict__ counts, int ranks,
                                           long long* s_counts, long long* s_table) {
  for (int k = threadIdx.x; k < 2 * ranks; k += blockDim.x) s_counts[k] = counts[k];
  __syncthreads();
  // table[k]: the lengths of segments s < k, prefixes (s < ranks) then suffixes
  for (int k = threadIdx.x; k <= 2 * ranks; k += blockDim.x) {
    long long at = 0;
    for (int seg = 0; seg < k; ++seg) {
      const int r = seg < ranks ? seg : seg - ranks;
      const long long mp = s_counts[2 * r + 1];
      at += seg < ranks ? mp : s_counts[2 * r] - mp;
    }
    s_table[k] = at;
  }
}

}  // namespace sweep_record
