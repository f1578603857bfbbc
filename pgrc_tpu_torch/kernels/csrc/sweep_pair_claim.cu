// Kernel F: sweep_pair_claim — an overlap round's ranks, pairing, claim and
// link writes, after its sort.
//
// Replaces pgrc_tpu/overlap/greedy_scs.py `_build_seg_fn.round_fn`'s ranks
// and pairing (:267-322: the seg_start and first-suffix cummaxes, the
// sort-2 pairing and the sort-3 route back to rows) and the link flush
// (:381-385). The port pairs by index instead of by sort: inside a run of
// equal hashes the prefixes come first (entries are built in (side, gid)
// order and sorted stably), so the suffix of rank r counted from the run's
// first suffix pairs with the prefix at seg_start + r, when the run has
// more than r prefixes.
//
// Input: the round's stable-sorted order keys ks [m] and entry indices ent
// [m] into the table's 2n entries (kernel D's order: entry r < n is row
// r's prefix, entry n + r row r's suffix), the table's ids [n] and rolled
// confirm hashes p2, h2 [n]. An entry's side is ent >= n, its row ent mod
// n, its gid ids[row] and its confirm hash p2[row] (prefix) or h2[row]
// (suffix): nothing is gathered per entry. In place: succ_g / ovl_g
// (global links), a_s / a_p (the table's active flags).
//
// The scan carries two plain maxima: seg_start (an entry contributes its
// index where a run starts, else 0) and fs (its index where a run of
// suffixes starts — a suffix whose left neighbour is a prefix or lies in
// another run — else -1). In the epilogue a suffix at e has rank
// e - fs and pairs when rank < fs - seg_start; its partner's entry
// pe = ent[seg_start + rank] is a prefix, so pe is the partner's row. A
// pair whose gids differ and whose confirm hashes agree links:
// succ_g[ids[row]] = ids[pe], ovl_g[...] = L - i, a_s[row] = 0. Every
// paired suffix clears a_p[pe], confirmed or not: the reference's
// conservative claim (:314-318). Each suffix pairs at most once and each
// prefix with at most one suffix, so every write lands on its own element:
// no atomics.
//
// What bounds it on the card: memory. Each entry's key and index are read
// once (16 B); a pair reads ids and p2 of its prefix and ids and h2 of its
// suffix and clears a_p (25 B); a link writes succ, ovl and a_s (9 B). What
// the design does about it: one pass (seg_scan.cuh), the keys and indices
// staged in shared memory by cp.async, side and row computed from the
// index, the partners' entries loaded for all of a thread's pairs before
// their gathers, no scan value in device memory.
//
// The sharded form (`kRecords`; pgrc_tpu's round under shard_map,
// greedy_scs.py:243-263 with its all_gather of the entries :259-263, its
// scatter table and per-device gather :323-331 and its pmax flush
// :386-390) runs on every rank over the entries of all ranks, gathered in
// one buffer (sweep_record.cuh: every rank's chunks of keys and [record,
// confirm hash] payloads) and sorted: ks [m] the keys in (side, rank) order
// (the key layout below) stably sorted, perm [m] the sort's permutation,
// and the ranks' counts, from which each block builds the table of
// 2 * ranks + 1 prefix sums that maps a position of that order to its row
// in the gathered buffer. perm < table[ranks] is a prefix,
// so the scan is the one-device scan with n = table[ranks], on keys and
// positions read in order. Only a paired suffix reads payloads: its own,
// at perm[e], and its partner's, at perm[seg_start + rank]; the record
// gives side, gid and the owner's row, the payload's second word the
// confirm hash. Every rank pairs every entry, so every rank writes every
// link into its replicated succ_g / ovl_g, and the arrays come out the same
// on all ranks: the reference's pmax flush has nothing to merge, and none
// is kept. A rank clears a_s / a_p only for entries it owns, the gids of
// its block [gid_lo, gid_hi) (compaction keeps a rank's rows on the rank),
// at the row the record names: this replaces the scatter table and gather.
// What bounds it: memory. The keys and the permutation are read in order
// (16 B an entry); a pair reads its partner's position (8 B, mostly from a
// line another thread of the run has read) and two payloads at random,
// each 16 bytes on 16: one 32-byte sector each. Nothing is copied or
// permuted before it: the gathered buffer is read where the gather put it.
// And, at the sizes a round has, the epilogue's latency: a pair's payload
// address takes a search of the table and its partner's position a load
// before the payload loads. What the design does about it: the one-device
// scan and staging; the table built in shared memory, no upload; the pairs
// of a warp (a few in its 256 entries, spread over its lanes) queued in
// the warp's slice of the staged keys, each lane then taking every 32nd,
// so a warp runs one chain of search, load and payload loads where its
// lanes' items would each have cost it one.
//
// The key layout (`sharded_keys`, the other half of the reference's entry
// gather) writes the gathered keys as one contiguous vector in (side,
// rank) order for the library's stable sort: a thread a position, reading
// its key from the gathered buffer, where a rank's keys lie in runs of a
// chunk (256 bytes). Bytes: 8 read and 8 written an entry.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"
#include "sweep_record.cuh"

namespace {

using seg_scan::State;

struct PairOp {
  __device__ static State identity() { return {0, -1}; }
  __device__ static State combine(State a, State b) {
    return {a.a > b.a ? a.a : b.a, a.b > b.b ? a.b : b.b};
  }
};

// An entry's contribution: (its index if it starts a run, else 0; its
// index if it starts a run of suffixes, else -1). An entry en >= n is a
// suffix: its index into the table's 2n entries on one device, its
// position in (side, rank) order in the sharded form (n: the prefixes).
__device__ __forceinline__ State entry_state(int64_t e, int64_t m, int64_t n, long long key,
                                             long long en, long long prev_key,
                                             long long prev_en) {
  if (e >= m) return PairOp::identity();
  const bool boundary = e == 0 || key != prev_key;
  const bool first_suf = en >= n && (prev_en < n || boundary);
  return {boundary ? e : 0, first_suf ? e : -1};
}

// Bits of an entry's index in its tile (seg_scan::kTile entries).
constexpr int kTileBits = 11;

// The gathered entries of the sharded form: the buffer, its ranks' stride
// in int64 words, the ranks' counts [ranks, (m, prefixes)] and the number
// of ranks.
struct Gathered {
  const long long* buf;
  int64_t rank_words;
  const long long* counts;
  int ranks;
};

template <bool kRecords>
__global__ void __launch_bounds__(seg_scan::kThreads, seg_scan::kMinBlocks)
sweep_pair_claim_kernel(int64_t m, int64_t n, const long long* __restrict__ ks,
                        const long long* __restrict__ ent, const int32_t* __restrict__ ids,
                        const int64_t* __restrict__ p2, const int64_t* __restrict__ h2,
                        Gathered g, long long gid_lo, long long gid_hi,
                        int32_t* __restrict__ succ_g, int32_t* __restrict__ ovl_g,
                        bool* __restrict__ a_s, bool* __restrict__ a_p, int ovl,
                        long long* scratch) {
  using namespace seg_scan;
  __shared__ __align__(16) long long s_ks[kTile];
  __shared__ __align__(16) long long s_en[kTile];
  __shared__ long long s_counts[kRecords ? 2 * sweep_record::kMaxRanks : 1];
  __shared__ long long s_table[kRecords ? 2 * sweep_record::kMaxRanks + 1 : 1];
  const int64_t tile = next_tile(scratch);
  stage_tile(ks, m, tile, 0, s_ks);
  stage_tile(ent, m, tile, 0, s_en);
  if constexpr (kRecords) sweep_record::load_table(g.counts, g.ranks, s_counts, s_table);
  const int64_t first = tile * kTile + (int64_t)threadIdx.x * kItems;
  // key and index left of the thread's first entry: thread 0 reads them
  // while the tile is copied, the others from the tile
  long long left_key = 0, left_en = 0;
  if (threadIdx.x == 0 && first > 0) {
    left_key = ks[first - 1];
    left_en = ent[first - 1];
  }
  staged_wait();
  if constexpr (kRecords) n = s_table[g.ranks];   // the prefixes: positions below are prefixes
  if (threadIdx.x > 0) {
    left_key = staged(s_ks, threadIdx.x * kItems - 1);
    left_en = staged(s_en, threadIdx.x * kItems - 1);
  }

  State agg = PairOp::identity();
  long long pk = left_key, pn = left_en;
#pragma unroll
  for (int c = 0; c < kItems / 2; ++c) {
    const longlong2 k = pair_of(s_ks, c), en = pair_of(s_en, c);
    const int64_t e = first + 2 * c;
    agg = PairOp::combine(agg, entry_state(e, m, n, k.x, en.x, pk, pn));
    agg = PairOp::combine(agg, entry_state(e + 1, m, n, k.y, en.y, k.x, en.x));
    pk = k.y;
    pn = en.y;
  }
  State acc = thread_prefix<PairOp>(agg, scratch, tile);
  // each paired suffix's partner position (-1: not a paired suffix)
  long long part[kItems];
  pk = left_key;
  pn = left_en;
#pragma unroll
  for (int c = 0; c < kItems / 2; ++c) {
    const longlong2 k = pair_of(s_ks, c), en = pair_of(s_en, c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t e = first + 2 * c + h;
      const long long key = h ? k.y : k.x, me = h ? en.y : en.x;
      acc = PairOp::combine(acc, entry_state(e, m, n, key, me, h ? k.x : pk, h ? en.x : pn));
      const long long rank = e - acc.b;
      part[2 * c + h] = (e < m && me >= n && rank < acc.b - acc.a) ? acc.a + rank : -1;
    }
    pk = k.y;
    pn = en.y;
  }
  if constexpr (kRecords) {
    // A warp's pairs are few and spread over its lanes' items, so each
    // lane's items would each cost the warp a map and two loads: queue the
    // warp's pairs (its own item, its partner's position) in the warp's
    // slice of s_ks, which the scan no longer reads, and let each lane take
    // every 32nd of them.
    const int lane = threadIdx.x & 31;
    static_assert(kTile == 1 << kTileBits, "a queued pair keeps its item in kTileBits bits");
    long long* queue = s_ks + (threadIdx.x & ~31) * kItems;
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) mine += part[j] >= 0;
    int at = mine;   // inclusive prefix of the lanes' pairs
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, at, d);
      if (lane >= d) at += o;
    }
    const int pairs = __shfl_sync(kFull, at, 31);
    at -= mine;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (part[j] >= 0) queue[at++] = part[j] << kTileBits | (threadIdx.x * kItems + j);
    __syncwarp();
    for (int q = lane; q < pairs; q += 32) {
      const long long task = queue[q];
      const sweep_record::Row rs = sweep_record::gathered_row(
          s_table, g.ranks, g.rank_words, staged(s_en, (int)(task & (kTile - 1))));
      const sweep_record::Row rp =
          sweep_record::gathered_row(s_table, g.ranks, g.rank_words, ent[task >> kTileBits]);
      const longlong2 pay_s = __ldg(reinterpret_cast<const longlong2*>(
          g.buf + rs.base + sweep_record::payload_word(rs.d)));
      const longlong2 pay_p = __ldg(reinterpret_cast<const longlong2*>(
          g.buf + rp.base + sweep_record::payload_word(rp.d)));
      const int32_t gid_p = sweep_record::gid(pay_p.x), gid_s = sweep_record::gid(pay_s.x);
      if (gid_p != gid_s && pay_p.y == pay_s.y) {
        succ_g[gid_s] = gid_p;
        ovl_g[gid_s] = ovl;
        if (gid_s >= gid_lo && gid_s < gid_hi) a_s[sweep_record::row(pay_s.x)] = false;
      }
      if (gid_p >= gid_lo && gid_p < gid_hi) a_p[sweep_record::row(pay_p.x)] = false;
    }
    return;
  }
  // each partner's entry, its row: every partner load is issued before
  // the gathers
#pragma unroll
  for (int j = 0; j < kItems; ++j) part[j] = part[j] >= 0 ? ent[part[j]] : -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long pe = part[j];
    if (pe < 0) continue;
    const int64_t srow = staged(s_en, threadIdx.x * kItems + j) - n;
    const int32_t gid_p = ids[pe], gid_s = ids[srow];
    if (gid_p != gid_s && p2[pe] == h2[srow]) {
      succ_g[gid_s] = gid_p;
      ovl_g[gid_s] = ovl;
      a_s[srow] = false;
    }
    a_p[pe] = false;
  }
}

// The key layout: keys[j] = the key of position j (in (side, rank) order)
// of the gathered buffer, j < m.
__global__ void __launch_bounds__(256)
sharded_keys_kernel(int64_t m, Gathered g, long long* __restrict__ keys) {
  __shared__ long long s_counts[2 * sweep_record::kMaxRanks];
  __shared__ long long s_table[2 * sweep_record::kMaxRanks + 1];
  sweep_record::load_table(g.counts, g.ranks, s_counts, s_table);
  __syncthreads();
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const sweep_record::Row r = sweep_record::gathered_row(s_table, g.ranks, g.rank_words, j);
  keys[j] = g.buf[r.base + sweep_record::key_word(r.d)];
}

}  // namespace

namespace {

template <bool kRecords>
int pair_claim(int device, void* stream, int64_t m, int64_t n, const void* ks, const void* ent,
               const void* ids, const void* p2, const void* h2, Gathered g,
               long long gid_lo, long long gid_hi, void* succ_g, void* ovl_g, void* a_s,
               void* a_p, int ovl, void* scratch, int64_t scratch_words) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  if (scratch_words < seg_scan::scratch_words(m)) return (int)cudaErrorInvalidValue;
  err = seg_scan::zero_scratch(scratch, m, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  sweep_pair_claim_kernel<kRecords><<<(unsigned)seg_scan::tiles_for(m), seg_scan::kThreads, 0,
                                      (cudaStream_t)stream>>>(
      m, n, (const long long*)ks, (const long long*)ent, (const int32_t*)ids,
      (const int64_t*)p2, (const int64_t*)h2, g, gid_lo, gid_hi,
      (int32_t*)succ_g, (int32_t*)ovl_g, (bool*)a_s, (bool*)a_p, ovl, (long long*)scratch);
  return (int)cudaGetLastError();
}

// A gathered buffer the kernels can read: ranks the table holds, payloads
// on 16 bytes.
bool valid(const Gathered& g) {
  return g.ranks >= 1 && g.ranks <= sweep_record::kMaxRanks &&
         (reinterpret_cast<uintptr_t>(g.buf) & 15) == 0 &&
         g.rank_words % sweep_record::kChunkWords == 0;
}

}  // namespace

extern "C" int pgrc_sweep_pair_claim(int device, void* stream, int64_t m, int64_t n,
                                     const void* ks, const void* ent, const void* ids,
                                     const void* p2, const void* h2, void* succ_g,
                                     void* ovl_g, void* a_s, void* a_p, int ovl,
                                     void* scratch, int64_t scratch_words) {
  return pair_claim<false>(device, stream, m, n, ks, ent, ids, p2, h2, Gathered{}, 0, 0,
                           succ_g, ovl_g, a_s, a_p, ovl, scratch, scratch_words);
}

// The sharded form: ks, perm [m] int64 (the gathered keys in (side, rank)
// order, stably sorted, and the sort's permutation); gathered: `ranks`
// ranks' buffers rank_words int64 words apart (sweep_record.cuh); counts
// [ranks, 2] int64 on the card; a rank clears the flags of gids in
// [gid_lo, gid_hi) only.
extern "C" int pgrc_sweep_pair_records(int device, void* stream, int64_t m, const void* ks,
                                       const void* perm, const void* gathered,
                                       int64_t rank_words, const void* counts, int ranks,
                                       int64_t gid_lo, int64_t gid_hi, void* succ_g,
                                       void* ovl_g, void* a_s, void* a_p, int ovl,
                                       void* scratch, int64_t scratch_words) {
  const Gathered g{(const long long*)gathered, rank_words, (const long long*)counts, ranks};
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  return pair_claim<true>(device, stream, m, 0, ks, perm, nullptr, nullptr, nullptr, g,
                          gid_lo, gid_hi, succ_g, ovl_g, a_s, a_p, ovl, scratch,
                          scratch_words);
}

// The key layout: keys [m] int64 from the gathered buffer, as above.
extern "C" int pgrc_sharded_keys(int device, void* stream, int64_t m, const void* gathered,
                                 int64_t rank_words, const void* counts, int ranks,
                                 void* keys) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Gathered g{(const long long*)gathered, rank_words, (const long long*)counts, ranks};
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  sharded_keys_kernel<<<(unsigned)((m + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      m, g, (long long*)keys);
  return (int)cudaGetLastError();
}
