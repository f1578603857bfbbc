// Kernel D: sweep_roll_entries — one overlap round's hash roll and its
// active entries, compacted.
//
// Replaces pgrc_tpu/overlap/greedy_scs.py `_build_seg_fn.round_fn`'s hash
// roll (:235-240) and entry build and selection (:251-258: the 2n keys, of
// which the sort keeps the valid ones). The entries are the 2n of the
// reference, in (side, gid) order: entry e < n is row e's prefix, which
// drops column L-i; entry n + r is row r's suffix, which drops column i-1:
//   p   = (p - v[L-i]) * A^-1  p2  = (p2 - v[L-i]) * B^-1
//   h  -= v[i-1] * A^(L-i)     h2 -= v[i-1] * B^(L-i)       (all mod 2^64)
// with A = HASH_BASE64, B = HASH_BASE64B (:54-57) and a symbol's value its
// 2-bit code + 4 * its N bit. Every row rolls every round, active or not
// and whether or not the round matches anything (:232-234): the recurrences
// are cumulative. h, p, h2, p2 are updated IN PLACE.
//
// The active entries (a_p[e] for a prefix, a_s[r] for a suffix) are written
// compacted and in entry order: keys[d] = the entry's rolled hash with bit
// 63 flipped (signed int64 order = unsigned order), ent[d] = e, and their
// count m to scratch word kTotalsWord (seg_scan.cuh), which the host reads
// once a round before it sorts keys[:m] stably. So the round's stable sort
// keeps the reference's (key, side|gid) order, and kernel F finds an
// entry's side, gid and confirm hash from its index.
//
// What bounds D on the card: two things. Bytes: an entry reads and writes
// its side's two hashes (32 B), reads one lane word and N-mask word and one
// flag, and an active entry writes 16 B. And a cost of a few microseconds a
// launch that does not scale with bytes (PERF.md section 6), which the round
// paid four times over before: D, then a cat, a nonzero with its host sync
// and a gather of the keys. What the design does about it: the selection
// is fused into the roll as a one-pass count scan (seg_scan.cuh's tiles and
// warp-wide decoupled look-back, as one segment), so a round is D, the
// sort, one gather and F; the output buffers are allocated once per table
// at capacity 2n and the scratch is zeroed here, by cudaMemsetAsync, not by
// a fill kernel. The roll is striped (consecutive threads on consecutive
// entries, so hash loads and stores coalesce); keys and flags go through
// shared memory to the blocked layout of the scan and back to a striped
// write of the outputs. A thread rolls only its side's pair of hashes; the
// price is that each side reads its row's lane sector, so the lanes come
// from memory twice where both sides' columns share a sector.
//
// The sharded form (`kRecords`, kernel D of a mesh round; pgrc_tpu's
// `round_fn` under shard_map, :243-263) rolls the same way but writes each
// active entry's whole record (sweep_record.cuh: key, side | gid | row,
// confirm hash) to out[3d .. 3d+2], since after the ranks' gather its row
// lives on another rank, and counts the active prefixes beside all active
// entries (scratch word kTotalsWord + 1): the prefixes come first, so that
// count splits the output into the two halves the gather keeps apart. An
// entry's gid is ids[row]; its confirm hash is the rolled p2 or h2, which
// the thread that rolled it reads back. Bytes: 4 more a row (ids) and 8
// more an active entry than the one-device form.
#include <cstdint>
#include <cuda_runtime.h>

#include "packed_cols.cuh"
#include "seg_scan.cuh"
#include "sweep_record.cuh"

namespace {

using seg_scan::State;

// Shared-memory slot of a tile's entry k: one pad word after every eight,
// so a thread reading its eight consecutive entries and a warp reading 32
// consecutive ones both touch distinct banks.
__device__ __forceinline__ int padded(int k) { return k + (k >> 3); }

template <bool kRecords>
__global__ void __launch_bounds__(seg_scan::kThreads, seg_scan::kMinBlocks)
sweep_roll_entries_kernel(int64_t n, const uint32_t* __restrict__ lanes, int ld_lanes,
                          const uint32_t* __restrict__ nmask, int ld_nmask,
                          const bool* __restrict__ active_s, const bool* __restrict__ active_p,
                          int i, int L, uint64_t pow_a, uint64_t pow_b, uint64_t inv_a,
                          uint64_t inv_b, uint64_t* __restrict__ h, uint64_t* __restrict__ p,
                          uint64_t* __restrict__ h2, uint64_t* __restrict__ p2,
                          const int32_t* __restrict__ ids, long long* __restrict__ keys,
                          long long* __restrict__ ent, long long* scratch) {
  using namespace seg_scan;
  constexpr uint64_t kFlip = 1ull << 63;
  __shared__ long long s_key[kTile + kTile / 8];
  __shared__ short s_slot[kTile];   // 1/0 active, then the entry's output slot or -1
  __shared__ long long s_base;
  const int64_t m = 2 * n;
  const int64_t tile = next_tile(scratch);
  const int64_t first = tile * kTile;

  // the roll, striped
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const int64_t e = first + idx;
    bool act = false;
    if (e < m) {
      const bool suf = e >= n;
      const int64_t r = suf ? e - n : e;
      const uint64_t v =
          packed_cols::col_val(lanes, ld_lanes, nmask, ld_nmask, r, suf ? i - 1 : L - i);
      uint64_t hv;
      if (suf) {
        hv = h[r] - v * pow_a;
        h[r] = hv;
        h2[r] = h2[r] - v * pow_b;
        act = active_s[r];
      } else {
        hv = (p[r] - v) * inv_a;
        p[r] = hv;
        p2[r] = (p2[r] - v) * inv_b;
        act = active_p[r];
      }
      s_key[padded(idx)] = (long long)(hv ^ kFlip);
    }
    s_slot[idx] = act;
  }
  __syncthreads();

  // the count scan, blocked: thread t holds entries t * kItems ..
  const int mine = threadIdx.x * kItems;
  long long cnt = 0, cnt_pref = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    cnt += s_slot[mine + j];
    if (kRecords && first + mine + j < n) cnt_pref += s_slot[mine + j];
  }
  const State pre = thread_prefix<CountOp>({cnt, cnt_pref}, scratch, tile);
  if (threadIdx.x == 0) s_base = pre.a;
  __syncthreads();
  short slot = (short)(pre.a - s_base);
#pragma unroll
  for (int j = 0; j < kItems; ++j) s_slot[mine + j] = s_slot[mine + j] ? slot++ : (short)-1;
  if (threadIdx.x == kThreads - 1 && tile == tiles_for(m) - 1) {
    scratch[kTotalsWord] = pre.a + cnt;   // m: the last tile's inclusive count
    if (kRecords) scratch[kTotalsWord + 1] = pre.b + cnt_pref;   // the active prefixes
  }
  __syncthreads();

  // the active entries, striped
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const short d = s_slot[idx];
    if (d < 0) continue;
    const int64_t o = s_base + d, e = first + idx;
    if constexpr (kRecords) {
      const bool suf = e >= n;
      const int64_t r = suf ? e - n : e;
      long long* rec = keys + sweep_record::kWords * o;
      rec[0] = s_key[padded(idx)];
      rec[1] = sweep_record::pack(suf, ids[r], r);
      rec[2] = (long long)(suf ? h2[r] : p2[r]);
    } else {
      keys[o] = s_key[padded(idx)];
      ent[o] = e;
    }
  }
}

}  // namespace

namespace {

template <bool kRecords>
int roll_entries(int device, void* stream, int64_t n, const void* lanes, int ld_lanes,
                 const void* nmask, int ld_nmask, const void* active_s, const void* active_p,
                 int i, int L, uint64_t pow_a, uint64_t pow_b, uint64_t inv_a, uint64_t inv_b,
                 void* h, void* p, void* h2, void* p2, const void* ids, void* keys, void* ent,
                 void* scratch, int64_t scratch_words) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t m = 2 * n;
  if (scratch_words < seg_scan::scratch_words(m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  err = seg_scan::zero_scratch(scratch, m, s);
  if (err != cudaSuccess || n == 0) return (int)err;
  sweep_roll_entries_kernel<kRecords>
      <<<(unsigned)seg_scan::tiles_for(m), seg_scan::kThreads, 0, s>>>(
          n, (const uint32_t*)lanes, ld_lanes, (const uint32_t*)nmask, ld_nmask,
          (const bool*)active_s, (const bool*)active_p, i, L, pow_a, pow_b, inv_a, inv_b,
          (uint64_t*)h, (uint64_t*)p, (uint64_t*)h2, (uint64_t*)p2, (const int32_t*)ids,
          (long long*)keys, (long long*)ent, (long long*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// keys, ent [2n] int64 (capacity); scratch: seg_scan::scratch_words(2n)
// int64 words, zeroed here; the count m lands in scratch[kTotalsWord].
extern "C" int pgrc_sweep_roll_entries(
    int device, void* stream, int64_t n, const void* lanes, int ld_lanes,
    const void* nmask, int ld_nmask, const void* active_s, const void* active_p,
    int i, int L, uint64_t pow_a, uint64_t pow_b, uint64_t inv_a, uint64_t inv_b,
    void* h, void* p, void* h2, void* p2, void* keys, void* ent, void* scratch,
    int64_t scratch_words) {
  return roll_entries<false>(device, stream, n, lanes, ld_lanes, nmask, ld_nmask, active_s,
                             active_p, i, L, pow_a, pow_b, inv_a, inv_b, h, p, h2, p2,
                             nullptr, keys, ent, scratch, scratch_words);
}

// The sharded form: ids [n] int32 (the rows' global ids), recs [2n, 3]
// int64 (capacity); m lands in scratch[kTotalsWord], the active prefixes,
// which come first, in scratch[kTotalsWord + 1].
extern "C" int pgrc_sweep_roll_records(
    int device, void* stream, int64_t n, const void* lanes, int ld_lanes,
    const void* nmask, int ld_nmask, const void* active_s, const void* active_p,
    int i, int L, uint64_t pow_a, uint64_t pow_b, uint64_t inv_a, uint64_t inv_b,
    void* h, void* p, void* h2, void* p2, const void* ids, void* recs, void* scratch,
    int64_t scratch_words) {
  return roll_entries<true>(device, stream, n, lanes, ld_lanes, nmask, ld_nmask, active_s,
                            active_p, i, L, pow_a, pow_b, inv_a, inv_b, h, p, h2, p2, ids,
                            recs, nullptr, scratch, scratch_words);
}
