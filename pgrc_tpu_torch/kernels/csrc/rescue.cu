// Kernels K and L: the matcher's interleaved-anchor rescue on the card.
//
// Replace the host pass 3 of pgrc_tpu/align/matcher.py `match_reads`
// (:726-752): `_build_rescue_index` (:763-791) and the two calls of
// `_interleaved_rescue` (:794-849), forward and reverse complement, for the
// reads that both device passes left unmatched. An interleaved anchor at pg
// position p hashes every second symbol of a 2k-wide window,
// H(p) = sum_t pg[p + 2t] * B^(k-1-t) mod 2^32, t < k, B = HASH_BASE, so a
// burst of errors inside one contiguous k-mer cannot kill every anchor.
//
// K, rescue_table: the reference's candidate table. Entry j samples
// p = j * k1 for p < pg_len - 2k + 1; its bucket is H >> 12 (2^20 buckets)
// and a bucket's candidates are its first 4 entries in ascending position
// (the reference's stable argsort, then lo + c for c < min(count, 4)). So
// the table holds only each bucket's 4 least entries: 2^20 x 4 slots of
// (j << 12) | (H & 0xFFF), ascending, ~0 where a bucket has fewer. The
// bucket and the low 12 bits give the full hash, so L checks a candidate's
// hash from its slot alone. j < 2^34 for any pg the join takes (2^35
// symbols), so a slot is 46 bits and one 64-bit form serves every pg.
// The build is one pass with no sort: a thread an entry hashes its window
// from the packed pg (2k - 1 symbols: 2 or 3 lanes) and inserts its slot
// value by a cascade of atomicMin down the bucket's four slots, each slot
// keeping the least value it is offered and handing the larger one to the
// next, the last dropping it. Whatever order the atomics land in, slot s
// ends as the s-th least value of the bucket: the same table every run.
// A value at or above the last slot (a plain read) stops at once, so in a
// bucket of many entries most of them make no atomic. Measured against it
// on an H100: four passes of one atomicMin each (pass s taking the least
// value above slot s - 1), 2.0-4.5 times slower from a 10.78M-symbol pg to
// a 300M one. The table is 32 MB, so its memory does not grow with the pg
// (the host index of a 2.3G pg held ~287M entries).
//
// L, rescue_best: one warp per read and strand. The warp stages the
// strand's codes (forward: the read's 1-byte codes as they are, N = 4;
// reverse: the reverse complement with every code above 3 set to 0, as
// matcher.py:305-307 makes it) and their 2-bit words. For every offset o in
// [0, L - 2k] (a lane each, 32 at a time) it hashes symbols o, o + 2, ...,
// o + 2(k - 1), reads the bucket's 4 slots (one 32-byte sector) and keeps a
// slot whose low bits equal the hash's and whose start s = j * k1 - o lies
// in [0, pg_len - L]; it counts that window's mismatches against the
// strand and keeps the least (mis, s) with mis <= max_mis. A warp shuffle
// takes the minimum: no atomics, so the result does not depend on order,
// and it is the reference's, whose update keeps the lexicographic minimum.
// Output: per read and strand one int64, (mis << 40) | s, or -1 for none.
//
// The pg: read from the packed lanes (2 bits a symbol, one zero pad lane,
// the device passes' `pg_lanes`), which pack N as A, or, when the wrapper
// passes them, from the pg's 1-byte codes: the matcher uploads those only
// for a pg that holds a code above 3, which the encoder's HQ pg never does.
// From the lanes a window's mismatches are counted 16 symbols a word: the
// XOR with the strand's word, its pairs folded to one bit, OR the strand's
// N bits (a read code above 3 never equals a 2-bit pg code), popcount.
//
// What bounds them: K, memory (the table's 32 MB written, the pg's lanes
// read once, an 8-byte table word read at random an entry, an atomic where
// the entry enters); L, latency on a few thousand reads (SE 2M's encode
// rescues ~3k): its work is the candidates' windows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kHashBase = 0x9E3779B1u;
constexpr int kLowBits = 12;          // hash bits in a slot; 32 - 12 = 20 bucket bits
constexpr uint32_t kLowMask = (1u << kLowBits) - 1;
constexpr int kCap = 4;               // slots a bucket
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kTableThreads = 256;
constexpr int kWarps = 4;             // L's warps a block
constexpr int kMaxL = 256;
constexpr int kMaxWords = kMaxL / 16;
constexpr int kPosBits = 40;          // L's output: (mis << 40) | start
constexpr unsigned kFull = 0xFFFFFFFFu;

// The 32 symbols from pg position p, symbol p in the top bits, from the
// packed lanes; lanes at n_lanes and past read as zero.
__device__ __forceinline__ unsigned long long lanes32(const uint32_t* __restrict__ lanes,
                                                      int64_t n_lanes, int64_t p) {
  const int64_t q = p >> 4;
  const int r = 2 * (int)(p & 15);
  const uint32_t a = __ldg(lanes + q);
  const uint32_t b = q + 1 < n_lanes ? __ldg(lanes + q + 1) : 0u;
  const uint32_t c = r != 0 && q + 2 < n_lanes ? __ldg(lanes + q + 2) : 0u;
  return ((unsigned long long)__funnelshift_l(b, a, r) << 32) | __funnelshift_l(c, b, r);
}

// H(p) of the interleaved window at p: from the lanes, or from the 1-byte
// codes where `bytes` is given.
__device__ __forceinline__ uint32_t pg_hash(const uint32_t* __restrict__ lanes,
                                            int64_t n_lanes,
                                            const uint8_t* __restrict__ bytes, int64_t p,
                                            int k) {
  uint32_t h = 0;
  if (bytes != nullptr) {
    for (int t = 0; t < k; ++t) h = h * kHashBase + __ldg(bytes + p + 2 * t);
    return h;
  }
  const unsigned long long w = lanes32(lanes, n_lanes, p);
  for (int t = 0; t < k; ++t) h = h * kHashBase + (uint32_t)((w >> (62 - 4 * t)) & 3u);
  return h;
}

__global__ void __launch_bounds__(kTableThreads)
rescue_table_kernel(const uint32_t* __restrict__ lanes, int64_t n_lanes,
                    const uint8_t* __restrict__ bytes, int64_t n_ent, int k, int k1,
                    unsigned long long* __restrict__ table) {
  const int64_t j = (int64_t)blockIdx.x * kTableThreads + threadIdx.x;
  if (j >= n_ent) return;
  const uint32_t h = pg_hash(lanes, n_lanes, bytes, j * k1, k);
  unsigned long long v = ((unsigned long long)j << kLowBits) | (h & kLowMask);
  unsigned long long* slot = table + (int64_t)(h >> kLowBits) * kCap;
  // slots only fall, so a plain read is at or above the slot's value: a
  // value at or above it would not enter the slot, and goes on as it would
  // from the atomic; at or above the last slot it is not among the four
  if (v >= slot[kCap - 1]) return;
  for (int s = 0; s < kCap; ++s) {
    if (v >= slot[s]) continue;
    const unsigned long long old = atomicMin(slot + s, v);
    if (old == kEmpty) return;
    v = old > v ? old : v;   // the larger goes on to the next slot
  }
}

struct BestArgs {
  const uint8_t* codes;       // [n, L] 1-byte read codes
  int64_t n;
  int L, k, k1, max_mis;
  const unsigned long long* table;
  const uint32_t* lanes;
  int64_t n_lanes;
  const uint8_t* bytes;       // the pg's 1-byte codes, or null: read the lanes
  int64_t pg_len;
  long long* out;             // [2n]: forward rows, then reverse complements
};

__global__ void __launch_bounds__(kWarps * 32) rescue_best_kernel(BestArgs a) {
  __shared__ uint8_t s_codes[kWarps][kMaxL];
  __shared__ uint32_t s_word[kWarps][kMaxWords];
  __shared__ uint32_t s_nbit[kWarps][kMaxWords];   // N bits, at each pair's low bit
  __shared__ uint32_t s_keep[kWarps][kMaxWords];   // the pairs' low bits inside L
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarps + warp;
  if (item >= 2 * a.n) return;   // whole warps leave together
  const bool rc = item >= a.n;
  const int L = a.L;
  const uint8_t* row = a.codes + (rc ? item - a.n : item) * L;
  uint8_t* c = s_codes[warp];
  for (int t = lane; t < L; t += 32) {
    const uint8_t f = rc ? row[L - 1 - t] : row[t];
    c[t] = rc ? (f <= 3 ? 3 - f : 0) : f;
  }
  __syncwarp();
  const int W = (L + 15) / 16;
  if (lane < W) {
    uint32_t w = 0, nb = 0, keep = 0;
    for (int u = 0; u < 16; ++u) {
      const int t = 16 * lane + u;
      const uint32_t v = t < L ? c[t] : 0u;
      w |= (v & 3u) << (30 - 2 * u);
      nb |= (uint32_t)(v > 3) << (30 - 2 * u);
      keep |= (uint32_t)(t < L) << (30 - 2 * u);
    }
    s_word[warp][lane] = w;
    s_nbit[warp][lane] = nb;
    s_keep[warp][lane] = keep;
  }
  __syncwarp();

  const int64_t last_start = a.pg_len - L;
  unsigned long long best = kEmpty;
  for (int o = lane; o <= L - 2 * a.k; o += 32) {
    uint32_t h = 0;
    for (int t = 0; t < a.k; ++t) h = h * kHashBase + c[o + 2 * t];
    const ulonglong2* sl = reinterpret_cast<const ulonglong2*>(
        a.table + (int64_t)(h >> kLowBits) * kCap);
    const ulonglong2 s01 = __ldg(sl), s23 = __ldg(sl + 1);
    const unsigned long long slots[kCap] = {s01.x, s01.y, s23.x, s23.y};
#pragma unroll
    for (int q = 0; q < kCap; ++q) {
      const unsigned long long v = slots[q];
      if (v == kEmpty) break;   // slots fill in order
      if ((uint32_t)(v & kLowMask) != (h & kLowMask)) continue;
      const int64_t s = (int64_t)(v >> kLowBits) * a.k1 - o;
      if (s < 0 || s > last_start) continue;
      int mis = 0;
      if (a.bytes != nullptr) {
        for (int t = 0; t < L && mis <= a.max_mis; ++t) mis += __ldg(a.bytes + s + t) != c[t];
      } else {
        // lane q + i + 1 <= ceil(pg_len / 16): the pad lane at most
        const int64_t q0 = s >> 4;
        const int r = 2 * (int)(s & 15);
        uint32_t hi = __ldg(a.lanes + q0);
        for (int i = 0; i < W && mis <= a.max_mis; ++i) {
          const uint32_t lo = __ldg(a.lanes + q0 + i + 1);
          const uint32_t x = __funnelshift_l(lo, hi, r) ^ s_word[warp][i];
          mis += __popc((((x | (x >> 1)) & 0x55555555u) | s_nbit[warp][i]) & s_keep[warp][i]);
          hi = lo;
        }
      }
      if (mis <= a.max_mis) {
        const unsigned long long key = ((unsigned long long)mis << kPosBits) | (unsigned long long)s;
        best = key < best ? key : best;
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFull, best, d);
    best = other < best ? other : best;
  }
  if (lane == 0) a.out[item] = (long long)best;   // kEmpty is -1
}

}  // namespace

// pg_lanes [n_lanes] (the packed pg and its zero pad lane), pg_bytes [pg_len]
// 1-byte codes or null, n_ent entries j (position j * k1), k <= 16 ->
// table [2^20 * 4] uint64, each bucket's least 4 slots ascending, ~0 empty.
extern "C" int pgrc_rescue_table(int device, void* stream, const void* pg_lanes,
                                 int64_t n_lanes, const void* pg_bytes, int64_t n_ent, int k,
                                 int k1, void* table) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(table, 0xFF, (size_t(1) << (32 - kLowBits)) * kCap * 8, s);
  if (err != cudaSuccess || n_ent == 0) return (int)err;
  rescue_table_kernel<<<(unsigned)((n_ent + kTableThreads - 1) / kTableThreads), kTableThreads,
                        0, s>>>((const uint32_t*)pg_lanes, n_lanes, (const uint8_t*)pg_bytes,
                                n_ent, k, k1, (unsigned long long*)table);
  return (int)cudaGetLastError();
}

// codes [n, L] uint8 (L <= 256), the table of pgrc_rescue_table, the pg as
// there, max_mis <= 254 -> out [2n] int64: rows r < n forward, n + r
// reverse complement, (mis << 40) | start or -1.
extern "C" int pgrc_rescue_best(int device, void* stream, const void* codes, int64_t n, int L,
                                int k, int k1, int max_mis, const void* table,
                                const void* pg_lanes, int64_t n_lanes, const void* pg_bytes,
                                int64_t pg_len, void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return (int)err;
  BestArgs a{(const uint8_t*)codes, n, L, k, k1, max_mis,
             (const unsigned long long*)table, (const uint32_t*)pg_lanes, n_lanes,
             (const uint8_t*)pg_bytes, pg_len, (long long*)out};
  const unsigned blocks = (unsigned)((2 * n + kWarps - 1) / kWarps);
  rescue_best_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
