// Maximal-exact-match finder for the stage-7 pg-vs-pg matcher.
//
// Native re-implementation of the sampled-anchor MEM recipe the device
// matcher also uses (the copMEM idea: matching/copmem/CopMEMMatcher.cpp
// :139-324 index build, :483-566 probe loop, re-designed): index `src`
// k-mer positions every k1, scan `query` every k2, verify anchors, extend
// each to a maximal run, and remember per-diagonal coverage so anchors
// inside an already-found run are skipped (no quadratic re-extension on
// long repeats). Output runs are maximal and >= min_len; the greedy
// non-overlapping selection stays in Python (few hundred runs).
//
// Symbols are uint8 value codes (0..4). Sequential single pass — the pg is
// a single string, host-side; this is the C++ runtime half of the design
// (device kernels cover the per-read matcher).
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

static inline uint64_t kmer_hash(const uint8_t* s, int64_t k) {
  // FNV-ish multiply-xor over the code bytes; only equality of full k-mers
  // matters (anchors are verified exactly), so distribution just needs to
  // spread buckets.
  uint64_t h = 0xcbf29ce484222325ull;
  for (int64_t i = 0; i < k; ++i) {
    h = (h ^ s[i]) * 0x100000001b3ull;
  }
  return h;
}

}  // namespace

extern "C" int64_t pg_find_matches(
    const uint8_t* src, int64_t ns, const uint8_t* query, int64_t nq,
    int64_t min_len, int64_t k, int64_t k1, int64_t k2, int64_t max_bucket,
    int64_t* out_spos, int64_t* out_qpos, int64_t* out_len, int64_t cap) {
  if (ns < k || nq < k || cap <= 0) return 0;
  const int64_t n_sample = (ns - k) / k1 + 1;
  int bits = 14;
  while ((1ll << bits) < n_sample && bits < 26) ++bits;
  const int64_t nbuck = 1ll << bits;
  const uint64_t mask = nbuck - 1;

  // CSR bucket table over sampled src positions
  std::vector<int32_t> counts(nbuck + 1, 0);
  std::vector<int64_t> hcache(n_sample);
  for (int64_t i = 0; i < n_sample; ++i) {
    uint64_t h = kmer_hash(src + i * k1, k) & mask;
    hcache[i] = h;
    ++counts[h + 1];
  }
  for (int64_t b = 0; b < nbuck; ++b) counts[b + 1] += counts[b];
  std::vector<int64_t> positions(n_sample);
  {
    std::vector<int32_t> fill(nbuck, 0);
    for (int64_t i = 0; i < n_sample; ++i) {
      int64_t h = hcache[i];
      positions[counts[h] + fill[h]] = i * k1;
      ++fill[h];
    }
  }

  // per-diagonal covered-until map: diag -> query end of the found run
  std::unordered_map<int64_t, int64_t> covered;
  covered.reserve(1024);
  int64_t out_n = 0;

  for (int64_t q = 0; q + k <= nq; q += k2) {
    uint64_t h = kmer_hash(query + q, k) & mask;
    int64_t lo = counts[h], hi = counts[h + 1];
    if (hi - lo > max_bucket) hi = lo + max_bucket;
    for (int64_t c = lo; c < hi; ++c) {
      int64_t s = positions[c];
      if (memcmp(src + s, query + q, (size_t)k) != 0) continue;
      int64_t diag = s - q;
      auto it = covered.find(diag);
      if (it != covered.end() && it->second >= q + k) continue;
      // extend left
      int64_t left = 0;
      while (s - left > 0 && q - left > 0 &&
             src[s - left - 1] == query[q - left - 1])
        ++left;
      // extend right
      int64_t right = 0;
      while (s + k + right < ns && q + k + right < nq &&
             src[s + k + right] == query[q + k + right])
        ++right;
      int64_t run_q0 = q - left;
      int64_t run_len = left + k + right;
      covered[diag] = run_q0 + run_len;
      if (run_len >= min_len) {
        if (out_n >= cap) return -1;  // caller retries with a bigger buffer
        out_spos[out_n] = s - left;
        out_qpos[out_n] = run_q0;
        out_len[out_n] = run_len;
        ++out_n;
      }
    }
  }
  return out_n;
}
