// Maximal-exact-match finder for the stage-7 pg-vs-pg matcher.
//
// Native re-implementation of the sampled-anchor MEM recipe the device
// matcher also uses (the copMEM idea: matching/copmem/CopMEMMatcher.cpp
// :139-324 index build, :483-566 probe loop, re-designed): index `src`
// k-mer positions every k1, scan `query` every k2, verify anchors, extend
// each to a maximal run, and remember per-diagonal coverage so anchors
// inside an already-found run are skipped (no quadratic re-extension on
// long repeats). Output runs are maximal and >= min_len; the greedy
// non-overlapping selection stays in Python.
//
// The index (`pg_index_build`) is built once per source pg and scanned by
// any number of queries (`pg_scan`), from any thread: it is read-only once
// built and there is no global state. A scan cuts its probes q = 0, k2,
// 2*k2, ... into contiguous slices, one per thread, each with its own
// covered-diagonal map and output; the outputs are merged, sorted and
// made unique. Every reported run is the maximal exact run on its diagonal
// through a verified anchor (extension is bounded by the whole src and
// query, never by a slice), and the map only skips anchors inside a run
// already found, so the set of runs is the same at any thread count; a run
// that crosses a slice edge is found by both slices and kept once.
//
// Symbols are uint8 value codes (0..4).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
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

struct Run {
  int64_t s, q, len;
  bool operator<(const Run& o) const {
    if (s != o.s) return s < o.s;
    if (q != o.q) return q < o.q;
    return len < o.len;
  }
  bool operator==(const Run& o) const {
    return s == o.s && q == o.q && len == o.len;
  }
};

// CSR bucket table over the sampled src positions i * k1: bucket b's
// positions are positions[counts[b] .. counts[b + 1]), in increasing order.
// P is int32_t where every count and position fits (ns < 2^31), else
// int64_t.
template <typename P>
struct Table {
  std::vector<P> counts, positions;
};

struct Index {
  const uint8_t* src;
  int64_t ns, k, k1;
  uint64_t mask;
  bool wide;
  Table<int32_t> t32;
  Table<int64_t> t64;
};

template <typename P>
void build_table(const Index& ix, int64_t n_sample, Table<P>& t) {
  const int64_t nbuck = (int64_t)ix.mask + 1;
  t.counts.assign(nbuck + 1, 0);
  std::vector<uint32_t> hcache(n_sample);
  for (int64_t i = 0; i < n_sample; ++i) {
    uint32_t h = (uint32_t)(kmer_hash(ix.src + i * ix.k1, ix.k) & ix.mask);
    hcache[i] = h;
    ++t.counts[h + 1];
  }
  for (int64_t b = 0; b < nbuck; ++b) t.counts[b + 1] += t.counts[b];
  t.positions.resize(n_sample);
  std::vector<P> fill(t.counts.begin(), t.counts.end() - 1);
  for (int64_t i = 0; i < n_sample; ++i) {
    t.positions[fill[hcache[i]]++] = (P)(i * ix.k1);
  }
}

// the probes [p0, p1) of one slice, with the slice's own covered map
template <typename P>
void scan_slice(const Index& ix, const Table<P>& t, const uint8_t* query,
                int64_t nq, int64_t min_len, int64_t k2, int64_t max_bucket,
                int64_t p0, int64_t p1, std::vector<Run>& out) {
  const uint8_t* src = ix.src;
  const int64_t ns = ix.ns, k = ix.k;
  const P* counts = t.counts.data();
  const P* positions = t.positions.data();
  // per-diagonal covered-until map: diag -> query end of the found run
  std::unordered_map<int64_t, int64_t> covered;
  covered.reserve(1024);
  for (int64_t p = p0; p < p1; ++p) {
    const int64_t q = p * k2;
    uint64_t h = kmer_hash(query + q, k) & ix.mask;
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
      if (run_len >= min_len) out.push_back({s - left, run_q0, run_len});
    }
  }
}

template <typename P>
void scan(const Index& ix, const Table<P>& t, const uint8_t* query,
          int64_t nq, int64_t min_len, int64_t k2, int64_t max_bucket,
          int64_t nthreads, std::vector<Run>& runs) {
  const int64_t nprobe = (nq - ix.k) / k2 + 1;
  if (nthreads > nprobe) nthreads = nprobe;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::vector<Run>> outs((size_t)nthreads);
  std::vector<char> failed((size_t)nthreads, 0);
  auto work = [&](int64_t i) {
    try {
      scan_slice(ix, t, query, nq, min_len, k2, max_bucket,
                 nprobe * i / nthreads, nprobe * (i + 1) / nthreads, outs[i]);
    } catch (const std::bad_alloc&) {
      failed[i] = 1;
    }
  };
  std::vector<std::thread> ts;
  int64_t started = 1;
  try {
    for (; started < nthreads; ++started) ts.emplace_back(work, started);
  } catch (const std::system_error&) {
    // no more threads: the calling thread scans the slices left
  }
  for (int64_t i = started; i < nthreads; ++i) work(i);
  work(0);
  for (auto& th : ts) th.join();
  for (char f : failed)
    if (f) throw std::bad_alloc();
  size_t total = 0;
  for (auto& o : outs) total += o.size();
  runs.reserve(total);
  for (auto& o : outs) {
    runs.insert(runs.end(), o.begin(), o.end());
    std::vector<Run>().swap(o);
  }
  std::sort(runs.begin(), runs.end());
  runs.erase(std::unique(runs.begin(), runs.end()), runs.end());
}

}  // namespace

// The index of src's k-mers at every k1-th position; src must outlive it.
// -> an opaque handle for pg_scan / pg_index_free, or NULL when out of
// memory.
extern "C" void* pg_index_build(const uint8_t* src, int64_t ns, int64_t k,
                                int64_t k1) {
  Index* ix = new (std::nothrow) Index();
  if (ix == nullptr) return nullptr;
  ix->src = src;
  ix->ns = ns;
  ix->k = k;
  ix->k1 = k1;
  const int64_t n_sample = ns < k ? 0 : (ns - k) / k1 + 1;
  int bits = 14;
  while ((1ll << bits) < n_sample && bits < 26) ++bits;
  ix->mask = (1ull << bits) - 1;
  ix->wide = ns >= (1ll << 31);
  try {
    if (ix->wide)
      build_table(*ix, n_sample, ix->t64);
    else
      build_table(*ix, n_sample, ix->t32);
  } catch (const std::bad_alloc&) {
    delete ix;
    return nullptr;
  }
  return ix;
}

extern "C" void pg_index_free(void* index) { delete (Index*)index; }

// Every maximal exact run (>= min_len) of query against the index's src
// through an anchor probed at q = 0, k2, 2*k2, ... (at most max_bucket
// candidates a probe), over nthreads contiguous slices of the probes.
// -> an opaque handle holding the runs sorted by (src pos, query pos,
// length) and unique, with their number in *count, for pg_runs_take; NULL
// when out of memory.
extern "C" void* pg_scan(const void* index, const uint8_t* query, int64_t nq,
                         int64_t min_len, int64_t k2, int64_t max_bucket,
                         int64_t nthreads, int64_t* count) {
  const Index& ix = *(const Index*)index;
  std::vector<Run>* runs = new (std::nothrow) std::vector<Run>();
  if (runs == nullptr) return nullptr;
  try {
    if (ix.ns >= ix.k && nq >= ix.k) {
      if (ix.wide)
        scan(ix, ix.t64, query, nq, min_len, k2, max_bucket, nthreads, *runs);
      else
        scan(ix, ix.t32, query, nq, min_len, k2, max_bucket, nthreads, *runs);
    }
  } catch (const std::bad_alloc&) {
    delete runs;
    return nullptr;
  }
  *count = (int64_t)runs->size();
  return runs;
}

// Copy a scan's runs into out [count, 3] (src pos, query pos, length) and
// free them; out may be NULL to free them only.
extern "C" void pg_runs_take(void* handle, int64_t* out) {
  std::vector<Run>* runs = (std::vector<Run>*)handle;
  if (out != nullptr) {
    for (size_t i = 0; i < runs->size(); ++i) {
      out[3 * i] = (*runs)[i].s;
      out[3 * i + 1] = (*runs)[i].q;
      out[3 * i + 2] = (*runs)[i].len;
    }
  }
  delete runs;
}
