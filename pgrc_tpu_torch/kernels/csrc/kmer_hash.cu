// Kernels B and C: u32 polynomial k-mer hashes over packed 2-bit lanes,
// written as the sort keys of the matcher's join.
//
// B, index_kmer_hash, replaces pgrc_tpu/align/matcher.py
// `_build_index_build_fn.build_fn` (:469-517): one block of the sampled k-mer
// table of the pseudogenome, the entries of the lanes from lane_off on, one
// every k1 symbols (entry e at position lane_off*16 + e*k1), positions past
// pg_len - k marked -1 (inert to the probe join). Positions are int32, or
// int64 for the wide probe of pgs past 2^31 symbols (matcher.py:485, 512).
// C, probe_kmer_hash, replaces the anchor hashes of `_make_probe.probe_fn`
// (:208-223): for every read and every probe offset, the hash of the k
// symbols starting there.
// Both compute H = sum_t v[t] * B^(k-1-t) mod 2^32 with B = HASH_BASE
// (pgrc_tpu/overlap/greedy_scs.py:36); symbols are the 2-bit codes at bits
// 2*(15 - j%16) of lane j/16, and lanes past the end read as zero.
//
// Each writes the join's composed key instead of the bare hash: high word
// H ^ 0x80000000 (the signed form of H - 2^31), low word key2 = 0 for a
// live index entry, 0xFFFFFFFF for an inert one, 1 + p for probe p = r*S + j.
// Its signed order is the reference's (hash, key2) order (matcher.py:228-238).
// B writes the head of a join's key buffer and C its tail, so the join sorts
// the buffer as it stands: no concatenation and no key pass in between.
//
// What bounds them on the card: memory (B writes 8 B of key and 4 or 8 B of
// position per entry and reads 2 bits per symbol; C reads 4 B per lane and
// writes 8 B per key). A Horner chain per output costs k dependent
// multiply-adds (k = 32-40), which would bound them by instructions, so:
// - B: a block of 256 threads owns a tile of 256*8 consecutive entries,
//   whose lanes and a halo of (k+16)/16 + 2 lanes are staged in shared memory
//   by cp.async. Each thread warms the Horner window of its first entry, then
//   rolls it a symbol at a time, H <- H*B + v_in - v_out*B^k, emitting every
//   k1-th window: about 6 operations per symbol instead of k per entry. The
//   hashes go through shared memory (swizzled 16-byte chunks, no bank
//   conflicts), and the tile leaves in 16-byte key and position stores,
//   consecutive threads on consecutive entries; the low key word and the
//   position come from the entry's index (a 64-bit tile base plus a 32-bit
//   offset), so only the hash is carried.
// - C: a block takes a tile of 64 rows and stages their lanes; one thread per
//   row writes its prefix hashes P[j+1] = P[j]*B + v[j] to shared memory
//   (about 4 operations per symbol), then one thread per (row, offset), in
//   output order, takes H = P[o+k] - P[o]*B^k: consecutive threads write
//   consecutive keys, and the row and offset step with the loop (no
//   division per key).
// Rolling and prefix hashes are the same sums mod 2^32, bit for bit; the
// plain versions (kmer_hash.py) run the reference's Horner chain instead.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

constexpr uint32_t kHashBase = 0x9E3779B1u;
constexpr uint32_t kInert = 0xFFFFFFFFu;
constexpr int kBThreads = 256;
constexpr int kBRun = 8;     // B's entries a thread (16 timed slower on an H100)
constexpr int kCThreads = 128;
constexpr int kCRows = 64;   // C's rows a block at most (16 and 32 timed slower)
constexpr size_t kSmemMax = 48 * 1024;  // dynamic shared memory without opt-in

__device__ __forceinline__ long long join_key(uint32_t h, uint32_t key2) {
  return (long long)(((unsigned long long)(h ^ 0x80000000u) << 32) | key2);
}

// Start copying n words src[0, n) to shared dst[0, n), words at n_src and
// past read as zero: cp.async in 16-byte chunks where both sides are
// aligned, plain loads at the ragged end. Wait with seg_scan::staged_wait().
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* __restrict__ src,
                                            int n, int64_t n_src) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
    if (aligned && i + 4 <= n && i + 4 <= n_src) {
      seg_scan::cp_async16(dst + i, src + i);
    } else {
      for (int u = i; u < i + 4 && u < n; ++u) dst[u] = u < n_src ? src[u] : 0u;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The 16 symbols from symbol j of staged lanes L, symbol j in the top bits.
__device__ __forceinline__ uint32_t window16(const uint32_t* L, int j) {
  const int c = j >> 4;
  return __funnelshift_l(L[c + 1], L[c], 2 * (j & 15));
}

// Slot of 16-byte chunk q when each thread writes C consecutive chunks:
// eight threads storing at once land on eight distinct bank groups.
template <int C>
__device__ __forceinline__ int swz(int q) {
  return q ^ ((q >> 3) & (C - 1));
}

struct IndexArgs {
  const uint32_t* pg;
  int64_t n_lanes, lane_off, pg_len, m;
  int k;
  uint32_t bk;  // B^k mod 2^32
  long long* key;
  void* ipos;
};

// Lanes staged per tile: the tile's, the halo of its last windows, one
// lane for window16's funnel and up to 3 for the 16-byte alignment.
__host__ __device__ inline int index_stage_words(int tile_symbols, int k) {
  return 3 + (tile_symbols + k) / 16 + 2;
}

template <typename Pos, int K1>
__global__ void __launch_bounds__(kBThreads) index_kmer_hash_kernel(IndexArgs a) {
  constexpr int RUN = kBRun;
  constexpr int kTile = kBThreads * RUN;         // entries of one block
  constexpr int kChunks = RUN / 4;               // 16-byte hash chunks a thread
  static_assert(RUN % 4 == 0 && 16 % K1 == 0, "tile geometry");
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_hash = smem;
  uint32_t* s_lanes = smem + kTile;
  const int64_t e0 = (int64_t)blockIdx.x * kTile;
  const int64_t lane0 = a.lane_off + (int64_t)blockIdx.x * (kTile * K1 / 16);
  const int64_t base = lane0 & ~3ll;  // 16-byte aligned start of the copy
  const int delta = (int)(lane0 - base);
  stage_words(s_lanes, a.pg + base, delta + index_stage_words(kTile * K1, a.k) - 3,
              a.n_lanes - base);
  seg_scan::staged_wait();
  const uint32_t* L = s_lanes + delta;

  // the thread's entries tid*RUN .. +RUN-1: warm the first window by Horner
  // (16 symbols a staged window), then roll k1 symbols per entry
  const int s = threadIdx.x * RUN * K1;
  uint32_t h = 0;
  int t = 0;
  for (; t + 16 <= a.k; t += 16) {
    const uint32_t w = window16(L, s + t);
#pragma unroll
    for (int u = 0; u < 16; ++u) h = h * kHashBase + ((w >> (30 - 2 * u)) & 3u);
  }
  for (uint32_t w = window16(L, s + t); t < a.k; ++t, w <<= 2) h = h * kHashBase + (w >> 30);
  uint32_t hs[RUN];
  hs[0] = h;
#pragma unroll
  for (int i = 1; i < RUN; ++i) {
    const int so = s + (i - 1) * K1;
    const uint32_t wo = window16(L, so), wi = window16(L, so + a.k);
#pragma unroll
    for (int u = 0; u < K1; ++u)
      h = h * kHashBase + ((wi >> (30 - 2 * u)) & 3u) - ((wo >> (30 - 2 * u)) & 3u) * a.bk;
    hs[i] = h;
  }
  uint4* s_chunk = reinterpret_cast<uint4*>(s_hash);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    s_chunk[swz<kChunks>(threadIdx.x * kChunks + c)] =
        make_uint4(hs[4 * c], hs[4 * c + 1], hs[4 * c + 2], hs[4 * c + 3]);
  __syncthreads();

  // out: entry pairs (2q, 2q + 1), consecutive threads on consecutive pairs
  const int n_e = (int)min((int64_t)kTile, a.m - e0);
  const int64_t pos_t = lane0 * 16;
  const int64_t lim64 = a.pg_len - a.k - pos_t;  // entry e is live iff e*K1 <= lim
  const int lim = lim64 < 0 ? -1 : (lim64 > kTile * K1 ? kTile * K1 : (int)lim64);
  const Pos pos_base = (Pos)pos_t;
  long long* kout = a.key + e0;
  Pos* pout = reinterpret_cast<Pos*>(a.ipos) + e0;
  const bool vec = ((reinterpret_cast<uintptr_t>(kout) & 15) |
                    (reinterpret_cast<uintptr_t>(pout) & (2 * sizeof(Pos) - 1))) == 0;
  for (int q = threadIdx.x; 2 * q < n_e; q += kBThreads) {
    const uint2 hv =
        reinterpret_cast<const uint2*>(s_hash + 4 * swz<kChunks>(q >> 1))[q & 1];
    const int e = 2 * q;
    const bool v0 = e * K1 <= lim, v1 = (e + 1) * K1 <= lim;
    const long long k0 = join_key(hv.x, v0 ? 0u : kInert);
    const long long k1 = join_key(hv.y, v1 ? 0u : kInert);
    const Pos p0 = v0 ? pos_base + (Pos)(e * K1) : (Pos)-1;
    const Pos p1 = v1 ? pos_base + (Pos)((e + 1) * K1) : (Pos)-1;
    if (vec && e + 1 < n_e) {
      *reinterpret_cast<longlong2*>(kout + e) = make_longlong2(k0, k1);
      if constexpr (sizeof(Pos) == 8)
        *reinterpret_cast<longlong2*>(pout + e) = make_longlong2(p0, p1);
      else
        *reinterpret_cast<int2*>(pout + e) = make_int2((int)p0, (int)p1);
    } else {
      kout[e] = k0;
      pout[e] = p0;
      if (e + 1 < n_e) {
        kout[e + 1] = k1;
        pout[e + 1] = p1;
      }
    }
  }
}

template <typename Pos, int K1>
cudaError_t launch_index(const IndexArgs& a, cudaStream_t s) {
  constexpr int kTile = kBThreads * kBRun;
  const size_t smem = 4 * ((size_t)kTile + ((index_stage_words(kTile * K1, a.k) + 3) & ~3));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((a.m + kTile - 1) / kTile);
  index_kmer_hash_kernel<Pos, K1><<<grid, kBThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename Pos>
cudaError_t launch_index_k1(int k1, const IndexArgs& a, cudaStream_t s) {
  switch (k1) {
    case 1: return launch_index<Pos, 1>(a, s);
    case 2: return launch_index<Pos, 2>(a, s);
    case 4: return launch_index<Pos, 4>(a, s);
    case 8: return launch_index<Pos, 8>(a, s);
    case 16: return launch_index<Pos, 16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Shared memory of kernel C: [rows * stride prefixes | rows * ld lanes |
// n_offs offsets], each part rounded to 16 bytes.
__host__ __device__ inline int round4(int w) { return (w + 3) & ~3; }
__host__ inline size_t probe_smem(int rows, int stride, int ld, int n_offs) {
  return 4 * ((size_t)round4(rows * stride) + round4(rows * ld) + n_offs);
}

__global__ void __launch_bounds__(kCThreads)
probe_kmer_hash_kernel(const uint32_t* __restrict__ reads, int64_t n_reads, int ld,
                       const int32_t* __restrict__ offs, int n_offs, int k,
                       int row_lanes, int rows, int stride, uint32_t bk,
                       long long* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_pre = smem;                                // row r: P[0..16*row_lanes]
  uint32_t* s_lanes = s_pre + round4(rows * stride);
  int32_t* s_offs = reinterpret_cast<int32_t*>(s_lanes + round4(rows * ld));
  const int64_t r0 = (int64_t)blockIdx.x * rows;
  const int nr = (int)min((int64_t)rows, n_reads - r0);
  stage_words(s_lanes, reads + r0 * ld, nr * ld, (int64_t)nr * ld);
  for (int j = threadIdx.x; j < n_offs; j += kCThreads) s_offs[j] = offs[j];
  seg_scan::staged_wait();

  // one thread per row: P[0] = 0, P[j+1] = P[j]*B + v[j]
  for (int r = threadIdx.x; r < nr; r += kCThreads) {
    const uint32_t* lr = s_lanes + r * ld;
    uint32_t* pr = s_pre + r * stride;  // stride odd: a warp's rows on distinct banks
    uint32_t p = 0;
    pr[0] = 0;
    for (int c = 0; c < row_lanes; ++c) {
      const uint32_t w = lr[c];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        p = p * kHashBase + ((w >> (30 - 2 * u)) & 3u);
        pr[16 * c + u + 1] = p;
      }
    }
  }
  __syncthreads();

  // one thread per key, in output order: key q = r * n_offs + j of the tile
  const int n_out = nr * n_offs;
  int r = threadIdx.x / n_offs, j = threadIdx.x - r * n_offs;
  const int dr = kCThreads / n_offs, dj = kCThreads - dr * n_offs;
  long long* o = out + r0 * n_offs;
  const uint32_t key2 = (uint32_t)(r0 * n_offs) + 1;  // < 2^32: the wrapper checks
  for (int q = threadIdx.x; q < n_out; q += kCThreads) {
    const uint32_t* pr = s_pre + r * stride;
    const int off = s_offs[j];
    o[q] = join_key(pr[off + k] - pr[off] * bk, key2 + (uint32_t)q);
    r += dr;
    j += dj;
    if (j >= n_offs) {
      j -= n_offs;
      ++r;
    }
  }
}

}  // namespace

// B: keys [m] int64 and ipos [m] (int64_t when wide, else int32_t) of the
// index block from lane lane_off.
extern "C" int pgrc_index_kmer_hash(int device, void* stream, const void* pg,
                                    int64_t n_lanes, int k, int k1,
                                    int64_t lane_off, int64_t pg_len, int64_t m,
                                    uint32_t bk, int wide, void* key, void* ipos) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  const IndexArgs a{(const uint32_t*)pg, n_lanes, lane_off, pg_len, m, k, bk,
                    (long long*)key, ipos};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(wide ? launch_index_k1<int64_t>(k1, a, s)
                    : launch_index_k1<int32_t>(k1, a, s));
}

// C: keys [n_reads * n_offs] int64 of every read at every offset; every
// offset in [0, max_off], max_off + k <= 16 * ld. A block takes kCRows rows,
// fewer where their prefixes would not fit in shared memory.
extern "C" int pgrc_probe_kmer_hash(int device, void* stream, const void* reads,
                                    int64_t n_reads, int ld, const void* offs,
                                    int n_offs, int max_off, int k, uint32_t bk,
                                    void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_reads == 0 || n_offs == 0) return 0;
  if (k < 1 || max_off < 0 || max_off + k > 16 * ld) return (int)cudaErrorInvalidValue;
  const int row_lanes = (max_off + k + 15) / 16;
  const int stride = 16 * row_lanes + 1;  // odd
  int rows = kCRows;
  while (rows > 1 && probe_smem(rows, stride, ld, n_offs) > kSmemMax) rows /= 2;
  const size_t smem = probe_smem(rows, stride, ld, n_offs);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_reads + rows - 1) / rows);
  probe_kmer_hash_kernel<<<grid, kCThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)reads, n_reads, ld, (const int32_t*)offs, n_offs, k, row_lanes,
      rows, stride, bk, (long long*)out);
  return (int)cudaGetLastError();
}
