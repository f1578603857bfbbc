// Kernels G (sweep_full_hashes) and G2 (sweep_init_links): the sweep's init.
//
// G replaces pgrc_tpu/overlap/greedy_scs.py `_build_init_fn.init_fn`'s and
// `_build_hash_fn.hash_fn`'s Horner loops (:429-441, :475-483): both
// full-read hashes of every row,
//   h0 = sum_j v_j A^(L-1-j),   h0b = sum_j v_j B^(L-1-j)      (mod 2^64)
// with A = HASH_BASE64, B = HASH_BASE64B (:54-57) and v_j the symbol's
// 2-bit code + 4 * its N bit. In its init form it also writes the init's
// sort key, min(h0, INV64 - 1) with bit 63 flipped (signed order = unsigned
// order), where the library's stable sort reads it (:443-447).
//
// What bounds G on the card: its bytes at L = 100 (a row is ~32-52 bytes in
// and 16-24 out), with its operations close behind. The design:
// - A chunked Horner: a byte of lane bits holds four symbols, so per byte
//   h = h * A^4 + TA[byte] (+ TNA[nibble of N bits]), the same for B, where
//   TX[byte] = sum_i code_i X^(3-i) and TNX[nib] = sum_i 4 bit_i X^(3-i)
//   (kernels/sweep_init.py `chunk_tables`): the same sums mod 2^64 as a
//   multiply-add a symbol, at about a third of the operations. A read
//   length off the byte ends symbol by symbol.
// - Tables in shared memory, bank-private: the 256 + 16 entries, each A's
//   value beside B's (one 16-byte load serves both hashes), are copied
//   kCopies = 8 times so that entry b of copy q sits in 16-byte bank group
//   q; thread t reads copy t mod 8, and the eight threads of a quarter warp,
//   which a 16-byte load serves together, never meet in a bank whatever
//   their bytes (with one copy, G took 1.31x as long on an H100, PERF.md).
//   The grid is the card's resident blocks, each walking tiles of
//   kHashThreads rows, so a block fills its 35 KB of tables once.
// - Coalesced loads: a tile's rows of lanes (and N mask) are contiguous in
//   device memory, so they arrive in shared memory by 16-byte cp.async
//   copies; thread t then hashes row t from there, four lane words at a
//   time (one 16-byte load when a row is a whole number of 16-byte chunks).
//   One staging buffer: with a second, the next tile in flight while this
//   one is hashed, G was 5% faster at L 100 and 9% slower with N (PERF.md).
//
// G2 replaces the init's linking (:442-465) after the stable sort: sorted
// position j links row sidx[j] to row sidx[j+1] when both their keys and
// their second hashes agree, at overlap L. A thread per sorted position
// compares j with j+1 and with j-1 and writes succ, ovl, active_s and
// active_p of row sidx[j] — every row exactly once, so there is no init
// pass, no mask indexing and no atomics. The last sorted position never
// links forward (the reference's wrap-around neighbour is forced false,
// :448-456). What bounds G2: memory, 8 bytes each of key, index and a
// gathered h0b a position, 10 bytes of results scattered to the row. The
// block stages its positions' keys, indices and gathered h0b (one gather a
// position, plus a halo of one each side) in shared memory, so a
// neighbour's h0b is not gathered again.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

constexpr int kHashThreads = 256;   // G: rows a tile, a thread a row
constexpr int kTableEntries = 256 + 16;   // the byte table, then the N-nibble table
constexpr int kCopies = 8;                // of the tables, one per 16-byte bank group
constexpr int kLinkThreads = 256;
constexpr uint64_t kFlip = 1ull << 63;
constexpr uint64_t kInv64 = ~0ull;

// Shared memory of G's block: the table copies, then a tile's lanes and N
// mask, each with 4 words of slack for the 16-byte reads past a row's end.
__host__ __device__ inline int hash_smem(int ld_lanes, int ld_nmask) {
  return 16 * kTableEntries * kCopies + 4 * (kHashThreads * ld_lanes + 4) +
         (ld_nmask ? 4 * (kHashThreads * ld_nmask + 4) : 0);
}

struct Hashes {
  uint64_t a, b;
};

// h = h * X^4 + T[byte] (+ TN[nib]) for both hashes; tab and ntab are the
// thread's copies, entry e at e * kCopies.
template <bool kN>
__device__ __forceinline__ void hash_byte(Hashes& h, uint64_t a4, uint64_t b4,
                                          const ulonglong2* tab, const ulonglong2* ntab,
                                          uint32_t byte, uint32_t nib) {
  const ulonglong2 t = tab[byte * kCopies];
  h.a = h.a * a4 + t.x;
  h.b = h.b * b4 + t.y;
  if (kN) {
    const ulonglong2 u = ntab[nib * kCopies];
    h.a += u.x;
    h.b += u.y;
  }
}

template <bool kN>
__global__ void __launch_bounds__(kHashThreads)
sweep_full_hashes_kernel(int64_t n, const uint32_t* __restrict__ lanes, int ld_lanes,
                         const uint32_t* __restrict__ nmask, int ld_nmask, int L,
                         uint64_t base_a, uint64_t base_b, const ulonglong2* __restrict__ tables,
                         uint64_t* __restrict__ h0, uint64_t* __restrict__ h0b,
                         long long* __restrict__ key) {
  extern __shared__ __align__(16) unsigned char smem[];
  ulonglong2* s_tab = reinterpret_cast<ulonglong2*>(smem);
  uint32_t* s_lanes = reinterpret_cast<uint32_t*>(s_tab + kTableEntries * kCopies);
  uint32_t* s_nmask = s_lanes + kHashThreads * ld_lanes + 4;
  for (int i = threadIdx.x; i < kTableEntries * kCopies; i += kHashThreads)
    s_tab[i] = tables[i / kCopies];
  const ulonglong2* tab = s_tab + (threadIdx.x & (kCopies - 1));
  const ulonglong2* ntab = tab + 256 * kCopies;
  const uint64_t a2 = base_a * base_a, b2 = base_b * base_b;
  const uint64_t a4 = a2 * a2, b4 = b2 * b2;
  const bool vec = (ld_lanes & 3) == 0;   // a row is whole 16-byte chunks
  const int64_t tiles = (n + kHashThreads - 1) / kHashThreads;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t first = tile * kHashThreads;
    const int rows = (int)min((int64_t)kHashThreads, n - first);
    seg_scan::copy_async(s_lanes, lanes + first * ld_lanes, 4 * rows * ld_lanes);
    if (kN) seg_scan::copy_async(s_nmask, nmask + first * ld_nmask, 4 * rows * ld_nmask);
    seg_scan::commit_copies();
    seg_scan::staged_wait();
    if (threadIdx.x < rows) {
      const uint32_t* row = s_lanes + threadIdx.x * ld_lanes;
      const uint32_t* nrow = s_nmask + threadIdx.x * ld_nmask;
      Hashes h = {0, 0};
      // four lane words (64 symbols) a step; word i's N bits are the high
      // (even i) or low (odd i) half of N-mask word i / 2
      for (int c = 0; 64 * c < L; ++c) {
        uint32_t w[4];
        if (vec) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + 4 * c);
          w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = row[4 * c + i];
        }
        const uint32_t nw[2] = {kN ? nrow[2 * c] : 0u, kN ? nrow[2 * c + 1] : 0u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int syms = min(16, L - (64 * c + 16 * i));   // of this word
          if (syms <= 0) break;
          const uint32_t nb = (nw[i >> 1] >> ((i & 1) ? 0 : 16)) & 0xFFFFu;
          if (syms == 16) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              hash_byte<kN>(h, a4, b4, tab, ntab, (w[i] >> (24 - 8 * j)) & 0xFFu,
                            (nb >> (12 - 4 * j)) & 0xFu);
          } else {
            // the read's last word: its whole bytes, then symbol by symbol
            for (int j = 0; j < syms >> 2; ++j)
              hash_byte<kN>(h, a4, b4, tab, ntab, (w[i] >> (24 - 8 * j)) & 0xFFu,
                            (nb >> (12 - 4 * j)) & 0xFu);
            for (int s = syms & ~3; s < syms; ++s) {
              const uint64_t v = ((w[i] >> (30 - 2 * s)) & 3u) + (((nb >> (15 - s)) & 1u) << 2);
              h.a = h.a * base_a + v;
              h.b = h.b * base_b + v;
            }
          }
        }
      }
      const int64_t r = first + threadIdx.x;
      h0[r] = h.a;
      h0b[r] = h.b;
      if (key != nullptr) key[r] = (long long)((h.a == kInv64 ? kInv64 - 1 : h.a) ^ kFlip);
    }
    __syncthreads();   // the tile's rows are read before the next tile's copies land
  }
}

template <bool kN>
cudaError_t launch_hashes(int device, cudaStream_t s, int64_t n, const void* lanes, int ld_lanes,
                          const void* nmask, int ld_nmask, int L, uint64_t base_a,
                          uint64_t base_b, const void* tables, void* h0, void* h0b, void* key) {
  const auto kernel = sweep_full_hashes_kernel<kN>;
  const int smem = hash_smem(ld_lanes, kN ? ld_nmask : 0);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kHashThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidValue;
  const int64_t tiles = (n + kHashThreads - 1) / kHashThreads;
  const unsigned grid = (unsigned)(tiles < (int64_t)per_sm * sms ? tiles : (int64_t)per_sm * sms);
  kernel<<<grid, kHashThreads, smem, s>>>(n, (const uint32_t*)lanes, ld_lanes,
                                           (const uint32_t*)nmask, ld_nmask, L, base_a, base_b,
                                           (const ulonglong2*)tables, (uint64_t*)h0,
                                           (uint64_t*)h0b, (long long*)key);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kLinkThreads)
sweep_init_links_kernel(int64_t n, const long long* __restrict__ ks,
                        const long long* __restrict__ sidx, const long long* __restrict__ h0b,
                        int L, int32_t* __restrict__ succ, int32_t* __restrict__ ovl,
                        bool* __restrict__ a_s, bool* __restrict__ a_p) {
  // slot q holds sorted position base + q - 1
  __shared__ long long s_k[kLinkThreads + 2], s_i[kLinkThreads + 2], s_h[kLinkThreads + 2];
  const int64_t base = (int64_t)blockIdx.x * kLinkThreads;
  for (int q = threadIdx.x; q < kLinkThreads + 2; q += kLinkThreads) {
    const int64_t j = base + q - 1;
    if (j >= 0 && j < n) {
      const long long r = sidx[j];
      s_k[q] = ks[j];
      s_i[q] = r;
      s_h[q] = h0b[r];
    }
  }
  __syncthreads();
  const int64_t j = base + threadIdx.x;
  if (j >= n) return;
  const int q = threadIdx.x + 1;
  const bool fwd = j + 1 < n && s_k[q + 1] == s_k[q] && s_h[q + 1] == s_h[q];
  const bool back = j > 0 && s_k[q - 1] == s_k[q] && s_h[q - 1] == s_h[q];
  const long long r = s_i[q];
  succ[r] = fwd ? (int32_t)s_i[q + 1] : -1;
  ovl[r] = fwd ? L : 0;
  a_s[r] = !fwd;
  a_p[r] = !back;
}

}  // namespace

// h0, h0b [n] u64 (int64 carriers); key [n] int64 or null (hash-only form);
// tables: kTableEntries (A's, B's) u64 pairs, kernels/sweep_init.py
// `table_tensor`.
extern "C" int pgrc_sweep_full_hashes(int device, void* stream, int64_t n, const void* lanes,
                                      int ld_lanes, const void* nmask, int ld_nmask, int L,
                                      uint64_t base_a, uint64_t base_b, const void* tables,
                                      void* h0, void* h0b, void* key) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const auto go = nmask != nullptr ? launch_hashes<true> : launch_hashes<false>;
  return (int)go(device, (cudaStream_t)stream, n, lanes, ld_lanes, nmask, ld_nmask, L, base_a,
                 base_b, tables, h0, h0b, key);
}

// ks [n] sorted keys, sidx [n] their rows, h0b [n] by row -> succ, ovl [n]
// int32, a_s, a_p [n] bool, by row.
extern "C" int pgrc_sweep_init_links(int device, void* stream, int64_t n, const void* ks,
                                     const void* sidx, const void* h0b, int L, void* succ,
                                     void* ovl, void* a_s, void* a_p) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  sweep_init_links_kernel<<<(unsigned)((n + kLinkThreads - 1) / kLinkThreads), kLinkThreads, 0,
                            (cudaStream_t)stream>>>(
      n, (const long long*)ks, (const long long*)sidx, (const long long*)h0b, L,
      (int32_t*)succ, (int32_t*)ovl, (bool*)a_s, (bool*)a_p);
  return (int)cudaGetLastError();
}
