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
// - Coalesced loads: the table's lanes are column-major ([W+1, n], lane c
//   of every row contiguous, core/packed.py `empty_cols`), so a tile's 256
//   rows of one lane word are one 1 KB run in device memory; the read's
//   ceil(L/16) lane columns (and ceil(L/32) N-mask columns) arrive in shared
//   memory, laid out [column][row], by 16-byte cp.async copies, and thread
//   t then hashes row t from there, reading its words at a stride of 256
//   words: consecutive threads on consecutive banks, no conflict. The pad
//   lane, which no hash reads, is not copied.
// - Two staging buffers: the block's next tile is in flight while this one
//   is hashed. A tile's columns are 1 KB runs at the table's column stride
//   apart; staged one tile at a time they left G 5% slower than on
//   row-major tiles, and double-buffered it is within 2% of them at SE 2M's
//   init and with N at 2^18 rows (PERF.md section 6). With row-major tiles a
//   second buffer had made G 5% faster at L 100 and 9% slower with N.
//
// G2 replaces the init's linking (:442-465) after the stable sort: sorted
// position j links row sidx[j] to row sidx[j+1] when both their keys and
// their second hashes agree, at overlap L. The last sorted position never
// links forward and the first never back (the reference's wrap-around
// neighbour is forced false, :448-456). What bounds G2: memory. Only a
// position whose key equals a neighbour's (two equal reads: the key is the
// full 64-bit read hash) can link, so the bytes it must move are the sorted
// keys (8 a position) and, at tied positions only, the row index, the
// gathered h0b and the changed results scattered to the row. The design:
// G2's wrapper first has every row's unlinked state (succ -1, ovl 0,
// active_s and active_p true) written in row order by a fill kernel
// (sweep_link_defaults, 10 bytes a row, coalesced; writing it from G's
// init form instead made G + G2 7% slower on an H100, PERF.md). Then G2
// proper, a thread per sorted position, reads its key coalesced and its
// neighbours' by warp shuffles (lanes 0 and 31 read the halo), and a warp
// whose ballot of tied positions is empty leaves there. At a tied position
// the thread reads sidx[j] and gathers h0b of its row, takes the
// neighbours' rows and h0b by shuffles, and writes only what changes: succ,
// ovl and active_s of a row that links forward, active_p of one linked
// from behind. Each row sits at one sorted position, so no two threads
// write one row, and nothing needs atomics.
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

// Shared memory of G's block: the table copies, then two staged tiles, each
// its lane words and N-mask words, [column][row], kHashThreads rows a
// column.
__host__ __device__ inline int hash_smem(int lane_cols, int nmask_cols) {
  return 16 * kTableEntries * kCopies + 2 * 4 * kHashThreads * (lane_cols + nmask_cols);
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
sweep_full_hashes_kernel(int64_t n, const uint32_t* __restrict__ lanes, int64_t ld_lanes,
                         const uint32_t* __restrict__ nmask, int64_t ld_nmask, int L,
                         uint64_t base_a, uint64_t base_b, const ulonglong2* __restrict__ tables,
                         uint64_t* __restrict__ h0, uint64_t* __restrict__ h0b,
                         long long* __restrict__ key) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wl = (L + 15) >> 4, wn = kN ? (L + 31) >> 5 : 0;   // the columns a hash reads
  ulonglong2* s_tab = reinterpret_cast<ulonglong2*>(smem);
  uint32_t* s_stage = reinterpret_cast<uint32_t*>(s_tab + kTableEntries * kCopies);
  const int stage = kHashThreads * (wl + wn);   // words of one staged tile
  for (int i = threadIdx.x; i < kTableEntries * kCopies; i += kHashThreads)
    s_tab[i] = tables[i / kCopies];
  const ulonglong2* tab = s_tab + (threadIdx.x & (kCopies - 1));
  const ulonglong2* ntab = tab + 256 * kCopies;
  const uint64_t a2 = base_a * base_a, b2 = base_b * base_b;
  const uint64_t a4 = a2 * a2, b4 = b2 * b2;
  const int64_t tiles = (n + kHashThreads - 1) / kHashThreads;
  // start staging tile t's columns into buf (one copy group is committed
  // a tile, so wait_copies<1> waits for all but the newest)
  const auto stage_tile = [&](int64_t t, uint32_t* buf) {
    const int64_t f = t * kHashThreads;
    const int r = (int)min((int64_t)kHashThreads, n - f);
    seg_scan::copy_cols_async<kHashThreads>(buf, lanes + f, ld_lanes, wl, r);
    if (kN)
      seg_scan::copy_cols_async<kHashThreads>(buf + kHashThreads * wl, nmask + f, ld_nmask, wn, r);
  };
  if (blockIdx.x < tiles) stage_tile(blockIdx.x, s_stage);
  seg_scan::commit_copies();
  int b = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, b ^= 1) {
    const int64_t first = tile * kHashThreads;
    const int rows = (int)min((int64_t)kHashThreads, n - first);
    if (tile + gridDim.x < tiles) stage_tile(tile + gridDim.x, s_stage + (b ^ 1) * stage);
    seg_scan::commit_copies();
    seg_scan::wait_copies<1>();
    __syncthreads();
    const uint32_t* s_lanes = s_stage + b * stage;
    const uint32_t* s_nmask = s_lanes + kHashThreads * wl;
    if (threadIdx.x < rows) {
      // the row's word c at col[c * kHashThreads]
      const uint32_t* col = s_lanes + threadIdx.x;
      const uint32_t* ncol = s_nmask + threadIdx.x;
      Hashes h = {0, 0};
      // four lane words (64 symbols) a step; word i's N bits are the high
      // (even i) or low (odd i) half of N-mask word i / 2
      for (int c = 0; 64 * c < L; ++c) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = 4 * c + i < wl ? col[(4 * c + i) * kHashThreads] : 0u;
        uint32_t nw[2] = {0u, 0u};
        if (kN) {
          nw[0] = ncol[2 * c * kHashThreads];
          if (2 * c + 1 < wn) nw[1] = ncol[(2 * c + 1) * kHashThreads];
        }
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
    __syncthreads();   // the tile's rows are read before its buffer is staged again
  }
}

template <bool kN>
cudaError_t launch_hashes(int device, cudaStream_t s, int64_t n, const void* lanes,
                          int64_t ld_lanes, const void* nmask, int64_t ld_nmask, int L,
                          uint64_t base_a, uint64_t base_b, const void* tables, void* h0,
                          void* h0b, void* key) {
  const auto kernel = sweep_full_hashes_kernel<kN>;
  const int smem = hash_smem((L + 15) >> 4, kN ? (L + 31) >> 5 : 0);
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
sweep_link_defaults_kernel(int64_t n, int32_t* __restrict__ succ, int32_t* __restrict__ ovl,
                           bool* __restrict__ a_s, bool* __restrict__ a_p) {
  const int64_t i = (int64_t)blockIdx.x * kLinkThreads + threadIdx.x;
  if (i >= n) return;
  succ[i] = -1;
  ovl[i] = 0;
  a_s[i] = true;
  a_p[i] = true;
}

__global__ void __launch_bounds__(kLinkThreads)
sweep_init_links_kernel(int64_t n, const long long* __restrict__ ks,
                        const long long* __restrict__ sidx, const long long* __restrict__ h0b,
                        int L, int32_t* __restrict__ succ, int32_t* __restrict__ ovl,
                        bool* __restrict__ a_s, bool* __restrict__ a_p) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int64_t j = (int64_t)blockIdx.x * kLinkThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // every lane stays to the end of the shuffles, those past n too
  const bool in = j < n;
  const long long k = in ? ks[j] : 0;
  long long k_next = __shfl_down_sync(kAll, k, 1);
  long long k_prev = __shfl_up_sync(kAll, k, 1);
  if (lane == 31 && j + 1 < n) k_next = ks[j + 1];
  if (lane == 0 && in && j > 0) k_prev = ks[j - 1];
  const bool tie_next = j + 1 < n && k_next == k;
  const bool tie_prev = in && j > 0 && k_prev == k;
  const bool tied = tie_next || tie_prev;
  if (__ballot_sync(kAll, tied) == 0) return;   // the whole warp: no tie
  long long r = 0, hb = 0;
  if (tied) {
    r = sidx[j];
    hb = h0b[r];
  }
  // a tied neighbour is tied too, so its lane holds its row and h0b
  long long r_next = __shfl_down_sync(kAll, r, 1);
  long long hb_next = __shfl_down_sync(kAll, hb, 1);
  long long hb_prev = __shfl_up_sync(kAll, hb, 1);
  if (lane == 31 && tie_next) {
    r_next = sidx[j + 1];
    hb_next = h0b[r_next];
  }
  if (lane == 0 && tie_prev) hb_prev = h0b[sidx[j - 1]];
  if (tie_next && hb_next == hb) {
    succ[r] = (int32_t)r_next;
    ovl[r] = L;
    a_s[r] = false;
  }
  if (tie_prev && hb_prev == hb) a_p[r] = false;
}

}  // namespace

// lanes [W+1, n] and nmask [Wn+1, n] (or null) column-major, column c of
// row r at c * ld + r, with at least ceil(L/16) and ceil(L/32) columns;
// h0, h0b [n] u64 (int64 carriers); key [n] int64 or null (hash-only form);
// tables: kTableEntries (A's, B's) u64 pairs, kernels/sweep_init.py
// `table_tensor`.
extern "C" int pgrc_sweep_full_hashes(int device, void* stream, int64_t n, const void* lanes,
                                      int64_t ld_lanes, const void* nmask, int64_t ld_nmask,
                                      int L,
                                      uint64_t base_a, uint64_t base_b, const void* tables,
                                      void* h0, void* h0b, void* key) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const auto go = nmask != nullptr ? launch_hashes<true> : launch_hashes<false>;
  return (int)go(device, (cudaStream_t)stream, n, lanes, ld_lanes, nmask, ld_nmask, L, base_a,
                 base_b, tables, h0, h0b, key);
}

// succ, ovl [n] int32, a_s, a_p [n] bool <- the init's unlinked state.
extern "C" int pgrc_sweep_link_defaults(int device, void* stream, int64_t n, void* succ,
                                        void* ovl, void* a_s, void* a_p) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  sweep_link_defaults_kernel<<<(unsigned)((n + kLinkThreads - 1) / kLinkThreads), kLinkThreads,
                               0, (cudaStream_t)stream>>>(n, (int32_t*)succ, (int32_t*)ovl,
                                                          (bool*)a_s, (bool*)a_p);
  return (int)cudaGetLastError();
}

// ks [n] sorted keys, sidx [n] their rows, h0b [n] by row; succ, ovl [n]
// int32, a_s, a_p [n] bool, by row, holding the unlinked state
// (pgrc_sweep_link_defaults), patched in place where rows link.
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
