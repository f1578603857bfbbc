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
// What bounds G on the card: its own chain of operations. A row is ~40
// bytes in and 16-24 out, against 2L dependent 64-bit multiply-adds (three
// 32-bit IMADs each) and L symbol extractions. The design: a thread per
// row, Horner over the row's lanes (16 symbols a lane word, unrolled, so
// every shift is a constant); the card holds enough rows in flight to hide
// the dependent chain. Splitting a row over 2 or 4 threads, joined with
// powers A^len, was slower (PERF.md). The same hashes come exactly from a
// chunked Horner, h = h * A^4 + T[byte] with a 256-entry table of four
// symbols' sums (and a 16-entry one for the N bits), at about a third of
// the operations: chip_smoke.py bounds G by that form, under which its
// bytes set the bound at L = 100.
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

#include "packed_cols.cuh"

namespace {

constexpr int kHashThreads = 128;
constexpr int kLinkThreads = 256;
constexpr uint64_t kFlip = 1ull << 63;
constexpr uint64_t kInv64 = ~0ull;

__global__ void __launch_bounds__(kHashThreads)
sweep_full_hashes_kernel(int64_t n, const uint32_t* __restrict__ lanes, int ld_lanes,
                         const uint32_t* __restrict__ nmask, int ld_nmask, int L,
                         uint64_t base_a, uint64_t base_b, uint64_t* __restrict__ h0,
                         uint64_t* __restrict__ h0b, long long* __restrict__ key) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  uint64_t ha = 0, hb = 0;
  for (int w = 0; (w << 4) < L; ++w) {
    const uint32_t word = lanes[r * ld_lanes + w];
    const uint32_t nb = packed_cols::lane_nbits(nmask, ld_nmask, r, w);
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      if ((w << 4) + s < L) {
        const uint64_t v = ((word >> (30 - 2 * s)) & 3u) + (((nb >> (15 - s)) & 1u) << 2);
        ha = ha * base_a + v;
        hb = hb * base_b + v;
      }
    }
  }
  h0[r] = ha;
  h0b[r] = hb;
  if (key != nullptr) key[r] = (long long)((ha == kInv64 ? kInv64 - 1 : ha) ^ kFlip);
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

// h0, h0b [n] u64 (int64 carriers); key [n] int64 or null (hash-only form).
extern "C" int pgrc_sweep_full_hashes(int device, void* stream, int64_t n, const void* lanes,
                                      int ld_lanes, const void* nmask, int ld_nmask, int L,
                                      uint64_t base_a, uint64_t base_b, void* h0, void* h0b,
                                      void* key) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  sweep_full_hashes_kernel<<<(unsigned)((n + kHashThreads - 1) / kHashThreads), kHashThreads, 0,
                             (cudaStream_t)stream>>>(
      n, (const uint32_t*)lanes, ld_lanes, (const uint32_t*)nmask, ld_nmask, L, base_a, base_b,
      (uint64_t*)h0, (uint64_t*)h0b, (long long*)key);
  return (int)cudaGetLastError();
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
