// Kernels B and C: u32 polynomial k-mer hashes over packed 2-bit lanes.
//
// B, index_kmer_hash, replaces pgrc_tpu/align/matcher.py
// `_build_index_build_fn.build_fn` (:469-517): one block of the sampled k-mer
// table of the pseudogenome, the entries of the lanes from lane_off on, one
// every k1 symbols (entry e at position lane_off*16 + e*k1), positions past
// pg_len - k marked -1 (inert to the probe join). Positions are int32, or
// int64 for the wide probe of pgs past 2^31 symbols (matcher.py:485, 512).
// C, probe_kmer_hash, replaces the anchor hashes of `_make_probe.probe_fn`
// (:213-223): for every read and every probe offset, the hash of the k
// symbols starting there.
// Both compute H = sum_t v[t] * B^(k-1-t) mod 2^32 by Horner with
// B = HASH_BASE (pgrc_tpu/overlap/greedy_scs.py:36); symbols are the 2-bit
// codes at bits 2*(15 - j%16) of lane j/16.
//
// What bounds them on the card: memory, the lanes read and the hashes and
// positions written once. The same hashes come out of a prefix hash,
// H(i, k) = P[i+k-1] - P[i-1] * B^k mod 2^32, at a few operations per
// k-mer, so the operations the function needs stay below its bytes' time.
// This design spends more: one thread per output entry runs the Horner
// chain of k dependent multiply-adds (k = 32 at the main path's sizes),
// each lane loaded once per 16 symbols (not once per symbol); the lane
// loads hit L1/L2 because neighbouring threads read neighbouring lanes.
// A prefix form would trade the chain for a scan over the lanes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kHashBase = 0x9E3779B1u;

__device__ __forceinline__ uint32_t kmer_hash(const uint32_t* __restrict__ lanes,
                                              int64_t n_lanes, int64_t sym0,
                                              int k) {
  uint32_t h = 0;
  int64_t s = sym0;
  int t = 0;
  while (t < k) {
    const int64_t c = s >> 4;
    const int o = (int)(s & 15);
    const uint32_t lane = c < n_lanes ? lanes[c] : 0u;  // past the end: zero
    const int take = (16 - o) < (k - t) ? (16 - o) : (k - t);
    for (int u = 0; u < take; ++u)
      h = h * kHashBase + ((lane >> (2 * (15 - o - u))) & 3u);
    t += take;
    s += take;
  }
  return h;
}

template <typename Pos>
__global__ void index_kmer_hash_kernel(const uint32_t* __restrict__ pg,
                                       int64_t n_lanes, int k, int k1,
                                       int64_t pos0, int64_t pg_len, int64_t m,
                                       uint32_t* __restrict__ ihash,
                                       Pos* __restrict__ ipos) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const int64_t pos = pos0 + e * k1;
  ihash[e] = kmer_hash(pg, n_lanes, pos, k);
  ipos[e] = pos <= pg_len - k ? (Pos)pos : (Pos)-1;
}

__global__ void probe_kmer_hash_kernel(const uint32_t* __restrict__ reads,
                                       int64_t n_reads, int ld_reads,
                                       const int32_t* __restrict__ offs,
                                       int n_offs, int k,
                                       uint32_t* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_reads * n_offs) return;
  const int64_t r = e / n_offs;
  const int j = (int)(e - r * n_offs);
  out[e] = kmer_hash(reads + r * ld_reads, ld_reads, offs[j], k);
}

}  // namespace

// wide != 0: ipos is int64_t, else int32_t (every valid position < 2^31)
extern "C" int pgrc_index_kmer_hash(int device, void* stream, const void* pg,
                                    int64_t n_lanes, int k, int k1,
                                    int64_t lane_off, int64_t pg_len, int64_t m,
                                    int wide, void* ihash, void* ipos) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  const unsigned grid = (unsigned)((m + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    index_kmer_hash_kernel<int64_t><<<grid, 256, 0, s>>>(
        (const uint32_t*)pg, n_lanes, k, k1, lane_off * 16, pg_len, m,
        (uint32_t*)ihash, (int64_t*)ipos);
  else
    index_kmer_hash_kernel<int32_t><<<grid, 256, 0, s>>>(
        (const uint32_t*)pg, n_lanes, k, k1, lane_off * 16, pg_len, m,
        (uint32_t*)ihash, (int32_t*)ipos);
  return (int)cudaGetLastError();
}

extern "C" int pgrc_probe_kmer_hash(int device, void* stream, const void* reads,
                                    int64_t n_reads, int ld_reads,
                                    const void* offs, int n_offs, int k,
                                    void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t m = n_reads * n_offs;
  if (m == 0) return 0;
  probe_kmer_hash_kernel<<<(unsigned)((m + 255) / 256), 256, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)reads, n_reads, ld_reads, (const int32_t*)offs, n_offs,
      k, (uint32_t*)out);
  return (int)cudaGetLastError();
}
