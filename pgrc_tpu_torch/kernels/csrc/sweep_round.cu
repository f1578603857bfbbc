// Kernel D: sweep_roll_entries — one overlap round's hash roll and its sort
// entries.
//
// Replaces pgrc_tpu/overlap/greedy_scs.py `_build_seg_fn.round_fn`'s hash
// roll (:235-240) and entry build (:251-258). For round i every row drops
// column i-1 from its suffix hashes and column L-i from its prefix hashes:
//   h  -= v[i-1] * A^(L-i)     h2 -= v[i-1] * B^(L-i)
//   p   = (p - v[L-i]) * A^-1  p2  = (p2 - v[L-i]) * B^-1      (all mod 2^64)
// with A = HASH_BASE64, B = HASH_BASE64B (:54-57) and a symbol's value its
// 2-bit code + 4 * its N bit. The rolls run every round, whether or not the
// round matches anything (:232-234): the recurrences are cumulative.
// Unlike the reference's pure update, h, p, h2, p2 are updated IN PLACE.
//
// Then it writes the round's 2n sort keys k1: entry r is row r's prefix,
// entry n + r its suffix; the key is the prefix (suffix) hash, or INV64
// when that side is inactive, stored with bit 63 flipped so that signed
// int64 order is the unsigned order (INV64 sorts last). Kernel F finds an
// entry's side, gid and confirm hash from its index, so no other entry
// field is written.
//
// What bounds it on the card: memory traffic, ~94 bytes per row per round
// (two lane words and an N-mask word in, two flags in, four hashes in and
// out, two 8-byte keys out) against a dozen 64-bit multiply-adds.
// What the design does about it: one thread per row, the roll and the entry
// build fused in one pass (the reference materialises them separately), and
// the four 64-bit powers passed as scalars, not gathered from a table.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t col_val(const uint32_t* __restrict__ lanes,
                                            int ld_lanes,
                                            const uint32_t* __restrict__ nmask,
                                            int ld_nmask, int64_t r, int t) {
  uint64_t c = (lanes[r * ld_lanes + (t >> 4)] >> (2 * (15 - (t & 15)))) & 3u;
  if (nmask != nullptr)
    c += (uint64_t)((nmask[r * ld_nmask + (t >> 5)] >> (31 - (t & 31))) & 1u) << 2;
  return c;
}

__global__ void sweep_roll_entries_kernel(
    int64_t n, const uint32_t* __restrict__ lanes, int ld_lanes,
    const uint32_t* __restrict__ nmask, int ld_nmask, const bool* __restrict__ active_s,
    const bool* __restrict__ active_p, int i, int L, uint64_t pow_a,
    uint64_t pow_b, uint64_t inv_a, uint64_t inv_b, uint64_t* __restrict__ h,
    uint64_t* __restrict__ p, uint64_t* __restrict__ h2,
    uint64_t* __restrict__ p2, int64_t* __restrict__ k1) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint64_t vi = col_val(lanes, ld_lanes, nmask, ld_nmask, r, i - 1);
  const uint64_t vm = col_val(lanes, ld_lanes, nmask, ld_nmask, r, L - i);
  const uint64_t hh = h[r] - vi * pow_a;
  const uint64_t hh2 = h2[r] - vi * pow_b;
  const uint64_t pp = (p[r] - vm) * inv_a;
  const uint64_t pp2 = (p2[r] - vm) * inv_b;
  h[r] = hh;
  h2[r] = hh2;
  p[r] = pp;
  p2[r] = pp2;

  constexpr uint64_t kFlip = 1ull << 63;
  constexpr uint64_t kInv64 = ~0ull;
  k1[r] = (int64_t)((active_p[r] ? pp : kInv64) ^ kFlip);
  k1[n + r] = (int64_t)((active_s[r] ? hh : kInv64) ^ kFlip);
}

}  // namespace

extern "C" int pgrc_sweep_roll_entries(
    int device, void* stream, int64_t n, const void* lanes, int ld_lanes,
    const void* nmask, int ld_nmask, const void* active_s, const void* active_p,
    int i, int L, uint64_t pow_a, uint64_t pow_b, uint64_t inv_a, uint64_t inv_b,
    void* h, void* p, void* h2, void* p2, void* k1) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  sweep_roll_entries_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                              (cudaStream_t)stream>>>(
      n, (const uint32_t*)lanes, ld_lanes, (const uint32_t*)nmask, ld_nmask,
      (const bool*)active_s, (const bool*)active_p, i, L, pow_a, pow_b, inv_a, inv_b,
      (uint64_t*)h, (uint64_t*)p, (uint64_t*)h2, (uint64_t*)p2, (int64_t*)k1);
  return (int)cudaGetLastError();
}
