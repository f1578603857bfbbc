// Kernel I: strand_rows — the matcher's strand rows: a take of packed read
// rows followed by the reverse complements of the same rows, in one pass.
//
// Replaces: pgrc_tpu/align/matcher.py "rcprep" (`_prep`, :654-678), which is
// pgrc_tpu/core/packed.py `revcomp_lanes` (:205-253) with the concatenate
// after it (K8), and "p2gather" (:700-710), the jitted jnp.take of pass 2's
// rows (K9). Given the forward lanes of n reads (the pack_lanes layout:
// symbol j at bits 2 * (15 - j % 16) of lane j / 16, N packed as A, one zero
// pad lane), their N mask or none, and R row ids (none: every row in order),
// it writes out[r] = lanes[rows[r]] and out[R + r] = the reverse complement
// of that row in the same layout: NOT of each 2-bit group, the reversed read
// in the first L symbol slots, zeros past it, every group on an N position
// (from the reversed mask) cleared to A, a zero pad lane.
//
// What bounds it on the card: bytes. Each taken row's W+1 lanes and Wn mask
// words are read once and 2 (W+1) words are written; the arithmetic is a
// few integer operations a lane.
//
// What the design does about it: a thread a lane pair. Thread i writes
// lane c = i % (W + 1) of taken row r = i / (W + 1) and lane c of its
// reverse complement, so each warp's loads of the forward lanes and both
// of its stores are consecutive words (a prep's rows are taken in order).
// Reverse lane c needs input lanes W - 1 - c and W - 2 - c of the same row,
// which sit in the sectors the row's other threads load (L1 hits). In
// registers: __brev of a lane and a swap of its bit pairs reverse its 2-bit
// groups; a funnel shift realigns the reversed read across lane boundaries
// (the reference's lane shift), which also leaves the tail slots zero; the
// two mask words under the lane are reversed and realigned the same way,
// and each N bit spreads to a 2-bit clear mask. No shared memory, no
// scratch, no second pass. Measured against it on an H100 (PERF.md): a
// thread a row, its lanes in registers and read and written as 16-byte
// vectors, took 0.0403 ms against 0.0321 at SE 2M's strand prep and 0.0250
// against 0.0233 on a take of half of its reads, but 0.0416 against 0.0455
// with N in 3% of the symbols (the matcher sees N reads only with -n).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// the 2-bit groups of a word in reverse order, each group's bits kept
__device__ __forceinline__ uint32_t reverse_groups(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// 16 bits -> 32: each bit becomes a 2-bit group of copies
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x | (x << 1);
}

// W lanes a read (L in (16 (W - 1), 16 W]), so WN = ceil(W / 2) mask words
// cover its symbols. rows: null = every row in order (R = n).
template <int W>
__global__ void __launch_bounds__(kThreads)
strand_rows_kernel(const uint32_t* __restrict__ lanes, const uint32_t* __restrict__ nmask,
                   int ld_nmask, const long long* __restrict__ rows, int64_t R, int L,
                   uint32_t* __restrict__ out) {
  constexpr int W1 = W + 1;
  constexpr int WN = (W + 1) / 2;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= R * W1) return;
  const int64_t r = i / W1;
  const int c = (int)(i - r * W1);
  const int64_t src = rows != nullptr ? (int64_t)__ldg(rows + r) : r;
  const uint32_t* row = lanes + src * W1;
  out[i] = __ldg(row + c);
  uint32_t rc = 0;   // the pad lane
  if (c < W) {
    // complemented lanes in reverse order, groups reversed in each: the
    // reversed read sits in the last L of the 16 W slots; shift it to the
    // first L, the vacated tail slots filling with zeros
    const uint32_t hi = reverse_groups(~__ldg(row + W - 1 - c));
    const uint32_t lo = c + 1 < W ? reverse_groups(~__ldg(row + W - 2 - c)) : 0u;
    rc = __funnelshift_l(lo, hi, 2 * (16 * W - L));
    if (nmask != nullptr) {
      // N bit of position j: bit 31 - j % 32 of word j / 32; reversed and
      // shifted the same way, bit i of mask word j marks reverse position
      // 32 j + i, and a mask word covers two lanes: bits 31..16 the even
      // one, 15..0 the odd
      const int j = c >> 1;
      const uint32_t* m = nmask + src * ld_nmask;
      const uint32_t nhi = __brev(__ldg(m + WN - 1 - j));
      const uint32_t nlo = j + 1 < WN ? __brev(__ldg(m + WN - 2 - j)) : 0u;
      const uint32_t nb = __funnelshift_l(nlo, nhi, 32 * WN - L);
      rc &= ~spread16((c & 1) ? (nb & 0xFFFFu) : (nb >> 16));
    }
  }
  out[R * W1 + i] = rc;
}

template <int W>
cudaError_t launch_strand_rows(cudaStream_t s, const void* lanes, const void* nmask,
                               int ld_nmask, const void* rows, int64_t R, int L, void* out) {
  const unsigned grid = (unsigned)((R * (W + 1) + kThreads - 1) / kThreads);
  strand_rows_kernel<W><<<grid, kThreads, 0, s>>>(
      (const uint32_t*)lanes, (const uint32_t*)nmask, ld_nmask, (const long long*)rows, R, L,
      (uint32_t*)out);
  return cudaGetLastError();
}

}  // namespace

#define PGRC_STRAND_CASE(WW) \
  case WW:                   \
    return (int)launch_strand_rows<WW>(s, lanes, nmask, ld_nmask, rows, R, L, out);

// lanes [n, W+1] int32 and nmask [n, ld_nmask] int32 (null: no N) of reads
// of length L (1..256, W = ceil(L / 16)); rows [R] int64 ids into them, or
// null for R = n rows in order; out [2R, W+1] int32.
extern "C" int pgrc_strand_rows(int device, void* stream, const void* lanes, const void* nmask,
                                int ld_nmask, const void* rows, int64_t R, int L, void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((L + 15) / 16) {
    PGRC_STRAND_CASE(1) PGRC_STRAND_CASE(2) PGRC_STRAND_CASE(3)
    PGRC_STRAND_CASE(4) PGRC_STRAND_CASE(5) PGRC_STRAND_CASE(6)
    PGRC_STRAND_CASE(7) PGRC_STRAND_CASE(8) PGRC_STRAND_CASE(9)
    PGRC_STRAND_CASE(10) PGRC_STRAND_CASE(11) PGRC_STRAND_CASE(12)
    PGRC_STRAND_CASE(13) PGRC_STRAND_CASE(14) PGRC_STRAND_CASE(15)
    PGRC_STRAND_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
}
