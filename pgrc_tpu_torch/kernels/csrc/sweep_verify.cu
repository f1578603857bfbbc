// Kernel J: sweep_verify_links — the exact check of a sweep table's links.
//
// Replaces, on the device path, the host pass that follows the rounds:
// pgrc_tpu/overlap/greedy_scs.py `_verify_links` (:866-888; the port's copy
// in overlap/host.py). The rounds link row x to row y = succ[x] at overlap
// o = ovl[x] on two independent 64-bit hash matches; a link holds only if
// x's last o symbols equal y's first o symbols, and a link that fails is
// cut: succ[x] = -1, ovl[x] = 0. Each link is judged alone, so the result
// does not depend on order, and it is the host pass's, bit for bit.
//
// The symbols are read from the sweep table as it was uploaded
// (core/packed.py `empty_cols`, packed_cols.cuh): lane word c of row r at
// lanes[c * ld + r], symbol t at bits 2 * (15 - t % 16) of word t / 16, N
// packed as A, one zero pad word after the row's W words; the N mask holds
// bit 31 - t % 32 of word t / 32, with its own pad word. For codes 0-4
// (ACGTN) two symbols are equal exactly when their 2-bit codes and their N
// bits are, so the check compares both streams, and the 2-bit stream alone
// when the table has no N mask (no N in the set).
//
// What bounds J: bytes, and few of them. A thread takes a row: it reads
// succ (coalesced) and leaves at once when the row has no link. Otherwise
// its row's words from symbol L - o on are read from consecutive columns,
// each word shifted into place by a funnel shift of two neighbours (the pad
// word covers the last one), and its successor's first ceil(o / 16) words
// are gathered, 4 bytes a column; the XOR of the two, masked past o
// symbols, must be zero, and the same at 1 bit a symbol for the N mask. A
// warp's rows read each column of theirs from one 128-byte line. At L 100
// a link moves about 66 bytes (8 of succ and ovl, ~7 words of each row),
// so SE 2M's full sweep, 1.76M links, needs ~0.035 ms of memory time; the
// host pass it replaces took 0.9-1.5 s an encode (PERF.md section 5).
//
// The counts: the block's links and cuts, by __syncthreads_count, added to
// counts[0] and counts[1] by one atomic each a block; the entry point
// zeroes them on the stream first.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Whether row x's symbols from s on differ from row y's first o in one
// stream of a column-major table t (kBits bits a symbol, 32 / kBits
// symbols a word, the first in the top bits): its words from word s / per
// on, shifted left by the bits of the symbols before s in that word.
template <int kBits>
__device__ __forceinline__ bool differs(const uint32_t* __restrict__ t, int64_t ld, int64_t x,
                                        int64_t y, int s, int o) {
  constexpr int kPer = 32 / kBits;
  const int q = s / kPer, r = kBits * (s % kPer);
  const int words = (o + kPer - 1) / kPer;
  uint32_t hi = __ldg(t + q * ld + x), diff = 0;
  for (int k = 0; k < words; ++k) {
    // q + k + 1 <= ceil(L / per): the row's pad word at most
    const uint32_t lo = __ldg(t + (q + k + 1) * ld + x);
    const int left = o - k * kPer;   // symbols of the overlap from this word on
    const uint32_t keep = left >= kPer ? ~0u : ~0u << (32 - kBits * left);
    diff |= (__funnelshift_l(lo, hi, r) ^ __ldg(t + k * ld + y)) & keep;
    hi = lo;
  }
  return diff != 0;
}

template <bool kN>
__global__ void __launch_bounds__(kThreads)
sweep_verify_links_kernel(int64_t n, const uint32_t* __restrict__ lanes, int64_t ld_lanes,
                          const uint32_t* __restrict__ nmask, int64_t ld_nmask, int L,
                          int32_t* __restrict__ succ, int32_t* __restrict__ ovl,
                          int* __restrict__ counts) {
  const int64_t x = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int32_t y = x < n ? succ[x] : -1;
  bool cut = false;
  if (y >= 0) {
    const int o = ovl[x];
    cut = differs<2>(lanes, ld_lanes, x, y, L - o, o) ||
          (kN && differs<1>(nmask, ld_nmask, x, y, L - o, o));
    if (cut) {
      succ[x] = -1;
      ovl[x] = 0;
    }
  }
  // every thread of the block reaches the counts, those without a link too
  const int linked = __syncthreads_count(y >= 0);
  const int cuts = __syncthreads_count(cut);
  if (threadIdx.x == 0) {
    if (linked) atomicAdd(counts, linked);
    if (cuts) atomicAdd(counts + 1, cuts);
  }
}

}  // namespace

// lanes [W+1, n] and nmask [Wn+1, n] (or null) column-major, column c of
// row r at c * ld + r, W = ceil(L / 16) and Wn = ceil(L / 32) words a row
// and a pad word each; succ, ovl [n] int32, the links (succ -1 = none, ovl
// in [1, L] where linked), cut in place; counts [2] int32 <- (links
// checked, links cut).
extern "C" int pgrc_sweep_verify_links(int device, void* stream, int64_t n, const void* lanes,
                                       int64_t ld_lanes, const void* nmask, int64_t ld_nmask,
                                       int L, void* succ, void* ovl, void* counts) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const auto kernel =
      nmask != nullptr ? sweep_verify_links_kernel<true> : sweep_verify_links_kernel<false>;
  kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      n, (const uint32_t*)lanes, ld_lanes, (const uint32_t*)nmask, ld_nmask, L, (int32_t*)succ,
      (int32_t*)ovl, (int*)counts);
  return (int)cudaGetLastError();
}
