// Kernel A: verify_best — best-of-n packed pg-window verify of read lanes.
//
// Replaces: exp_pallas_verify.py `kernel` (:64-88, the repo's one Pallas
// kernel, which never compiled on the TPU) and the computation it tried to
// speed up, pgrc_tpu/align/matcher.py `_make_probe._verify` (:191-206) with
// the best-of-n_verify loop around it (:268-308).
//
// What bounds it on the card: the candidate window loads. Each accepted
// start reads W+1 consecutive u32 pg lanes at a data-dependent address;
// the arithmetic per lane is a handful of integer ops and one popcount, so
// the kernel waits on scattered 32-byte loads, not on the ALUs.
//
// What the design does about it: one thread per read, its W <= 16 read lanes
// held in registers (the lane loop is a template parameter, so it unrolls),
// and the whole packed pg left in device memory, where the 50 MB L2 holds
// the pg of a multi-million-read input (2 bits per symbol: a 5M-symbol pg
// is 1.25 MB). That is what the TPU kernel tried to get from VMEM. The
// slots are walked in offset order and the first n_verify in-range ones are
// verified — the same set the reference's stable argsort picks — keeping
// the (mismatches, position) minimum, so no [R, S, W+1] window tensor is
// ever materialised.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int64_t clamp_lane(int64_t i, int64_t n) {
  return i < n ? i : n - 1;
}

// Pos: int32_t, or int64_t for the wide probe of pgs past 2^31 symbols
// (matcher.py:180-181, positions up to 2^35). Its largest value starts the
// best position, as the reference's big_pos does.
template <typename Pos> struct PosMax;
template <> struct PosMax<int32_t> { static constexpr int32_t value = INT32_MAX; };
template <> struct PosMax<int64_t> { static constexpr int64_t value = INT64_MAX; };

template <int W, typename Pos>
__global__ void verify_best_kernel(
    const uint32_t* __restrict__ reads, int64_t n_reads, int ld_reads,
    const Pos* __restrict__ start_all, const uint8_t* __restrict__ in_range,
    int n_slots, const uint32_t* __restrict__ pg, int64_t pg_lanes_len,
    Pos pg_top, uint32_t tail_mask, int max_mis, int n_verify,
    uint8_t* __restrict__ out_mis, Pos* __restrict__ out_pos) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_reads) return;
  uint32_t rl[W];
#pragma unroll
  for (int c = 0; c < W; ++c) rl[c] = reads[r * ld_reads + c];
  rl[W - 1] &= tail_mask;

  int best_mis = 255;
  Pos best_pos = PosMax<Pos>::value;
  int taken = 0;
  for (int j = 0; j < n_slots && taken < n_verify; ++j) {
    if (!in_range[r * n_slots + j]) continue;
    ++taken;
    Pos st = start_all[r * n_slots + j];
    st = st < 0 ? 0 : (st > pg_top ? pg_top : st);
    const int64_t q = (int64_t)st >> 4;
    const uint32_t s2 = (uint32_t)(st & 15) << 1;
    int mis = 0;
    uint32_t cur = pg[clamp_lane(q, pg_lanes_len)];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const uint32_t nxt = pg[clamp_lane(q + c + 1, pg_lanes_len)];
      // a 32-bit shift by 32 is undefined: at s2 == 0 the next lane
      // contributes nothing, as the reference's where() says (matcher.py:201)
      uint32_t aligned = s2 ? ((cur << s2) | (nxt >> (32u - s2))) : cur;
      if (c == W - 1) aligned &= tail_mask;
      const uint32_t x = aligned ^ rl[c];
      mis += __popc((x | (x >> 1)) & 0x55555555u);
      cur = nxt;
    }
    if (mis < best_mis || (mis == best_mis && st < best_pos)) {
      best_mis = mis;
      best_pos = st;
    }
  }
  const bool ok = best_mis <= max_mis;
  out_mis[r] = ok ? (uint8_t)best_mis : (uint8_t)255;
  out_pos[r] = ok ? best_pos : (Pos)-1;
}

template <int W, typename Pos>
void launch_verify(dim3 grid, dim3 block, cudaStream_t s, const void* reads,
                   int64_t n_reads, int ld_reads, const void* start_all,
                   const void* in_range, int n_slots, const void* pg,
                   int64_t pg_lanes_len, int64_t pg_top, uint32_t tail_mask,
                   int max_mis, int n_verify, void* out_mis, void* out_pos) {
  verify_best_kernel<W, Pos><<<grid, block, 0, s>>>(
      (const uint32_t*)reads, n_reads, ld_reads, (const Pos*)start_all,
      (const uint8_t*)in_range, n_slots, (const uint32_t*)pg, pg_lanes_len,
      (Pos)pg_top, tail_mask, max_mis, n_verify, (uint8_t*)out_mis,
      (Pos*)out_pos);
}

}  // namespace

#define PGRC_VERIFY_CASE(WW)                                                 \
  case WW:                                                                   \
    (wide ? launch_verify<WW, int64_t> : launch_verify<WW, int32_t>)(        \
        grid, block, s, reads, n_reads, ld_reads, start_all, in_range,       \
        n_slots, pg, pg_lanes_len, pg_top, tail_mask, max_mis, n_verify,     \
        out_mis, out_pos);                                                   \
    break;

// wide != 0: start_all and out_pos are int64_t, else int32_t
extern "C" int pgrc_verify_best(int device, void* stream, const void* reads,
                                int64_t n_reads, int W, int ld_reads,
                                const void* start_all, const void* in_range,
                                int n_slots, const void* pg,
                                int64_t pg_lanes_len, int64_t pg_top,
                                uint32_t tail_mask, int max_mis, int n_verify,
                                int wide, void* out_mis, void* out_pos) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_reads == 0) return 0;
  const dim3 block(256);
  const dim3 grid((unsigned)((n_reads + 255) / 256));
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    PGRC_VERIFY_CASE(1) PGRC_VERIFY_CASE(2) PGRC_VERIFY_CASE(3)
    PGRC_VERIFY_CASE(4) PGRC_VERIFY_CASE(5) PGRC_VERIFY_CASE(6)
    PGRC_VERIFY_CASE(7) PGRC_VERIFY_CASE(8) PGRC_VERIFY_CASE(9)
    PGRC_VERIFY_CASE(10) PGRC_VERIFY_CASE(11) PGRC_VERIFY_CASE(12)
    PGRC_VERIFY_CASE(13) PGRC_VERIFY_CASE(14) PGRC_VERIFY_CASE(15)
    PGRC_VERIFY_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
