// Kernel A: verify_best — best-of-n packed pg-window verify of read lanes,
// from the join's anchors.
//
// Replaces: exp_pallas_verify.py `kernel` (:64-88, the repo's one Pallas
// kernel, which never compiled on the TPU) and the computation it tried to
// speed up, pgrc_tpu/align/matcher.py `_make_probe._verify` (:191-206) with
// the best-of-n_verify loop around it (:268-308), and the anchors-to-starts
// lines before it (:262-266): start = anchor - offset, in range when the
// anchor exists and the window lies inside the pg.
//
// What bounds it on the card: bytes. A read's anchors (`res`, the join's
// output, 8 bytes a slot) are most of them; then its W lanes and, per
// verified window, W+1 consecutive u32 pg lanes at a data-dependent address
// (the packed pg of a multi-million-read input, 2 bits a symbol, sits in the
// 50 MB L2). The arithmetic per lane is a handful of integer ops and one
// popcount. Before this kernel read the anchors itself, the probe turned
// them into starts and a mask in ~8 elementwise launches that moved ~4x the
// anchors' bytes, and A then waited on one window's W+1 scattered 4-byte
// loads after another.
//
// What the design does about it: one thread a read, 128 a block, which
// - reads its anchors and offsets 8 at a time (independent loads in
//   flight, not one dependent load a slot) and takes the first n_verify
//   in-range slots in slot order, 6 windows a batch (4 above L 128);
// - issues the loads of every window of a batch before it counts any: a
//   window is read as the aligned 16-byte chunks that hold its W+1 lanes
//   (three chunks at W 7), so a window costs three vector loads, not W+1
//   scalar ones, and all of a batch's loads are in flight together (the
//   pg must start on 16 bytes: the wrapper refuses one that does not);
// - then counts each window from registers and keeps the (mismatches,
//   position) minimum in slot order.
// Measured against it on an H100 (PERF.md), and slower at SE 2M's
// first probe: a group of 8 threads a read (lanes and slots spread over
// the group, a ballot to choose, shuffles to count); a block staging its
// reads' anchor rows in shared memory by coalesced loads; anchors read
// one or 4 at a time; 4 or 8 windows a batch; 256-thread blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStep = 8;   // anchors a thread loads at once

__device__ __forceinline__ int64_t clamp_lane(int64_t i, int64_t n) {
  return i < n ? i : n - 1;
}

// Pos: int32_t, or int64_t for the wide probe of pgs past 2^31 symbols
// (matcher.py:180-181, positions up to 2^35). Its largest value starts the
// best position, as the reference's big_pos does.
template <typename Pos> struct PosMax;
template <> struct PosMax<int32_t> { static constexpr int32_t value = INT32_MAX; };
template <> struct PosMax<int64_t> { static constexpr int64_t value = INT64_MAX; };

// words[o + i] for a runtime o in 0..3 and a compile-time i, without
// indexing the register array at run time
__device__ __forceinline__ uint32_t pick(const uint32_t* words, int o, int i) {
  return o == 0 ? words[i] : o == 1 ? words[i + 1] : o == 2 ? words[i + 2] : words[i + 3];
}

template <int W, typename Pos>
__global__ void __launch_bounds__(kThreads)
verify_best_kernel(const uint32_t* __restrict__ reads, int64_t n_reads, int ld_reads,
                   const long long* __restrict__ res, const int32_t* __restrict__ offs,
                   int n_slots, const uint32_t* __restrict__ pg, int64_t pg_lanes_len,
                   int64_t last_start, uint32_t tail_mask, int max_mis, int n_verify,
                   uint8_t* __restrict__ out_mis, Pos* __restrict__ out_pos) {
  // 16-byte chunks a window of W+1 lanes can touch, and windows a thread
  // loads before it counts any (fewer for long reads, to bound registers)
  constexpr int kChunks = (W + 3) / 4 + 1;
  constexpr int kBatch = kChunks <= 3 ? 6 : 4;
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_reads) return;
  uint32_t rl[W];
#pragma unroll
  for (int c = 0; c < W; ++c) rl[c] = reads[r * ld_reads + c];
  rl[W - 1] &= tail_mask;
  const long long* anchors = res + r * n_slots;

  int best_mis = 255;
  Pos best_pos = PosMax<Pos>::value;
  int taken = 0, j = 0;
  while (taken < n_verify && j < n_slots) {
    // choose up to kBatch in-range slots, in slot order
    Pos st[kBatch];
    int cnt = 0;
    while (cnt < kBatch && taken < n_verify && j < n_slots) {
      long long a[kStep];
      int o[kStep];
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        const bool have = j + e < n_slots;
        a[e] = have ? anchors[j + e] : 0;
        o[e] = have ? offs[j + e] : 0;
      }
      int next = j + kStep;
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        const int64_t s = a[e] - 1 - o[e];
        // a signed compare: last_start < 0 (pg_len < L) leaves no slot in
        // range; in range, the reference's clip to [0, pg_top] keeps s
        if (cnt < kBatch && taken < n_verify && a[e] > 0 && s >= 0 && s <= last_start) {
#pragma unroll
          for (int w = 0; w < kBatch; ++w)
            if (w == cnt) st[w] = (Pos)s;
          ++cnt;
          ++taken;
          if (cnt == kBatch) next = j + e + 1;   // the next batch starts after this slot
        }
      }
      j = next;
    }
    // every chosen window's chunks first, then the counts
    uint32_t words[kBatch][4 * kChunks];
#pragma unroll
    for (int w = 0; w < kBatch; ++w) {
      if (w < cnt) {
        const int64_t q0 = ((int64_t)st[w] >> 4) & ~(int64_t)3;
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int64_t at = q0 + 4 * i;
          if (at + 3 < pg_lanes_len) {
            const uint4 v = *reinterpret_cast<const uint4*>(pg + at);
            words[w][4 * i] = v.x;
            words[w][4 * i + 1] = v.y;
            words[w][4 * i + 2] = v.z;
            words[w][4 * i + 3] = v.w;
          } else {   // a chunk past the pg's last lane: lane by lane, clamped
#pragma unroll
            for (int e = 0; e < 4; ++e)
              words[w][4 * i + e] = pg[clamp_lane(at + e, pg_lanes_len)];
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kBatch; ++w) {
      if (w < cnt) {
        const int o = (int)(((int64_t)st[w] >> 4) & 3);
        const uint32_t s2 = (uint32_t)(st[w] & 15) << 1;
        int mis = 0;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const uint32_t cur = pick(words[w], o, c), nxt = pick(words[w], o, c + 1);
          // a 32-bit shift by 32 is undefined: at s2 == 0 the next lane
          // contributes nothing, as the reference's where() says (matcher.py:201)
          uint32_t aligned = s2 ? ((cur << s2) | (nxt >> (32u - s2))) : cur;
          if (c == W - 1) aligned &= tail_mask;
          const uint32_t x = aligned ^ rl[c];
          mis += __popc((x | (x >> 1)) & 0x55555555u);
        }
        if (mis < best_mis || (mis == best_mis && st[w] < best_pos)) {
          best_mis = mis;
          best_pos = st[w];
        }
      }
    }
  }
  const bool ok = best_mis <= max_mis;
  out_mis[r] = ok ? (uint8_t)best_mis : (uint8_t)255;
  out_pos[r] = ok ? best_pos : (Pos)-1;
}

template <int W, typename Pos>
cudaError_t launch_verify(cudaStream_t s, const void* reads, int64_t n_reads, int ld_reads,
                          const void* res, const void* offs, int n_slots, const void* pg,
                          int64_t pg_lanes_len, int64_t last_start, uint32_t tail_mask,
                          int max_mis, int n_verify, void* out_mis, void* out_pos) {
  const unsigned grid = (unsigned)((n_reads + kThreads - 1) / kThreads);
  verify_best_kernel<W, Pos><<<grid, kThreads, 0, s>>>(
      (const uint32_t*)reads, n_reads, ld_reads, (const long long*)res, (const int32_t*)offs,
      n_slots, (const uint32_t*)pg, pg_lanes_len, last_start, tail_mask, max_mis, n_verify,
      (uint8_t*)out_mis, (Pos*)out_pos);
  return cudaGetLastError();
}

}  // namespace

#define PGRC_VERIFY_CASE(WW)                                                       \
  case WW:                                                                         \
    return (int)(wide ? launch_verify<WW, int64_t> : launch_verify<WW, int32_t>)(  \
        s, reads, n_reads, ld_reads, res, offs, n_slots, pg, pg_lanes_len,         \
        pg_len - L, tail_mask, max_mis, n_verify, out_mis, out_pos);

// res [n_reads, n_slots] int64: the join's anchors (position + 1, 0 = none);
// offs [n_slots] int32: the probe offsets; wide != 0: out_pos is int64_t,
// else int32_t.
extern "C" int pgrc_verify_best(int device, void* stream, const void* reads,
                                int64_t n_reads, int W, int ld_reads, const void* res,
                                const void* offs, int n_slots, const void* pg,
                                int64_t pg_lanes_len, int64_t pg_len, int L,
                                uint32_t tail_mask, int max_mis, int n_verify, int wide,
                                void* out_mis, void* out_pos) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_reads == 0) return 0;
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
}
