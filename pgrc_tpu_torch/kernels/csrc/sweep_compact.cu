// Kernel H: sweep_compact — the sweep table's compaction at a segment end.
//
// Replaces pgrc_tpu/overlap/greedy_scs.py `_build_compact_fn.compact_fn`
// (:488-528: a stable partition of the rows with a_s | a_p to the front by
// one sort, then a take of every per-row array) and the host's count
// readback that decides it (:391-397, :816-823). Rows with keep = a_s | a_p
// move, in row order, to the front of the output arrays: each of the
// lane_cols lane columns and nmask_cols N-mask columns of the table's
// column-major lanes ([cols, n] int32, column c of row r at c * ld + r;
// core/packed.py `empty_cols`), ids (int32), the four rolled hashes h, p,
// h2, p2 (int64) and a_s, a_p (bool). The output arrays are sized n (the
// caller's choice, PERF.md section 5); the kept rows fill the first k
// entries of each, and of each output column. Dropped rows have written
// their links already, so compaction moves rows and never changes a link
// (:824-826).
//
// The same pass writes three totals to scratch words kTotalsWord.. (see
// seg_scan.cuh): the kept rows k, the active suffixes and the active
// prefixes. The host reads the three in one copy: the sweep stops when
// either side has none left (the reference's test, :818-819) and else
// takes the first k rows of each output.
//
// What bounds H on the card: memory, the flags of every row (2 B) and each
// kept row's ~70 B (at L = 100 without N; ~90 B with N) read once and
// written once. The design:
// - Loads before the look-back. A block takes a tile of kItems * threads
//   consecutive rows and, first thing, starts cp.async copies of the tile's
//   slice of every per-row array into shared memory: the flags in one copy
//   group, the rest (each lane and N-mask column, ids, the four hashes) in
//   a second, a column's tile one run of 4 B a row, staged [column][row]. It
//   waits for the flags alone, scans them (seg_scan.cuh's count scan with
//   its warp-wide look-back: thread t's kItems consecutive rows, each flag
//   array read as one 8-byte word), and the row bytes arrive meanwhile.
// - Writes from shared memory. The tile's kept rows land in one contiguous
//   output run per array and per lane column, rows base .. base + cnt,
//   where base is the count kept before the tile and can take any value.
//   Each run is written as 32-bit words, consecutive threads on consecutive
//   words, in 16-byte stores between a head and a tail of single words that
//   reach and leave 16-byte alignment (int32 runs start at any residue of
//   base mod 4, int64 runs at any residue mod 2); each word comes from its
//   row's staged copy through the tile's list of kept rows. The lane and
//   N-mask columns go out together (write_columns): a thread reads four
//   kept rows' places in the list once and writes them to every column, so
//   the list is not read again for each column. The flags go out a byte a
//   thread (2 of a row's ~70 bytes).
// - The tile: a tile of 70-90 B rows fills shared memory fast (2048 rows:
//   140-180 KB, one block an SM), so H has its own tile, kTile = 1024 rows
//   (timed on an H100 against 512 and 2048 at SE 2M's first compaction,
//   PERF.md), halved to 512 for rows too wide for a block's shared memory:
//   up to L 255 with N (17 lane and 9 N-mask columns, 142 B a row, 147 KB a
//   tile) the whole tile fits; L 496 with N (234 B a row) halves it.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

using seg_scan::State;

constexpr int kItems = 8;        // rows a thread scans: one 8-byte word of each flag array
constexpr int kTile = 1024;      // rows a block
constexpr int kMinTile = 512;    // for wide rows; the wrapper sizes the scratch for it
constexpr int kArrays = 9;       // lanes, nmask, ids, h, p, h2, p2, a_s, a_p (the ABI's order)
constexpr int kLanes = 0, kNmask = 1, kIds = 2, kHash = 3, kAs = 7, kAp = 8;

struct Arrays {
  const void* in[kArrays];   // nmask may be null
  void* out[kArrays];
  int cols[2];               // lane and N-mask columns
  int64_t ld_in[2], ld_out[2];   // their column strides, in words
};

// Bytes a row of each array.
__host__ __device__ inline int row_bytes(int a, int lane_cols, int nmask_cols) {
  return a == kLanes ? 4 * lane_cols : a == kNmask ? 4 * nmask_cols : a == kIds ? 4 : a < kAs ? 8 : 1;
}

// Shared memory of a tile: each array's staged rows (16-byte aligned, as
// tile is a multiple of 16), then the list of the tile's kept rows.
__host__ __device__ inline int tile_smem(int tile, int lane_cols, int nmask_cols, bool has_nmask) {
  int bytes = 2 * tile;
  for (int a = 0; a < kArrays; ++a)
    if (a != kNmask || has_nmask) bytes += tile * row_bytes(a, lane_cols, nmask_cols);
  return bytes;
}

// Write the tile's kept rows of a staged array of kW 32-bit words a row (1
// or 2) to the output rows base .. base + cnt of out: consecutive threads
// on consecutive words, 16-byte stores between a head and a tail of single
// words. src[d] is the staged row of the tile's d-th kept row.
template <int kW>
__device__ __forceinline__ void write_words(uint32_t* __restrict__ out, const uint32_t* s,
                                            long long base, int cnt, const short* src) {
  static_assert(kW == 1 || kW == 2, "int32 or int64 rows");
  uint32_t* dst = out + base * kW;
  const int total = cnt * kW;
  const int head =
      min(total, (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2));
  const auto word = [&](int x) -> uint32_t {
    return kW == 1 ? s[src[x]] : s[src[x >> 1] * 2 + (x & 1)];
  };
  for (int x = threadIdx.x; x < head; x += blockDim.x) dst[x] = word(x);
  const int body = (total - head) >> 2;
  for (int g = threadIdx.x; g < body; g += blockDim.x) {
    const int x = head + 4 * g;
    *reinterpret_cast<uint4*>(dst + x) = make_uint4(word(x), word(x + 1), word(x + 2), word(x + 3));
  }
  for (int x = head + 4 * body + threadIdx.x; x < total; x += blockDim.x) dst[x] = word(x);
}

// Write the tile's kept rows of `cols` staged int32 columns (column c at
// s + c * kRows) to the output rows base .. base + cnt of each output
// column (out + c * ld, ld a multiple of 4, so every column's run starts at
// the same residue mod 4): a thread takes four consecutive kept rows, reads
// their staged rows' indices once and writes one 16-byte store a column,
// consecutive threads on consecutive stores; the head and tail rows that
// reach and leave 16-byte alignment are written singly.
template <int kRows>
__device__ __forceinline__ void write_columns(uint32_t* __restrict__ out, int64_t ld,
                                              const uint32_t* s, int cols, long long base,
                                              int cnt, const short* src) {
  uint32_t* dst = out + base;
  const int head =
      min(cnt, (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2));
  const int body = (cnt - head) >> 2;
  for (int g = threadIdx.x; g < body; g += blockDim.x) {
    const int d = head + 4 * g;
    const int r0 = src[d], r1 = src[d + 1], r2 = src[d + 2], r3 = src[d + 3];
    for (int c = 0; c < cols; ++c) {
      const uint32_t* sc = s + c * kRows;
      *reinterpret_cast<uint4*>(dst + c * ld + d) = make_uint4(sc[r0], sc[r1], sc[r2], sc[r3]);
    }
  }
  // the head and tail rows
  const int tail = cnt - head - 4 * body;
  for (int x = threadIdx.x; x < (head + tail) * cols; x += blockDim.x) {
    const int k = x / cols, c = x - k * cols;
    const int d = k < head ? k : head + 4 * body + (k - head);
    dst[c * ld + d] = s[c * kRows + src[d]];
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
sweep_compact_kernel(int64_t n, Arrays arr, long long* scratch) {
  constexpr int kRows = kThreads * kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_base;
  __shared__ int s_cnt;
  const int64_t tile = seg_scan::next_tile(scratch);
  const int64_t first = tile * kRows;
  const int rows = (int)min((int64_t)kRows, n - first);

  // start the tile's copies: the flags (group 1), then the rows (group 2)
  unsigned char* staged[kArrays];
  int off = 0;
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    staged[a] = smem + off;
    if (a != kNmask || arr.in[kNmask] != nullptr)
      off += kRows * row_bytes(a, arr.cols[kLanes], arr.cols[kNmask]);
  }
  short* src = reinterpret_cast<short*>(smem + off);
#pragma unroll
  for (int a = kAs; a <= kAp; ++a)
    seg_scan::copy_async(staged[a], static_cast<const char*>(arr.in[a]) + first, rows);
  seg_scan::commit_copies();
#pragma unroll
  for (int a = kLanes; a <= kNmask; ++a) {   // the lane and N-mask columns, [column][row]
    if (arr.in[a] == nullptr) continue;
    seg_scan::copy_cols_async<kRows>(reinterpret_cast<uint32_t*>(staged[a]),
                                     static_cast<const uint32_t*>(arr.in[a]) + first,
                                     arr.ld_in[a], arr.cols[a], rows);
  }
#pragma unroll
  for (int a = kIds; a < kAs; ++a) {
    const int rb = row_bytes(a, 0, 0);
    seg_scan::copy_async(staged[a], static_cast<const char*>(arr.in[a]) + first * rb, rows * rb);
  }
  seg_scan::commit_copies();
  seg_scan::wait_copies<1>();
  __syncthreads();

  // the keep flags of the thread's kItems consecutive rows, a byte each
  // (bool: 0 or 1), past the table's end masked off; State: (kept, active
  // suffixes + active prefixes << 32), each below 2^30
  // (the mask is built a byte at a time: a shift by 8 * the valid count,
  // with its end cases, gave all ones for 0 or 1 valid rows on an H100)
  const int mine = threadIdx.x * kItems;
  unsigned long long live = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (mine + j < rows) live |= 0xFFull << (8 * j);
  const auto flags = [&](int a) {
    return *reinterpret_cast<const unsigned long long*>(staged[a] + mine) & live;
  };
  const unsigned long long fs = flags(kAs), fp = flags(kAp);
  const unsigned long long keep = fs | fp;
  const long long cnt = __popcll(keep), suf = __popcll(fs), pref = __popcll(fp);
  const State pre = seg_scan::thread_prefix<seg_scan::CountOp, kThreads / 32>(
      {cnt, suf + (pref << 32)}, scratch, tile);
  if (threadIdx.x == 0) s_base = pre.a;
  __syncthreads();
  int slot = (int)(pre.a - s_base);
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if ((keep >> (8 * j)) & 1) src[slot++] = (short)(mine + j);
  if (threadIdx.x == kThreads - 1) {
    s_cnt = slot;
    if (tile == seg_scan::tiles_for(n, kRows) - 1) {
      const long long sides = pre.b + suf + (pref << 32);
      scratch[seg_scan::kTotalsWord] = pre.a + cnt;
      scratch[seg_scan::kTotalsWord + 1] = sides & 0xFFFFFFFFll;
      scratch[seg_scan::kTotalsWord + 2] = sides >> 32;
    }
  }
  seg_scan::wait_copies<0>();
  __syncthreads();

  // the kept rows, from shared memory, one contiguous run per array
  const long long base = s_base;
  const int kept = s_cnt;
  const auto words = [&](int a) { return reinterpret_cast<const uint32_t*>(staged[a]); };
  const auto out = [&](int a) { return static_cast<uint32_t*>(arr.out[a]); };
  for (int a = kLanes; a <= kNmask; ++a)
    if (arr.in[a] != nullptr)
      write_columns<kRows>(out(a), arr.ld_out[a], words(a), arr.cols[a], base, kept, src);
  write_words<1>(out(kIds), words(kIds), base, kept, src);
#pragma unroll
  for (int a = kHash; a < kAs; ++a) write_words<2>(out(a), words(a), base, kept, src);
#pragma unroll
  for (int a = kAs; a <= kAp; ++a) {
    unsigned char* o = static_cast<unsigned char*>(arr.out[a]) + base;
    for (int d = threadIdx.x; d < kept; d += kThreads) o[d] = staged[a][src[d]];
  }
}

template <int kThreads>
cudaError_t launch(int64_t n, const Arrays& arr, int smem, long long* scratch,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(sweep_compact_kernel<kThreads>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sweep_compact_kernel<kThreads>
      <<<(unsigned)seg_scan::tiles_for(n, kThreads * kItems), kThreads, smem, s>>>(
          n, arr, scratch);
  return cudaGetLastError();
}

}  // namespace

// int64 scratch words the wrapper allocates for a compaction of n rows (at
// the smaller tile, so either tile fits).
extern "C" int64_t pgrc_sweep_compact_scratch_words(int64_t n) {
  return seg_scan::scratch_words(n, kMinTile);
}

// Rows a tile (of rows that fit; chip_smoke.py sizes H's edge cases by it).
extern "C" int64_t pgrc_sweep_compact_tile() { return kTile; }

// Inputs [n] (lanes [lane_cols, n] and nmask [nmask_cols, n] or null,
// column-major with column strides ld_lanes and ld_nmask), outputs of the
// same shapes (16-byte aligned, as torch allocates them; the output
// columns at strides ld_o_lanes and ld_o_nmask, multiples of 4 words, as
// core/packed.py `empty_cols` gives them); scratch:
// pgrc_sweep_compact_scratch_words(n) int64 words, zeroed here; the totals
// (kept, active suffixes, active prefixes) land in scratch[kTotalsWord ..].
extern "C" int pgrc_sweep_compact(int device, void* stream, int64_t n, const void* lanes,
                                  int lane_cols, int64_t ld_lanes, const void* nmask,
                                  int nmask_cols, int64_t ld_nmask, const void* ids,
                                  const void* h, const void* p, const void* h2, const void* p2,
                                  const void* a_s, const void* a_p, void* o_lanes,
                                  int64_t ld_o_lanes, void* o_nmask, int64_t ld_o_nmask,
                                  void* o_ids, void* o_h, void* o_p, void* o_h2, void* o_p2,
                                  void* o_as, void* o_ap, void* scratch, int64_t scratch_words) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (scratch_words < seg_scan::scratch_words(n, kMinTile) || lane_cols < 2 || lane_cols > 32 ||
      ld_lanes < n || ld_o_lanes < n || ld_o_lanes % 4 != 0 ||
      (nmask != nullptr && (nmask_cols < 2 || nmask_cols > 32 || ld_nmask < n ||
                            ld_o_nmask < n || ld_o_nmask % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  // the static shared memory of the scan and the tile's counters, with room
  const int reserve = 1024;
  const bool fits =
      tile_smem(kTile, lane_cols, nmask_cols, nmask != nullptr) + reserve <= smem_max;
  const int tile = fits ? kTile : kMinTile;
  const int smem = tile_smem(tile, lane_cols, nmask_cols, nmask != nullptr);
  cudaStream_t s = (cudaStream_t)stream;
  err = seg_scan::zero_scratch(scratch, n, s, tile);
  if (err != cudaSuccess || n == 0) return (int)err;
  const Arrays arr = {{lanes, nmask, ids, h, p, h2, p2, a_s, a_p},
                      {o_lanes, o_nmask, o_ids, o_h, o_p, o_h2, o_p2, o_as, o_ap},
                      {lane_cols, nmask_cols},
                      {ld_lanes, ld_nmask},
                      {ld_o_lanes, ld_o_nmask}};
  long long* sc = (long long*)scratch;
  if (fits) return (int)launch<kTile / kItems>(n, arr, smem, sc, s);
  return (int)launch<kMinTile / kItems>(n, arr, smem, sc, s);
}
