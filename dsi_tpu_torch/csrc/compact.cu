// Kernel L: stable valid-first compaction of received rows.
//
// Replaces the stable pad-bit partition that K18 and K20b share:
// dsi_tpu/parallel/tfidf.py:124-134 (lax.sort((is_pad,) + keys64 + pay64,
// num_keys=1) over the wave's received rows) and dsi_tpu/ops/meshroute.py
// :83-93 compact_received (jnp.argsort(is_pad, stable=True)).  Per shard s
// of rows [n_dev, r, w] u32:
//
//   out[s][j]              = the j-th row, in row order, that is not a pad
//                            row, for j < n_valid[s];
//   out[s][n_valid[s] + j] = the j-th pad row, in row order.
//
// A pad row has its first `pad_lanes` lanes all 0xFFFFFFFF: 2 for K18, whose
// test is on the first packed u64 key word, 1 for compact_received, whose
// test is on lane 0.  The two differ only on a row whose lane 0 alone is all
// ones (non-ASCII input, which K18's has_high throws away), so each caller
// passes its own.
//
// Bound: memory bytes (every row read once and written once; the tested
// lanes are read a second time).
// Design: three launches, A's idiom (csrc/tokenize.cu).  (1) compact_count:
// block (tile, shard) counts the valid rows of its tile; (2) compact_scan:
// one block per shard scans its tiles' counts, giving each tile's first
// valid slot and the shard's n_valid; (3) compact_write: each tile takes one
// ballot per warp per round of kLThreads rows, one thread ranks the (round,
// warp) counts in row order, and every thread writes its row at
// valid_before(i) when it is valid, at n_valid + i - valid_before(i) when it
// is a pad row.  Ranks come from ballots and scans, never from atomics, and
// nothing is sorted.

#include "common.cuh"

namespace {

constexpr int kLThreads = 256;
constexpr int kLWarps = kLThreads / 32;
constexpr int kLRounds = 8;
constexpr int64_t kLTile = int64_t(kLThreads) * kLRounds;

__device__ __forceinline__ bool row_valid(const uint32_t* rows, int64_t r,
                                          int w, int pad_lanes, int s,
                                          int64_t i) {
  if (i >= r) return false;
  const uint32_t* row = rows + (int64_t(s) * r + i) * w;
  bool pad = true;
  for (int c = 0; c < pad_lanes; ++c) pad = pad && row[c] == 0xFFFFFFFFu;
  return !pad;
}

// counts[s * tiles + tile] = valid rows of `tile` of shard s.
__global__ void compact_count(const uint32_t* rows, int64_t r, int w,
                              int pad_lanes, int tiles, int* counts) {
  const int s = blockIdx.y;
  const int64_t base = int64_t(blockIdx.x) * kLTile;
  int cnt = 0;
  for (int q = 0; q < kLRounds; ++q) {
    const int64_t i = base + int64_t(q) * kLThreads + threadIdx.x;
    cnt += row_valid(rows, r, w, pad_lanes, s, i) ? 1 : 0;
  }
  int total;
  block_exclusive_scan<int>(cnt, total);
  if (threadIdx.x == 0) counts[int64_t(s) * tiles + blockIdx.x] = total;
}

// Block s scans row s of counts: offsets[s][tile] is the valid rows of the
// tiles before `tile`, n_valid[s] the row's sum.
__global__ void compact_scan(const int* counts, int tiles, int* offsets,
                             int* n_valid) {
  const int64_t row = int64_t(blockIdx.x) * tiles;
  int run = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? counts[row + i] : 0;
    int sum;
    const int before = block_exclusive_scan<int>(v, sum);
    if (i < tiles) offsets[row + i] = run + before;
    run += sum;
  }
  if (threadIdx.x == 0) n_valid[blockIdx.x] = run;
}

__global__ void compact_write(const uint32_t* rows, int64_t r, int w,
                              int pad_lanes, int tiles, const int* offsets,
                              const int* n_valid, int vec4, uint32_t* out) {
  __shared__ unsigned masks[kLRounds][kLWarps];
  __shared__ int before[kLRounds][kLWarps];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t base = int64_t(blockIdx.x) * kLTile;
  bool valid[kLRounds];
#pragma unroll
  for (int q = 0; q < kLRounds; ++q) {
    const int64_t i = base + int64_t(q) * kLThreads + tid;
    valid[q] = row_valid(rows, r, w, pad_lanes, s, i);
    const unsigned m = __ballot_sync(kFullMask, valid[q]);
    if (lane == 0) masks[q][warp] = m;
  }
  __syncthreads();
  if (tid == 0) {
    // Row order inside a tile is round-major, warp-minor.
    int run = offsets[int64_t(s) * tiles + blockIdx.x];
    for (int q = 0; q < kLRounds; ++q) {
      for (int v = 0; v < kLWarps; ++v) {
        before[q][v] = run;
        run += __popc(masks[q][v]);
      }
    }
  }
  __syncthreads();
  const int64_t nv = n_valid[s];
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kLRounds; ++q) {
    const int64_t i = base + int64_t(q) * kLThreads + tid;
    if (i >= r) continue;
    const int64_t vb = before[q][warp] + __popc(masks[q][warp] & lanes_below);
    const int64_t pos = valid[q] ? vb : nv + i - vb;
    const uint32_t* src = rows + (int64_t(s) * r + i) * w;
    uint32_t* dst = out + (int64_t(s) * r + pos) * w;
    if (vec4) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (int c = 0; c < (w >> 2); ++c) d4[c] = s4[c];
    } else {
      for (int c = 0; c < w; ++c) dst[c] = src[c];
    }
  }
}

}  // namespace

extern "C" {

int64_t dsi_compact_scratch_bytes(int n_dev, int64_t r) {
  return 2 * align8(4 * int64_t(n_dev) * ceil_div(r, kLTile));
}

// rows [n_dev, r, w] u32; out [n_dev, r, w] u32 (not aliasing rows);
// n_valid [n_dev] i32.
int dsi_compact(const void* rows, int n_dev, int64_t r, int w, int pad_lanes,
                void* out, void* n_valid, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = int(ceil_div(r, kLTile));
  int* counts = static_cast<int*>(scratch);
  int* offsets = reinterpret_cast<int*>(
      static_cast<char*>(scratch) + align8(4 * int64_t(n_dev) * tiles));
  const uint32_t* in = static_cast<const uint32_t*>(rows);
  uint32_t* o = static_cast<uint32_t*>(out);
  int* nv = static_cast<int*>(n_valid);
  const int vec4 = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(rows) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const dim3 grid{unsigned(tiles), unsigned(n_dev)};
  compact_count<<<grid, kLThreads, 0, st>>>(in, r, w, pad_lanes, tiles,
                                            counts);
  DSI_CHECK_LAUNCH();
  compact_scan<<<unsigned(n_dev), kLThreads, 0, st>>>(counts, tiles, offsets,
                                                      nv);
  DSI_CHECK_LAUNCH();
  compact_write<<<grid, kLThreads, 0, st>>>(in, r, w, pad_lanes, tiles,
                                            offsets, nv, vec4, o);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
