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
// passes its own.  (The mesh append no longer runs L: kernel M's received
// entry, csrc/postings_append.cu, reads only the routed rows.)
//
// Bound: memory bytes (every row read once and written once).
//
// Design: two launches over (block, shard) blocks, no memset.  A tile is
// dsi_compact_tile_rows(n_dev, r, w) rows, a multiple of 32 (at most 16 KB
// of them where a row is at most 128 words, halved while the grid has
// fewer than 128 blocks); a block takes one tile, or as many as keep a
// shard at 1,024 blocks or fewer.
//  (1) compact_count tests each row's pad lanes once: one ballot a warp per
//      32 rows, each ballot kept as the block's mask word, their popcounts
//      the block's count.
//  (2) compact_write sums the counts of its shard's blocks (the ones before
//      its own: its first valid slot; all of them: n_valid), then tile by
//      tile scans the tile's mask words in one warp, stages its rows in
//      shared memory with coalesced 16-byte loads, ranks every row from its
//      mask word (valid rows first, then pad rows, each in row order) and
//      writes the tile's valid run and its pad run, each one contiguous
//      range of `out`, with consecutive threads on consecutive 16-byte words
//      (E's write idiom).  At most 1,024 blocks a shard keep the sums at
//      four loads a thread however long the shard (128 measured slower at
//      [8, 2,097,152, 8] and no faster at [8, 262,144, 8]).
// Ranks come from ballots and tile counts, never from atomics, and nothing
// is sorted.  Weighed against one cooperative launch with a grid-wide sync
// (each tile held in shared memory across it): that fits the resident grid
// only up to ~25 MB of rows, so the TF-IDF wave at 8 shards (64 MB) would
// still need this design, and the count pass it saves reads the tested
// lanes of an L2-resident 1 MiB at the small shape.  One design serves
// every shape.  Rows wider than 128 words take 32-row tiles copied
// straight from device memory, where each row is already contiguous.

#include "common.cuh"

namespace {

constexpr int kLThreads = 256;
constexpr int kLWarps = kLThreads / 32;
constexpr int kLStageWords = 4096;   // 16 KB of staged rows a tile
constexpr int kLMaxTileRows = 1024;  // 32 mask words: one warp scans them
constexpr int kLMinBlocks = 128;
constexpr int kLMaxBlocks = 1024;  // a shard's blocks, where r allows

int tile_rows(int n_dev, int64_t r, int w) {
  int t = 32;
  while (2 * t <= kLMaxTileRows && int64_t(2 * t) * w <= kLStageWords) {
    t *= 2;
  }
  while (t > 64 && int64_t(n_dev) * ceil_div(r, t) < kLMinBlocks) t /= 2;
  return t;
}

// A block's rows: whole tiles, doubled until a shard has kLMaxBlocks
// blocks or fewer.
int64_t block_rows(int n_dev, int64_t r, int w) {
  int64_t b = tile_rows(n_dev, r, w);
  while (ceil_div(r, b) > kLMaxBlocks) b *= 2;
  return b;
}

__device__ __forceinline__ bool is_pad(const uint32_t* row, int pad_lanes) {
  bool pad = true;
  for (int c = 0; c < pad_lanes; ++c) pad = pad && row[c] == 0xFFFFFFFFu;
  return pad;
}

// masks[(s * blocks + x) * (block / 32) + j]: bit b set when row 32 j + b
// of block x of shard s is valid; counts[s * blocks + x]: the block's
// valid rows.
__global__ void __launch_bounds__(kLThreads)
    compact_count(const uint32_t* rows, int64_t r, int w, int pad_lanes,
                  int64_t block, int blocks, unsigned* masks, int* counts) {
  __shared__ int warp_valid[kLWarps];
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = int64_t(blockIdx.x) * block;
  const int64_t n = r - row0 < block ? r - row0 : block;
  const int64_t mw = block >> 5;
  const uint32_t* base = rows + (int64_t(s) * r + row0) * w;
  unsigned* m = masks + (int64_t(s) * blocks + blockIdx.x) * mw;
  int valid = 0;
  for (int64_t j = warp; j < mw; j += kLWarps) {
    const int64_t i = 32 * j + lane;
    const bool v = i < n && !is_pad(base + i * w, pad_lanes);
    const unsigned bits = __ballot_sync(kFullMask, v);
    if (lane == 0) m[j] = bits;
    valid += __popc(bits);
  }
  if (lane == 0) warp_valid[warp] = valid;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int v = 0; v < kLWarps; ++v) sum += warp_valid[v];
    counts[int64_t(s) * blocks + blockIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(kLThreads)
    compact_write(const uint32_t* rows, int64_t r, int w, int tile,
                  int64_t block, int blocks, int staged, int vec4,
                  const unsigned* masks, const int* counts, uint32_t* out,
                  int* n_valid) {
  extern __shared__ __align__(16) unsigned char lshared[];
  __shared__ int order[kLMaxTileRows];  // tile row at each sorted position
  __shared__ unsigned wmask[32];
  __shared__ int wbefore[32];  // the tile's valid rows before mask word j
  __shared__ long long sums[2][kLWarps];
  __shared__ int tile_valid;
  const int s = blockIdx.y;
  const int x = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = int64_t(x) * block;
  const int64_t nb = r - row0 < block ? r - row0 : block;

  // The shard's valid rows before this block, and in all.
  const int* cnt = counts + int64_t(s) * blocks;
  long long before = 0, total = 0;
  for (int j = threadIdx.x; j < blocks; j += kLThreads) {
    const int v = cnt[j];
    total += v;
    before += j < x ? v : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(kFullMask, before, o);
    total += __shfl_xor_sync(kFullMask, total, o);
  }
  if (lane == 0) {
    sums[0][warp] = before;
    sums[1][warp] = total;
  }
  __syncthreads();
  before = 0;
  total = 0;
  for (int v = 0; v < kLWarps; ++v) {
    before += sums[0][v];
    total += sums[1][v];
  }
  if (x == 0 && threadIdx.x == 0) n_valid[s] = int(total);

  // The out rows of the block's next valid row and next pad row: after the
  // shard's valid rows come the pad rows of the blocks before this one.
  int64_t vrow = int64_t(s) * r + before;
  int64_t prow = int64_t(s) * r + total + (row0 - before);
  const unsigned* m = masks + (int64_t(s) * blocks + x) * (block >> 5);
  const uint32_t* src = rows + (int64_t(s) * r + row0) * w;
  for (int64_t a = 0; a < nb; a += tile) {
    const int n = int(nb - a < tile ? nb - a : tile);
    __syncthreads();  // the last tile's stage and order are read
    const uint32_t* st =
        staged ? load_words<kLThreads>(src + a * w, n * w,
                                       reinterpret_cast<uint32_t*>(lshared))
               : src + a * w;
    if (warp == 0) {
      const unsigned mk = 32 * lane < n ? m[(a >> 5) + lane] : 0u;
      const int c = __popc(mk);
      int y = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(kFullMask, y, o);
        if (lane >= o) y += z;
      }
      wmask[lane] = mk;
      wbefore[lane] = y - c;
      if (lane == 31) tile_valid = y;
    }
    __syncthreads();
    const int nv = tile_valid;
    for (int i = threadIdx.x; i < n; i += kLThreads) {
      const unsigned mk = wmask[i >> 5];
      const unsigned bit = 1u << (i & 31);
      const int vb = wbefore[i >> 5] + __popc(mk & (bit - 1u));
      order[(mk & bit) ? vb : nv + i - vb] = i;
    }
    __syncthreads();
    // Sorted position q goes to out row vrow + q when q < nv (a valid
    // row), else to prow + q - nv.
    const int64_t pq = prow - nv;
    if (vec4) {
      const int w4 = w >> 2;
      const uint4* s4 = reinterpret_cast<const uint4*>(st);
      uint4* o4 = reinterpret_cast<uint4*>(out);
      const int units = n * w4;
      for (int y = threadIdx.x; y < units; y += kLThreads) {
        const int q = y / w4;
        const int c = y - q * w4;
        o4[((q < nv ? vrow : pq) + q) * w4 + c] = s4[order[q] * w4 + c];
      }
    } else {
      const int words = n * w;
      for (int y = threadIdx.x; y < words; y += kLThreads) {
        const int q = y / w;
        const int c = y - q * w;
        out[((q < nv ? vrow : pq) + q) * w + c] =
            st[int64_t(order[q]) * w + c];
      }
    }
    vrow += nv;
    prow += n - nv;
  }
}

}  // namespace

extern "C" {

// The rows a tile of kernel L stages for rows [n_dev, r, w] (a block takes
// one tile, or 2^k tiles where a shard has more than 1,024 of them).
int64_t dsi_compact_tile_rows(int n_dev, int64_t r, int w) {
  return tile_rows(n_dev, r, w);
}

int64_t dsi_compact_scratch_bytes(int n_dev, int64_t r, int w) {
  const int64_t block = block_rows(n_dev, r, w);
  const int64_t blocks = int64_t(n_dev) * ceil_div(r, block);
  return align8(4 * blocks) + 4 * blocks * (block >> 5);
}

// rows [n_dev, r, w] u32; out [n_dev, r, w] u32 (not aliasing rows);
// n_valid [n_dev] i32; scratch dsi_compact_scratch_bytes(n_dev, r, w)
// bytes, 4-byte aligned.  n_dev in [1, 65535], r >= 1, 1 <= pad_lanes <= w.
int dsi_compact(const void* rows, int n_dev, int64_t r, int w, int pad_lanes,
                void* out, void* n_valid, void* scratch, void* stream) {
  if (n_dev < 1 || n_dev > 65535 || r < 1 || w < 1 || pad_lanes < 1 ||
      pad_lanes > w) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = tile_rows(n_dev, r, w);
  const int64_t block = block_rows(n_dev, r, w);
  const int64_t blocks = ceil_div(r, block);
  int* counts = static_cast<int*>(scratch);
  unsigned* masks = reinterpret_cast<unsigned*>(
      static_cast<char*>(scratch) + align8(4 * int64_t(n_dev) * blocks));
  const uint32_t* in = static_cast<const uint32_t*>(rows);
  const int staged = int64_t(tile) * w <= kLStageWords;
  const int vec4 = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(rows) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const dim3 grid{unsigned(blocks), unsigned(n_dev)};
  compact_count<<<grid, kLThreads, 0, st>>>(in, r, w, pad_lanes, block,
                                            int(blocks), masks, counts);
  DSI_CHECK_LAUNCH();
  const size_t smem =
      staged ? size_t(4 * stage_words(int64_t(tile) * w)) : 0;
  compact_write<<<grid, kLThreads, smem, st>>>(
      in, r, w, tile, block, int(blocks), staged, vec4, masks, counts,
      static_cast<uint32_t*>(out), static_cast<int*>(n_valid));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
