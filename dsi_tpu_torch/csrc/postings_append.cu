// Kernel M: the device-offset postings append, and the mesh append's
// compaction fused into it.
//
// Replaces K20a, dsi_tpu/device/postings.py:57-86 _append_device (one
// shard_map body per device, the overflow a lax.pmax over the mesh axis).
// Per shard d of buf [n_dev, cap, w] u32, with nr = scal[d][0]:
//
//   new_n[d]  = n[d] + nr;
//   ov        = max over every shard e of (new_n[e] > cap);
//   no_op[d]  = max(ov, dirty[d]);
//   unless no_op[d]: buf[d][n[d] + j] = rows[d][j] for j < nr;
//   n_out[d]  = no_op[d] ? n[d] : new_n[d];  dirty_out[d] = no_op[d];
//   flags[d]  = (no_op[d], n_out[d]).
//
// The commit is all-or-nothing: a no-op leaves buf byte for byte as it was,
// and a committing shard's rows all fit (new_n <= cap), so no row past cap
// is ever written.
//
// The received entry replaces K20b's compaction and append together,
// dsi_tpu/device/postings.py:104-141 _mesh_append_device after its
// exchange: compact_received (dsi_tpu/ops/meshroute.py:83, the received
// rows whose lane 0 is not all ones, stable) and the same append with nr =
// n_recv[d].  It reads kernel E's recv [n_dev, n_dev * r, w] and E's
// per-pair totals [n_dev (source), n_dev (dest)]: pair (s, d)'s rows are
// recv[d][s * r, s * r + totals[s][d]), the rest of its block E's pad rows
// (key lanes, lane 0 included, all ones), which compact_received drops.  So
// only those heads are read, each head row still tested (a row E routed
// whose lane 0 is all ones is dropped, as the reference drops it), and the
// kept rows go straight to buf[d][n[d] + rank], rank in source order then
// row order.  No pad row is read or written.
//
// Bound: memory bytes (the appended rows read once and written once, plus
// the n_dev scalars).
//
// Design.  The append: one launch, grid (blocks, shard), the blocks a shard
// 2 x the card's SMs / n_dev (at most one 16-byte word a thread); every
// block recomputes the global overflow from the n_dev scalars
// (__syncthreads_or), so no block depends on another, and copies its
// grid-stride share of the shard's rows [0, nr), one contiguous run of
// nr * w words on both sides, in 16-byte words where w and the pointers
// allow.  The received entry: two launches over (chunk, pair) blocks, no
// memset; each pair's head is cut into the same chunks by both (a multiple
// of 32 rows, 512 blocks in all at least).
//  (1) postings_append_count tests lane 0 of each head row once: one ballot
//      a warp per 32 rows, kept as the pair's mask word; its count goes to
//      counts[pair * chunks + chunk], pairs destination-major.
//  (2) postings_append_write sums every destination's counts, one warp a
//      destination (the global overflow, from the exact counts), and the
//      counts before its own chunk in its destination's order (its first
//      rank); unless the append no-ops it stages its chunk's rows tile by
//      tile in shared memory (coalesced 16-byte loads), ranks the kept rows
//      of the tile from the mask words and writes them as one contiguous
//      range of buf, consecutive threads on consecutive words.
// The new counts go to n_out, dirty_out and flags, buffers other than the n
// and dirty that every block reads; the wrapper's owner swaps them in after
// the launch.  No host sync: n, dirty, scal and totals never leave the card.

#include "common.cuh"

namespace {

constexpr int kMThreads = 256;
constexpr int kMWarps = kMThreads / 32;
// The received entry's blocks, at least (chunks a pair: this / pairs).
constexpr int kMChunkBlocks = 512;
constexpr int kMStageWords = 4096;  // 16 KB of staged rows a tile
constexpr int kMMaxTileRows = 1024;

int append_blocks_per_shard(int n_dev, int64_t words) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1) {
    sms = 132;
  }
  const int64_t want = ceil_div(words, 4 * int64_t(kMThreads));
  int64_t b = 2 * int64_t(sms) / n_dev;
  b = b < want ? b : want;
  return int(b < 1 ? 1 : b);
}

// No-op and flags of shard d, from the overflow `ov` of every shard; one
// thread writes them.
__device__ __forceinline__ int commit_flags(int ov, int n0, int nr, int dd,
                                            int d, bool writer, int* n_out,
                                            int* dirty_out, int* flags) {
  const int no_op = ov > dd ? ov : dd;
  if (writer) {
    const int out_n = no_op > 0 ? n0 : n0 + nr;
    n_out[d] = out_n;
    dirty_out[d] = no_op;
    flags[2 * d] = no_op;
    flags[2 * d + 1] = out_n;
  }
  return no_op;
}

__global__ void __launch_bounds__(kMThreads)
    postings_append_copy(uint32_t* buf, int64_t cap, int w, const int* n,
                         const int* dirty, const uint32_t* rows, int64_t r,
                         const int* scal, int scal_w, int n_dev, int vec4,
                         int* n_out, int* dirty_out, int* flags) {
  const int d = blockIdx.y;
  int over = 0;
  for (int e = threadIdx.x; e < n_dev; e += kMThreads) {
    over |= int64_t(n[e]) + scal[int64_t(e) * scal_w] > cap ? 1 : 0;
  }
  const int ov = __syncthreads_or(over) ? 1 : 0;
  const int n0 = n[d];
  const int nr = scal[int64_t(d) * scal_w];
  const int no_op =
      commit_flags(ov, n0, nr, dirty[d], d,
                   blockIdx.x == 0 && threadIdx.x == 0, n_out, dirty_out,
                   flags);
  if (no_op > 0) return;
  const int64_t words = int64_t(nr < r ? nr : r) * w;
  const uint32_t* src = rows + int64_t(d) * r * w;
  uint32_t* dst = buf + (int64_t(d) * cap + n0) * w;
  const int64_t step = int64_t(gridDim.x) * kMThreads;
  const int64_t first = int64_t(blockIdx.x) * kMThreads + threadIdx.x;
  if (vec4) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t i = first; i < (words >> 2); i += step) d4[i] = s4[i];
  } else {
    for (int64_t i = first; i < words; i += step) dst[i] = src[i];
  }
}

// Pair (s, d)'s chunk `b` of its head: rows [lo, hi) of recv[d][s * r ...],
// lo a multiple of 32 (so no two chunks share a mask word); empty, with
// hi <= lo, past the head's end.
__device__ __forceinline__ void head_chunk(const int* totals, int n_dev,
                                           int64_t r, int s, int d, int b,
                                           int chunks, int64_t& lo,
                                           int64_t& hi) {
  int64_t h = totals[int64_t(s) * n_dev + d];
  h = h < 0 ? 0 : (h > r ? r : h);
  const int64_t cs = (ceil_div(h, chunks) + 31) & ~int64_t(31);
  lo = int64_t(b) * cs;
  hi = lo + cs < h ? lo + cs : h;
}

// Block x is chunk x % chunks of pair p = x / chunks = d * n_dev + s.
__global__ void __launch_bounds__(kMThreads)
    postings_append_count(const uint32_t* recv, int64_t r, int w, int n_dev,
                          const int* totals, int chunks, int64_t mwp,
                          unsigned* masks, int* counts) {
  __shared__ int warp_valid[kMWarps];
  const int p = blockIdx.x / chunks;
  const int b = blockIdx.x - p * chunks;
  const int d = p / n_dev;
  const int s = p - d * n_dev;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int64_t lo, hi;
  head_chunk(totals, n_dev, r, s, d, b, chunks, lo, hi);
  const uint32_t* head = recv + int64_t(p) * r * w;
  unsigned* m = masks + int64_t(p) * mwp;
  int valid = 0;
  for (int64_t j = (lo >> 5) + warp; 32 * j < hi; j += kMWarps) {
    const int64_t i = 32 * j + lane;
    const bool v = i < hi && head[i * w] != 0xFFFFFFFFu;
    const unsigned bits = __ballot_sync(kFullMask, v);
    if (lane == 0) m[j] = bits;
    valid += __popc(bits);
  }
  if (lane == 0) warp_valid[warp] = valid;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int v = 0; v < kMWarps; ++v) sum += warp_valid[v];
    counts[blockIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(kMThreads)
    postings_append_write(uint32_t* buf, int64_t cap, int w, const int* n,
                          const int* dirty, const uint32_t* recv, int64_t r,
                          int n_dev, const int* totals, int chunks,
                          int64_t mwp, const unsigned* masks,
                          const int* counts, int tile, int staged, int vec4,
                          int* n_out, int* dirty_out, int* flags) {
  extern __shared__ __align__(16) unsigned char mshared[];
  __shared__ int order[kMMaxTileRows];  // tile row of each kept row
  __shared__ unsigned wmask[32];
  __shared__ int wbefore[32];  // the tile's kept rows before mask word j
  __shared__ int tile_valid;
  __shared__ long long own[2];  // kept rows of d before this chunk, in all
  const int p = blockIdx.x / chunks;
  const int b = blockIdx.x - p * chunks;
  const int d = p / n_dev;
  const int s = p - d * n_dev;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Every destination's kept rows (the overflow), and this block's first
  // rank among d's: the counts before its own in d's (source, chunk) order.
  const int64_t seg = int64_t(n_dev) * chunks;
  const int64_t mine = int64_t(s) * chunks + b;
  int over = 0;
  for (int e = warp; e < n_dev; e += kMWarps) {
    const int* c = counts + int64_t(e) * seg;
    long long sum = 0, pre = 0;
    for (int64_t k = lane; k < seg; k += 32) {
      const int v = c[k];
      sum += v;
      pre += k < mine ? v : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(kFullMask, sum, o);
      pre += __shfl_xor_sync(kFullMask, pre, o);
    }
    over |= int64_t(n[e]) + sum > cap ? 1 : 0;
    if (e == d && lane == 0) {
      own[0] = pre;
      own[1] = sum;
    }
  }
  const int ov = __syncthreads_or(over) ? 1 : 0;
  const int n0 = n[d];
  const int no_op =
      commit_flags(ov, n0, int(own[1]), dirty[d], d,
                   s == 0 && b == 0 && threadIdx.x == 0, n_out, dirty_out,
                   flags);
  if (no_op > 0) return;

  int64_t lo, hi;
  head_chunk(totals, n_dev, r, s, d, b, chunks, lo, hi);
  const uint32_t* head = recv + int64_t(p) * r * w;
  const unsigned* m = masks + int64_t(p) * mwp;
  int64_t at = int64_t(d) * cap + n0 + own[0];  // buf row of the next kept
  uint32_t* stage = reinterpret_cast<uint32_t*>(mshared);
  for (int64_t a = lo; a < hi; a += tile) {
    const int nt = int(hi - a < tile ? hi - a : tile);
    __syncthreads();  // the last tile's stage and order are read
    const uint32_t* src = head + a * w;
    const uint32_t* st =
        staged ? load_words<kMThreads>(src, nt * w, stage) : src;
    if (warp == 0) {
      const unsigned mk = 32 * lane < nt ? m[(a >> 5) + lane] : 0u;
      const int c = __popc(mk);
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
      }
      wmask[lane] = mk;
      wbefore[lane] = x - c;
      if (lane == 31) tile_valid = x;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += kMThreads) {
      const unsigned mk = wmask[i >> 5];
      const unsigned bit = 1u << (i & 31);
      if (mk & bit) order[wbefore[i >> 5] + __popc(mk & (bit - 1u))] = i;
    }
    __syncthreads();
    const int nv = tile_valid;
    if (vec4) {
      const int w4 = w >> 2;
      const uint4* s4 = reinterpret_cast<const uint4*>(st);
      uint4* o4 = reinterpret_cast<uint4*>(buf) + at * w4;
      for (int x = threadIdx.x; x < nv * w4; x += kMThreads) {
        const int q = x / w4;
        o4[x] = s4[order[q] * w4 + (x - q * w4)];
      }
    } else {
      uint32_t* o = buf + at * w;
      for (int x = threadIdx.x; x < nv * w; x += kMThreads) {
        const int q = x / w;
        o[x] = st[int64_t(order[q]) * w + (x - q * w)];
      }
    }
    at += nv;
  }
}

int received_chunks(int n_dev) {
  const int pairs = n_dev * n_dev;
  return pairs >= kMChunkBlocks ? 1 : ceil_div(kMChunkBlocks, pairs);
}

int received_tile(int w) {
  int t = 32;
  while (2 * t <= kMMaxTileRows && int64_t(2 * t) * w <= kMStageWords) {
    t *= 2;
  }
  return t;
}

}  // namespace

extern "C" {

// buf [n_dev, cap, w] u32, updated in place; n, dirty [n_dev] i32; rows
// [n_dev, r, w] u32; scal [n_dev, scal_w] i32 (column 0 = rows to append);
// n_out, dirty_out [n_dev] i32 and flags [n_dev, 2] i32, distinct from n
// and dirty.
int dsi_postings_append(void* buf, int n_dev, int64_t cap, int w,
                        const void* n, const void* dirty, const void* rows,
                        int64_t r, const void* scal, int scal_w, void* n_out,
                        void* dirty_out, void* flags, void* stream) {
  if (n_dev < 1 || n_dev > 65535 || cap < 1 || w < 1 || r < 1) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec4 = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(buf) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  const dim3 grid{unsigned(append_blocks_per_shard(n_dev, r * w)),
                  unsigned(n_dev)};
  postings_append_copy<<<grid, kMThreads, 0, st>>>(
      static_cast<uint32_t*>(buf), cap, w, static_cast<const int*>(n),
      static_cast<const int*>(dirty), static_cast<const uint32_t*>(rows), r,
      static_cast<const int*>(scal), scal_w, n_dev, vec4,
      static_cast<int*>(n_out), static_cast<int*>(dirty_out),
      static_cast<int*>(flags));
  DSI_CHECK_LAUNCH();
  return 0;
}

int64_t dsi_postings_append_received_scratch_bytes(int n_dev, int64_t r) {
  const int64_t pairs = int64_t(n_dev) * n_dev;
  return align8(4 * pairs * received_chunks(n_dev)) +
         4 * pairs * ceil_div(r, 32);
}

// The received entry.  recv [n_dev, n_dev * r, w] u32 as kernel E wrote it
// (k >= 1 key lanes, so lane 0 of its pad rows is all ones); totals
// [n_dev, n_dev] i32, totals[s][d] the rows of source s E routed to d; buf,
// n, dirty, n_out, dirty_out and flags as for dsi_postings_append, with nr
// = the rows of d's heads whose lane 0 is not all ones.  scratch holds
// dsi_postings_append_received_scratch_bytes(n_dev, r) bytes, 4-byte
// aligned.  n_dev in [1, 1024].
int dsi_postings_append_received(void* buf, int n_dev, int64_t cap, int w,
                                  const void* n, const void* dirty,
                                  const void* recv, int64_t r,
                                  const void* totals, void* n_out,
                                  void* dirty_out, void* flags,
                                  void* scratch, void* stream) {
  if (n_dev < 1 || n_dev > 1024 || cap < 1 || w < 1 || r < 1) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = received_chunks(n_dev);
  const int64_t blocks = int64_t(n_dev) * n_dev * chunks;
  const int64_t mwp = ceil_div(r, 32);
  int* counts = static_cast<int*>(scratch);
  unsigned* masks = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) +
                                                align8(4 * blocks));
  const uint32_t* rv = static_cast<const uint32_t*>(recv);
  const int* tot = static_cast<const int*>(totals);
  postings_append_count<<<unsigned(blocks), kMThreads, 0, st>>>(
      rv, r, w, n_dev, tot, chunks, mwp, masks, counts);
  DSI_CHECK_LAUNCH();
  const int tile = received_tile(w);
  const int staged = int64_t(tile) * w <= kMStageWords;
  const int vec4 = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(buf) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(recv) % 16 == 0);
  const size_t smem =
      staged ? size_t(4 * stage_words(int64_t(tile) * w)) : 0;
  postings_append_write<<<unsigned(blocks), kMThreads, smem, st>>>(
      static_cast<uint32_t*>(buf), cap, w, static_cast<const int*>(n),
      static_cast<const int*>(dirty), rv, r, n_dev, tot, chunks, mwp, masks,
      counts, tile, staged, vec4, static_cast<int*>(n_out),
      static_cast<int*>(dirty_out), static_cast<int*>(flags));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
