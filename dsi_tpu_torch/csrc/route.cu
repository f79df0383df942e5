// Kernel E: route rows to their destination shards (the shuffle).
//
// Replaces K8's shuffle_rows (dsi_tpu/parallel/shuffle.py:68-95): per
// source shard, a stable argsort of the destinations, a bincount, a scatter
// into one r-row block per destination, then the tiled lax.all_to_all.  On
// one card the shards are the leading dimension, so the whole exchange is
// one write address:
//
//   recv[d][s * r + j] = the j-th row of source s (in row order) with
//                        dest == d;  rows past that count are the pad row
//                        (k lanes 0xFFFFFFFF, p zero payload lanes).
//
// rows [n_dev, r, w] u32 (w = k + p), dest [n_dev, r] i32; a dest outside
// [0, n_dev) (the reference parks invalid rows on n_dev) is dropped.
//
// Bound: memory bytes (rows and dests read once, recv written once).
// Design: four launches.  (1) route_count: block (tile, source) counts its
// rows per destination; (2) route_scan: one block per (source, dest) scans
// that pair's tile counts, giving each tile's first slot and the pair's
// total; (3) route_write: each tile walks its rows in rounds of one row per
// thread and ranks a row among the rows of the same destination from
// __match_any_sync inside the warp plus per-warp counts in shared memory
// for the warps before it, so the order is the input order and no atomic
// decides it; (4) route_pad fills every slot past the pair's total.

#include "common.cuh"

namespace {

constexpr int kEThreads = 256;
constexpr int kEWarps = kEThreads / 32;
constexpr int kEItems = 8;
constexpr int64_t kETile = int64_t(kEThreads) * kEItems;

__device__ __forceinline__ int row_dest(const int* dest, int64_t r, int n_dev,
                                        int s, int64_t i) {
  if (i >= r) return n_dev;
  const int d = dest[int64_t(s) * r + i];
  return (d >= 0 && d < n_dev) ? d : n_dev;
}

// hist[(s * n_dev + d) * tiles + tile] = rows of `tile` of source s bound
// for d.  Shared memory: warp_counts[kEWarps][n_dev].
__global__ void route_count(const int* dest, int64_t r, int n_dev, int tiles,
                            int* hist) {
  extern __shared__ int warp_counts[];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int x = tid; x < kEWarps * n_dev; x += kEThreads) warp_counts[x] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * kETile;
  for (int q = 0; q < kEItems; ++q) {
    const int d = row_dest(dest, r, n_dev, s, base + int64_t(q) * kEThreads +
                                                  tid);
    const unsigned peers = __match_any_sync(kFullMask, d);
    // Only the lowest lane of each group writes, and each warp owns its
    // row of warp_counts: no two threads touch one entry.
    if (d < n_dev && lane == __ffs(peers) - 1) {
      warp_counts[warp * n_dev + d] += __popc(peers);
    }
    __syncwarp();  // the next round's leader may be another lane
  }
  __syncthreads();
  for (int d = tid; d < n_dev; d += kEThreads) {
    int sum = 0;
    for (int w = 0; w < kEWarps; ++w) sum += warp_counts[w * n_dev + d];
    hist[(int64_t(s) * n_dev + d) * tiles + blockIdx.x] = sum;
  }
}

// Block b scans row b of hist (one (source, dest) pair): offsets[b][tile]
// is the pair's rows in the tiles before `tile`, totals[b] the row's sum.
__global__ void route_scan(const int* hist, int tiles, int* offsets,
                           int* totals) {
  const int64_t row = int64_t(blockIdx.x) * tiles;
  int run = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? hist[row + i] : 0;
    int sum;
    const int before = block_exclusive_scan<int>(v, sum);
    if (i < tiles) offsets[row + i] = run + before;
    run += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = run;
}

// Shared memory: running[n_dev], then warp_counts[kEWarps][n_dev].
__global__ void route_write(const uint32_t* rows, const int* dest, int64_t r,
                            int n_dev, int w, int tiles, const int* offsets,
                            uint32_t* recv) {
  extern __shared__ int smem[];
  int* running = smem;
  int* warp_counts = smem + n_dev;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int d = tid; d < n_dev; d += kEThreads) {
    running[d] = offsets[(int64_t(s) * n_dev + d) * tiles + blockIdx.x];
  }
  for (int x = tid; x < kEWarps * n_dev; x += kEThreads) warp_counts[x] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * kETile;
  const int64_t out_rows = int64_t(n_dev) * r;
  for (int q = 0; q < kEItems; ++q) {
    const int64_t i = base + int64_t(q) * kEThreads + tid;
    const int d = row_dest(dest, r, n_dev, s, i);
    const unsigned peers = __match_any_sync(kFullMask, d);
    const int rank = __popc(peers & lanes_below);
    if (d < n_dev && rank == 0) warp_counts[warp * n_dev + d] = __popc(peers);
    __syncthreads();
    if (d < n_dev) {
      int64_t pos = running[d] + rank;
      for (int v = 0; v < warp; ++v) pos += warp_counts[v * n_dev + d];
      const uint32_t* src = rows + (int64_t(s) * r + i) * w;
      uint32_t* dst = recv + (int64_t(d) * out_rows + int64_t(s) * r + pos) *
                                 w;
      for (int c = 0; c < w; ++c) dst[c] = src[c];
    }
    __syncthreads();
    for (int dd = tid; dd < n_dev; dd += kEThreads) {
      int add = 0;
      for (int v = 0; v < kEWarps; ++v) {
        add += warp_counts[v * n_dev + dd];
        warp_counts[v * n_dev + dd] = 0;
      }
      running[dd] += add;
    }
    __syncthreads();
  }
}

// One thread per recv row: rows past their (source, dest) total get the
// pad row.
__global__ void route_pad(int64_t r, int n_dev, int w, int k,
                          const int* totals, uint32_t* recv) {
  const int64_t x = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t out_rows = int64_t(n_dev) * r;
  if (x >= int64_t(n_dev) * out_rows) return;
  const int64_t d = x / out_rows;
  const int64_t s = (x % out_rows) / r;
  const int64_t j = x % r;
  if (j < totals[s * n_dev + d]) return;
  uint32_t* dst = recv + x * w;
  for (int c = 0; c < w; ++c) dst[c] = c < k ? 0xFFFFFFFFu : 0u;
}

struct RouteScratch {
  int* hist;
  int* offsets;
  int* totals;
};

RouteScratch carve(void* scratch, int n_dev, int64_t r) {
  const int64_t tiles = ceil_div(r, kETile);
  const int64_t pairs = int64_t(n_dev) * n_dev;
  char* p = static_cast<char*>(scratch);
  RouteScratch s;
  s.hist = reinterpret_cast<int*>(p);
  p += align8(4 * pairs * tiles);
  s.offsets = reinterpret_cast<int*>(p);
  p += align8(4 * pairs * tiles);
  s.totals = reinterpret_cast<int*>(p);
  return s;
}

}  // namespace

extern "C" {

int64_t dsi_route_scratch_bytes(int n_dev, int64_t r) {
  const int64_t tiles = ceil_div(r, kETile);
  const int64_t pairs = int64_t(n_dev) * n_dev;
  return 2 * align8(4 * pairs * tiles) + align8(4 * pairs);
}

// rows [n_dev, r, w] u32; dest [n_dev, r] i32; recv [n_dev, n_dev * r, w]
// u32.  The first k lanes of a row are key lanes (pad 0xFFFFFFFF), the rest
// payload (pad 0).  n_dev in [1, 1024], r >= 1.
int dsi_route(const void* rows, const void* dest, int n_dev, int64_t r,
              int w, int k, void* recv, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* dst = static_cast<const int*>(dest);
  uint32_t* out = static_cast<uint32_t*>(recv);
  RouteScratch s = carve(scratch, n_dev, r);
  const int tiles = int(ceil_div(r, kETile));
  const dim3 grid{unsigned(tiles), unsigned(n_dev)};
  const size_t count_smem = size_t(4) * kEWarps * n_dev;
  route_count<<<grid, kEThreads, count_smem, st>>>(dst, r, n_dev, tiles,
                                                   s.hist);
  DSI_CHECK_LAUNCH();
  route_scan<<<unsigned(n_dev) * unsigned(n_dev), kScanThreads, 0, st>>>(
      s.hist, tiles, s.offsets, s.totals);
  DSI_CHECK_LAUNCH();
  route_write<<<grid, kEThreads, count_smem + size_t(4) * n_dev, st>>>(
      static_cast<const uint32_t*>(rows), dst, r, n_dev, w, tiles, s.offsets,
      out);
  DSI_CHECK_LAUNCH();
  const int64_t all_rows = int64_t(n_dev) * n_dev * r;
  route_pad<<<unsigned(ceil_div(all_rows, 256)), 256, 0, st>>>(
      r, n_dev, w, k, s.totals, out);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
