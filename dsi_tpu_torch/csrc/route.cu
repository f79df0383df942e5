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
// Bound: memory bytes (rows and dests read once, recv written once).  At
// the mesh shapes recv is n_dev times the rows and almost all pad, so the
// pad's write is most of the bound.
//
// Design: a memset of n_dev tickets and two launches over (tile, source)
// blocks; a tile is T = dsi_route_tile_rows(w) rows, T * w words at most
// kStageWords.
//  (1) route_count reads its tile's dests (16-byte loads where aligned)
//      and counts them per destination.  Each warp walks a contiguous
//      stretch of the tile 32 rows at a time; a __match_any_sync group adds
//      its size to the warp's own counter through its lowest lane, so no
//      atomic decides anything.  The last block of a source in (a ticket
//      after __threadfence) turns that source's tile counts into each
//      tile's first slot per destination and each pair's total, one warp a
//      destination.
//  (2) route_write ranks each row stably among the tile's rows of its
//      destination the same way (its warp's count before it plus its
//      group's lanes below it), stages the tile's rows in shared memory
//      (coalesced 16-byte loads; none when every row of the tile is
//      dropped), and writes destination by destination:
//      each destination's run is one contiguous range of recv words,
//      written with consecutive threads on consecutive words.  Then it
//      writes its share of its source's pad rows: for each destination the
//      pair's pad rows [s*r + total, s*r + r) are one contiguous word
//      range, which the source's tiles split at 16-byte boundaries and fill
//      with 16-byte stores.  Every recv word is written exactly once.
// Every per-destination counter lives in shared memory for every n_dev the
// contract allows: at n_dev 1024 and w 7 the write pass takes about 81 KB
// (above 48 KB the launch opts in to it), so no n_dev needs another path.

#include "common.cuh"

namespace {

constexpr int kEThreads = 256;
constexpr int kEWarps = kEThreads / 32;
constexpr int kStageWords = 8192;  // 32 KB of staged rows a tile
constexpr int kMaxTileRows = 2048;
// A one-row tile of this width still fits the write pass's shared memory
// beside the counters of 1024 destinations.
constexpr int kMaxWidth = 32768;

int tile_rows(int w) {
  int t = 1;
  while (2 * t <= kMaxTileRows && int64_t(2 * t) * w <= kStageWords) t *= 2;
  return t;
}

__device__ __forceinline__ int clamp_dest(int d, int n_dev) {
  return (d >= 0 && d < n_dev) ? d : n_dev;
}

// sd[0, n) = the tile's dests at g[0, n), each outside [0, n_dev) as n_dev;
// 16-byte loads between a scalar head and tail.
__device__ void load_dests(const int* g, int n, int n_dev, int* sd) {
  int head = int((4 - ((reinterpret_cast<uintptr_t>(g) >> 2) & 3)) & 3);
  head = head < n ? head : n;
  const int nv = (n - head) >> 2;
  const int4* gv = reinterpret_cast<const int4*>(g + head);
  for (int v = threadIdx.x; v < nv; v += kEThreads) {
    const int4 x = gv[v];
    int* o = sd + head + 4 * v;
    o[0] = clamp_dest(x.x, n_dev);
    o[1] = clamp_dest(x.y, n_dev);
    o[2] = clamp_dest(x.z, n_dev);
    o[3] = clamp_dest(x.w, n_dev);
  }
  const int tail = head + 4 * nv;
  const int x = threadIdx.x;
  if (x < head) sd[x] = clamp_dest(g[x], n_dev);
  if (x < n - tail) sd[tail + x] = clamp_dest(g[tail + x], n_dev);
}

// Warp w walks rows [w * stretch, (w + 1) * stretch) of the tile in order,
// 32 at a time, and counts them per destination in its own counters
// wcnt[w][.]; with `rank`, rank[i] = the rows of i's destination before i
// in the warp's stretch.  Rows at or past n, or with dest n_dev, count for
// nothing.  Every lane of a warp runs the same number of rounds.
__device__ void warp_count(const int* sd, int n, int stretch, int n_dev,
                           int* wcnt, int* rank) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* mine = wcnt + warp * n_dev;
  const int lo = warp * stretch;
  for (int c = 0; c < stretch; c += 32) {
    const int i = lo + c + lane;
    const int d = (c + lane < stretch && i < n) ? sd[i] : n_dev;
    const unsigned peers = __match_any_sync(kFullMask, d);
    if (d < n_dev && rank != nullptr) {
      rank[i] = mine[d] + __popc(peers & below);
    }
    __syncwarp();  // every lane has read mine[d] before its leader adds
    if (d < n_dev && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    __syncwarp();
  }
}

__host__ __device__ inline int stretch_of(int tile) {
  return (tile + kEWarps - 1) / kEWarps;
}

// hist[(s * n_dev + d) * tiles + tile] becomes the rows of source s bound
// for d in the tiles before `tile`, totals[s * n_dev + d] the pair's rows.
// Shared memory: sd[T], wcnt[kEWarps][n_dev].
__global__ void __launch_bounds__(kEThreads)
    route_count(const int* dest, int64_t r, int n_dev, int tile, int tiles,
                int* hist, int* totals, unsigned* tickets) {
  extern __shared__ int cshared[];
  __shared__ bool last;
  int* sd = cshared;
  int* wcnt = cshared + tile;
  const int s = blockIdx.y;
  const int64_t row0 = int64_t(blockIdx.x) * tile;
  const int n = int(r - row0 < tile ? r - row0 : tile);
  load_dests(dest + int64_t(s) * r + row0, n, n_dev, sd);
  for (int x = threadIdx.x; x < kEWarps * n_dev; x += kEThreads) wcnt[x] = 0;
  __syncthreads();
  warp_count(sd, n, stretch_of(tile), n_dev, wcnt, nullptr);
  __syncthreads();
  int* src_hist = hist + int64_t(s) * n_dev * tiles;
  for (int d = threadIdx.x; d < n_dev; d += kEThreads) {
    int sum = 0;
    for (int v = 0; v < kEWarps; ++v) sum += wcnt[v * n_dev + d];
    src_hist[int64_t(d) * tiles + blockIdx.x] = sum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + s, 1u) == unsigned(tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int d = warp; d < n_dev; d += kEWarps) {
    int* h = src_hist + int64_t(d) * tiles;
    int run = 0;
    for (int c = 0; c < tiles; c += 32) {
      const int i = c + lane;
      const int v = i < tiles ? __ldcg(h + i) : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
      }
      if (i < tiles) h[i] = run + x - v;
      run += __shfl_sync(kFullMask, x, 31);
    }
    if (lane == 0) totals[int64_t(s) * n_dev + d] = run;
  }
}

// The boundary between tile t - 1's and tile t's shares of the pad words
// [lo, hi): a 16-byte boundary of recv (whose word 0 sits `mis` words past
// one), non-decreasing in t, lo at t = 0 and hi at t = tiles.
__device__ __forceinline__ int64_t pad_split(int64_t lo, int64_t hi, int t,
                                             int tiles, int mis) {
  if (t <= 0) return lo;
  if (t >= tiles) return hi;
  int64_t x = lo + (hi - lo) * t / tiles;
  x -= (x + mis) & 3;
  return x < lo ? lo : x;
}

// recv words [a, b) become pad: word x is 0xFFFFFFFF when x % w < k, else
// 0 (every recv row starts at a multiple of w words); 16-byte stores
// between a scalar head and tail.
__device__ void fill_pad(uint32_t* recv, int64_t a, int64_t b, int w, int k,
                         int mis) {
  if (a >= b) return;
  int64_t a4 = a + ((4 - ((a + mis) & 3)) & 3);
  a4 = a4 < b ? a4 : b;
  const int64_t nv = (b - a4) >> 2;
  const int64_t tail = a4 + 4 * nv;
  const int x = threadIdx.x;
  if (x < a4 - a) recv[a + x] = (a + x) % w < k ? ~0u : 0u;
  if (x < b - tail) recv[tail + x] = (tail + x) % w < k ? ~0u : 0u;
  int p = int((a4 + 4 * int64_t(x)) % w);
  const int step = int((4 * int64_t(kEThreads)) % w);
  uint4* out = reinterpret_cast<uint4*>(recv + a4);
  for (int64_t v = x; v < nv; v += kEThreads) {
    uint32_t val[4];
    int q = p;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      val[i] = q < k ? ~0u : 0u;
      q = q + 1 == w ? 0 : q + 1;
    }
    out[v] = make_uint4(val[0], val[1], val[2], val[3]);
    p += step;
    if (p >= w) p -= w;
  }
}

struct WriteSmem {
  uint32_t* stage;  // T * w + 3 words
  int* sd;          // [T]
  int* rank;        // [T]
  int* order;       // [T]: tile row at each sorted position
  int* wcnt;        // [kEWarps][n_dev]
  long long* base;  // [n_dev]: recv row of sorted position 0 of each dest
};

__host__ __device__ inline int64_t stage_bytes(int tile, int w) {
  return ((int64_t(tile) * w + 3 + 3) & ~int64_t(3)) * 4;
}

__host__ __device__ inline int64_t write_smem_bytes(int tile, int w,
                                                    int n_dev) {
  return stage_bytes(tile, w) + 3 * 4 * int64_t(tile) +
         align8(4 * int64_t(kEWarps) * n_dev) + 8 * int64_t(n_dev);
}

__device__ WriteSmem carve_write(unsigned char* p, int tile, int w,
                                 int n_dev) {
  WriteSmem m;
  m.stage = reinterpret_cast<uint32_t*>(p);
  p += stage_bytes(tile, w);
  m.sd = reinterpret_cast<int*>(p);
  m.rank = m.sd + tile;
  m.order = m.rank + tile;
  m.wcnt = m.order + tile;
  p += 3 * 4 * int64_t(tile) + align8(4 * int64_t(kEWarps) * n_dev);
  m.base = reinterpret_cast<long long*>(p);
  return m;
}

__global__ void __launch_bounds__(kEThreads)
    route_write(const uint32_t* rows, const int* dest, int64_t r, int n_dev,
                int w, int k, int tile, int tiles, const int* offsets,
                const int* totals, uint32_t* recv) {
  extern __shared__ __align__(16) unsigned char wshared[];
  __shared__ int n_sorted;
  const WriteSmem m = carve_write(wshared, tile, w, n_dev);
  const int s = blockIdx.y;
  const int t = blockIdx.x;
  const int64_t row0 = int64_t(t) * tile;
  const int n = int(r - row0 < tile ? r - row0 : tile);
  const int stretch = stretch_of(tile);
  load_dests(dest + int64_t(s) * r + row0, n, n_dev, m.sd);
  for (int x = threadIdx.x; x < kEWarps * n_dev; x += kEThreads) {
    m.wcnt[x] = 0;
  }
  __syncthreads();
  warp_count(m.sd, n, stretch, n_dev, m.wcnt, m.rank);
  __syncthreads();

  // Per destination: the warps' counts become each warp's first rank, and
  // the tile's counts, scanned over destinations, each destination's
  // first sorted position; base maps a sorted position to its recv row.
  int carry = 0;
  for (int c = 0; c < n_dev; c += kEThreads) {
    const int d = c + threadIdx.x;
    int cnt = 0;
    if (d < n_dev) {
      for (int v = 0; v < kEWarps; ++v) {
        const int x = m.wcnt[v * n_dev + d];
        m.wcnt[v * n_dev + d] = cnt;
        cnt += x;
      }
    }
    int sum;
    const int start = carry + block_exclusive_scan<int>(cnt, sum);
    if (d < n_dev) {
      // wcnt[v][d] now counts from the destination's first sorted position.
      for (int v = 0; v < kEWarps; ++v) m.wcnt[v * n_dev + d] += start;
      m.base[d] = (int64_t(d) * n_dev + s) * r +
                  offsets[(int64_t(s) * n_dev + d) * tiles + t] - start;
    }
    carry += sum;
  }
  if (threadIdx.x == 0) n_sorted = carry;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kEThreads) {
    const int d = m.sd[i];
    if (d < n_dev) m.order[m.wcnt[(i / stretch) * n_dev + d] + m.rank[i]] = i;
  }
  // A tile whose rows are all dropped (past a shard's valid rows, as most
  // of the mesh shapes' tiles are) reads none of them.
  const uint32_t* st =
      n_sorted > 0
          ? load_words<kEThreads>(rows + (int64_t(s) * r + row0) * w, n * w,
                                  m.stage)
          : nullptr;
  __syncthreads();

  // The data rows: sorted position q's word c goes to recv row base + q.
  const int words = n_sorted * w;
  for (int x = threadIdx.x; x < words; x += kEThreads) {
    const int q = x / w;
    const int c = x - q * w;
    const int i = m.order[q];
    recv[(m.base[m.sd[i]] + q) * w + c] = st[i * w + c];
  }

  // This tile's share of its source's pad rows, destination by destination.
  const int mis = int((reinterpret_cast<uintptr_t>(recv) >> 2) & 3);
  for (int d = 0; d < n_dev; ++d) {
    const int64_t pair0 = (int64_t(d) * n_dev + s) * r;
    const int64_t lo = (pair0 + totals[int64_t(s) * n_dev + d]) * w;
    const int64_t hi = (pair0 + r) * w;
    fill_pad(recv, pad_split(lo, hi, t, tiles, mis),
             pad_split(lo, hi, t + 1, tiles, mis), w, k, mis);
  }
}

struct RouteScratch {
  int* hist;
  int* totals;
  unsigned* tickets;
};

RouteScratch carve(void* scratch, int n_dev, int64_t tiles) {
  const int64_t pairs = int64_t(n_dev) * n_dev;
  char* p = static_cast<char*>(scratch);
  RouteScratch s;
  s.hist = reinterpret_cast<int*>(p);
  p += align8(4 * pairs * tiles);
  s.totals = reinterpret_cast<int*>(p);
  p += align8(4 * pairs);
  s.tickets = reinterpret_cast<unsigned*>(p);
  return s;
}

}  // namespace

extern "C" {

// The rows a tile of kernel E holds for rows of w words.
int64_t dsi_route_tile_rows(int w) { return tile_rows(w); }

// Where, in bytes from the start of the scratch, dsi_route leaves
// totals[s * n_dev + d] (i32): the rows of source s routed to d, so that
// recv[d][s * r, s * r + totals[s * n_dev + d]) are that pair's rows and
// the rest of its block pad.
int64_t dsi_route_totals_offset(int n_dev, int64_t r, int w) {
  return align8(4 * int64_t(n_dev) * n_dev * ceil_div(r, tile_rows(w)));
}

int64_t dsi_route_scratch_bytes(int n_dev, int64_t r, int w) {
  const int64_t tiles = ceil_div(r, tile_rows(w));
  const int64_t pairs = int64_t(n_dev) * n_dev;
  return align8(4 * pairs * tiles) + align8(4 * pairs) + 4 * int64_t(n_dev);
}

// rows [n_dev, r, w] u32; dest [n_dev, r] i32; recv [n_dev, n_dev * r, w]
// u32.  The first k lanes of a row are key lanes (pad 0xFFFFFFFF), the rest
// payload (pad 0).  n_dev in [1, 1024], r >= 1, 1 <= w <= kMaxWidth.
// scratch holds dsi_route_scratch_bytes(n_dev, r, w) bytes, 4-byte aligned.
int dsi_route(const void* rows, const void* dest, int n_dev, int64_t r,
              int w, int k, void* recv, void* scratch, void* stream) {
  if (n_dev < 1 || n_dev > 1024 || r < 1 || w < 1 || w > kMaxWidth ||
      k < 0 || k > w) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = tile_rows(w);
  const int64_t tiles = ceil_div(r, tile);
  if (tiles > 0x7FFFFFFF) return int(cudaErrorInvalidValue);
  RouteScratch s = carve(scratch, n_dev, tiles);
  cudaError_t e = cudaMemsetAsync(s.tickets, 0, 4 * size_t(n_dev), st);
  if (e != cudaSuccess) return int(e);
  const dim3 grid{unsigned(tiles), unsigned(n_dev)};
  const size_t count_smem = 4 * (size_t(tile) + size_t(kEWarps) * n_dev);
  route_count<<<grid, kEThreads, count_smem, st>>>(
      static_cast<const int*>(dest), r, n_dev, tile, int(tiles), s.hist,
      s.totals, s.tickets);
  DSI_CHECK_LAUNCH();
  const size_t write_smem = size_t(write_smem_bytes(tile, w, n_dev));
  if (write_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(route_write,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(write_smem));
    if (e != cudaSuccess) return int(e);
  }
  route_write<<<grid, kEThreads, write_smem, st>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int*>(dest), r,
      n_dev, w, k, tile, int(tiles), s.hist, s.totals,
      static_cast<uint32_t*>(recv));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
