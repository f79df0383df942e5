// Kernel C: group runs of equal rows of sorted key words.
//
// Replaces the K3 group step of the JAX word-count programs: group_sorted
// (dsi_tpu/ops/wordcount.py:161-196) plus the gathers behind it
// (wordcount.py:406-409, corpus_wc.py:189-192).  A row is valid when its
// first key word is not the pad key; a run starts where any key word
// differs from the previous row.  Outputs, for the first u_cap runs: the
// run's key words, its head row (upos), the sum of its rows' counts, and
// one int32 payload read through the sort's permutation at the head
// (token length, or poslen on the corpus path).  n_unique is the true run
// count even when it exceeds u_cap.  Past n_unique, upos is t-1 and keys,
// totals and payload are 0.
//
// Bound: memory bytes (the sorted keys and counts are read once, the u_cap
// rows written once).
//
// Design: a memset of the look-back state, then two launches.
// (1) One sweep over tiles of kGTile rows, claimed in ticket order.  A
//     thread takes rows at a stride of the block, so a warp loads each key
//     word as 256 contiguous bytes; row i - 1 comes from the neighbouring
//     lane (or, for a warp's first, from shared memory).  Heads are ranked
//     by ballots and per-segment counts (a segment is one warp's 32 rows),
//     the count sums by warp scans; one warp scans the tile's 64 segments
//     and publishes the tile's (heads, count sum), and the block finds its
//     exclusive prefix by decoupled look-back (common.cuh).  Each head
//     with uid <= u_cap then stores the running count sum before it
//     (hc[uid]) and, below u_cap, its row (upos).  The last tile writes
//     n_unique and, when n_unique <= u_cap, the valid rows' count sum at
//     hc[n_unique].  A tile waits on no load after its look-back.
// (2) Over u_cap rows: below n_unique, totals[u] = hc[u + 1] - hc[u] (the
//     total of run u_cap - 1 stops at the head of run u_cap) and the key
//     words and payload gathered through upos[u]; the rest are pad rows.
//     Counts are int64 so the kernel serves u64 tables.

#include "common.cuh"

namespace {

constexpr int kGThreads = 256;
constexpr int kGWarps = kGThreads / 32;
constexpr int kGItems = 8;
// A segment is one warp's 32 rows of one item; segment s holds rows
// [32 s, 32 s + 32) of the tile, so segments run in row order.
constexpr int kGSegs = kGItems * kGWarps;
constexpr int64_t kGTile = int64_t(kGThreads) * kGItems;
static_assert(kGSegs == 64, "one warp scans the segments two a lane");

__global__ void __launch_bounds__(kGThreads, 4)
    g_sweep(const uint64_t* __restrict__ sk, int k64, int64_t t,
            const long long* __restrict__ counts, int64_t u_cap,
            unsigned* ticket, LookBack lb, long long* __restrict__ hc,
            int* __restrict__ upos, int* __restrict__ n_unique) {
  __shared__ int seg_heads[kGSegs];
  __shared__ long long seg_sum[kGSegs];
  __shared__ uint64_t seg_last[kGSegs];  // each segment's last row, a word
  __shared__ uint64_t tile_prev;         // the row before the tile, a word
  __shared__ unsigned tile_heads;  // the tile's aggregate
  __shared__ long long tile_sum;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = claim_tile(ticket);
  const int64_t row0 = tile * kGTile + threadIdx.x;  // item j: + j * kGThreads

  // One round of loads a key word (with word 0, the counts).  Row i - 1
  // comes from the neighbouring lane; a segment's first row takes it from
  // the previous segment's last (shared memory), the tile's first from the
  // row before the tile (row 0's is a pad row, as in the reference).
  long long cnt[kGItems];
  unsigned valid = 0, diff = 0;  // bit j: item j's row
  for (int w = 0; w < k64; ++w) {
    const uint64_t* col = sk + int64_t(w) * t;
    uint64_t v[kGItems];
#pragma unroll
    for (int j = 0; j < kGItems; ++j) {
      const int64_t i = row0 + j * kGThreads;
      v[j] = i < t ? col[i] : ~0ull;
      if (w == 0) cnt[j] = i < t ? counts[i] : 0;
    }
    if (threadIdx.x == 0) {
      tile_prev = tile > 0 ? col[tile * kGTile - 1] : ~0ull;
    }
#pragma unroll
    for (int j = 0; j < kGItems; ++j) {
      if (lane == 31) seg_last[j * kGWarps + warp] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kGItems; ++j) {
      const int s = j * kGWarps + warp;
      uint64_t p = __shfl_up_sync(kFullMask, v[j], 1);
      if (lane == 0) p = s > 0 ? seg_last[s - 1] : tile_prev;
      if (w == 0) valid |= unsigned(v[j] != ~0ull) << j;
      diff |= unsigned(v[j] != p) << j;
    }
    __syncthreads();  // seg_last holds the next word's rows next
  }
  const unsigned heads = valid & diff;

  // Per segment: its heads (a ballot) and its count sum (a warp scan,
  // which also leaves each row's exclusive sum within the segment).
#pragma unroll
  for (int j = 0; j < kGItems; ++j) {
    const long long c = (valid >> j) & 1u ? cnt[j] : 0;
    long long x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFullMask, x, o);
      if (lane >= o) x += y;
    }
    cnt[j] = x - c;
    const unsigned hm = __ballot_sync(kFullMask, (heads >> j) & 1u);
    if (lane == 31) seg_sum[j * kGWarps + warp] = x;
    if (lane == 0) seg_heads[j * kGWarps + warp] = __popc(hm);
  }
  __syncthreads();

  if (warp == 0) {
    // Segments 2 lane and 2 lane + 1: exclusive offsets in place.
    const int h0 = seg_heads[2 * lane], h1 = seg_heads[2 * lane + 1];
    const long long c0 = seg_sum[2 * lane], c1 = seg_sum[2 * lane + 1];
    int h = h0 + h1;
    long long c = c0 + c1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int hy = __shfl_up_sync(kFullMask, h, o);
      const long long cy = __shfl_up_sync(kFullMask, c, o);
      if (lane >= o) {
        h += hy;
        c += cy;
      }
    }
    seg_heads[2 * lane] = h - h0 - h1;
    seg_heads[2 * lane + 1] = h - h1;
    seg_sum[2 * lane] = c - c0 - c1;
    seg_sum[2 * lane + 1] = c - c1;
    if (lane == 31) {
      tile_heads = unsigned(h);
      tile_sum = c;
      lb_publish(lb, tile, tile == 0 ? kLbInclusive : kLbAggregate,
                 unsigned(h), c);
    }
  }
  __syncthreads();

  const unsigned agg_h = tile_heads;
  const long long agg_c = tile_sum;
  unsigned ex_h = 0;
  long long ex_c = 0;
  if (tile > 0) {
    lb_exclusive<kGThreads>(lb, tile, ex_h, ex_c);
    if (threadIdx.x == 0) {
      lb_publish(lb, tile, kLbInclusive, ex_h + agg_h, ex_c + agg_c);
    }
  }
  if (threadIdx.x == 0 && tile == int64_t(gridDim.x) - 1) {
    const int64_t nu = int64_t(ex_h) + agg_h;
    *n_unique = int(nu);
    if (nu <= u_cap) hc[nu] = ex_c + agg_c;
  }

  // Each head with uid <= u_cap: the count sum before it and, below u_cap,
  // its row.  Stores only; the second launch gathers through upos.
  const int64_t uid0 = ex_h;
  if (uid0 > u_cap) return;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kGItems; ++j) {
    const unsigned hm = __ballot_sync(kFullMask, (heads >> j) & 1u);
    if ((heads >> j) & 1u) {
      const int s = j * kGWarps + warp;
      const int64_t uid = uid0 + seg_heads[s] + __popc(hm & below);
      if (uid <= u_cap) {
        hc[uid] = ex_c + seg_sum[s] + cnt[j];
        if (uid < u_cap) upos[uid] = int(row0 + j * kGThreads);
      }
    }
  }
}

// Over u_cap rows: below n_unique the run's total, key words and payload
// (gathered through upos and the sort's permutation); past it a pad row.
__global__ void g_final(const uint64_t* __restrict__ sk, int k64, int64_t t,
                        const int* __restrict__ payload,
                        const int* __restrict__ perm, int64_t u_cap,
                        const int* __restrict__ n_unique,
                        const long long* __restrict__ hc,
                        uint64_t* __restrict__ keys_u,
                        int* __restrict__ upos, int* __restrict__ payload_u,
                        long long* __restrict__ totals) {
  const int64_t u = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= u_cap) return;
  if (u < *n_unique) {
    const int64_t i = upos[u];
    const int pi = payload != nullptr ? perm[i] : 0;
    totals[u] = hc[u + 1] - hc[u];
    for (int w = 0; w < k64; ++w) {
      keys_u[int64_t(w) * u_cap + u] = sk[int64_t(w) * t + i];
    }
    payload_u[u] = payload != nullptr ? payload[pi] : 0;
  } else {
    totals[u] = 0;
    upos[u] = int(t - 1);
    payload_u[u] = 0;
    for (int w = 0; w < k64; ++w) keys_u[int64_t(w) * u_cap + u] = 0;
  }
}

// Scratch: [ticket | status [tiles]] (zeroed each call), sums [2 tiles],
// hc [u_cap + 1].
constexpr int64_t kTicketBytes = 8;

int64_t tiles_of(int64_t t) { return ceil_div(t, kGTile); }

}  // namespace

extern "C" {

int64_t dsi_group_scratch_bytes(int64_t t, int64_t u_cap) {
  return kTicketBytes + 8 * tiles_of(t) + 16 * tiles_of(t) + 8 * (u_cap + 1);
}

// Rows a tile of the sweep (the tile edges chip_smoke.py tests at).
int64_t dsi_group_tile_rows() { return kGTile; }

// sorted_keys [k64, t] u64; counts [t] i64 per sorted row; payload [t] i32
// in pre-sort row order and perm [t] i32 from the sort (both null for no
// payload); keys_u [k64, u_cap] u64; totals [u_cap] i64; upos [u_cap] i32;
// payload_u [u_cap] i32; n_unique [1] i32.
int dsi_group(const void* sorted_keys, int k64, int64_t t, const void* counts,
              const void* payload, const void* perm, int64_t u_cap,
              void* keys_u, void* totals, void* upos, void* payload_u,
              void* n_unique, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(t);
  char* p = static_cast<char*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(p);
  LookBack lb;
  lb.status = reinterpret_cast<unsigned long long*>(p + kTicketBytes);
  lb.sums = reinterpret_cast<long long*>(p + kTicketBytes + 8 * tiles);
  long long* hc = lb.sums + 2 * tiles;
  int* nu = static_cast<int*>(n_unique);
  cudaError_t e = cudaMemsetAsync(p, 0, kTicketBytes + 8 * tiles, st);
  if (e != cudaSuccess) return int(e);
  const uint64_t* sk = static_cast<const uint64_t*>(sorted_keys);
  g_sweep<<<unsigned(tiles), kGThreads, 0, st>>>(
      sk, k64, t, static_cast<const long long*>(counts), u_cap, ticket, lb,
      hc, static_cast<int*>(upos), nu);
  DSI_CHECK_LAUNCH();
  g_final<<<unsigned(ceil_div(u_cap, 256)), 256, 0, st>>>(
      sk, k64, t, static_cast<const int*>(payload),
      static_cast<const int*>(perm), u_cap, nu, hc,
      static_cast<uint64_t*>(keys_u), static_cast<int*>(upos),
      static_cast<int*>(payload_u), static_cast<long long*>(totals));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
