// Kernel B: stable lexicographic sort of k64 u64 key words.
//
// Replaces the K3 sort of the JAX word-count programs: lax.sort over the
// packed key words at dsi_tpu/ops/wordcount.py:401 (tokenize_group_core)
// and dsi_tpu/ops/corpus_wc.py:187 (_corpus_core, is_stable=True).  Keys
// are word-major [k64, t] (2 words at max_word_len 16, 8 at 64).  Output:
// the row permutation and the keys gathered through it.
//
// Bound: memory bytes.  An LSD radix sort moves each (key word,
// permutation) pair in and out once per non-trivial 8-bit pass.
//
// Design.  From the last key word to the first: one histogram sweep of the
// word fills all 8 digit histograms at once (gathering the word through
// the current permutation when a pass has already moved rows); a pass
// whose digit is the same in every row is the identity of a stable sort
// and is skipped on the device, so no count goes back to the host.  Each
// non-trivial pass is one sweep over tiles: a tile ranks its rows by digit
// in input order (__match_any_sync inside a warp plus per-warp digit
// counts in shared memory, no atomics deciding an order), publishes its
// per-digit counts with a status flag, finds its global offsets by
// decoupled look-back over the earlier tiles (Merrill & Garland's
// single-pass scan, as in Onesweep), stages its rows in sorted order in
// shared memory and writes each one once.  Blocks are persistent: each
// claims its next tile before it works on the current one and loads it
// into shared memory with cp.async meanwhile, so the card's memory stays
// busy while blocks rank.  The first pass that moves rows takes the
// permutation from the row index and the word from the input, and the
// final gather writes every word at once.
//
// Two drivers of the same tile code:
//   small t (<= kSmallMax): ONE cooperative launch, at most as many
//     blocks as can be resident (occupancy x SMs, worked out at first
//     use); the blocks run every word's histogram, plan and passes,
//     separated by grid-wide barriers, and the final gather.  A launch the
//     card refuses returns its error; there is no other path.
//   large t: a memset of the state, then per word one histogram launch
//     (whose last block plans the word's passes) and 8 pass launches (a
//     skipped pass returns at once), tiles taken from a ticket counter in
//     claim order so no co-residency is assumed, then one final gather:
//     2 + 9 * k64 launches.
// Optional n_sort (device int32 [1]): only rows below it are sorted; rows
// from n_sort on stay where they are.  Each call leaves in its scratch the
// count of passes it skipped and of passes it ran.

#include "common.cuh"

#include <cooperative_groups.h>

#include <cstddef>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kRsThreads = 256;  // one thread per digit in the scans
constexpr int kRsWarps = kRsThreads / 32;
// Rows a thread per tile and look-back slots loaded at once, each path
// (measured on the H100, PERF.md, PR 11).
constexpr int kSmallItems = 8, kSmallWindow = 8;
constexpr int kLargeItems = 16, kLargeWindow = 4;
constexpr int64_t kSmallTile = int64_t(kRsThreads) * kSmallItems;
// Largest t sorted by the one-launch cooperative path (PERF.md, PR 11).
constexpr int64_t kSmallMax = int64_t(1) << 20;
constexpr int kHistItems = 8;    // rows a thread loads at once, histogram

// pass_src: the side holding a pass's input (bit 0), kIota when the input
// is the raw key word with the row index as permutation, kSkip when the
// pass is the identity.
constexpr int kSkip = -1;
constexpr int kIota = 2;
// Look-back status word: (epoch << 2 | state) << 32 | count.
constexpr unsigned kAggregate = 1, kInclusive = 2;

struct RsState {
  unsigned hist[2][8][256];  // digit counts of word w in hist[w & 1]
  int pass_src[8];
  unsigned ticket[8];
  unsigned done;             // histogram blocks finished
  int side;                  // side holding (keys, perm) of the last pass
  int moved;                 // 0 while the permutation is the row index
  unsigned passes[2];        // passes of this call: skipped, run
};

// Side 0 is the output (sorted keys' word 0, perm); side 1 is scratch.
struct Bufs {
  uint64_t* k[2];
  int* p[2];
};

// One pass's operands: read (kin, pin; pin null: the row index), write
// (kout, pout), the digit starts and the look-back slots [tiles][256].
struct PassArgs {
  const uint64_t* kin;
  const int* pin;
  uint64_t* kout;
  int* pout;
  const int* bases;
  unsigned long long* status;
  int64_t n;
  int shift;
  unsigned epoch;
};

template <int ITEMS>
struct TileSmem {
  uint64_t in_keys[kRsThreads * ITEMS];  // the next tile, as loaded
  int in_perm[kRsThreads * ITEMS];
  uint64_t keys[kRsThreads * ITEMS];     // the tile's rows in sorted order
  int perm[kRsThreads * ITEMS];
  int whist[kRsWarps][256];              // per-warp digit counts, offsets
  int tstart[256];                       // tile-local start of each digit
  int gofs[256];                         // global position of that start
  int bases[256];                        // the pass's digit starts
  long long ticket;
};

constexpr int64_t align16(int64_t bytes) {
  return (bytes + 15) & ~int64_t(15);
}

__device__ __forceinline__ int64_t sort_rows(const int* n_sort, int64_t t) {
  if (n_sort == nullptr) return t;
  const int64_t n = *n_sort;
  return n < 0 ? 0 : (n < t ? n : t);
}

// Loads of the pass buffers through L2 only: other blocks of the one-launch
// path wrote them since this SM last read them.
__device__ __forceinline__ uint64_t ld_l2(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ unsigned long long ld_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ int digit(uint64_t key, int shift) {
  return int((key >> shift) & 255);
}

// Adds the 8 digits of `key` to h[8][256] in shared memory: one add for a
// warp whose lanes agree (common: pad rows, zero high bytes), else one a
// lane.  Every lane of the warp calls it; `ok` marks a real row.
__device__ __forceinline__ void count_digits(unsigned (*h)[256], uint64_t key,
                                             bool ok) {
  const int lane = threadIdx.x & 31;
  const unsigned oks = __ballot_sync(kFullMask, ok);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int d = ok ? digit(key, 8 * p) : -1;
    const int first = __shfl_sync(kFullMask, d, 0);
    if (__all_sync(kFullMask, d == first)) {
      if (lane == 0 && ok) atomicAdd(&h[p][d], __popc(oks));
    } else if (ok) {
      atomicAdd(&h[p][d], 1u);
    }
  }
}

// One sweep over `n` rows of one word: read the word (through the current
// permutation once rows have moved, writing it to the pass buffer) and
// count its 8 digit histograms into `h`.  Blocks take chunks of
// kHistItems rows a thread in grid-stride order, every load of a chunk in
// flight at once.
__device__ void histogram_rows(const uint64_t* keys_w, int64_t n, Bufs b,
                               int side, bool moved, unsigned (*h)[256]) {
  constexpr int64_t kChunk = int64_t(kRsThreads) * kHistItems;
  uint64_t* kb = b.k[side];
  const int* pb = b.p[side];
  for (int64_t base = blockIdx.x * kChunk; base < n;
       base += int64_t(gridDim.x) * kChunk) {
    uint64_t key[kHistItems];
    if (moved) {
      int src[kHistItems];
#pragma unroll
      for (int r = 0; r < kHistItems; ++r) {
        const int64_t i = base + r * kRsThreads + threadIdx.x;
        src[r] = i < n ? __ldcg(pb + i) : 0;
      }
#pragma unroll
      for (int r = 0; r < kHistItems; ++r) {
        const int64_t i = base + r * kRsThreads + threadIdx.x;
        key[r] = i < n ? keys_w[src[r]] : 0ull;
      }
#pragma unroll
      for (int r = 0; r < kHistItems; ++r) {
        const int64_t i = base + r * kRsThreads + threadIdx.x;
        if (i < n) kb[i] = key[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < kHistItems; ++r) {
        const int64_t i = base + r * kRsThreads + threadIdx.x;
        key[r] = i < n ? keys_w[i] : 0ull;
      }
    }
#pragma unroll
    for (int r = 0; r < kHistItems; ++r) {
      count_digits(h, key[r], base + r * kRsThreads + threadIdx.x < n);
    }
  }
}

// One block of kRsThreads plans a word from its 8 histograms `hist`
// (global): which passes are trivial (one digit holds all n rows) and
// where each pass reads.  `side`/`moved` describe the buffers before the
// word; the new values are returned through side_out/moved_out.  The
// skipped passes are added to *skipped unless it is null.
__device__ void plan_word(const unsigned* hist, int64_t n, int side,
                          int moved, int* pass_src, int* side_out,
                          int* moved_out, unsigned* skipped) {
  __shared__ int trivial[8];
  if (threadIdx.x < 8) trivial[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (int64_t(__ldcg(hist + p * 256 + threadIdx.x)) == n) trivial[p] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned skips = 0;
    for (int p = 0; p < 8; ++p) {
      if (trivial[p]) {
        pass_src[p] = kSkip;
        ++skips;
      } else {
        pass_src[p] = side | (moved ? 0 : kIota);
        side ^= 1;
        moved = 1;
      }
    }
    *side_out = side;
    *moved_out = moved;
    if (skipped != nullptr) *skipped += skips;
  }
  __syncthreads();
}

// Every block of a pass: the exclusive start of each digit, from the
// word's count of digit threadIdx.x in `hist` (global).
__device__ __forceinline__ void digit_starts(const unsigned* hist,
                                             int* bases) {
  int total;
  bases[threadIdx.x] =
      block_exclusive_scan<int>(int(__ldcg(hist + threadIdx.x)), total);
}

__device__ __forceinline__ void publish(unsigned long long* slot,
                                        unsigned epoch, unsigned state,
                                        unsigned count) {
  const unsigned long long v =
      (static_cast<unsigned long long>((epoch << 2) | state) << 32) | count;
  *reinterpret_cast<volatile unsigned long long*>(slot) = v;
}

// Exclusive count of this thread's digit over tiles [0, tile) of the pass
// stamped `epoch`: decoupled look-back over slot column `status`, WINDOW
// predecessors' slots loaded at once (a walk then costs one L2 round trip
// per window), each slot up to the first inclusive one waited for.
template <int WINDOW>
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* status, int64_t tile, unsigned epoch) {
  const unsigned agg = (epoch << 2) | kAggregate;
  const unsigned inc = (epoch << 2) | kInclusive;
  unsigned excl = 0;
  for (int64_t j = tile - 1; j >= 0; j -= WINDOW) {
    unsigned long long s[WINDOW];
#pragma unroll
    for (int q = 0; q < WINDOW; ++q) {
      s[q] = j - q >= 0 ? ld_volatile(status + (j - q) * 256) : 0ull;
    }
#pragma unroll
    for (int q = 0; q < WINDOW; ++q) {
      if (j - q < 0) return excl;
      unsigned flag = unsigned(s[q] >> 32);
      while (flag != agg && flag != inc) {
        __nanosleep(32);
        s[q] = ld_volatile(status + (j - q) * 256);
        flag = unsigned(s[q] >> 32);
      }
      excl += unsigned(s[q]);
      if (flag == inc) return excl;
    }
  }
  return excl;
}

// cp.async into shared memory: 16 bytes through L2 only (the pass
// buffers, which other SMs rewrite between passes of the one-launch path),
// or 8 bytes of the read-only input; `bytes` of the source are read, the
// rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async_l2(void* dst, const void* src,
                                            int bytes) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// Start loading tile `tile`'s rows below n into in_keys / in_perm.
template <int ITEMS>
__device__ void prefetch_tile(int64_t tile, const PassArgs& a,
                              TileSmem<ITEMS>& sm) {
  constexpr int kTile = kRsThreads * ITEMS;
  const int64_t row0 = tile * kTile;
  const int64_t left = a.n - row0;
  if (a.pin == nullptr) {  // the raw key word: 8-byte aligned
    for (int c = threadIdx.x; c < kTile && c < left; c += kRsThreads) {
      cp_async_8(&sm.in_keys[c], a.kin + row0 + c);
    }
  } else {
    for (int c = 2 * threadIdx.x; c < kTile && c < left;
         c += 2 * kRsThreads) {
      cp_async_l2(&sm.in_keys[c], a.kin + row0 + c,
                  left - c >= 2 ? 16 : 8);
    }
    for (int c = 4 * threadIdx.x; c < kTile && c < left;
         c += 4 * kRsThreads) {
      cp_async_l2(&sm.in_perm[c], a.pin + row0 + c,
                  left - c >= 4 ? 16 : 4 * int(left - c));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One tile whose rows are in key[] / pm[] (row warp * 32 * ITEMS + r * 32
// + lane of the tile): rank, look back, stage, write.
template <int ITEMS, int WINDOW>
__device__ void sort_tile(int64_t tile, const PassArgs& a,
                          const uint64_t (&key)[ITEMS],
                          const int (&pm)[ITEMS], TileSmem<ITEMS>& sm) {
  constexpr int kTile = kRsThreads * ITEMS;
  constexpr int kSeg = 32 * ITEMS;  // rows of one warp, in input order
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t row0 = tile * kTile + warp * kSeg + lane;
  for (int w = 0; w < kRsWarps; ++w) sm.whist[w][tid] = 0;
  __syncthreads();

  // Rank among the warp's earlier rows of the same digit.
  int rank[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool ok = row0 + r * 32 < a.n;
    const int d = ok ? digit(key[r], a.shift) : -1;
    const unsigned peers = __match_any_sync(kFullMask, d);
    const int before = ok ? sm.whist[warp][d] : 0;
    rank[r] = before + __popc(peers & below);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) {
      sm.whist[warp][d] = before + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();

  // Thread `tid` owns digit tid: per-warp offsets, the tile's count, its
  // publication and the look-back over the earlier tiles.
  int count = 0;
  for (int w = 0; w < kRsWarps; ++w) {
    const int c = sm.whist[w][tid];
    sm.whist[w][tid] = count;
    count += c;
  }
  unsigned long long* mine = a.status + tile * 256 + tid;
  publish(mine, a.epoch, tile == 0 ? kInclusive : kAggregate,
          unsigned(count));
  int total;
  sm.tstart[tid] = block_exclusive_scan<int>(count, total);
  const unsigned excl = look_back<WINDOW>(a.status + tid, tile, a.epoch);
  if (tile > 0) publish(mine, a.epoch, kInclusive, excl + unsigned(count));
  sm.gofs[tid] = a.bases[tid] + int(excl);
  __syncthreads();

  // Stage the tile in sorted order, then write it out run by run.
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (row0 + r * 32 < a.n) {
      const int d = digit(key[r], a.shift);
      const int pos = sm.tstart[d] + sm.whist[warp][d] + rank[r];
      sm.keys[pos] = key[r];
      sm.perm[pos] = pm[r];
    }
  }
  __syncthreads();
  const int64_t left = a.n - tile * kTile;
  const int valid = left < kTile ? int(left) : kTile;
#pragma unroll 4
  for (int j = tid; j < valid; j += kRsThreads) {
    const uint64_t k = sm.keys[j];
    const int d = digit(k, a.shift);
    const int64_t o = int64_t(sm.gofs[d]) + (j - sm.tstart[d]);
    a.kout[o] = k;
    a.pout[o] = sm.perm[j];
  }
}

// The block's tiles of one pass, in increasing order from `next()` (the
// same value in every thread) until it passes the last tile; each tile's
// rows are loaded while the one before is ranked and written.
template <int ITEMS, int WINDOW, class Next>
__device__ void run_pass(const PassArgs& a, Next next, TileSmem<ITEMS>& sm) {
  constexpr int kTile = kRsThreads * ITEMS;
  constexpr int kSeg = 32 * ITEMS;
  const int64_t tiles = ceil_div(a.n, kTile);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int64_t cur = next();
  if (cur < tiles) prefetch_tile(cur, a, sm);
  while (cur < tiles) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    uint64_t key[ITEMS];
    int pm[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int local = warp * kSeg + r * 32 + lane;
      const int64_t i = cur * kTile + local;
      key[r] = i < a.n ? sm.in_keys[local] : 0ull;
      pm[r] = a.pin != nullptr ? sm.in_perm[local] : int(i);
    }
    __syncthreads();  // in_keys / in_perm are free for the next tile
    const int64_t nxt = next();
    if (nxt < tiles) prefetch_tile(nxt, a, sm);
    sort_tile<ITEMS, WINDOW>(cur, a, key, pm, sm);
    cur = nxt;
  }
  __syncthreads();  // the shared tile is reused
}

// Sorted output of row i once every pass has run: the permutation from the
// last pass's side, word 0 from its key buffer, the other words gathered.
__device__ __forceinline__ void write_row(const uint64_t* keys, int k64,
                                         int64_t t, int64_t n, int64_t i,
                                         Bufs b, int side, int moved) {
  if (i >= n || !moved) {
    b.p[0][i] = int(i);
    for (int w = 0; w < k64; ++w) {
      b.k[0][int64_t(w) * t + i] = keys[int64_t(w) * t + i];
    }
    return;
  }
  const int pi = __ldcg(b.p[side] + i);
  if (side != 0) {
    b.p[0][i] = pi;
    b.k[0][i] = ld_l2(b.k[side] + i);
  }
  for (int w = 1; w < k64; ++w) {
    b.k[0][int64_t(w) * t + i] = keys[int64_t(w) * t + pi];
  }
}

__device__ __forceinline__ PassArgs make_pass(const uint64_t* keys_w, int src,
                                              int p, unsigned epoch,
                                              int64_t n, const Bufs& b,
                                              const int* bases,
                                              unsigned long long* status) {
  const int s = src & 1;
  const bool iota = (src & kIota) != 0;
  PassArgs a;
  a.kin = iota ? keys_w : b.k[s];
  a.pin = iota ? nullptr : b.p[s];
  a.kout = b.k[s ^ 1];
  a.pout = b.p[s ^ 1];
  a.bases = bases;
  a.status = status;
  a.n = n;
  a.shift = 8 * p;
  a.epoch = epoch;
  return a;
}

// ── large t: one launch per step ────────────────────────────────────────

__global__ void __launch_bounds__(kRsThreads)
    rs_hist(const uint64_t* keys_w, int w, int64_t t, const int* n_sort,
            Bufs b, RsState* st) {
  __shared__ unsigned h[8][256];
  __shared__ bool last;
  for (int i = threadIdx.x; i < 8 * 256; i += kRsThreads) (&h[0][0])[i] = 0;
  __syncthreads();
  const int64_t n = sort_rows(n_sort, t);
  const int side = *reinterpret_cast<volatile int*>(&st->side);
  const int moved = *reinterpret_cast<volatile int*>(&st->moved);
  histogram_rows(keys_w, n, b, side, moved != 0, h);
  __syncthreads();
  unsigned* hist = &st->hist[w & 1][0][0];
  for (int i = threadIdx.x; i < 8 * 256; i += kRsThreads) {
    const unsigned c = (&h[0][0])[i];
    if (c != 0) atomicAdd(hist + i, c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&st->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block marks the trivial passes and the sides, and resets the
  // per-word state; each pass scans its own digit counts.  The other
  // histogram, last read by the previous word's passes, is the next
  // word's.
  plan_word(hist, n, side, moved, st->pass_src, &st->side, &st->moved,
            &st->passes[0]);
  unsigned* other = &st->hist[(w + 1) & 1][0][0];
  for (int i = threadIdx.x; i < 8 * 256; i += kRsThreads) other[i] = 0;
  if (threadIdx.x < 8) st->ticket[threadIdx.x] = 0;
  if (threadIdx.x == 0) st->done = 0;
}

__global__ void __launch_bounds__(kRsThreads, 2)
    rs_pass(const uint64_t* keys_w, int w, int64_t t, const int* n_sort,
            int p, Bufs b, RsState* st, unsigned long long* status) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<TileSmem<kLargeItems>*>(smem);
  const int src = st->pass_src[p];
  if (src == kSkip) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) ++st->passes[1];
  digit_starts(st->hist[w & 1][p], sm.bases);
  const PassArgs a = make_pass(keys_w, src, p, unsigned(8 * w + p + 1),
                               sort_rows(n_sort, t), b, sm.bases, status);
  run_pass<kLargeItems, kLargeWindow>(a, [&]() -> int64_t {
    if (threadIdx.x == 0) sm.ticket = atomicAdd(&st->ticket[p], 1u);
    __syncthreads();
    return sm.ticket;
  }, sm);
}

__global__ void rs_final(const uint64_t* keys, int k64, int64_t t,
                         const int* n_sort, Bufs b, const RsState* st) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= t) return;
  write_row(keys, k64, t, sort_rows(n_sort, t), i, b, st->side, st->moved);
}

// ── small t: one cooperative launch ─────────────────────────────────────

__global__ void __launch_bounds__(kRsThreads)
    rs_coop(const uint64_t* keys, int k64, int64_t t, const int* n_sort,
            Bufs b, RsState* st, unsigned long long* status,
            int64_t status_words) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<TileSmem<kSmallItems>*>(smem);
  auto h = reinterpret_cast<unsigned (*)[256]>(smem);  // the histogram phase
  __shared__ int pass_src[8];
  __shared__ int word_side, word_moved;

  const int64_t n = sort_rows(n_sort, t);
  const int64_t gtid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t gstride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = gtid; i < status_words; i += gstride) status[i] = 0;
  for (int64_t i = gtid; i < 2 * 8 * 256; i += gstride) {
    (&st->hist[0][0][0])[i] = 0;
  }
  // Block 0 alone counts the passes: every block skips the same ones.
  unsigned* passes = blockIdx.x == 0 ? st->passes : nullptr;
  if (passes != nullptr && threadIdx.x == 0) passes[0] = passes[1] = 0;
  grid.sync();

  int side = 0, moved = 0;
  for (int w = k64 - 1; w >= 0; --w) {
    const uint64_t* kw = keys + int64_t(w) * t;
    unsigned* hist = &st->hist[w & 1][0][0];
    for (int i = threadIdx.x; i < 8 * 256; i += kRsThreads) (&h[0][0])[i] = 0;
    __syncthreads();
    histogram_rows(kw, n, b, side, moved != 0, h);
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * 256; i += kRsThreads) {
      const unsigned c = (&h[0][0])[i];
      if (c != 0) atomicAdd(hist + i, c);
    }
    grid.sync();
    // Every block plans the word from the same counts, so every block
    // skips the same passes and meets the same barriers.  The other
    // histogram buffer is cleared for the next word: every block read it
    // before the barrier above.
    unsigned* other = &st->hist[(w + 1) & 1][0][0];
    for (int64_t i = gtid; i < 8 * 256; i += gstride) other[i] = 0;
    plan_word(hist, n, side, moved, pass_src, &word_side, &word_moved,
              passes);
    bool any = false;
    for (int p = 0; p < 8; ++p) {
      if (pass_src[p] == kSkip) continue;
      any = true;
      if (passes != nullptr && threadIdx.x == 0) ++passes[1];
      digit_starts(hist + p * 256, sm.bases);
      const PassArgs a = make_pass(kw, pass_src[p], p,
                                   unsigned(8 * w + p + 1), n, b, sm.bases,
                                   status);
      int64_t tile = int64_t(blockIdx.x) - int64_t(gridDim.x);
      run_pass<kSmallItems, kSmallWindow>(
          a, [&]() { return tile += gridDim.x; }, sm);
      grid.sync();
    }
    side = word_side;
    moved = word_moved;
    if (!any) grid.sync();  // the cleared histogram before the next word
  }
  for (int64_t i = gtid; i < t; i += gstride) {
    write_row(keys, k64, t, n, i, b, side, moved);
  }
}

struct Carved {
  Bufs b;
  RsState* st;
  unsigned long long* status;
  int64_t status_words;  // enough for the small path's (smaller) tiles
};

Carved carve(void* scratch, void* sorted_keys, void* perm, int64_t t) {
  char* p = static_cast<char*>(scratch);
  Carved c;
  c.b.k[0] = static_cast<uint64_t*>(sorted_keys);
  c.b.p[0] = static_cast<int*>(perm);
  c.b.k[1] = reinterpret_cast<uint64_t*>(p);
  p += align16(8 * t);
  c.b.p[1] = reinterpret_cast<int*>(p);
  p += align16(4 * t);
  c.st = reinterpret_cast<RsState*>(p);
  p += align16(sizeof(RsState));
  c.status = reinterpret_cast<unsigned long long*>(p);
  c.status_words = 256 * ceil_div(t, kSmallTile);
  return c;
}

// Resident blocks of `kern` on the whole card with `smem` bytes of dynamic
// shared memory, and the card's SMs, worked out once per (kernel, device).
struct Resident {
  const void* kern;
  int dev;
  int blocks;
  int sms;
};
// Callers on several host threads share the cache: it is read and filled
// under g_resident_mu.
std::mutex g_resident_mu;
Resident g_resident[64];
int g_n_resident = 0;

template <class Kernel>
int resident_blocks(Kernel kern, int smem, Resident* out) {
  const void* key = reinterpret_cast<const void*>(kern);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  std::lock_guard<std::mutex> lock(g_resident_mu);
  for (int i = 0; i < g_n_resident; ++i) {
    if (g_resident[i].kern == key && g_resident[i].dev == dev) {
      *out = g_resident[i];
      return 0;
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kRsThreads,
                                                    smem);
  if (e != cudaSuccess) return int(e);
  if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  *out = {key, dev, per_sm * sms, sms};
  if (g_n_resident < 64) g_resident[g_n_resident++] = *out;
  return 0;
}

int sort_small(const uint64_t* keys, int k64, int64_t t, const int* n_sort,
               Carved c, cudaStream_t st) {
  const int smem = int(sizeof(TileSmem<kSmallItems>));
  Resident r;
  const int rc = resident_blocks(rs_coop, smem, &r);
  if (rc != 0) return rc;
  const int64_t tiles = ceil_div(t, kSmallTile);
  const unsigned grid = unsigned(tiles < r.blocks ? tiles : r.blocks);
  void* args[] = {&keys, &k64, &t, &n_sort, &c.b, &c.st, &c.status,
                  &c.status_words};
  return int(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rs_coop),
                                         dim3(grid), dim3(kRsThreads), args,
                                         smem, st));
}

int sort_large(const uint64_t* keys, int k64, int64_t t, const int* n_sort,
               Carved c, cudaStream_t st) {
  const int smem = int(sizeof(TileSmem<kLargeItems>));
  Resident r, rh;
  int rc = resident_blocks(rs_pass, smem, &r);
  if (rc != 0) return rc;
  rc = resident_blocks(rs_hist, 0, &rh);
  if (rc != 0) return rc;
  const int64_t tiles = ceil_div(t, kRsThreads * kLargeItems);
  const cudaError_t e = cudaMemsetAsync(
      c.st, 0, align16(sizeof(RsState)) + 8 * 256 * tiles, st);
  if (e != cudaSuccess) return int(e);
  const int64_t chunks = ceil_div(t, kRsThreads * kHistItems);
  const unsigned hist_blocks =
      unsigned(chunks < rh.blocks ? chunks : rh.blocks);
  const unsigned pass_blocks = unsigned(tiles < r.blocks ? tiles : r.blocks);
  for (int w = k64 - 1; w >= 0; --w) {
    const uint64_t* kw = keys + int64_t(w) * t;
    rs_hist<<<hist_blocks, kRsThreads, 0, st>>>(kw, w, t, n_sort, c.b,
                                                 c.st);
    DSI_CHECK_LAUNCH();
    for (int p = 0; p < 8; ++p) {
      rs_pass<<<pass_blocks, kRsThreads, smem, st>>>(kw, w, t, n_sort, p,
                                                     c.b, c.st, c.status);
      DSI_CHECK_LAUNCH();
    }
  }
  rs_final<<<unsigned(ceil_div(t, kRsThreads)), kRsThreads, 0, st>>>(
      keys, k64, t, n_sort, c.b, c.st);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

int64_t dsi_radix_sort_scratch_bytes(int64_t t) {
  return align16(8 * t) + align16(4 * t) + align16(sizeof(RsState)) +
         8 * 256 * ceil_div(t, kSmallTile);
}

// Byte offset in the scratch of a sort of t rows of two u32 that the call
// leaves there: the 8-bit passes it skipped and the passes it ran.
int64_t dsi_radix_sort_passes_offset(int64_t t) {
  return align16(8 * t) + align16(4 * t) + offsetof(RsState, passes);
}

// Largest t that path 0 sorts with the one-launch path.
int64_t dsi_radix_sort_small_max() { return kSmallMax; }

// keys [k64, t] u64 (word 0 most significant); n_sort [1] i32 or null;
// sorted_keys [k64, t] u64; perm [t] i32: sorted_keys[w][i] ==
// keys[w][perm[i]], ties in input order, rows from n_sort on in place.
// path: 0 picks by t, 1 the one-launch path, 2 the one-launch-a-pass path.
int dsi_radix_sort_ex(const void* keys, int k64, int64_t t,
                      const void* n_sort, void* sorted_keys, void* perm,
                      void* scratch, void* stream, int path) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* in = static_cast<const uint64_t*>(keys);
  const int* ns = static_cast<const int*>(n_sort);
  const Carved c = carve(scratch, sorted_keys, perm, t);
  if (path == 0) path = t <= kSmallMax ? 1 : 2;
  switch (path) {
    case 1: return sort_small(in, k64, t, ns, c, st);
    case 2: return sort_large(in, k64, t, ns, c, st);
    default: return int(cudaErrorInvalidValue);
  }
}

int dsi_radix_sort(const void* keys, int k64, int64_t t, void* sorted_keys,
                   void* perm, void* scratch, void* stream) {
  return dsi_radix_sort_ex(keys, k64, t, nullptr, sorted_keys, perm, scratch,
                           stream, 0);
}

}  // extern "C"
