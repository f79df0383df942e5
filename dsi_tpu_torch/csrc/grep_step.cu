// Kernel J: the streaming grep step, with its emit epilogue.
//
// Replaces K16, dsi_tpu/parallel/grepstream.py _grep_step_device (:243),
// run by the reference under shard_map once per device; here one row of
// the [n_dev, N] batch per virtual shard.  Per row, with dlen valid bytes:
//
//   match[i]  = chunk[i + j] == pat[j] for every j (0 past N);
//   line_id[i] = VALID newlines (pos < dlen) strictly before i;
//   n_lines   = valid newlines + 1 if the last valid byte is not '\n'
//               (0 when dlen == 0); overflow = n_lines > l_cap;
//   occ[l]    = sum of match over line l, for l < l_cap (a match whose
//               line is l_cap or later is dropped);
//   over the lines l < min(n_lines, l_cap): hist[min(occ, bins-1)] += 1,
//               matched = lines with occ > 0, occurrences = sum of occ;
//   the k candidates by (occ desc, line asc) among matched lines, as rows
//   [hi, lo, 8, occ, 0] of the global line number base + l (u64 base);
//   rows past n_cand = min(matched, k) are all zeros;
//   hist_ext = [hist, n_lines, matched, occurrences] u32;
//   scal = [n_cand, n_lines, overflow, matched, occurrences] i32.
//
// With emit (K16e, the reference's emit=True branch, :324-339), also:
//
//   keep[i]  = i < dlen && occ[min(line_id[i], l_cap - 1)] > 0 (a line's
//              terminating newline has the line's own id, so it is kept
//              with the line);
//   comp     = the kept bytes in stream order, then zeros to N;
//   kept_n   = the count of kept bytes.
//
// Bound: memory bytes (the batch read once, comp written once; the other
// outputs are tiny).  At the stream's shapes the card sits at launch
// latency, so the design counts launches and passes over the row.
//
// Design: one entry point a step; a memset of the look-back state and the
// tickets, then two launches.
// (1) gs_sweep reads each row once.  Tiles of kTile bytes are claimed in
//     ticket order across the rows and staged in shared memory with
//     16-byte loads (byte loads only at a row's end or for a row that is
//     not 16-byte aligned), with a halo of kHalo bytes that serves the
//     pattern; a longer pattern reads the rest from global memory.  Each
//     thread tests its 64 bytes four to a word (a SIMD-within-a-register
//     byte compare) for newlines and for the pattern's first two bytes,
//     and checks the rest of the pattern at the few candidates.  One
//     block scan ranks the newlines and matches of the tile, and one
//     decoupled look-back (common.cuh) gives the tile's first line and the
//     matches before it.  No count is kept per line: newline j writes
//     cum[j + 1], the matches at or before it, so occ[l] = cum[l + 1] -
//     cum[l] (the row's match total past its last newline), each entry
//     written once by a plain store, with no atomic and no zeroed array.
//     The row's last tile writes its totals; each tile keeps its first
//     line for the emit.
// (2) gs_lines takes work items from one ticket: first the line tiles of
//     kLineTile lines below min(n_lines, l_cap) of every row, then (with
//     emit) the byte tiles again.  A line tile reads its occ from cum,
//     builds its histogram in shared memory (one atomic a warp and
//     bucket), and selects its k least keys in one block-wide step: a
//     radix select on occ (one 8-bit pass a byte of the tile's largest
//     occ, usually one) finds the threshold, and ties are taken in line
//     order by a block scan.  The last line tile of a row to finish (a
//     ticket after __threadfence) merges the tiles' selections: a pool of
//     at most 512 keys in shared memory is cut to the keys at or under the
//     largest key of a tile that kept k (an upper bound on the k-th), and
//     each of those is ranked against the others; a larger pool goes
//     through the same radix select.  It writes every element of cand,
//     scal and hist_ext.  An emit tile reads its bytes once more, rebuilds
//     each byte's line from the sweep's tile offset and its newline masks,
//     takes keep from cum, ranks the kept bytes by a block scan and
//     decoupled look-back, stages them in shared memory and writes them
//     once, coalesced.  With emit the launch is cooperative (the grid at
//     most the resident blocks): after a grid-wide barrier every block
//     writes its share of each row's zero tail, 16 bytes a store.  A
//     launch the card refuses returns its error; there is no other path.

#include "common.cuh"

#include <cooperative_groups.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // one thread a radix bin in the select
constexpr int kWarps = kThreads / 32;
constexpr int kSegs = 2;  // 32-byte segments a thread: 16 KiB a tile
constexpr int kTile = 32 * kSegs * kThreads;
constexpr int kHalo = 64;             // staged bytes past a tile
constexpr int kStaged = kTile + kHalo;
constexpr int kLineItems = 8;  // consecutive lines a thread
constexpr int kLineTile = kLineItems * kThreads;
constexpr int kMaxBins = 64;
constexpr uint64_t kNoKey = ~0ull;
constexpr uint32_t kBig = 0x7FFFFFFFu;
static_assert(kStaged % 16 == 0, "the stage is loaded 16 bytes a thread");
static_assert(kTile < 65536, "a tile's counts pack two to an int");

// Scratch.  The words the call's memset zeroes come first.
struct Scratch {
  unsigned* tickets;                // [2]: the sweep's, the lines launch's
  unsigned* done;                   // [n_dev] line tiles finished
  unsigned long long* sw_status;    // [n_dev * tiles] the sweep's look-back
  unsigned long long* em_status;    // [n_dev * tiles] the emit's look-back
  long long* sw_sums;               // [2 * n_dev * tiles]
  int* line0;                       // [n_dev * tiles] a byte tile's 1st line
  int* rows;                        // [n_dev * 4] n_nl, matches, n_lines, kept
  int* cum;                         // [n_dev * (l_cap + 1)]
  int* lt_stats;                    // [n_dev * ltiles * (bins + 3)]
  uint64_t* lt_keys;                // [n_dev * ltiles * kk]
  uint64_t* sel;                    // [n_dev * k]
  int64_t zero_bytes;
  int64_t total_bytes;
};

Scratch carve(void* scratch, int n_dev, int64_t N, int64_t l_cap, int bins,
              int k) {
  const int64_t tiles = ceil_div(N, kTile);
  const int64_t ltiles = ceil_div(l_cap, kLineTile);
  const int64_t kk = k < kLineTile ? k : kLineTile;
  char* base = static_cast<char*>(scratch);
  int64_t at = 0;
  auto take = [&](int64_t bytes) {
    char* p = base + at;
    at += (bytes + 15) & ~int64_t(15);
    return p;
  };
  Scratch s;
  s.tickets = reinterpret_cast<unsigned*>(take(8));
  s.done = reinterpret_cast<unsigned*>(take(4 * int64_t(n_dev)));
  s.sw_status =
      reinterpret_cast<unsigned long long*>(take(8 * int64_t(n_dev) * tiles));
  s.em_status =
      reinterpret_cast<unsigned long long*>(take(8 * int64_t(n_dev) * tiles));
  s.zero_bytes = at;
  s.sw_sums = reinterpret_cast<long long*>(take(16 * int64_t(n_dev) * tiles));
  s.line0 = reinterpret_cast<int*>(take(4 * int64_t(n_dev) * tiles));
  s.rows = reinterpret_cast<int*>(take(16 * int64_t(n_dev)));
  s.cum = reinterpret_cast<int*>(take(4 * int64_t(n_dev) * (l_cap + 1)));
  s.lt_stats =
      reinterpret_cast<int*>(take(4 * int64_t(n_dev) * ltiles * (bins + 3)));
  s.lt_keys =
      reinterpret_cast<uint64_t*>(take(8 * int64_t(n_dev) * ltiles * kk));
  s.sel = reinterpret_cast<uint64_t*>(take(8 * int64_t(n_dev) * k));
  s.total_bytes = at;
  return s;
}

struct Params {
  const uint8_t* chunks;
  int64_t N;
  const uint8_t* pats;
  int m;
  const int* dlen;
  const int64_t* bases;
  int n_dev;
  int64_t l_cap;
  int bins;
  int k;
  int kk;  // min(k, kLineTile): the keys a line tile keeps
  int64_t tiles;
  int64_t ltiles;
  int* hist_ext;
  int* cand;
  int* scal;
  uint8_t* comp;  // null: no emit
  int* kept;
  Scratch w;
};

__device__ __forceinline__ int64_t clamp_dlen(const int* dlen, int row,
                                              int64_t N) {
  const int64_t d = dlen[row];
  return d < 0 ? 0 : (d > N ? N : d);
}

// Block-wide sums of a and b and maximum of c, every thread gets all
// three (one barrier, then one more before the shared words are reused).
struct Totals {
  long long a, b;
  uint32_t c;
};

__device__ __forceinline__ Totals block_totals(long long a, long long b,
                                               uint32_t c) {
  __shared__ long long sh_a[kWarps], sh_b[kWarps];
  __shared__ uint32_t sh_c[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFullMask, a, o);
    b += __shfl_xor_sync(kFullMask, b, o);
  }
  c = __reduce_max_sync(kFullMask, c);
  if ((threadIdx.x & 31) == 0) {
    sh_a[threadIdx.x >> 5] = a;
    sh_b[threadIdx.x >> 5] = b;
    sh_c[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  Totals t = {0, 0, 0u};
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    t.a += sh_a[i];
    t.b += sh_b[i];
    t.c = sh_c[i] > t.c ? sh_c[i] : t.c;
  }
  __syncthreads();  // the shared words are rewritten by the next call
  return t;
}

// ── (1) the sweep ────────────────────────────────────────────────────────

__global__ void __launch_bounds__(kThreads, 8)
    gs_sweep(const __grid_constant__ Params P) {
  __shared__ __align__(16) uint8_t sb[kStaged];
  __shared__ uint8_t sp[kHalo + 1];
  const Scratch& w = P.w;
  const int64_t item = claim_tile(w.tickets);
  const int row = int(item / P.tiles);
  const int64_t tile = item - int64_t(row) * P.tiles;
  const int64_t base = tile * kTile;
  const int64_t N = P.N;
  const int m = P.m;
  const uint8_t* c = P.chunks + int64_t(row) * N;
  const uint8_t* pat = P.pats + int64_t(row) * m;
  const int64_t dl = clamp_dlen(P.dlen, row, N);

  // Stage bytes [base, base + kStaged), zero past N, and the pattern's
  // first kHalo + 1 bytes.
  const bool aligned = (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  for (int v = threadIdx.x; v < kStaged / 16; v += kThreads) {
    const int64_t g = base + 16 * int64_t(v);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (aligned && g + 16 <= N) {
      x = __ldg(reinterpret_cast<const uint4*>(c + g));
    } else if (g < N) {
      uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b) {  // static indices keep wv in registers
        if (g + b < N) wv[b >> 2] |= uint32_t(c[g + b]) << (8 * (b & 3));
      }
      x = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    *reinterpret_cast<uint4*>(sb + 16 * v) = x;
  }
  if (threadIdx.x <= kHalo && int(threadIdx.x) < m) {
    sp[threadIdx.x] = pat[threadIdx.x];
  }
  __syncthreads();

  // This thread's 64 bytes, two 32-byte segments: valid newlines and
  // match starts as masks.
  const int p0 = 32 * kSegs * threadIdx.x;  // tile-relative
  uint32_t nlm[kSegs], mm[kSegs];
  int my_nl = 0, my_m = 0;
#pragma unroll
  for (int sg = 0; sg < kSegs; ++sg) {
    const int ps = p0 + 32 * sg;
    const int64_t gs = base + ps;
    const uint4 q0 = *reinterpret_cast<const uint4*>(sb + ps);
    const uint4 q1 = *reinterpret_cast<const uint4*>(sb + ps + 16);
    const uint32_t wd[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    nlm[sg] = eq32(wd, 10) & low_bits(dl - gs);
    uint32_t x = eq32(wd, sp[0]) & low_bits(N - gs);
    if (m > 1) {  // the second byte, one position on (byte 32 from the stage)
      x &= (eq32(wd, sp[1]) >> 1) | (sb[ps + 32] == sp[1] ? 0x80000000u : 0u);
    }
    for (uint32_t cand = m > 2 ? x : 0u; cand != 0; cand &= cand - 1) {
      const int b = __ffs(cand) - 1;
      bool hit = true;
      for (int j = 2; j < m && hit; ++j) {
        const int64_t q = ps + b + j;
        const uint8_t y =
            q < kStaged ? sb[q] : (base + q < N ? c[base + q] : 0);
        hit = y == (j <= kHalo ? sp[j] : pat[j]);
      }
      if (!hit) x &= ~(1u << b);
    }
    mm[sg] = x;
    my_nl += __popc(nlm[sg]);
    my_m += __popc(x);
  }

  // Rank newlines and matches in the tile, then across tiles.
  int packed;
  const int off = block_exclusive_scan<int>(my_nl | (my_m << 16), packed);
  const unsigned t_nl = unsigned(packed) & 0xFFFFu;
  const unsigned t_m = unsigned(packed) >> 16;
  LookBack lb;
  lb.status = w.sw_status + int64_t(row) * P.tiles;
  lb.sums = w.sw_sums + 2 * int64_t(row) * P.tiles;
  if (threadIdx.x == 0) {
    lb_publish(lb, tile, tile == 0 ? kLbInclusive : kLbAggregate, t_nl, t_m);
  }
  unsigned nl_before = 0;
  long long m_before = 0;
  if (tile > 0) {
    lb_exclusive<kThreads>(lb, tile, nl_before, m_before);
    if (threadIdx.x == 0) {
      lb_publish(lb, tile, kLbInclusive, nl_before + t_nl, m_before + t_m);
    }
  }

  // Newline j ends line j: cum[j + 1] = the matches at or before it.
  int* cum = w.cum + int64_t(row) * (P.l_cap + 1);
  int before = int(m_before) + (off >> 16);
  int64_t j = int64_t(nl_before) + (off & 0xFFFF);
#pragma unroll
  for (int sg = 0; sg < kSegs; ++sg) {
    for (uint32_t x = nlm[sg]; x != 0 && j < P.l_cap; x &= x - 1, ++j) {
      const int b = __ffs(x) - 1;
      cum[j + 1] = before + __popc(mm[sg] & (0xFFFFFFFFu >> (31 - b)));
    }
    before += __popc(mm[sg]);
  }
  if (threadIdx.x == 0) {
    w.line0[int64_t(row) * P.tiles + tile] = int(nl_before);
    if (tile == P.tiles - 1) {
      const int n_nl = int(nl_before + t_nl);
      int* r = w.rows + 4 * row;
      r[0] = n_nl;
      r[1] = int(m_before + t_m);
      r[2] = n_nl + (dl > 0 && c[dl - 1] != 10 ? 1 : 0);
    }
  }
}

// ── (2) lines, merge and emit ────────────────────────────────────────────

// The row's matches before line j starts (j <= n_lines): occ[l] =
// before_line(l + 1) - before_line(l).
__device__ __forceinline__ int before_line(const int* cum, int64_t j,
                                           int64_t n_nl, int total) {
  return j == 0 ? 0 : j <= n_nl ? __ldcg(cum + j) : total;
}

// A block-wide top-k over a sequence of items, 8 a thread a chunk (item
// order: chunk, then thread, then slot), each an occ (0: no candidate) and
// its key.  The k largest occ, ties in item order, are the items with occ
// > T and the first `need` with occ == T.  select_threshold finds T and
// need by a radix select (one 8-bit pass a byte of max_occ; every thread
// owns a bin); it is called only with more than k candidates.
template <class Load>
__device__ __forceinline__ void select_threshold(int64_t n_chunks,
                                                 uint32_t max_occ, int k,
                                                 Load load, uint32_t& T,
                                                 int& need) {
  __shared__ int hist[kThreads];
  __shared__ int s_digit, s_need;
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  int rest = k;
  const int bytes = max_occ < 256 ? 1 : (32 - __clz(max_occ) + 7) / 8;
  for (int pass = bytes - 1; pass >= 0; --pass) {
    const int shift = 8 * pass;
    hist[threadIdx.x] = 0;
    __syncthreads();
    for (int64_t ch = 0; ch < n_chunks; ++ch) {
      uint32_t occ[kLineItems];
      uint64_t key[kLineItems];
      load(ch, occ, key);
#pragma unroll
      for (int q = 0; q < kLineItems; ++q) {
        const uint32_t o = occ[q];
        const bool in = o > 0 && (uint64_t(o) >> (shift + 8)) == prefix;
        const int d = in ? int((o >> shift) & 255u) : kThreads;
        const unsigned peers = __match_any_sync(kFullMask, d);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
      }
    }
    __syncthreads();
    const int bin = kThreads - 1 - int(threadIdx.x);
    const int v = hist[bin];
    int all;
    const int above = block_exclusive_scan<int>(v, all);  // digits > bin
    if (above < rest && rest <= above + v) {
      s_digit = bin;
      s_need = rest - above;
    }
    __syncthreads();
    prefix = (prefix << 8) | uint32_t(s_digit);
    rest = s_need;
    __syncthreads();  // s_digit and hist are rewritten by the next pass
  }
  T = prefix;
  need = rest;
}

// Stores the selected keys in item order through store(pos, key); returns
// their count.  With every_tie (at most k candidates: T 1, need k) the
// ties are not ranked.
template <class Load, class Store>
__device__ __forceinline__ int select_store(int64_t n_chunks, uint32_t T,
                                            int need, bool every_tie,
                                            Load load, Store store) {
  int ties_before = 0, taken_before = 0;
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    uint32_t occ[kLineItems];
    uint64_t key[kLineItems];
    load(ch, occ, key);
    int ties = 0;
#pragma unroll
    for (int q = 0; q < kLineItems; ++q) ties += occ[q] == T ? 1 : 0;
    int all_ties = 0;
    int tie = every_tie ? 0
                        : ties_before +
                              block_exclusive_scan<int>(ties, all_ties);
    bool take[kLineItems];
    int n_take = 0;
#pragma unroll
    for (int q = 0; q < kLineItems; ++q) {
      take[q] = occ[q] > T || (occ[q] == T && (every_tie || tie++ < need));
      n_take += take[q] ? 1 : 0;
    }
    int all_take;
    int pos = taken_before + block_exclusive_scan<int>(n_take, all_take);
#pragma unroll
    for (int q = 0; q < kLineItems; ++q) {
      if (take[q]) store(pos++, key[q]);
    }
    ties_before += all_ties;
    taken_before += all_take;
  }
  return taken_before;
}

// A pool of at most this many keys is ranked in shared memory when its
// candidates fit a block; a larger one goes through the radix select.
constexpr int kSmallPool = 2 * kThreads;

__device__ __forceinline__ void write_cand(int* cand, int rank, uint64_t x,
                                           uint64_t base) {
  const uint64_t g = base + (x & 0xFFFFFFFFull);
  int* o = cand + rank * 5;
  o[0] = int(uint32_t(g >> 32));
  o[1] = int(uint32_t(g));
  o[2] = 8;
  o[3] = int(kBig - uint32_t(x >> 32));
  o[4] = 0;
}

// The top-k of a whole row from its line tiles' selections (the pool, in
// line order, kNoKey past each tile's count), ordered by rank, and every
// element of the row's cand, scal and hist_ext.
__device__ void merge_row(const Params& P, int row, int64_t used,
                          uint64_t* smem) {
  __shared__ int m_hist[kMaxBins];
  const Scratch& w = P.w;
  const int stride = P.bins + 3;
  const int* stats = w.lt_stats + int64_t(row) * P.ltiles * stride;
  const uint64_t* keys = w.lt_keys + int64_t(row) * P.ltiles * P.kk;
  const int n_lines = __ldcg(w.rows + 4 * row + 2);
  const uint64_t base = uint64_t(P.bases[row]);
  const int64_t pool = used * P.kk;
  auto pool_key = [&](int64_t v) {
    return v < pool ? __ldcg(keys + v) : kNoKey;
  };
  // A small pool's keys, two a thread, load with the stats below.
  const bool small = pool <= kSmallPool;
  uint64_t pk[2] = {kNoKey, kNoKey};
  if (small) {
#pragma unroll
    for (int q = 0; q < 2; ++q) pk[q] = pool_key(q * kThreads + threadIdx.x);
  }

  // The tiles' histograms, totals and largest occ, one load a thread.
  for (int b = threadIdx.x; b < P.bins; b += kThreads) m_hist[b] = 0;
  __syncthreads();
  int m_part = 0;
  long long o_part = 0;
  uint32_t mx = 0;
  for (int64_t i = threadIdx.x; i < used * stride; i += kThreads) {
    const int f = int(i % stride);
    const int v = __ldcg(stats + i);
    if (f < P.bins) {
      if (v != 0) atomicAdd(&m_hist[f], v);
    } else if (f == P.bins) {
      m_part += v;
    } else if (f == P.bins + 1) {
      o_part += v;
    } else {
      mx = uint32_t(v) > mx ? uint32_t(v) : mx;
    }
  }
  const Totals tot = block_totals(m_part, o_part, mx);  // completes m_hist
  const int matched = int(tot.a);
  const long long occurrences = tot.b;
  int* h = P.hist_ext + int64_t(row) * (P.bins + 3);
  for (int b = threadIdx.x; b < P.bins; b += kThreads) h[b] = m_hist[b];

  int* cand = P.cand + int64_t(row) * P.k * 5;
  const int n_cand = matched < P.k ? matched : P.k;
  bool ranked = false;  // block-uniform
  if (small) {
    // An upper bound on the k-th least key is the largest key of any tile
    // that kept k keys (its list is full); every pool key below a key at
    // or under it is at or under it too, so such a key's rank among these
    // candidates is its rank in the pool, its row in cand.
    __shared__ __align__(16) uint64_t sp[kSmallPool];
    __shared__ uint64_t s_cand[kThreads];
    __shared__ uint64_t s_bound[kWarps];
#pragma unroll
    for (int q = 0; q < 2; ++q) sp[q * kThreads + threadIdx.x] = pk[q];
    __syncthreads();
    uint64_t bound = kNoKey;
    if (int64_t(threadIdx.x) < used && P.kk == P.k &&
        sp[(threadIdx.x + 1) * P.kk - 1] != kNoKey) {
      bound = 0;
      for (int j = 0; j < P.kk; ++j) {
        const uint64_t y = sp[threadIdx.x * P.kk + j];
        bound = y > bound ? y : bound;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t y = __shfl_xor_sync(kFullMask, bound, o);
      bound = y < bound ? y : bound;
    }
    if ((threadIdx.x & 31) == 0) s_bound[threadIdx.x >> 5] = bound;
    __syncthreads();
    bound = kNoKey;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      bound = s_bound[i] < bound ? s_bound[i] : bound;
    }
    const bool in0 = pk[0] != kNoKey && pk[0] <= bound;
    const bool in1 = pk[1] != kNoKey && pk[1] <= bound;
    int n_in;
    int at = block_exclusive_scan<int>(int(in0) + int(in1), n_in);
    if (n_in <= kThreads) {
      if (in0) s_cand[at++] = pk[0];
      if (in1) s_cand[at] = pk[1];
      __syncthreads();
      if (int(threadIdx.x) < n_in) {
        const uint64_t x = s_cand[threadIdx.x];
        int rank = 0;
        for (int j = 0; j < n_in; ++j) rank += s_cand[j] < x ? 1 : 0;
        if (rank < P.k) write_cand(cand, rank, x, base);
      }
      ranked = true;
    }
  }
  if (!ranked) {
    const int64_t chunks = ceil_div(pool, kLineTile);
    auto load = [&](int64_t ch, uint32_t (&occ)[kLineItems],
                    uint64_t (&key)[kLineItems]) {
      const int64_t v0 = ch * kLineTile + int64_t(threadIdx.x) * kLineItems;
#pragma unroll
      for (int q = 0; q < kLineItems; ++q) {
        key[q] = pool_key(v0 + q);
        occ[q] = key[q] == kNoKey ? 0u : kBig - uint32_t(key[q] >> 32);
      }
    };
    uint32_t T = 1;
    int need = P.k;
    if (matched > P.k) select_threshold(chunks, tot.c, P.k, load, T, need);
    // The winners in shared memory when they fit (the block's stage).
    uint64_t* sel = P.k <= kTile / 8 ? smem : w.sel + int64_t(row) * P.k;
    select_store(chunks, T, need, matched <= P.k, load,
                 [&](int pos, uint64_t key) { sel[pos] = key; });
    __syncthreads();  // sel complete
    // The winners in (occ desc, line asc) order: a key's rank among them.
    for (int i = threadIdx.x; i < n_cand; i += kThreads) {
      const uint64_t x = sel[i];
      int rank = 0;
      for (int q = 0; q < n_cand; ++q) rank += sel[q] < x ? 1 : 0;
      write_cand(cand, rank, x, base);
    }
  }
  for (int64_t i = int64_t(n_cand) * 5 + threadIdx.x; i < int64_t(P.k) * 5;
       i += kThreads) {
    cand[i] = 0;
  }
  if (threadIdx.x == 0) {
    h[P.bins] = n_lines;
    h[P.bins + 1] = matched;
    h[P.bins + 2] = int(occurrences);
    int* sc = P.scal + int64_t(row) * 5;
    sc[0] = n_cand;
    sc[1] = n_lines;
    sc[2] = int64_t(n_lines) > P.l_cap ? 1 : 0;
    sc[3] = matched;
    sc[4] = int(occurrences);
  }
}

// Line tile lt of a row with `used` line tiles (its lines below
// min(n_lines, l_cap)).
__device__ void line_tile(const Params& P, int row, int64_t lt, int64_t used,
                          uint64_t* smem) {
  __shared__ int sh_hist[kMaxBins];
  __shared__ int s_last;
  const Scratch& w = P.w;
  const int* r = w.rows + 4 * row;
  const int lane = threadIdx.x & 31;
  const int* cum = w.cum + int64_t(row) * (P.l_cap + 1);
  const int64_t l0 = lt * kLineTile + int64_t(threadIdx.x) * kLineItems;
  // cum[l0 .. l0 + 8], loaded with the row's totals (an index past l_cap
  // reads cum[l_cap]; its value is not used).
  int cv[kLineItems + 1];
#pragma unroll
  for (int q = 0; q <= kLineItems; ++q) {
    cv[q] = __ldcg(cum + (l0 + q < P.l_cap ? l0 + q : P.l_cap));
  }
  const int64_t n_nl = r[0];
  const int total = r[1];
  const int64_t n_lines = r[2];
  const int64_t lim = n_lines < P.l_cap ? n_lines : P.l_cap;
  auto before = [&](int q) {  // before_line(l0 + q) from cv
    const int64_t j = l0 + q;
    return j == 0 ? 0 : j <= n_nl ? cv[q] : total;
  };

  for (int b = threadIdx.x; b < P.bins; b += kThreads) sh_hist[b] = 0;
  __syncthreads();
  uint32_t occ[kLineItems];
  int matched = 0;
  long long occurrences = 0;
  uint32_t mx = 0;
  int prev = before(0);
#pragma unroll
  for (int q = 0; q < kLineItems; ++q) {
    const int64_t l = l0 + q;
    occ[q] = 0;
    if (l < lim) {
      const int next = before(q + 1);
      occ[q] = uint32_t(next - prev);
      prev = next;
      matched += occ[q] > 0 ? 1 : 0;
      occurrences += occ[q];
      mx = occ[q] > mx ? occ[q] : mx;
    }
    // Bucket 0 holds the lines without a match (all lines when bins is 1)
    // and is counted from the totals; a warp with a matched line counts
    // its buckets with one atomic a bucket.
    const bool hit = occ[q] > 0 && P.bins > 1;
    if (__any_sync(kFullMask, hit)) {
      const int bucket = !hit ? kMaxBins
                         : occ[q] < uint32_t(P.bins - 1) ? int(occ[q])
                                                         : P.bins - 1;
      const unsigned peers = __match_any_sync(kFullMask, bucket);
      if (hit && lane == __ffs(peers) - 1) {
        atomicAdd(&sh_hist[bucket], __popc(peers));
      }
    }
  }
  const Totals tot = block_totals(matched, occurrences, mx);  // and sh_hist
  const int t_matched = int(tot.a);
  const long long t_occ = tot.b;
  mx = tot.c;

  auto load = [&](int64_t, uint32_t (&o)[kLineItems],
                  uint64_t (&key)[kLineItems]) {
#pragma unroll
    for (int q = 0; q < kLineItems; ++q) {
      o[q] = occ[q];
      key[q] = (uint64_t(kBig - occ[q]) << 32) | uint64_t(l0 + q);
    }
  };
  uint32_t T = 1;
  int need = P.k;
  if (t_matched > P.k) select_threshold(1, mx, P.k, load, T, need);
  const int64_t slot = int64_t(row) * P.ltiles + lt;
  uint64_t* keys = w.lt_keys + slot * P.kk;
  const int n_sel =
      select_store(1, T, need, t_matched <= P.k, load,
                   [&](int pos, uint64_t key) { keys[pos] = key; });
  for (int q = n_sel + threadIdx.x; q < P.kk; q += kThreads) keys[q] = kNoKey;
  int* st = w.lt_stats + slot * (P.bins + 3);
  for (int b = threadIdx.x + 1; b < P.bins; b += kThreads) st[b] = sh_hist[b];
  if (threadIdx.x == 0) {
    const int64_t lines = lim - lt * kLineTile;
    st[0] = int(lines < kLineTile ? lines : kLineTile) -
            (P.bins > 1 ? t_matched : 0);
    st[P.bins] = t_matched;
    st[P.bins + 1] = int(t_occ);
    st[P.bins + 2] = int(mx);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(w.done + row, 1u) == used - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    merge_row(P, row, used, smem);
  }
}

__device__ void emit_tile(const Params& P, int row, int64_t tile,
                          uint8_t* out) {
  const Scratch& w = P.w;
  const int64_t N = P.N;
  const uint8_t* c = P.chunks + int64_t(row) * N;
  const int64_t dl = clamp_dlen(P.dlen, row, N);
  const int64_t g0 = tile * kTile + 32 * kSegs * int64_t(threadIdx.x);
  const int* r = w.rows + 4 * row;
  const int64_t n_nl = r[0];
  const int total = r[1];
  const int64_t line0 = w.line0[int64_t(row) * P.tiles + tile];
  uint32_t wd[kSegs][8];
  if ((reinterpret_cast<uintptr_t>(c) & 15) == 0 && g0 + 32 * kSegs <= N) {
    const uint4* v = reinterpret_cast<const uint4*>(c + g0);
#pragma unroll
    for (int sg = 0; sg < kSegs; ++sg) {
      const uint4 q0 = __ldg(v + 2 * sg), q1 = __ldg(v + 2 * sg + 1);
      wd[sg][0] = q0.x; wd[sg][1] = q0.y; wd[sg][2] = q0.z; wd[sg][3] = q0.w;
      wd[sg][4] = q1.x; wd[sg][5] = q1.y; wd[sg][6] = q1.z; wd[sg][7] = q1.w;
    }
  } else {
#pragma unroll
    for (int sg = 0; sg < kSegs; ++sg) {
#pragma unroll
      for (int q = 0; q < 8; ++q) wd[sg][q] = 0u;
    }
#pragma unroll
    for (int b = 0; b < 32 * kSegs; ++b) {  // static indices, as above
      if (g0 + b < N) {
        wd[b >> 5][(b >> 2) & 7] |= uint32_t(c[g0 + b]) << (8 * (b & 3));
      }
    }
  }
  uint32_t valid[kSegs], nlm[kSegs];
  int n_nl_here = 0;
#pragma unroll
  for (int sg = 0; sg < kSegs; ++sg) {
    valid[sg] = low_bits(dl - (g0 + 32 * sg));
    nlm[sg] = eq32(wd[sg], 10) & valid[sg];
    n_nl_here += __popc(nlm[sg]);
  }
  int unused;
  const int nl_off = block_exclusive_scan<int>(n_nl_here, unused);

  // keep: the bytes up to and including a newline are one line.  Whether
  // this thread's first kBatch lines keep their bytes comes from one batch
  // of loads; a thread with more lines loads the rest one by one.
  const int* cum = w.cum + int64_t(row) * (P.l_cap + 1);
  const int64_t first = line0 + nl_off;
  auto kept_line = [&](int64_t l) {
    const int64_t lc = l < P.l_cap - 1 ? l : P.l_cap - 1;
    return before_line(cum, lc + 1, n_nl, total) >
           before_line(cum, lc, n_nl, total);
  };
  constexpr int kBatch = 8;
  uint32_t batch = 0;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    batch |= kept_line(first + i) ? 1u << i : 0u;
  }
  uint32_t keep[kSegs];
  int n_keep = 0;
  int line = 0;  // this thread's line, counted from `first`
#pragma unroll
  for (int sg = 0; sg < kSegs; ++sg) {
    keep[sg] = 0;
    uint32_t x = nlm[sg];
    for (int start = 0; start < 32 && (valid[sg] >> start) != 0;) {
      const int end = x != 0 ? __ffs(x) - 1 : 31;
      if (line < kBatch ? (batch >> line) & 1u : kept_line(first + line)) {
        keep[sg] |= (0xFFFFFFFFu >> (31 - end)) & (0xFFFFFFFFu << start);
      }
      if (x != 0) {  // a newline ends the line; else it runs on
        x &= x - 1;
        ++line;
      }
      start = end + 1;
    }
    keep[sg] &= valid[sg];
    n_keep += __popc(keep[sg]);
  }

  int t_kept;
  const int k_off = block_exclusive_scan<int>(n_keep, t_kept);
  LookBack lb;
  lb.status = w.em_status + int64_t(row) * P.tiles;
  lb.sums = nullptr;
  if (threadIdx.x == 0) {
    lb_publish(lb, tile, tile == 0 ? kLbInclusive : kLbAggregate,
               unsigned(t_kept), 0);
  }
  unsigned k_before = 0;
  if (tile > 0) {
    long long unused_sum;
    lb_exclusive<kThreads>(lb, tile, k_before, unused_sum);
    if (threadIdx.x == 0) {
      lb_publish(lb, tile, kLbInclusive, k_before + unsigned(t_kept), 0);
    }
  }
  // The kept bytes in order, each word's by static indices (a byte index
  // taken from a mask would put wd in local memory).
  int at = k_off;
#pragma unroll
  for (int sg = 0; sg < kSegs; ++sg) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t kb = (keep[sg] >> (4 * q)) & 15u;
      if (kb == 0) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((kb >> i) & 1u) out[at++] = uint8_t(wd[sg][q] >> (8 * i));
      }
    }
  }
  __syncthreads();
  uint8_t* dst = P.comp + int64_t(row) * N + k_before;
  for (int i = threadIdx.x; i < t_kept; i += kThreads) dst[i] = out[i];
  if (threadIdx.x == 0 && tile == P.tiles - 1) {
    const int kn = int(k_before) + t_kept;
    P.kept[row] = kn;
    w.rows[4 * row + 3] = kn;
  }
}

// Zeros over comp's bytes [lo, hi) by the whole grid, 16 bytes a store
// between the edges.
__device__ void zero_tail(uint8_t* comp, int64_t lo, int64_t hi) {
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  int64_t a = lo + ((16 - (reinterpret_cast<uintptr_t>(comp + lo) & 15)) & 15);
  if (a > hi) a = hi;
  const int64_t b = a + (hi - a) / 16 * 16;
  for (int64_t i = lo + tid; i < a; i += stride) comp[i] = 0;
  for (int64_t i = b + tid; i < hi; i += stride) comp[i] = 0;
  uint4* body = reinterpret_cast<uint4*>(comp + a);
  for (int64_t i = tid; i < (b - a) / 16; i += stride) {
    body[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The line tiles of a row: those below min(n_lines, l_cap), at least one.
__device__ __forceinline__ int64_t used_tiles(const Params& P, int row) {
  const int64_t n_lines = P.w.rows[4 * row + 2];
  const int64_t lim = n_lines < P.l_cap ? n_lines : P.l_cap;
  return lim > 0 ? ceil_div(lim, kLineTile) : 1;
}

__global__ void __launch_bounds__(kThreads, 4)
    gs_lines(const __grid_constant__ Params P) {
  // An emit tile's kept bytes or the merge's winners.
  __shared__ __align__(16) uint64_t stage[kTile / 8];
  // The line items of every row (their rows' totals load while the first
  // ticket is claimed).
  const int64_t n_lines0 =
      int(threadIdx.x) < P.n_dev ? P.w.rows[4 * threadIdx.x + 2] : 0;
  int64_t item = claim_tile(P.w.tickets + 1);
  long long mine = 0, line_items;
  if (int(threadIdx.x) < P.n_dev) {
    const int64_t lim = n_lines0 < P.l_cap ? n_lines0 : P.l_cap;
    mine = lim > 0 ? ceil_div(lim, kLineTile) : 1;
  }
  for (int r = threadIdx.x + kThreads; r < P.n_dev; r += kThreads) {
    mine += used_tiles(P, r);
  }
  block_exclusive_scan<long long>(mine, line_items);
  const int64_t items =
      line_items + (P.comp != nullptr ? int64_t(P.n_dev) * P.tiles : 0);
  for (; item < items; item = claim_tile(P.w.tickets + 1)) {
    if (item < line_items) {
      int row = 0;
      int64_t lt = item, used = used_tiles(P, 0);
      while (lt >= used) {
        lt -= used;
        used = used_tiles(P, ++row);
      }
      line_tile(P, row, lt, used, stage);
    } else {
      const int64_t e = item - line_items;
      const int row = int(e / P.tiles);
      emit_tile(P, row, e - int64_t(row) * P.tiles,
                reinterpret_cast<uint8_t*>(stage));
    }
    __syncthreads();  // the claimed ticket's shared word is rewritten next
  }
  if (P.comp == nullptr) return;
  cg::this_grid().sync();  // every row's kept_n is known
  // The rows' kept_n, loaded together, then each row's tail.
  constexpr int kRows = kTile / 8;
  for (int r0 = 0; r0 < P.n_dev; r0 += kRows) {
    const int rn = P.n_dev - r0 < kRows ? P.n_dev - r0 : kRows;
    for (int r = threadIdx.x; r < rn; r += kThreads) {
      stage[r] = uint64_t(__ldcg(P.w.rows + 4 * (r0 + r) + 3));
    }
    __syncthreads();
    for (int r = 0; r < rn; ++r) {
      const int64_t row = r0 + r;
      zero_tail(P.comp, row * P.N + int64_t(stage[r]), (row + 1) * P.N);
    }
    __syncthreads();  // stage is rewritten by the next rows
  }
}

// Blocks of gs_lines resident on the current device at once, worked out
// once per device (the cooperative launch's grid).
std::mutex g_resident_mu;
int g_resident[64];

int resident_blocks(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 0 || dev >= 64) return int(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(g_resident_mu);
  if (g_resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gs_lines,
                                                      kThreads, 0);
    if (e != cudaSuccess) return int(e);
    if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
    g_resident[dev] = per_sm * sms;
  }
  *out = g_resident[dev];
  return 0;
}

}  // namespace

extern "C" {

// Bytes a tile of the sweep and lines a line tile (the edges chip_smoke.py
// and the shared edge cases place their bytes and lines at).
int64_t dsi_grep_step_tile_bytes() { return kTile; }
int64_t dsi_grep_step_line_tile() { return kLineTile; }

int64_t dsi_grep_step_scratch_bytes(int n_dev, int64_t N, int64_t l_cap,
                                    int bins, int k) {
  return carve(nullptr, n_dev, N, l_cap, bins, k).total_bytes;
}

// chunks [n_dev, N] u8; pats [n_dev, m] u8; dlen [n_dev] i32; bases
// [n_dev] u64; hist_ext [n_dev, bins + 3] u32; cand [n_dev, k, 5] u32;
// scal [n_dev, 5] i32; comp [n_dev, N] u8 (not aliasing chunks) and kept
// [n_dev] i32, both null for a step without emit.  Every element of the
// outputs is written here.
int dsi_grep_step(const void* chunks, int n_dev, int64_t N, const void* pats,
                  int m, const void* dlen, const void* bases, int64_t l_cap,
                  int bins, int k, void* hist_ext, void* cand, void* scal,
                  void* comp, void* kept, void* scratch, void* stream) {
  if (n_dev < 1 || N < 1 || N > 0x7FFFFFFF || m < 1 || l_cap < 1 ||
      l_cap >= 0x7FFFFFFF || bins < 1 || bins > kMaxBins || k < 1 ||
      (comp == nullptr) != (kept == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params P;
  P.chunks = static_cast<const uint8_t*>(chunks);
  P.N = N;
  P.pats = static_cast<const uint8_t*>(pats);
  P.m = m;
  P.dlen = static_cast<const int*>(dlen);
  P.bases = static_cast<const int64_t*>(bases);
  P.n_dev = n_dev;
  P.l_cap = l_cap;
  P.bins = bins;
  P.k = k;
  P.kk = k < kLineTile ? k : kLineTile;
  P.tiles = ceil_div(N, kTile);
  P.ltiles = ceil_div(l_cap, kLineTile);
  P.hist_ext = static_cast<int*>(hist_ext);
  P.cand = static_cast<int*>(cand);
  P.scal = static_cast<int*>(scal);
  P.comp = static_cast<uint8_t*>(comp);
  P.kept = static_cast<int*>(kept);
  P.w = carve(scratch, n_dev, N, l_cap, bins, k);
  int resident = 0;
  const int rc = resident_blocks(&resident);
  if (rc != 0) return rc;
  cudaError_t e = cudaMemsetAsync(scratch, 0, size_t(P.w.zero_bytes), s);
  if (e != cudaSuccess) return int(e);
  gs_sweep<<<unsigned(int64_t(n_dev) * P.tiles), kThreads, 0, s>>>(P);
  DSI_CHECK_LAUNCH();
  const int64_t items = int64_t(n_dev) * P.ltiles +
                        (comp != nullptr ? int64_t(n_dev) * P.tiles : 0);
  const unsigned grid = unsigned(items < resident ? items : resident);
  if (comp == nullptr) {
    gs_lines<<<grid, kThreads, 0, s>>>(P);
    DSI_CHECK_LAUNCH();
    return 0;
  }
  void* args[] = {&P};
  return int(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gs_lines),
                                         dim3(grid), dim3(kThreads), args, 0,
                                         s));
}

}  // extern "C"
