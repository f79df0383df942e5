// Kernel H: grep line flags for literal, class and alternation patterns.
//
// Replaces K13, dsi_tpu/ops/grepk.py grep_kernel (:116) with
// line_flags_from_match (:61), and K14, dsi_tpu/ops/regexk.py
// classgrep_kernel (:198); one call also serves an alternation of such
// branches, whose flags the reference ORs (dsi_tpu/ops/altk.py:134,
// jnp.maximum).  A branch is m positions, each a set of bytes (a literal's
// one byte, a class's ranges), and the two anchors:
//
//   match[i]   = some branch accepts chunk[i + j] at each of its positions
//                j (0 past n, as _shift_left zero-fills), with ^ the byte
//                before i is '\n' (or i == 0), with $ the byte at i + m is
//                '\n' or 0;
//   line_id[i] = newlines strictly before i;
//   line_match[l] = max of match over the positions of line l, for
//                l < l_cap (jax.ops.segment_max: a line with no position
//                keeps INT32_MIN, the reference's empty-segment value);
//   n_lines    = newlines in the whole chunk + 1; overflow = n_lines > l_cap.
//
// The same pass serves kernel I (csrc/nfa.cu): given a per-position mask
// in place of a pattern, dsi_line_flags_prezeroed gives the same three
// outputs.
//
// Bound: memory bytes (the chunk read once, the flags written once).
//
// Design: one pass, a memset of the look-back state and one kernel a call
// (kernel I zeroes the state in its own first launch, so no memset there).
// (1) The pattern is a launch argument (GrepSpec, 1,052 bytes, built on the
//     host by ops/grepk.py grep_spec; its table staged in shared memory): a
//     256-entry table of 32-bit masks for a Shift-And word that holds every
//     branch, branch k in bits [o_k, o_k + m_k) in REVERSE order (bit
//     o_k + j stands for position m_k - 1 - j).  The word runs backwards
//     over the bytes, D = (((D << 1) & keep) | inject) & table[byte]: after
//     byte e, bit o_k + j is set iff bytes e .. e + j match the branch's
//     last j + 1 positions, so a branch's last bit is set exactly where a
//     match STARTS and a match belongs to the line of the byte that sets
//     it, whatever its branch's length.  $ is in the injection (a branch's
//     first bit enters only where the byte after, read one step before, is
//     '\n' or 0), ^ in the test (a branch's last bit counts only at a line
//     start).  A literal longer than the word (32 bytes) keeps its first 32
//     in the word and checks the rest at the word's hits, from the launch's
//     arguments up to kTailInline bytes, else from a copy on the card.
// (2) Tiles of kTile bytes, block b taking tiles b, b + grid, ...: a
//     cooperative launch of at most the resident blocks, so no ticket and a
//     tile waits only on lower tiles of running blocks.  A thread takes 32
//     positions, one bit each, and loads its bytes and kWarm + 1 more (its
//     neighbour's, from L1) straight into registers with 16-byte loads, so
//     the loads start with the kernel and no barrier stands between them
//     and the test: newlines by a SIMD-within-a-register compare, hits by
//     the word over the 32 bytes and kWarm more (a template parameter, 4
//     for branches of at most 5 positions, else 32, so every loop unrolls;
//     with the warm-up of 4 as two interleaved chains of 16 positions), its
//     steps without the anchors' tests where no branch has ^ or $ (a second
//     template parameter).  No byte is loaded a position at a time.
//     (Measured on the H100, `the` at 2 MiB: tiles from a ticket cost ~1 us
//     more a call, release/acquire status words and a single chain ~1 us,
//     the anchors' tests ~0.6 us; a shared-memory stage of the tile with a
//     halo took as long as these loads.)
// (3) A line is a segment: each thread's pair (newlines, whether the line
//     still open at its end has a hit) goes through one block scan and one
//     decoupled look-back over tiles (status word state << 32 | lines << 1
//     | hit) with the segmented combine seg_combine, which gives each thread
//     its first line id and that line's flag so far.  Each line's flag is
//     stored once, with a plain store, by the thread that holds its
//     newline; the chunk's last line by the thread that holds byte n - 1,
//     which also stores n_lines and overflow.  No atomic, no pre-fill.
// (4) After its tiles a block waits for the last tile's inclusive prefix
//     (n_lines) and stores its share of the INT_MIN tail [n_lines, l_cap)
//     with 16-byte stores.

#include <climits>
#include <cstring>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;  // positions a thread, one bit each in a word
constexpr int64_t kTile = int64_t(kThreads) * kItems;  // 8 KiB
constexpr int kTailInline = 2048;

// The pattern (ops/grepk.py grep_spec packs the same layout).
struct GrepSpec {
  uint32_t table[256];  // bit b: the byte is accepted at word bit b
  uint32_t keep;        // ~ every branch's first bit
  uint32_t inj;         // first bits of the branches without $
  uint32_t inj_eol;     // first bits of the branches with $
  uint32_t last;        // last bits of the branches without ^
  uint32_t last_bol;    // last bits of the branches with ^
  int32_t m_max;        // the longest branch in the word, 1 .. 32
  int32_t tail_len;     // a long literal's bytes past the word, else 0
};
static_assert(sizeof(GrepSpec) == 1052, "the host packs 1,052 bytes");

// A long literal's bytes past the word: in `bytes`, or on the card at dev.
struct Tail {
  const uint8_t* dev;
  uint8_t bytes[kTailInline];
};

struct Lines {
  const uint8_t* chunk;
  int64_t n;
  int64_t l_cap;
  int* line_match;
  int* scalars;
  unsigned long long* status;    // [tiles], zeroed before the launch
  int64_t tiles;
};

// Kernels' ids for the resident-block cache: the mask pass, the long
// literal's, then the word's four (with and without anchors x warm-ups).
enum { kMaskKernel, kWordLong, kWord, kKernels = kWord + 4 };

// A tile's status word carries its whole value (no sum slot to order), so
// it is stored and loaded with relaxed order: one 64-bit access, no fence.
__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        int64_t tile, unsigned state,
                                        uint32_t value) {
  st_relaxed(status + tile,
             (static_cast<unsigned long long>(state) << 32) | value);
}

// (lines, open-line hit) pairs packed as lines << 1 | hit; a before b.
// Associative, 0 the identity: lines add; the open line's hit is b's when
// b has a newline, else a's or b's.
__device__ __forceinline__ uint32_t seg_combine(uint32_t a, uint32_t b) {
  const uint32_t nb = b >> 1;
  return (((a >> 1) + nb) << 1) | (nb != 0 ? (b & 1u) : ((a | b) & 1u));
}

// Exclusive seg_combine scan of one value per thread in thread order;
// `total` gets the block's.  Every thread must call it.
__device__ uint32_t block_seg_scan(uint32_t v, uint32_t& total) {
  __shared__ uint32_t warp_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x = seg_combine(y, x);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < kWarps ? warp_tot[lane] : 0u;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s = seg_combine(y, s);
    }
    if (lane < kWarps) warp_tot[lane] = s;
  }
  __syncthreads();
  uint32_t ex = __shfl_up_sync(kFullMask, x, 1);
  if (lane == 0) ex = 0;
  const uint32_t r = seg_combine(warp > 0 ? warp_tot[warp - 1] : 0u, ex);
  total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return r;
}

// The exclusive prefix of tile `tile` over tiles [0, tile) by the whole
// block, as common.cuh's lb_exclusive walks it (a window of kThreads
// predecessors a round trip, stopping at the nearest inclusive prefix),
// with seg_combine taken in tile order in place of the sums.
__device__ uint32_t lines_look_back(const unsigned long long* status,
                                    int64_t tile) {
  __shared__ unsigned inc_mask[kWarps];
  __shared__ uint32_t warp_val[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t acc = 0;  // the tiles after the current window, in order
  for (int64_t j = tile - 1; j >= 0; j -= kThreads) {
    const int64_t q = j - threadIdx.x;
    unsigned long long word = 0;
    unsigned state = kLbInclusive;  // before tile 0: an empty prefix
    if (q >= 0) {
      word = ld_relaxed(status + q);
      state = unsigned(word >> 32);
      while (state == 0) {
        __nanosleep(32);
        word = ld_relaxed(status + q);
        state = unsigned(word >> 32);
      }
    }
    const unsigned m = __ballot_sync(kFullMask, state == kLbInclusive);
    if (lane == 0) inc_mask[warp] = m;
    __syncthreads();
    int stop = kThreads - 1;
    bool found = false;
    for (int x = kWarps - 1; x >= 0; --x) {
      if (inc_mask[x] != 0) {
        stop = 32 * x + __ffs(inc_mask[x]) - 1;
        found = true;
      }
    }
    // Thread t holds tile j - t: a higher thread is an earlier tile.
    uint32_t v = q >= 0 && int(threadIdx.x) <= stop ? uint32_t(word) : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_down_sync(kFullMask, v, o);
      if (lane + o < 32) v = seg_combine(y, v);
    }
    if (lane == 0) warp_val[warp] = v;
    __syncthreads();
    uint32_t win = 0;
#pragma unroll
    for (int x = kWarps - 1; x >= 0; --x) win = seg_combine(win, warp_val[x]);
    acc = seg_combine(win, acc);
    __syncthreads();  // the shared words are rewritten by the next window
    if (found) break;
  }
  return acc;
}

// K little-endian words of the chunk from byte q (q % 16 == 0), 0 outside
// [0, n): 16-byte loads, byte loads only at the chunk's ends or where the
// chunk is not 16-byte aligned.
template <int K>
__device__ __forceinline__ void load_words(const uint8_t* c, int64_t n,
                                           int64_t q, uint32_t (&w)[K]) {
  const bool aligned = (reinterpret_cast<uintptr_t>(c) & 15) == 0;
#pragma unroll
  for (int v = 0; v < (K + 3) / 4; ++v) {
    const int64_t g = q + 16 * v;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (aligned && g >= 0 && g + 16 <= n) {
      x = __ldg(reinterpret_cast<const uint4*>(c + g));
    } else if (g + 16 > 0 && g < n) {
      uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b) {  // static indices keep wv in registers
        if (g + b >= 0 && g + b < n) {
          wv[b >> 2] |= uint32_t(__ldg(c + g + b)) << (8 * (b & 3));
        }
      }
      x = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * v + i < K) w[4 * v + i] = xs[i];
    }
  }
}

// Bit k set where byte k of the first 8 words is c.
template <int K>
__device__ __forceinline__ uint32_t bytes_eq(const uint32_t (&w)[K],
                                             uint8_t c) {
  const uint32_t c4 = 0x01010101u * c;
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) m |= eq4(w[q], c4) << (4 * q);
  return m;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// One step of the word down to byte k (nxt: byte k + 1), recording a hit
// at k when k is one of the thread's positions.  Without anchors (kAnchors
// false: no branch has ^ or $) neither the byte after nor the line start
// is looked at.
template <bool kAnchors, int K>
__device__ __forceinline__ void word_step(const uint32_t (&w)[K], int k,
                                          bool record, uint32_t bol,
                                          const uint32_t* T,
                                          const GrepSpec& sp, uint32_t& d,
                                          uint32_t& nxt, uint32_t& hits) {
  const uint32_t b = byte_of(w, k);
  if (!kAnchors) {
    d = (((d << 1) & sp.keep) | sp.inj) & T[b];
    if (record) hits |= uint32_t((d & sp.last) != 0) << k;
    return;
  }
  d = (((d << 1) & sp.keep) |
       (nxt == 10 || nxt == 0 ? sp.inj | sp.inj_eol : sp.inj)) & T[b];
  if (record) {
    const uint32_t lst = (bol >> k) & 1u ? sp.last | sp.last_bol : sp.last;
    hits |= uint32_t((d & lst) != 0) << k;
  }
  nxt = b;
}

// The word's hits among a thread's 32 positions (bit k: a match starts at
// p + k), from its bytes w (32 + kWarm + 1 of them from p); `bol` has bit
// k set where p + k starts a line.  With the short warm-up the word runs
// as two chains of 16 positions, interleaved: half the dependent steps, a
// few more steps in all.
template <int kWarm, bool kAnchors, int K>
__device__ __forceinline__ uint32_t word_hits(const uint32_t (&w)[K],
                                              uint32_t bol, const uint32_t* T,
                                              const GrepSpec& sp) {
  constexpr int kTop = kItems + kWarm;  // the look-ahead byte
  static_assert(K == kTop / 4 + 1, "the thread's words reach its look-ahead");
  uint32_t hits = 0;
  if (kWarm < kItems / 2) {
    constexpr int kHalf = kItems / 2;
    uint32_t da = 0, db = 0, hb = 0;
    uint32_t na = byte_of(w, kTop), nb = byte_of(w, kHalf + kWarm);
#pragma unroll
    for (int s = 0; s < kHalf + kWarm; ++s) {
      word_step<kAnchors>(w, kTop - 1 - s, kTop - 1 - s < kItems, bol, T, sp,
                          da, na, hits);
      word_step<kAnchors>(w, kHalf + kWarm - 1 - s,
                          kHalf + kWarm - 1 - s < kHalf, bol, T, sp, db, nb,
                          hb);
    }
    hits |= hb;
  } else {
    uint32_t d = 0, nxt = byte_of(w, kTop);
#pragma unroll
    for (int k = kTop - 1; k >= 0; --k) {
      word_step<kAnchors>(w, k, k < kItems, bol, T, sp, d, nxt, hits);
    }
  }
  return hits;
}

// One tile's lines: the pair scan, the look-back, each line's flag stored
// once, the last line and the scalars.  `front(p, nl, h)` loads a thread's
// bytes from p and gives its newlines and its match starts.
template <class Front>
__device__ void tile_lines(const Lines& L, int64_t tile, Front front) {
  __shared__ uint32_t s_before;
  const int64_t p = tile * kTile + int64_t(kItems) * threadIdx.x;
  const uint32_t valid = low_bits(L.n - p);
  uint32_t nl, h;
  front(p, nl, h);
  nl &= valid;
  h &= valid;

  // The thread's pair: its newlines and a hit after its last one.
  const int top = nl != 0 ? 31 - __clz(nl) : -1;
  const uint32_t after_top = top >= 31 ? 0u : h >> (top + 1);
  const uint32_t v = (uint32_t(__popc(nl)) << 1) | (after_top != 0 ? 1u : 0u);
  uint32_t tile_total;
  const uint32_t in_tile = block_seg_scan(v, tile_total);
  if (tile == 0) {
    if (threadIdx.x == 0) {
      publish(L.status, 0, kLbInclusive, tile_total);
      s_before = 0;
    }
  } else {
    if (threadIdx.x == 0) publish(L.status, tile, kLbAggregate, tile_total);
    const uint32_t ex = lines_look_back(L.status, tile);
    if (threadIdx.x == 0) {
      publish(L.status, tile, kLbInclusive, seg_combine(ex, tile_total));
      s_before = ex;
    }
  }
  __syncthreads();
  const uint32_t before = seg_combine(s_before, in_tile);

  // Newline q ends line lid: its flag is the open hit and the hits in
  // (the previous newline, q].
  int64_t lid = before >> 1;
  uint32_t open = before & 1u;
  int prev = -1;
  for (uint32_t rest = nl; rest != 0; rest &= rest - 1) {
    const int q = __ffs(rest) - 1;
    const uint32_t seg = low_bits(q + 1) & ~low_bits(prev + 1);
    if (lid < L.l_cap) L.line_match[lid] = int(open | ((h & seg) != 0));
    ++lid;
    open = 0;
    prev = q;
  }
  const int64_t k = L.n - 1 - p;
  if (k >= 0 && k < kItems) {  // byte n - 1: the last line, the scalars
    const uint32_t rest = prev >= 31 ? 0u : h >> (prev + 1);
    if (lid < L.l_cap) {
      L.line_match[lid] =
          (nl >> k) & 1u ? INT_MIN : int(open | (rest != 0 ? 1u : 0u));
    }
    L.scalars[0] = int(lid + 1);
    L.scalars[1] = lid + 1 > L.l_cap ? 1 : 0;
  }
}

// The block's tiles (blockIdx.x, then every gridDim.x-th: the launch is
// cooperative, so every block runs and a tile waits only on lower tiles,
// each of a running block that took its own lower tiles first), then its
// share of the INT_MIN tail.
template <class Front>
__device__ void line_pass(const Lines& L, Front front) {
  __shared__ uint32_t s_lines;
  for (int64_t tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    tile_lines(L, tile, front);
    __syncthreads();  // the shared words are rewritten by the next tile
  }
  if (threadIdx.x == 0) {
    unsigned long long word = ld_relaxed(L.status + L.tiles - 1);
    while (unsigned(word >> 32) != kLbInclusive) {
      __nanosleep(64);
      word = ld_relaxed(L.status + L.tiles - 1);
    }
    s_lines = (uint32_t(word) >> 1) + 1;
  }
  __syncthreads();
  const int64_t lo = s_lines, hi = L.l_cap;
  if (lo >= hi) return;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  int64_t v0 = hi, v1 = hi;  // [v0, v1): the 16-byte words
  if ((reinterpret_cast<uintptr_t>(L.line_match) & 15) == 0) {
    v0 = (lo + 3) & ~int64_t(3);
    v1 = hi & ~int64_t(3);
    if (v0 > v1) v0 = v1 = hi;
  }
  const int4 fill = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
  for (int64_t i = v0 / 4 + tid; i < v1 / 4; i += stride) {
    reinterpret_cast<int4*>(L.line_match)[i] = fill;
  }
  for (int64_t i = lo + tid; i < v0; i += stride) L.line_match[i] = INT_MIN;
  for (int64_t i = v1 + tid; i < hi; i += stride) L.line_match[i] = INT_MIN;
}

// The pattern's pass; `tail` a long literal's bytes past the word.
template <int kWarm, bool kAnchors, bool kLong>
__device__ __forceinline__ void pattern_pass(const Lines& L,
                                             const GrepSpec& sp,
                                             const uint8_t* tail) {
  __shared__ uint32_t T[256];
  T[threadIdx.x] = sp.table[threadIdx.x];
  __syncthreads();
  line_pass(L, [&](int64_t p, uint32_t& nl, uint32_t& h) {
    // The thread's 32 bytes and kWarm + 1 more: the next thread's, from
    // L1 after its own loads.
    uint32_t w[(kItems + kWarm) / 4 + 1];
    load_words(L.chunk, L.n, p, w);
    const bool bol0 = p == 0 || (p <= L.n && __ldg(L.chunk + p - 1) == 10);
    nl = bytes_eq(w, 10);
    h = word_hits<kWarm, kAnchors>(w, (nl << 1) | (bol0 ? 1u : 0u), T, sp);
    if (kLong) {  // the literal's bytes past the word, at the word's hits
      for (uint32_t c = h & low_bits(L.n - p); c != 0; c &= c - 1) {
        const int b = __ffs(c) - 1;
        const int64_t s = p + b + kItems;
        bool ok = true;
        for (int i = 0; i < sp.tail_len && ok; ++i) {
          const uint8_t y = s + i < L.n ? __ldg(L.chunk + s + i) : uint8_t(0);
          ok = y == tail[i];
        }
        if (!ok) h &= ~(1u << b);
      }
    }
  });
}

template <int kWarm, bool kAnchors>
__global__ void __launch_bounds__(kThreads)
    grep_lines(const __grid_constant__ Lines L,
               const __grid_constant__ GrepSpec sp) {
  pattern_pass<kWarm, kAnchors, false>(L, sp, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    grep_lines_long(const __grid_constant__ Lines L,
                    const __grid_constant__ GrepSpec sp,
                    const __grid_constant__ Tail tl) {
  pattern_pass<32, false, true>(L, sp,
                                tl.dev != nullptr ? tl.dev : tl.bytes);
}

__global__ void __launch_bounds__(kThreads)
    mask_lines(const __grid_constant__ Lines L, const uint8_t* mask) {
  line_pass(L, [&L, mask](int64_t p, uint32_t& nl, uint32_t& h) {
    uint32_t w[8], m[8];
    load_words(L.chunk, L.n, p, w);
    load_words(mask, L.n, p, m);
    nl = bytes_eq(w, 10);
    h = ~bytes_eq(m, 0);
  });
}

// Blocks of each kernel resident on the current device at once, worked out
// once per device: the cooperative launch's grid.
std::mutex g_resident_mu;
int g_resident[kKernels][64];

int launch(int id, const void* fn, void** args, int64_t tiles,
           cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 0 || dev >= 64) return int(cudaErrorInvalidDevice);
  int resident;
  {
    std::lock_guard<std::mutex> lock(g_resident_mu);
    if (g_resident[id][dev] == 0) {
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return int(e);
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads, 0);
      if (e != cudaSuccess) return int(e);
      if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
      g_resident[id][dev] = per_sm * sms;
    }
    resident = g_resident[id][dev];
  }
  const unsigned grid = unsigned(tiles < resident ? tiles : resident);
  return int(cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                         0, s));
}

int64_t tiles_of(int64_t n) { return ceil_div(n, kTile); }

Lines lines_of(const void* chunk, int64_t n, int64_t l_cap, void* line_match,
               void* scalars, void* scratch) {
  Lines L;
  L.chunk = static_cast<const uint8_t*>(chunk);
  L.n = n;
  L.l_cap = l_cap;
  L.line_match = static_cast<int*>(line_match);
  L.scalars = static_cast<int*>(scalars);
  L.status = static_cast<unsigned long long*>(scratch);
  L.tiles = tiles_of(n);
  return L;
}

bool bad_shape(int64_t n, int64_t l_cap) {
  // Line counts travel as lines << 1 in 32 bits, n_lines as an int.
  return n < 1 || n >= 0x7FFFFFFF || l_cap < 1 || l_cap > 0x7FFFFFFF;
}

}  // namespace

extern "C" {

// Bytes of a tile (the edges chip_smoke.py's cases place their lines at).
int64_t dsi_grep_tile_bytes() { return kTile; }

// Bytes of the look-back state (a status word a tile), all zero before a
// launch.
int64_t dsi_grep_scratch_bytes(int64_t n) { return 8 * tiles_of(n); }

// The one buffer of a dsi_grep call: line_match [l_cap] i32, then
// n_lines and overflow i32, then the look-back state at a 16-byte offset.
int64_t dsi_grep_bytes(int64_t n, int64_t l_cap) {
  return ((4 * (l_cap + 2) + 15) & ~int64_t(15)) + dsi_grep_scratch_bytes(n);
}

// chunk [n] u8 on the card; spec a HOST GrepSpec (1,052 bytes); a long
// literal's tail_len bytes past the word at `tail` (host) when they fit
// kTailInline, else at `tail_dev` (card); out the buffer of
// dsi_grep_bytes(n, l_cap) bytes.  A memset and one kernel.
int dsi_grep(const void* chunk, int64_t n, const void* spec,
             const void* tail, const void* tail_dev, int64_t l_cap,
             void* out, void* stream) {
  if (bad_shape(n, l_cap) || spec == nullptr) return cudaErrorInvalidValue;
  GrepSpec sp;
  std::memcpy(&sp, spec, sizeof(sp));
  if (sp.m_max < 1 || sp.m_max > kItems || sp.tail_len < 0 ||
      (sp.tail_len > 0 &&
       (sp.m_max != kItems ||
        (sp.tail_len <= kTailInline ? tail == nullptr : tail_dev == nullptr))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* o = static_cast<char*>(out);
  void* scratch = o + ((4 * (l_cap + 2) + 15) & ~int64_t(15));
  Lines L = lines_of(chunk, n, l_cap, o, o + 4 * l_cap, scratch);
  cudaError_t e =
      cudaMemsetAsync(scratch, 0, size_t(dsi_grep_scratch_bytes(n)), s);
  if (e != cudaSuccess) return int(e);
  if (sp.tail_len > 0) {
    Tail tl;
    tl.dev = nullptr;
    if (sp.tail_len <= kTailInline) {
      std::memcpy(tl.bytes, tail, size_t(sp.tail_len));
    } else {
      tl.dev = static_cast<const uint8_t*>(tail_dev);
    }
    void* args[] = {&L, &sp, &tl};
    return launch(kWordLong, reinterpret_cast<const void*>(grep_lines_long),
                  args, L.tiles, s);
  }
  // The word's warm-up: at least the longest branch less one byte.
  void* args[] = {&L, &sp};
  const bool anchors = sp.inj_eol != 0 || sp.last_bol != 0;
  const int warm = sp.m_max <= 5 ? 0 : 1;
  static const void* const kernels[2][2] = {
      {reinterpret_cast<const void*>(grep_lines<4, false>),
       reinterpret_cast<const void*>(grep_lines<32, false>)},
      {reinterpret_cast<const void*>(grep_lines<4, true>),
       reinterpret_cast<const void*>(grep_lines<32, true>)}};
  return launch(kWord + 2 * anchors + warm, kernels[anchors][warm], args,
                L.tiles, s);
}

// The pass alone over a per-position mask [n] u8 on the card (kernel I):
// line_match [l_cap] i32, scalars [2] i32 = n_lines, overflow, and its
// look-back state (dsi_grep_scratch_bytes(n)) already zero.
int dsi_line_flags_prezeroed(const void* chunk, int64_t n, const void* mask,
                             int64_t l_cap, void* line_match, void* scalars,
                             void* scratch, void* stream) {
  if (bad_shape(n, l_cap) || mask == nullptr) return cudaErrorInvalidValue;
  Lines L = lines_of(chunk, n, l_cap, line_match, scalars, scratch);
  void* args[] = {&L, &mask};
  return launch(kMaskKernel, reinterpret_cast<const void*>(mask_lines), args,
                L.tiles, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
