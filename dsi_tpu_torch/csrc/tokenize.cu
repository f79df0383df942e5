// Kernel A: tokenize and compact.
//
// Replaces the front end of the JAX word-count programs: K1+K2 in
// dsi_tpu/ops/wordcount.py tokenize_group_core (:350-379, with
// pack_key_lanes :115) and the K6 front end in dsi_tpu/ops/corpus_wc.py
// _corpus_core (:132-159).  Computes the [A-Za-z] class, token starts,
// n_tokens, has_high (any byte >= 0x80), the compaction of starts to t_cap
// rows in input order, each token's exact length, max_len over the
// compacted rows, the big-endian u32 key lanes masked to the length, packed
// pairwise into u64 key words (word-major [k64, t_cap]), and optionally
// poslen = start << 7 | length (the unmasked length, as corpus_wc.py:156).
//
// Bound: memory bytes (the chunk is read once, the t_cap rows written
// once).
//
// Design: a memset of the look-back state, then two launches.
// (1) One sweep over tiles of kTokTile bytes, claimed in ticket order.  A
//     block stages its tile in shared memory with 16-byte loads, with the
//     16 bytes before it and a halo of kTokHalo bytes after (the key bytes
//     of its last tokens).  Each thread classifies 32 bytes, four to a
//     SIMD-within-a-register test, into one 32-bit letter mask, so its
//     starts and ends are bit masks; one block scan of their counts ranks
//     them, and the i-th start of the tile pairs with its i-th end (the
//     reference's own argument, wordcount.py:356-365), less an end that
//     closes a token begun in an earlier tile.  Only the tile's last token
//     can run past it; its length scans the halo, then global memory, with
//     no cap (exactness_retry reads max_len).  A token belongs to the tile that
//     holds its first byte.  The tile publishes its start count and the
//     block finds its exclusive prefix by decoupled look-back (common.cuh);
//     then one thread a token builds its key words from shared memory with
//     __byte_perm and writes row r, consecutive r on consecutive lanes.
//     max_len takes one atomic a block, has_high one.  The last tile
//     records n_tokens.
// (2) The pad rows [n_tokens, t_cap): length 0, key words all ones, poslen
//     0; and the scalars, so the caller need not zero them.

#include "common.cuh"

namespace {

constexpr int kTokThreads = 256;
constexpr int kTokWarps = kTokThreads / 32;
constexpr int kTokTile = 8192;                 // bytes a tile
constexpr int kTokMaxStarts = kTokTile / 2;  // a start or end needs 2 bytes
constexpr int kTokHalo = 64;                 // staged bytes past a tile
// Staged: 16 bytes before the tile, the tile and the halo.  The buffer
// holds a zeroed word past them for the two-word reads of __byte_perm.
constexpr int kTokStaged = 16 + kTokTile + kTokHalo;
constexpr int kTokPadBlocks = 2048;
static_assert(kTokTile == 32 * kTokThreads, "32 bytes a thread");
static_assert(kTokMaxStarts < 65536, "counts packed two to an int");

// Scratch: acc [4] i32 (n_tokens, max_len, has_high, 0), ticket, status
// [tiles]; all zeroed each call.
constexpr int64_t kAccBytes = 16, kTicketBytes = 8;

__device__ __forceinline__ uint32_t load_be32(const uint8_t* chunk, int64_t n,
                                              int64_t g) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    v = (v << 8) | (g + b < n ? uint32_t(chunk[g + b]) : 0u);
  }
  return v;
}

// The letter class of the 4 bytes of w (little-endian) as 4 bits, bit b
// for byte b: case folded by OR 0x20, then 0x61 <= x <= 0x7a per byte
// with the high bit kept out of the additions (bytes >= 0x80 are never
// letters).
__device__ __forceinline__ uint32_t letters4(uint32_t w) {
  const uint32_t x = w | 0x20202020u;
  const uint32_t x7 = x & 0x7F7F7F7Fu;
  const uint32_t ge = x7 + 0x1F1F1F1Fu;  // bit 7 set: x7 >= 0x61
  const uint32_t gt = x7 + 0x05050505u;  // bit 7 set: x7 >= 0x7b
  const uint32_t m = (ge & ~gt & ~x & 0x80808080u) >> 7;
  return (m * 0x10204080u) >> 28;
}

// Keeps the first `keep` big-endian bytes of a lane (all from 4 on).
__device__ __forceinline__ uint32_t lane_mask(int64_t keep) {
  return keep >= 4 ? 0xFFFFFFFFu
                   : keep <= 0 ? 0u : 0xFFFFFFFFu << (8 * (4 - int(keep)));
}

// Big-endian u32 lane at byte p of the tile (p + 4 within the staged bytes:
// from shared memory, else from global memory), masked to `keep` bytes.
__device__ __forceinline__ uint32_t key_lane(const uint8_t* sb,
                                             const uint8_t* chunk, int64_t n,
                                             int64_t base, int64_t p,
                                             int64_t keep) {
  if (keep <= 0) return 0u;
  uint32_t v;
  if (p + 4 <= kTokTile + kTokHalo) {
    const int a = int(p) + 16;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(sb);
    v = __byte_perm(w[a >> 2], w[(a >> 2) + 1], 0x0123u + 0x1111u * (a & 3));
  } else {
    v = load_be32(chunk, n, base + p);
  }
  return v & lane_mask(keep);
}

__global__ void __launch_bounds__(kTokThreads)
    tok_sweep(const uint8_t* chunk, int64_t n, int k, int64_t t_cap,
              unsigned* ticket, LookBack lb, int* acc, uint64_t* keys,
              int* lengths, uint32_t* poslen) {
  __shared__ __align__(16) uint8_t sb[kTokStaged + 16];
  __shared__ uint16_t start_at[kTokMaxStarts], end_at[kTokMaxStarts];
  __shared__ int warp_max[kTokWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = claim_tile(ticket);
  const int64_t base = tile * kTokTile;

  // Stage bytes [base - 16, base + kTokTile + kTokHalo), zero outside
  // [0, n).
  const bool aligned = (reinterpret_cast<uintptr_t>(chunk) & 15) == 0;
  for (int c = threadIdx.x; c < kTokStaged / 16; c += kTokThreads) {
    const int64_t g = base - 16 + 16 * int64_t(c);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (aligned && g >= 0 && g + 16 <= n) {
      v = __ldg(reinterpret_cast<const uint4*>(chunk + g));
    } else if (g < n && g + 16 > 0) {
      uint32_t wv[4] = {0u, 0u, 0u, 0u};
      for (int b = 0; b < 16; ++b) {
        const int64_t gi = g + b;
        if (gi >= 0 && gi < n) {
          wv[b >> 2] |= uint32_t(chunk[gi]) << (8 * (b & 3));
        }
      }
      v = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    *reinterpret_cast<uint4*>(sb + 16 * c) = v;
  }
  if (threadIdx.x == 0) *reinterpret_cast<uint32_t*>(sb + kTokStaged) = 0u;
  __syncthreads();

  // Each thread's 32 bytes: the letter class as one 32-bit mask (4 bytes a
  // word at once), its starts and ends as masks, their counts ranked by one
  // block scan (starts in the low half, ends in the high half).
  const uint4* mine = reinterpret_cast<const uint4*>(sb + 16) + 2 * threadIdx.x;
  const uint4 q0 = mine[0], q1 = mine[1];
  const uint32_t words[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  uint32_t l = 0, any_hi = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    l |= letters4(words[q]) << (4 * q);
    any_hi |= words[q];
  }
  const bool high = (any_hi & 0x80808080u) != 0;
  const int p0 = 32 * threadIdx.x;  // first byte, tile-relative
  const uint32_t before = is_letter(sb[16 + p0 - 1]) ? 1u : 0u;
  const uint32_t after = is_letter(sb[16 + p0 + 32]) ? 1u : 0u;
  uint32_t sm = l & ~((l << 1) | before);
  uint32_t em = l & ~((l >> 1) | (after << 31));
  int total;
  const int off = block_exclusive_scan<int>(
      __popc(sm) | (__popc(em) << 16), total);
  const int n_starts = total & 0xFFFF, n_ends = total >> 16;
  if (threadIdx.x == 0) {
    lb_publish(lb, tile, tile == 0 ? kLbInclusive : kLbAggregate, n_starts,
               0);
  }
  for (int r = off & 0xFFFF; sm != 0; sm &= sm - 1, ++r) {
    start_at[r] = uint16_t(p0 + __ffs(sm) - 1);
  }
  for (int r = off >> 16; em != 0; em &= em - 1, ++r) {
    end_at[r] = uint16_t(p0 + __ffs(em) - 1);
  }
  __syncthreads();
  unsigned ex = 0;
  if (tile > 0) {
    long long unused;
    lb_exclusive<kTokThreads>(lb, tile, ex, unused);
    if (threadIdx.x == 0) {
      lb_publish(lb, tile, kLbInclusive, ex + n_starts, 0);
    }
  }
  if (threadIdx.x == 0 && tile == int64_t(gridDim.x) - 1) {
    acc[0] = int(ex + n_starts);
  }

  // One thread a token.  The first end closes a token begun before the
  // tile when the tile starts inside one.
  const int skip = is_letter(sb[15]) && is_letter(sb[16]) ? 1 : 0;
  const int k64 = (k + 1) / 2;
  const int64_t r0 = ex;
  int local_max = 0;
  for (int r = threadIdx.x; r < n_starts && r0 + r < t_cap;
       r += kTokThreads) {
    const int64_t row = r0 + r;
    const int st = start_at[r];
    int64_t len;
    if (r + skip < n_ends) {
      len = int64_t(end_at[r + skip]) - st + 1;
    } else {  // runs past the tile: the halo, then global memory
      int64_t p = kTokTile;
      while (p < kTokTile + kTokHalo && is_letter(sb[16 + p])) ++p;
      if (p == kTokTile + kTokHalo) {
        while (base + p < n && is_letter(chunk[base + p])) ++p;
      }
      len = p - st;
    }
    local_max = int(len) > local_max ? int(len) : local_max;
    lengths[row] = int(len);
    if (poslen != nullptr) {
      poslen[row] = (uint32_t(base + st) << 7) | uint32_t(len);
    }
    if (st + 4 * k + 4 <= kTokTile + kTokHalo) {
      // Lane j is bytes 4 j .. 4 j + 3 of the token: one __byte_perm of
      // two consecutive shared-memory words, k + 1 words in all.
      const int a = st + 16;
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(sb) + (a >> 2);
      const unsigned sel = 0x0123u + 0x1111u * unsigned(a & 3);
      uint32_t prev = wp[0];
      for (int w = 0; w < k64; ++w) {
        const uint32_t mid = wp[2 * w + 1];
        const uint64_t hi = __byte_perm(prev, mid, sel) &
                            lane_mask(len - 8 * w);
        uint64_t lo = 0xFFFFFFFFull;
        if (2 * w + 1 < k) {
          prev = wp[2 * w + 2];
          lo = __byte_perm(mid, prev, sel) & lane_mask(len - 8 * w - 4);
        }
        keys[int64_t(w) * t_cap + row] = (hi << 32) | lo;
      }
    } else {  // near the tile's end at a wide window
      for (int w = 0; w < k64; ++w) {
        const int j = 2 * w;
        const uint64_t hi = key_lane(sb, chunk, n, base, st + 4 * j,
                                     len - 4 * j);
        const uint64_t lo =
            j + 1 < k ? key_lane(sb, chunk, n, base, st + 4 * (j + 1),
                                 len - 4 * (j + 1))
                      : 0xFFFFFFFFull;
        keys[int64_t(w) * t_cap + row] = (hi << 32) | lo;
      }
    }
  }
  const int m = __reduce_max_sync(kFullMask, local_max);
  if (lane == 0) warp_max[warp] = m;
  const int any_high = __syncthreads_or(high ? 1 : 0);
  if (threadIdx.x == 0) {
    int bm = 0;
    for (int q = 0; q < kTokWarps; ++q) {
      bm = warp_max[q] > bm ? warp_max[q] : bm;
    }
    if (bm > 0) atomicMax(&acc[1], bm);
    if (any_high) atomicOr(&acc[2], 1);
  }
}

// Pad rows: length 0, every key word all ones (sorts last), poslen 0.  Key
// words one row a thread; lengths and poslen four rows a thread, 16 bytes
// a store where all four are pad rows.
__global__ void tok_pad(int k64, int64_t t_cap, const int* acc,
                        uint64_t* __restrict__ keys,
                        int* __restrict__ lengths,
                        uint32_t* __restrict__ poslen, int* scalars) {
  const int64_t n_tokens = acc[0];
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    scalars[threadIdx.x] = threadIdx.x < 3 ? acc[threadIdx.x] : 0;
  }
  const int64_t gid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t p = n_tokens + gid; p < t_cap; p += stride) {
    for (int w = 0; w < k64; ++w) keys[int64_t(w) * t_cap + p] = ~0ull;
  }
  for (int64_t p = (n_tokens & ~int64_t(3)) + 4 * gid; p < t_cap;
       p += 4 * stride) {
    if (p >= n_tokens && p + 4 <= t_cap) {
      *reinterpret_cast<int4*>(lengths + p) = make_int4(0, 0, 0, 0);
      if (poslen != nullptr) {
        *reinterpret_cast<uint4*>(poslen + p) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int64_t q = p; q < p + 4 && q < t_cap; ++q) {
        if (q < n_tokens) continue;
        lengths[q] = 0;
        if (poslen != nullptr) poslen[q] = 0;
      }
    }
  }
}

int64_t tiles_of(int64_t n) { return ceil_div(n, kTokTile); }

}  // namespace

extern "C" {

int64_t dsi_tokenize_scratch_bytes(int64_t n) {
  return kAccBytes + kTicketBytes + 8 * tiles_of(n);
}

// Bytes a tile of the sweep (the tile edges chip_smoke.py tests at).
int64_t dsi_tokenize_tile_bytes() { return kTokTile; }

// chunk [n] u8; keys [k64, t_cap] u64; lengths [t_cap] i32; poslen [t_cap]
// u32 or null; scalars [4] i32, written here: n_tokens (the true count,
// even above t_cap), max_len, has_high, 0.
int dsi_tokenize(const void* chunk, int64_t n, int k, int64_t t_cap,
                 void* keys, void* lengths, void* poslen, void* scalars,
                 void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(n);
  char* p = static_cast<char*>(scratch);
  int* acc = reinterpret_cast<int*>(p);
  unsigned* ticket = reinterpret_cast<unsigned*>(p + kAccBytes);
  LookBack lb;
  lb.status =
      reinterpret_cast<unsigned long long*>(p + kAccBytes + kTicketBytes);
  lb.sums = nullptr;
  cudaError_t e = cudaMemsetAsync(p, 0, dsi_tokenize_scratch_bytes(n), s);
  if (e != cudaSuccess) return int(e);
  tok_sweep<<<unsigned(tiles), kTokThreads, 0, s>>>(
      static_cast<const uint8_t*>(chunk), n, k, t_cap, ticket, lb, acc,
      static_cast<uint64_t*>(keys), static_cast<int*>(lengths),
      static_cast<uint32_t*>(poslen));
  DSI_CHECK_LAUNCH();
  const int64_t pad_blocks = ceil_div(t_cap, 256);
  tok_pad<<<unsigned(pad_blocks < kTokPadBlocks ? pad_blocks : kTokPadBlocks),
            256, 0, s>>>((k + 1) / 2, t_cap, acc,
                         static_cast<uint64_t*>(keys),
                         static_cast<int*>(lengths),
                         static_cast<uint32_t*>(poslen),
                         static_cast<int*>(scalars));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
