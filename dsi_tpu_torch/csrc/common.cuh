// Shared device helpers for the word-count kernels (tokenize, radix_sort,
// group, fnv).  Each .cu file is its own translation unit and includes this
// header; everything here has internal linkage so the objects link into one
// shared library without clashes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// [A-Za-z], == unicode.IsLetter on ASCII (dsi_tpu/ops/wordcount.py:63).
__device__ __forceinline__ bool is_letter(uint8_t b) {
  return (b >= 65 && b <= 90) || (b >= 97 && b <= 122);
}

// Bits [0, n) set (kernels H and J), n clamped to [0, 32].
__device__ __forceinline__ uint32_t low_bits(int64_t n) {
  return n >= 32 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << n) - 1u;
}

// Bit b set where byte b of w equals the byte replicated in c4: an exact
// zero-byte test of w ^ c4, the high bit kept out of the additions.
__device__ __forceinline__ uint32_t eq4(uint32_t w, uint32_t c4) {
  const uint32_t x = w ^ c4;
  const uint32_t t = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
  const uint32_t z = ~t & 0x80808080u;
  return ((z >> 7) * 0x10204080u) >> 28;
}

// The bytes equal to c among a thread's 32 (8 little-endian words).
__device__ __forceinline__ uint32_t eq32(const uint32_t (&wd)[8], uint8_t c) {
  const uint32_t c4 = 0x01010101u * c;
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) m |= eq4(wd[q], c4) << (4 * q);
  return m;
}

// Exclusive scan of one value per thread across the block, in thread order.
// blockDim.x must be a multiple of 32 and at most 1024.  Every thread of the
// block must call it.  Writes the block total to `total`.
template <typename T>
__device__ T block_exclusive_scan(T v, T& total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < n_warps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  T result = (warp > 0 ? warp_sums[warp - 1] : T(0)) + x - v;
  total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return result;
}

// Copies g[0, n) into shared memory at 16 bytes a thread, by a block of
// THREADS threads (kernels E, L and M stage their tiles with it); returns
// where word 0 landed in `stage` (n + 3 words), offset so that the 16-byte
// aligned words of g land on 16-byte aligned words of the stage.
template <int THREADS>
__device__ uint32_t* load_words(const uint32_t* g, int n, uint32_t* stage) {
  int head = int((4 - ((reinterpret_cast<uintptr_t>(g) >> 2) & 3)) & 3);
  head = head < n ? head : n;
  uint32_t* st = stage + ((4 - head) & 3);
  const int nv = (n - head) >> 2;
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  uint4* sv = reinterpret_cast<uint4*>(st + head);
  for (int v = threadIdx.x; v < nv; v += THREADS) sv[v] = gv[v];
  const int tail = head + 4 * nv;
  const int x = threadIdx.x;
  if (x < head) st[x] = g[x];
  if (x < n - tail) st[tail + x] = g[tail + x];
  return st;
}

// The 16 bytes at byte address p, of any alignment, for a warp whose lane
// l + 1 asks for p + 16 (so every lane has the same p % 16; kernels N and P
// read with it).  Each lane loads the aligned 16 bytes at or below p, takes
// the next aligned 16 from lane l + 1 with __shfl_down_sync (lane 31 loads
// them itself) and funnel-shifts the pair into place: one 16-byte load a
// lane.  Only aligned vectors that overlap [lo, hi) are read; the bytes of
// the others are undefined.  Every lane of the warp must call it.
__device__ __forceinline__ uint4 load16_any(uintptr_t p, uintptr_t lo,
                                            uintptr_t hi) {
  const unsigned sh = unsigned(p & 15);
  const uintptr_t a = p - sh;
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (a + 16 > lo && a < hi) x = __ldg(reinterpret_cast<const uint4*>(a));
  if (sh == 0) return x;  // the same branch in every lane
  uint4 y;
  y.x = __shfl_down_sync(kFullMask, x.x, 1);
  y.y = __shfl_down_sync(kFullMask, x.y, 1);
  y.z = __shfl_down_sync(kFullMask, x.z, 1);
  y.w = __shfl_down_sync(kFullMask, x.w, 1);
  if ((threadIdx.x & 31) == 31) {
    y = make_uint4(0u, 0u, 0u, 0u);
    if (a + 32 > lo && a + 16 < hi) {
      y = __ldg(reinterpret_cast<const uint4*>(a + 16));
    }
  }
  const uint32_t w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  const unsigned q = sh >> 2, bits = 8 * (sh & 3);
  uint32_t s[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    s[m] = q == 0 ? w[m] : q == 1 ? w[m + 1] : q == 2 ? w[m + 2] : w[m + 3];
  }
  return make_uint4(__funnelshift_r(s[0], s[1], bits),
                    __funnelshift_r(s[1], s[2], bits),
                    __funnelshift_r(s[2], s[3], bits),
                    __funnelshift_r(s[3], s[4], bits));
}

// The words of a stage of n words for load_words, rounded up to 16 bytes.
__host__ __device__ inline int64_t stage_words(int64_t n) {
  return (n + 3 + 3) & ~int64_t(3);
}

constexpr int kScanThreads = 1024;

// Exclusive scan of in[0, n) into out[0, n) by ONE block of kScanThreads:
// each thread sums a contiguous stretch, the stretch sums are scanned across
// the block, then each thread writes its stretch.  The arrays it serves
// (per-block counts, radix histograms) hold at most a few hundred thousand
// entries, so one block is enough.  Writes the grand total to *total when
// total is not null.
template <typename T>
__global__ void scan_exclusive_kernel(const T* in, T* out, int64_t n,
                                      T* total) {
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  T s = 0;
  for (int64_t i = lo; i < hi; ++i) s += in[i];
  T all;
  T run = block_exclusive_scan<T>(s, all);
  for (int64_t i = lo; i < hi; ++i) {
    T v = in[i];
    out[i] = run;
    run += v;
  }
  if (threadIdx.x == 0 && total != nullptr) *total = all;
}

// ── Decoupled look-back over one column of tiles ─────────────────────────
//
// Merrill & Garland's single-pass scan (as in CUB's tile state), shared by
// kernels A, C, J and N.  Tiles are numbered in the order blocks claim them
// from a ticket counter, so every tile a block waits on belongs to a block
// that already runs: no co-residency is assumed.  Tile j publishes the pair
// (count, sum) twice: its own aggregate as soon as it has it, then its
// inclusive prefix once it has looked back.  status[j] is state << 32 |
// count (state 0 until the first publish); each state's int64 sum has its
// own slot, sums[2j] the aggregate's and sums[2j + 1] the inclusive
// prefix's, written before the status word, which is stored with release
// order and loaded with acquire order: a reader that sees a state reads
// that state's sum whole.  status is zeroed before the launch; sums need
// not be, and is null where the aggregate is a count alone.

constexpr unsigned kLbAggregate = 1, kLbInclusive = 2;

struct LookBack {
  unsigned long long* status;  // [tiles]
  long long* sums;             // [2 * tiles] or null
};

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One thread publishes tile `tile`'s aggregate or inclusive prefix.
__device__ __forceinline__ void lb_publish(const LookBack& lb, int64_t tile,
                                           unsigned state, unsigned count,
                                           long long sum) {
  if (lb.sums != nullptr) {
    lb.sums[2 * tile + (state == kLbInclusive ? 1 : 0)] = sum;
  }
  st_release(lb.status + tile,
             (static_cast<unsigned long long>(state) << 32) | count);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The exclusive prefix (count, sum) of tile `tile` over tiles [0, tile),
// by the whole block of THREADS threads; every thread gets it.  Thread q
// reads the status of tile j - q for a window of THREADS predecessors j,
// j - 1, ..., waiting until each is published; the walk stops at the
// nearest inclusive prefix.  A window as wide as the block lets the
// inclusive prefixes keep ahead of the blocks in flight: a walk covers
// THREADS tiles a round trip to L2 (measured faster on the H100 than one
// warp reading 8 tiles a lane, PERF.md).
template <int THREADS>
__device__ __forceinline__ void lb_exclusive(const LookBack& lb, int64_t tile,
                                             unsigned& count,
                                             long long& sum) {
  constexpr int kWarps = THREADS / 32;
  __shared__ unsigned inc_mask[kWarps];
  __shared__ unsigned warp_count[kWarps];
  __shared__ long long warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned c = 0;
  long long s = 0;
  for (int64_t j = tile - 1; j >= 0; j -= THREADS) {
    const int64_t q = j - threadIdx.x;
    unsigned long long word = 0;
    unsigned state = kLbInclusive;  // before tile 0: an empty prefix
    if (q >= 0) {
      word = ld_acquire(lb.status + q);
      state = unsigned(word >> 32);
      while (state == 0) {
        __nanosleep(32);
        word = ld_acquire(lb.status + q);
        state = unsigned(word >> 32);
      }
    }
    const unsigned m = __ballot_sync(kFullMask, state == kLbInclusive);
    if (lane == 0) inc_mask[warp] = m;
    __syncthreads();
    // Threads 0 .. the nearest inclusive one (all when there is none).
    int stop = THREADS - 1;
    bool found = false;
    for (int x = kWarps - 1; x >= 0; --x) {
      if (inc_mask[x] != 0) {
        stop = 32 * x + __ffs(inc_mask[x]) - 1;
        found = true;
      }
    }
    const bool mine = q >= 0 && int(threadIdx.x) <= stop;
    unsigned cv = mine ? unsigned(word) : 0u;
    long long sv = 0;
    if (mine && lb.sums != nullptr) {
      sv = __ldcg(lb.sums + 2 * q + (state == kLbInclusive ? 1 : 0));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cv += __shfl_xor_sync(kFullMask, cv, o);
      sv += __shfl_xor_sync(kFullMask, sv, o);
    }
    if (lane == 0) {
      warp_count[warp] = cv;
      warp_sum[warp] = sv;
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      c += warp_count[x];
      s += warp_sum[x];
    }
    __syncthreads();  // the shared words are rewritten by the next window
    if (found) break;
  }
  count = c;
  sum = s;
}

// The tile a block works on: the next ticket.  Every thread of the block
// must call it.
__device__ __forceinline__ int64_t claim_tile(unsigned* ticket) {
  __shared__ unsigned tile;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1u);
  __syncthreads();
  return tile;
}

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int64_t align8(int64_t bytes) {
  return (bytes + 7) & ~int64_t(7);
}

}  // namespace

#define DSI_CHECK_LAUNCH()                       \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)
