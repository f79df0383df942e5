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
// Bound: memory bytes (the chunk is read twice, the rows written once).
// Design: three launches.  (1) per-tile start counts and has_high;
// (2) one-block exclusive scan of the tile counts (total = n_tokens);
// (3) each tile re-finds its starts, ranks them in input order with a block
// scan, and writes the rows below t_cap; the same launch fills the pad rows
// [n_tokens, t_cap).  A token's length scans forward to the next
// non-letter with no cap, so max_len is exact (exactness_retry needs it).

#include "common.cuh"

namespace {

constexpr int kTokThreads = 256;
constexpr int kTokItems = 16;
constexpr int64_t kTokTile = int64_t(kTokThreads) * kTokItems;

// Starts among this thread's kTokItems bytes, plus whether any is >= 0x80.
__device__ __forceinline__ int thread_starts(const uint8_t* chunk, int64_t n,
                                             int64_t base, bool& high) {
  bool prev = base > 0 && base - 1 < n ? is_letter(chunk[base - 1]) : false;
  int cnt = 0;
  high = false;
  for (int j = 0; j < kTokItems; ++j) {
    const int64_t i = base + j;
    if (i >= n) break;
    const uint8_t b = chunk[i];
    const bool l = is_letter(b);
    cnt += (l && !prev) ? 1 : 0;
    high |= b >= 128;
    prev = l;
  }
  return cnt;
}

__global__ void tok_count(const uint8_t* chunk, int64_t n, int* tile_counts,
                          int* scalars) {
  const int64_t base = blockIdx.x * kTokTile + int64_t(threadIdx.x) * kTokItems;
  bool high;
  const int cnt = thread_starts(chunk, n, base, high);
  int total;
  block_exclusive_scan<int>(cnt, total);
  const int any_high = __syncthreads_or(high ? 1 : 0);
  if (threadIdx.x == 0) {
    tile_counts[blockIdx.x] = total;
    if (any_high) atomicOr(&scalars[2], 1);
  }
}

// Big-endian u32 lane j of the token at `s`, bytes past `len` zeroed.
__device__ __forceinline__ uint32_t key_lane(const uint8_t* chunk, int64_t s,
                                             int len, int j) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int p = 4 * j + b;
    v = (v << 8) | (p < len ? uint32_t(chunk[s + p]) : 0u);
  }
  return v;
}

__global__ void tok_write(const uint8_t* chunk, int64_t n, int k,
                          int64_t t_cap, const int* tile_offsets,
                          uint64_t* keys, int* lengths, uint32_t* poslen,
                          int* scalars) {
  const int64_t base = blockIdx.x * kTokTile + int64_t(threadIdx.x) * kTokItems;
  const int k64 = (k + 1) / 2;
  bool high;
  const int cnt = thread_starts(chunk, n, base, high);
  int total;
  int64_t r = int64_t(tile_offsets[blockIdx.x]) +
              block_exclusive_scan<int>(cnt, total);
  int local_max = 0;
  bool prev = base > 0 && base - 1 < n ? is_letter(chunk[base - 1]) : false;
  for (int j = 0; j < kTokItems && r < t_cap; ++j) {
    const int64_t i = base + j;
    if (i >= n) break;
    const bool l = is_letter(chunk[i]);
    if (l && !prev) {
      int len = 1;
      while (i + len < n && is_letter(chunk[i + len])) ++len;
      local_max = len > local_max ? len : local_max;
      lengths[r] = len;
      for (int w = 0; w < k64; ++w) {
        const uint64_t hi = key_lane(chunk, i, len, 2 * w);
        const uint64_t lo =
            2 * w + 1 < k ? key_lane(chunk, i, len, 2 * w + 1) : 0xFFFFFFFFull;
        keys[int64_t(w) * t_cap + r] = (hi << 32) | lo;
      }
      if (poslen != nullptr) poslen[r] = (uint32_t(i) << 7) | uint32_t(len);
      ++r;
    }
    prev = l;
  }
  if (local_max > 0) atomicMax(&scalars[1], local_max);

  // Pad rows: length 0, every key word all ones (sorts last), poslen 0.
  const int64_t n_tokens = scalars[0];
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t p = n_tokens + int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       p < t_cap; p += stride) {
    lengths[p] = 0;
    for (int w = 0; w < k64; ++w) keys[int64_t(w) * t_cap + p] = ~0ull;
    if (poslen != nullptr) poslen[p] = 0;
  }
}

}  // namespace

extern "C" {

int64_t dsi_tokenize_scratch_bytes(int64_t n) {
  return 2 * align8(4 * ceil_div(n, kTokTile));
}

// chunk [n] u8; keys [k64, t_cap] u64; lengths [t_cap] i32; poslen [t_cap]
// u32 or null; scalars [4] i32, zeroed by the caller: n_tokens, max_len,
// has_high.
int dsi_tokenize(const void* chunk, int64_t n, int k, int64_t t_cap,
                 void* keys, void* lengths, void* poslen, void* scalars,
                 void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = ceil_div(n, kTokTile);
  int* counts = static_cast<int*>(scratch);
  int* offsets = reinterpret_cast<int*>(static_cast<char*>(scratch) +
                                        align8(4 * tiles));
  int* sc = static_cast<int*>(scalars);
  const uint8_t* c = static_cast<const uint8_t*>(chunk);
  tok_count<<<unsigned(tiles), kTokThreads, 0, s>>>(c, n, counts, sc);
  DSI_CHECK_LAUNCH();
  scan_exclusive_kernel<int><<<1, kScanThreads, 0, s>>>(counts, offsets,
                                                        tiles, sc);
  DSI_CHECK_LAUNCH();
  tok_write<<<unsigned(tiles), kTokThreads, 0, s>>>(
      c, n, k, t_cap, offsets, static_cast<uint64_t*>(keys),
      static_cast<int*>(lengths), static_cast<uint32_t*>(poslen), sc);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
