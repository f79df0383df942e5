// Kernel H: grep line flags for literal and character-class patterns.
//
// Replaces K13, dsi_tpu/ops/grepk.py grep_kernel (:116) with
// line_flags_from_match (:61), and K14, dsi_tpu/ops/regexk.py
// classgrep_kernel (:198).  A class pattern is a list of m <= 32
// positions, each an OR of up to 8 byte ranges lo <= b <= hi, plus the two
// anchors; a literal is its m bytes (any m), compared for equality:
//
//   match[i]   = every position j accepts chunk[i + j] (0 past n, as
//                _shift_left zero-fills), and with ^ the byte before i is
//                '\n' (or i == 0), and with $ the byte at i + m is '\n' or 0;
//   line_id[i] = newlines strictly before i;
//   line_match[l] = max of match over the positions of line l, for
//                l < l_cap (jax.ops.segment_max: a line with no position
//                keeps INT32_MIN, the reference's empty-segment value);
//   n_lines    = newlines in the whole chunk + 1; overflow = n_lines > l_cap.
//
// The same line-flag epilogue serves kernel I (csrc/nfa.cu): given a
// per-position mask instead of a pattern, dsi_line_flags turns it into the
// same three outputs.
//
// Bound: memory bytes (the chunk read once, the flags written once); the
// pattern test is a few compares a byte, and mostly fails at the first.
// Design: three launches, kernel A's compaction structure.  (1) grep_count:
// newlines per 4 KiB tile; (2) a one-block exclusive scan of the tile
// counts (total = newlines); (3) grep_flags: each thread ranks its 16 bytes'
// first line id with a block scan, tests its positions, and folds the
// flags of each run of positions on one line into ONE atomicMax, so the
// atomics number about the lines, not the bytes.  Max is order-free, so the
// flags do not depend on the order the atomics land in.

#include <climits>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxPos = 32;
constexpr int kMaxRanges = 8;
constexpr int kGThreads = 256;
constexpr int kGItems = 16;
constexpr int64_t kGTile = int64_t(kGThreads) * kGItems;

// The pattern, passed by value (about 570 bytes of the 4 KiB parameter
// space).  A literal (tier 1) is `pat`, m bytes on the card, of any length;
// a class pattern (tier 2) is m <= 32 positions of ranges, `pat` null.
struct GrepSpec {
  const uint8_t* pat;
  uint8_t lo[kMaxPos][kMaxRanges];
  uint8_t hi[kMaxPos][kMaxRanges];
  uint8_t n_ranges[kMaxPos];
  int m;
  int anchor_start;
  int anchor_end;
};

__device__ __forceinline__ uint8_t byte_at(const uint8_t* chunk, int64_t n,
                                           int64_t p) {
  return p < n ? chunk[p] : uint8_t(0);
}

__device__ __forceinline__ bool match_at(const uint8_t* chunk, int64_t n,
                                         int64_t i, const GrepSpec& sp) {
  if (sp.pat != nullptr) {
    for (int j = 0; j < sp.m; ++j)
      if (byte_at(chunk, n, i + j) != __ldg(sp.pat + j)) return false;
    return true;
  }
  for (int j = 0; j < sp.m; ++j) {
    const uint8_t c = byte_at(chunk, n, i + j);
    bool ok = false;
    for (int r = 0; r < sp.n_ranges[j]; ++r)
      ok |= (c >= sp.lo[j][r]) & (c <= sp.hi[j][r]);
    if (!ok) return false;
  }
  if (sp.anchor_start && i > 0 && chunk[i - 1] != 10) return false;
  if (sp.anchor_end) {
    const uint8_t c = byte_at(chunk, n, i + sp.m);
    if (c != 10 && c != 0) return false;
  }
  return true;
}

__global__ void grep_fill(int* line_match, int64_t l_cap) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < l_cap;
       i += stride)
    line_match[i] = INT_MIN;
}

__global__ void grep_count(const uint8_t* chunk, int64_t n, int* tile_counts) {
  const int64_t base = blockIdx.x * kGTile + int64_t(threadIdx.x) * kGItems;
  int cnt = 0;
  for (int j = 0; j < kGItems; ++j) cnt += byte_at(chunk, n, base + j) == 10;
  int total;
  block_exclusive_scan<int>(cnt, total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// `mask` null: test the pattern `sp`; else match[i] = mask[i] != 0.
__global__ void grep_flags(const uint8_t* chunk, int64_t n, GrepSpec sp,
                           const uint8_t* mask, const int* tile_offsets,
                           const int* nl_total, int64_t l_cap,
                           int* line_match, int* scalars) {
  const int64_t base = blockIdx.x * kGTile + int64_t(threadIdx.x) * kGItems;
  int cnt = 0;
  for (int j = 0; j < kGItems; ++j) cnt += byte_at(chunk, n, base + j) == 10;
  int total;
  int64_t lid = int64_t(tile_offsets[blockIdx.x]) +
                block_exclusive_scan<int>(cnt, total);
  int run = INT_MIN;  // max over this thread's positions of line `lid`
  for (int j = 0; j < kGItems; ++j) {
    const int64_t i = base + j;
    if (i >= n) break;
    const bool hit = mask != nullptr ? mask[i] != 0 : match_at(chunk, n, i, sp);
    run = run > int(hit) ? run : int(hit);
    if (chunk[i] == 10) {  // the newline ends its line: flush the run
      if (lid < l_cap) atomicMax(&line_match[lid], run);
      ++lid;
      run = INT_MIN;
    }
  }
  if (run != INT_MIN && lid < l_cap) atomicMax(&line_match[lid], run);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int n_lines = *nl_total + 1;
    scalars[0] = n_lines;
    scalars[1] = int64_t(n_lines) > l_cap ? 1 : 0;
  }
}

int64_t flags_scratch_bytes(int64_t n) {
  return 2 * align8(4 * ceil_div(n, kGTile)) + 8;
}

int run_line_flags(const uint8_t* chunk, int64_t n, const GrepSpec& sp,
                   const uint8_t* mask, int64_t l_cap, int* line_match,
                   int* scalars, void* scratch, cudaStream_t s) {
  const int64_t tiles = ceil_div(n, kGTile);
  int* counts = static_cast<int*>(scratch);
  int* offsets = reinterpret_cast<int*>(static_cast<char*>(scratch) +
                                        align8(4 * tiles));
  int* nl_total = reinterpret_cast<int*>(static_cast<char*>(scratch) +
                                         2 * align8(4 * tiles));
  const int64_t fill_blocks = ceil_div(l_cap, 256) < 4096
                                  ? ceil_div(l_cap, 256) : 4096;
  grep_fill<<<unsigned(fill_blocks), 256, 0, s>>>(line_match, l_cap);
  DSI_CHECK_LAUNCH();
  grep_count<<<unsigned(tiles), kGThreads, 0, s>>>(chunk, n, counts);
  DSI_CHECK_LAUNCH();
  scan_exclusive_kernel<int><<<1, kScanThreads, 0, s>>>(counts, offsets,
                                                        tiles, nl_total);
  DSI_CHECK_LAUNCH();
  grep_flags<<<unsigned(tiles), kGThreads, 0, s>>>(
      chunk, n, sp, mask, offsets, nl_total, l_cap, line_match, scalars);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

int64_t dsi_grep_scratch_bytes(int64_t n) { return flags_scratch_bytes(n); }

// chunk [n] u8; a literal: pat [m] u8 on the card, lo/hi/n_ranges null;
// a class pattern: pat null, lo, hi [32 * 8] u8 and n_ranges [32] u8 HOST
// arrays (position-major), m <= 32; line_match [l_cap] i32; scalars [2]
// i32 = n_lines, overflow.
int dsi_grep(const void* chunk, int64_t n, const void* pat, const void* lo,
             const void* hi, const void* n_ranges, int m, int anchor_start,
             int anchor_end, int64_t l_cap, void* line_match, void* scalars,
             void* scratch, void* stream) {
  if (m < 1 || n < 1 || l_cap < 1) return cudaErrorInvalidValue;
  GrepSpec sp;
  std::memset(&sp, 0, sizeof(sp));
  sp.pat = static_cast<const uint8_t*>(pat);
  if (pat == nullptr) {
    if (m > kMaxPos) return cudaErrorInvalidValue;
    std::memcpy(sp.lo, lo, sizeof(sp.lo));
    std::memcpy(sp.hi, hi, sizeof(sp.hi));
    std::memcpy(sp.n_ranges, n_ranges, sizeof(sp.n_ranges));
    for (int j = 0; j < m; ++j)
      if (sp.n_ranges[j] < 1 || sp.n_ranges[j] > kMaxRanges)
        return cudaErrorInvalidValue;
  }
  sp.m = m;
  sp.anchor_start = anchor_start;
  sp.anchor_end = anchor_end;
  return run_line_flags(static_cast<const uint8_t*>(chunk), n, sp, nullptr,
                        l_cap, static_cast<int*>(line_match),
                        static_cast<int*>(scalars), scratch,
                        static_cast<cudaStream_t>(stream));
}

// The epilogue alone, for a per-position mask [n] u8 on the card (kernel I).
int dsi_line_flags(const void* chunk, int64_t n, const void* mask,
                   int64_t l_cap, void* line_match, void* scalars,
                   void* scratch, void* stream) {
  if (n < 1 || l_cap < 1) return cudaErrorInvalidValue;
  GrepSpec sp;
  std::memset(&sp, 0, sizeof(sp));
  return run_line_flags(static_cast<const uint8_t*>(chunk), n, sp,
                        static_cast<const uint8_t*>(mask), l_cap,
                        static_cast<int*>(line_match),
                        static_cast<int*>(scalars), scratch,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
