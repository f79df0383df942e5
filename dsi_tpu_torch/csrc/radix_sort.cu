// Kernel B: stable lexicographic sort of k64 u64 key words.
//
// Replaces the K3 sort of the JAX word-count programs: lax.sort over the
// packed key words at dsi_tpu/ops/wordcount.py:401 (tokenize_group_core)
// and dsi_tpu/ops/corpus_wc.py:187 (_corpus_core, is_stable=True).  Keys
// are word-major [k64, t] (2 words at max_word_len 16, 8 at 64).  Output:
// the row permutation and the keys gathered through it.
//
// Bound: memory bytes.  An LSD radix sort moves each (key word,
// permutation) pair in and out once per 8-bit pass: 8 * k64 passes.
// Design: from the last key word to the first, gather the word through the
// current permutation, then 8 stable counting passes over (word, perm)
// pairs.  Each pass is tile histograms -> per-digit scans of the tile
// counts (one block per digit) and a scan of the 256 digit totals ->
// scatter.  The scatter ranks elements in
// input order inside its tile: a tile is walked in rounds of one element
// per thread, and within a round a thread's rank among equal digits comes
// from __match_any_sync inside its warp plus per-warp digit counts in
// shared memory for the warps before it.  No atomics decide an order, so
// every pass, and the sort, is stable (the corpus path reads each word's
// first occurrence from the first row of its run).

#include "common.cuh"

namespace {

constexpr int kRsThreads = 256;
constexpr int kRsWarps = kRsThreads / 32;
constexpr int kRsItems = 16;
constexpr int64_t kRsTile = int64_t(kRsThreads) * kRsItems;

__global__ void rs_iota(int* perm, int64_t t) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < t) perm[i] = int(i);
}

__global__ void rs_gather(const uint64_t* src, const int* perm, int64_t t,
                          uint64_t* dst) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < t) dst[i] = src[perm[i]];
}

// hist is digit-major: hist[d * tiles + tile], so its exclusive scan is
// each (digit, tile)'s first output slot.
__global__ void rs_hist(const uint64_t* keys, int64_t t, int shift,
                        int* hist) {
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * kRsTile;
  for (int r = 0; r < kRsItems; ++r) {
    const int64_t i = base + int64_t(r) * kRsThreads + threadIdx.x;
    if (i < t) atomicAdd(&h[(keys[i] >> shift) & 255], 1);
  }
  __syncthreads();
  hist[int64_t(threadIdx.x) * gridDim.x + blockIdx.x] = h[threadIdx.x];
}

// Block d scans row d of the digit-major histogram: offsets[d][tile] is the
// count of digit d in the tiles before `tile`; totals[d] the row's sum.
__global__ void rs_scan_digit(const int* hist, int tiles, int* offsets,
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

// One block of 256 threads: bases[d] = sum of totals[d'] for d' < d.
__global__ void rs_scan_bases(const int* totals, int* bases) {
  int all;
  bases[threadIdx.x] = block_exclusive_scan<int>(totals[threadIdx.x], all);
}

__global__ void rs_scatter(const uint64_t* keys_in, const int* perm_in,
                           int64_t t, int shift, const int* offsets,
                           const int* bases, uint64_t* keys_out,
                           int* perm_out) {
  __shared__ int running[256];
  __shared__ int warp_counts[kRsWarps][256];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  running[tid] = bases[tid] + offsets[int64_t(tid) * gridDim.x + blockIdx.x];
  for (int w = 0; w < kRsWarps; ++w) warp_counts[w][tid] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * kRsTile;
  for (int r = 0; r < kRsItems; ++r) {
    const int64_t i = base + int64_t(r) * kRsThreads + tid;
    const bool ok = i < t;
    const uint64_t key = ok ? keys_in[i] : 0ull;
    const int d = ok ? int((key >> shift) & 255) : 256;
    const unsigned peers = __match_any_sync(kFullMask, d);
    const int rank = __popc(peers & lanes_below);
    if (ok && rank == 0) warp_counts[warp][d] = __popc(peers);
    __syncthreads();
    if (ok) {
      int pos = running[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_counts[w][d];
      keys_out[pos] = key;
      perm_out[pos] = perm_in[i];
    }
    __syncthreads();
    int add = 0;
    for (int w = 0; w < kRsWarps; ++w) {
      add += warp_counts[w][tid];
      warp_counts[w][tid] = 0;
    }
    running[tid] += add;
    __syncthreads();
  }
}

struct SortScratch {
  uint64_t* kbuf;
  uint64_t* kalt;
  int* palt;
  int* hist;
  int* offsets;
  int* totals;
  int* bases;
};

SortScratch carve(void* scratch, int64_t t) {
  const int64_t tiles = ceil_div(t, kRsTile);
  char* p = static_cast<char*>(scratch);
  SortScratch s;
  s.kbuf = reinterpret_cast<uint64_t*>(p);
  p += align8(8 * t);
  s.kalt = reinterpret_cast<uint64_t*>(p);
  p += align8(8 * t);
  s.palt = reinterpret_cast<int*>(p);
  p += align8(4 * t);
  s.hist = reinterpret_cast<int*>(p);
  p += align8(4 * 256 * tiles);
  s.offsets = reinterpret_cast<int*>(p);
  p += align8(4 * 256 * tiles);
  s.totals = reinterpret_cast<int*>(p);
  s.bases = s.totals + 256;
  return s;
}

}  // namespace

extern "C" {

int64_t dsi_radix_sort_scratch_bytes(int64_t t) {
  const int64_t tiles = ceil_div(t, kRsTile);
  return 2 * align8(8 * t) + align8(4 * t) + 2 * align8(4 * 256 * tiles) +
         4 * 512;
}

// keys [k64, t] u64 (word 0 most significant); sorted_keys [k64, t] u64;
// perm [t] i32: sorted_keys[w][i] == keys[w][perm[i]], ties in input order.
int dsi_radix_sort(const void* keys, int k64, int64_t t, void* sorted_keys,
                   void* perm, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* in = static_cast<const uint64_t*>(keys);
  uint64_t* out = static_cast<uint64_t*>(sorted_keys);
  int* p = static_cast<int*>(perm);
  SortScratch s = carve(scratch, t);
  const unsigned tiles = unsigned(ceil_div(t, kRsTile));
  const unsigned row_blocks = unsigned(ceil_div(t, 256));
  rs_iota<<<row_blocks, 256, 0, st>>>(p, t);
  DSI_CHECK_LAUNCH();
  for (int w = k64 - 1; w >= 0; --w) {
    rs_gather<<<row_blocks, 256, 0, st>>>(in + int64_t(w) * t, p, t, s.kbuf);
    DSI_CHECK_LAUNCH();
    // 8 passes, ping-pong (kbuf, perm) <-> (kalt, palt): an even count, so
    // the sorted pairs end where they started.
    for (int pass = 0; pass < 8; ++pass) {
      const bool even = (pass & 1) == 0;
      const uint64_t* kin = even ? s.kbuf : s.kalt;
      uint64_t* kout = even ? s.kalt : s.kbuf;
      const int* pin = even ? p : s.palt;
      int* pout = even ? s.palt : p;
      rs_hist<<<tiles, kRsThreads, 0, st>>>(kin, t, 8 * pass, s.hist);
      DSI_CHECK_LAUNCH();
      rs_scan_digit<<<256, kScanThreads, 0, st>>>(s.hist, int(tiles),
                                                   s.offsets, s.totals);
      DSI_CHECK_LAUNCH();
      rs_scan_bases<<<1, 256, 0, st>>>(s.totals, s.bases);
      DSI_CHECK_LAUNCH();
      rs_scatter<<<tiles, kRsThreads, 0, st>>>(kin, pin, t, 8 * pass,
                                               s.offsets, s.bases, kout,
                                               pout);
      DSI_CHECK_LAUNCH();
    }
  }
  for (int w = 0; w < k64; ++w) {
    rs_gather<<<row_blocks, 256, 0, st>>>(in + int64_t(w) * t, p, t,
                                          out + int64_t(w) * t);
    DSI_CHECK_LAUNCH();
  }
  return 0;
}

}  // extern "C"
