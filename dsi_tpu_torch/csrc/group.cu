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
// Bound: memory bytes (the sorted keys and counts are read, the u_cap
// rows written).  Design: four launches.  (1) per-tile head counts and
// count sums over valid rows; (2) one-block exclusive scans of both (their
// totals are n_unique and the valid-row count sum); (3) each tile ranks its
// heads in order with block scans and writes the head rows below u_cap,
// plus the running count sum at each head (hc, u_cap + 1 entries);
// (4) over u_cap rows: totals from consecutive hc entries, masking past
// n_unique.  Counts are int64 so the same kernel serves u64 count tables.

#include "common.cuh"

namespace {

constexpr int kGThreads = 256;
constexpr int kGItems = 16;
constexpr int64_t kGTile = int64_t(kGThreads) * kGItems;

__device__ __forceinline__ bool row_valid(const uint64_t* sk, int64_t i) {
  return sk[i] != ~0ull;
}

__device__ __forceinline__ bool row_is_head(const uint64_t* sk, int k64,
                                            int64_t t, int64_t i) {
  if (!row_valid(sk, i)) return false;
  if (i == 0) return true;
  for (int w = 0; w < k64; ++w) {
    if (sk[int64_t(w) * t + i] != sk[int64_t(w) * t + i - 1]) return true;
  }
  return false;
}

__device__ __forceinline__ void thread_sums(const uint64_t* sk, int k64,
                                            int64_t t, const int64_t* counts,
                                            int64_t base, int& heads,
                                            int64_t& csum) {
  heads = 0;
  csum = 0;
  for (int j = 0; j < kGItems; ++j) {
    const int64_t i = base + j;
    if (i >= t) break;
    heads += row_is_head(sk, k64, t, i) ? 1 : 0;
    csum += row_valid(sk, i) ? counts[i] : 0;
  }
}

__global__ void g_count(const uint64_t* sk, int k64, int64_t t,
                        const int64_t* counts, int* tile_heads,
                        int64_t* tile_csum) {
  const int64_t base = blockIdx.x * kGTile + int64_t(threadIdx.x) * kGItems;
  int heads;
  int64_t csum;
  thread_sums(sk, k64, t, counts, base, heads, csum);
  int h_total;
  int64_t c_total;
  block_exclusive_scan<int>(heads, h_total);
  block_exclusive_scan<int64_t>(csum, c_total);
  if (threadIdx.x == 0) {
    tile_heads[blockIdx.x] = h_total;
    tile_csum[blockIdx.x] = c_total;
  }
}

__global__ void g_write(const uint64_t* sk, int k64, int64_t t,
                        const int64_t* counts, const int* payload,
                        const int* perm, int64_t u_cap,
                        const int* tile_heads_off,
                        const int64_t* tile_csum_off, int64_t* hc,
                        uint64_t* keys_u, int* upos, int* payload_u) {
  const int64_t base = blockIdx.x * kGTile + int64_t(threadIdx.x) * kGItems;
  int heads;
  int64_t csum;
  thread_sums(sk, k64, t, counts, base, heads, csum);
  int h_total;
  int64_t c_total;
  int64_t uid = int64_t(tile_heads_off[blockIdx.x]) +
                block_exclusive_scan<int>(heads, h_total);
  int64_t run = tile_csum_off[blockIdx.x] +
                block_exclusive_scan<int64_t>(csum, c_total);
  for (int j = 0; j < kGItems && uid <= u_cap; ++j) {
    const int64_t i = base + j;
    if (i >= t) break;
    if (row_is_head(sk, k64, t, i)) {
      hc[uid] = run;
      if (uid < u_cap) {
        upos[uid] = int(i);
        for (int w = 0; w < k64; ++w) {
          keys_u[int64_t(w) * u_cap + uid] = sk[int64_t(w) * t + i];
        }
        payload_u[uid] = payload != nullptr ? payload[perm[i]] : 0;
      }
      ++uid;
    }
    run += row_valid(sk, i) ? counts[i] : 0;
  }
}

__global__ void g_final(int k64, int64_t t, int64_t u_cap,
                        const int* n_unique, const int64_t* valid_sum,
                        const int64_t* hc, uint64_t* keys_u, int* upos,
                        int* payload_u, int64_t* totals) {
  const int64_t u = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= u_cap) return;
  const int64_t nu = *n_unique;
  if (u < nu) {
    totals[u] = (u + 1 < nu ? hc[u + 1] : *valid_sum) - hc[u];
  } else {
    totals[u] = 0;
    upos[u] = int(t - 1);
    payload_u[u] = 0;
    for (int w = 0; w < k64; ++w) keys_u[int64_t(w) * u_cap + u] = 0;
  }
}

struct GroupScratch {
  int64_t* tile_csum;
  int64_t* tile_csum_off;
  int64_t* hc;
  int64_t* valid_sum;
  int* tile_heads;
  int* tile_heads_off;
};

GroupScratch carve(void* scratch, int64_t t, int64_t u_cap) {
  const int64_t tiles = ceil_div(t, kGTile);
  char* p = static_cast<char*>(scratch);
  GroupScratch s;
  s.tile_csum = reinterpret_cast<int64_t*>(p);
  p += 8 * tiles;
  s.tile_csum_off = reinterpret_cast<int64_t*>(p);
  p += 8 * tiles;
  s.hc = reinterpret_cast<int64_t*>(p);
  p += 8 * (u_cap + 1);
  s.valid_sum = reinterpret_cast<int64_t*>(p);
  p += 8;
  s.tile_heads = reinterpret_cast<int*>(p);
  p += align8(4 * tiles);
  s.tile_heads_off = reinterpret_cast<int*>(p);
  return s;
}

}  // namespace

extern "C" {

int64_t dsi_group_scratch_bytes(int64_t t, int64_t u_cap) {
  const int64_t tiles = ceil_div(t, kGTile);
  return 16 * tiles + 8 * (u_cap + 1) + 8 + 2 * align8(4 * tiles);
}

// sorted_keys [k64, t] u64; counts [t] i64 per sorted row; payload [t] i32
// in pre-sort row order and perm [t] i32 from the sort (both null for no
// payload); keys_u [k64, u_cap] u64; totals [u_cap] i64; upos [u_cap] i32;
// payload_u [u_cap] i32; n_unique [1] i32.
int dsi_group(const void* sorted_keys, int k64, int64_t t, const void* counts,
              const void* payload, const void* perm, int64_t u_cap,
              void* keys_u, void* totals, void* upos, void* payload_u,
              void* n_unique, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* sk = static_cast<const uint64_t*>(sorted_keys);
  const int64_t* cnt = static_cast<const int64_t*>(counts);
  GroupScratch s = carve(scratch, t, u_cap);
  const unsigned tiles = unsigned(ceil_div(t, kGTile));
  int* nu = static_cast<int*>(n_unique);
  g_count<<<tiles, kGThreads, 0, st>>>(sk, k64, t, cnt, s.tile_heads,
                                       s.tile_csum);
  DSI_CHECK_LAUNCH();
  scan_exclusive_kernel<int><<<1, kScanThreads, 0, st>>>(
      s.tile_heads, s.tile_heads_off, tiles, nu);
  DSI_CHECK_LAUNCH();
  scan_exclusive_kernel<int64_t><<<1, kScanThreads, 0, st>>>(
      s.tile_csum, s.tile_csum_off, tiles, s.valid_sum);
  DSI_CHECK_LAUNCH();
  g_write<<<tiles, kGThreads, 0, st>>>(
      sk, k64, t, cnt, static_cast<const int*>(payload),
      static_cast<const int*>(perm), u_cap, s.tile_heads_off,
      s.tile_csum_off, s.hc, static_cast<uint64_t*>(keys_u),
      static_cast<int*>(upos), static_cast<int*>(payload_u));
  DSI_CHECK_LAUNCH();
  g_final<<<unsigned(ceil_div(u_cap, 256)), 256, 0, st>>>(
      k64, t, u_cap, nu, s.valid_sum, s.hc, static_cast<uint64_t*>(keys_u),
      static_cast<int*>(upos), static_cast<int*>(payload_u),
      static_cast<int64_t*>(totals));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
