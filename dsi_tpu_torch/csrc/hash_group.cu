// Kernel F: the hash grouper.
//
// Replaces K5, _hash_group (dsi_tpu/ops/wordcount.py:199-320), which
// groups identical tokens without the big sort: each token goes to the
// bucket fnv & (n_buckets-1) of its FNV-1a hash; per bucket the token
// count, the max length, the unsigned MIN of an optional u32 payload
// (`extra`, the corpus path's pos << 7 | len) and the min and max of every
// u64 key word.  A bucket is dirty when it is occupied and some key word's
// min differs from its max: two distinct words share it.  Tokens of dirty
// buckets are compacted in token order into d_cap rows, which kernels B
// and C sort and group exactly (with `extra` as one more key word after
// the k64 key words); group_overflow = n_dirty > d_cap.  The output is the
// clean buckets in bucket-index order, then the dirty uniques in sorted
// order, cut at u_cap, zero past n_unique; n_unique stays true above u_cap
// so the capacity ladder can widen.
//
// Bound: memory bytes (the token keys, lengths, hashes and payload read
// once, the u_cap output rows written once; the bucket state is scratch).
// Design: two entry points around B and C.
//   dsi_hash_bucket:   (1) memsets of the bucket state; (2) one thread per
//     token, atomics into its bucket (min/max of the key words as unsigned
//     64-bit atomics, so the clean bucket's max is its one word, as the
//     reference's unsigned segment_max); (3) one thread per bucket writes
//     its flag: empty, clean or dirty; (4)-(6) ordered compaction of the
//     dirty tokens: per-tile counts, a one-block scan (total = n_dirty),
//     then each tile ranks its dirty tokens with a block scan and writes
//     the rows below d_cap, and the pad rows [n_dirty, d_cap) after.
//   dsi_hash_assemble: (1)-(3) ordered compaction of the clean buckets to
//     u_cap rows, the same three passes over the buckets; (4) one thread
//     per output row places the dirty uniques at n_clean + i and zeroes
//     the rest, and writes n_unique and group_overflow.
// Every per-bucket reduction is an integer sum, min or max, so the order
// of the atomics cannot change the result, and both compactions keep
// their input order: the output is exact and deterministic.

#include "common.cuh"

namespace {

constexpr int kHThreads = 256;
constexpr int kHItems = 16;
constexpr int64_t kHTile = int64_t(kHThreads) * kHItems;

constexpr uint8_t kEmpty = 0, kClean = 1, kDirty = 2;

struct HashScratch {
  uint32_t* cnt;            // [nb] tokens per bucket
  int* len;                 // [nb] max token length
  uint32_t* ex;             // [nb] unsigned MIN of extra
  unsigned long long* kmin; // [k64, nb]
  unsigned long long* kmax; // [k64, nb]
  uint8_t* flag;            // [nb] kEmpty / kClean / kDirty
  int* tok_tiles;           // [tiles over t] dirty tokens per tile
  int* tok_offsets;
  int* bkt_tiles;           // [tiles over nb] clean buckets per tile
  int* bkt_offsets;
  int* totals;              // [2] n_dirty, n_clean
};

HashScratch carve(void* scratch, int k64, int64_t t, int64_t nb) {
  char* p = static_cast<char*>(scratch);
  HashScratch s;
  // Zeroed: cnt, len.  All ones: ex, kmin.  Zeroed: kmax.  In this order,
  // so three memsets reset the state.
  s.cnt = reinterpret_cast<uint32_t*>(p);
  p += 4 * nb;
  s.len = reinterpret_cast<int*>(p);
  p += 4 * nb;
  s.ex = reinterpret_cast<uint32_t*>(p);
  p += 4 * nb;
  p = static_cast<char*>(scratch) + align8(12 * nb);
  s.kmin = reinterpret_cast<unsigned long long*>(p);
  p += 8 * int64_t(k64) * nb;
  s.kmax = reinterpret_cast<unsigned long long*>(p);
  p += 8 * int64_t(k64) * nb;
  s.flag = reinterpret_cast<uint8_t*>(p);
  p += align8(nb);
  // The bucket tiles and totals come before the token tiles, so the
  // assembly (which has no t) carves the same addresses with t = 0.
  const int64_t tb = ceil_div(nb, kHTile), tt = ceil_div(t, kHTile);
  s.bkt_tiles = reinterpret_cast<int*>(p);
  p += align8(4 * tb);
  s.bkt_offsets = reinterpret_cast<int*>(p);
  p += align8(4 * tb);
  s.totals = reinterpret_cast<int*>(p);
  p += 8;
  s.tok_tiles = reinterpret_cast<int*>(p);
  p += align8(4 * tt);
  s.tok_offsets = reinterpret_cast<int*>(p);
  return s;
}

__device__ __forceinline__ int64_t n_tokens(const int* n_valid, int64_t t) {
  const int64_t n = *n_valid;
  return n < t ? (n < 0 ? 0 : n) : t;
}

__global__ void hg_accumulate(const uint64_t* keys, int k64, int64_t t,
                              const int* lengths, const uint32_t* fnv,
                              const int* n_valid, const uint32_t* extra,
                              int64_t nb, HashScratch s) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_tokens(n_valid, t)) return;
  const int64_t b = fnv[i] & uint32_t(nb - 1);
  atomicAdd(&s.cnt[b], 1u);
  atomicMax(&s.len[b], lengths[i]);
  if (extra != nullptr) atomicMin(&s.ex[b], extra[i]);
  for (int w = 0; w < k64; ++w) {
    const unsigned long long k = keys[int64_t(w) * t + i];
    atomicMin(&s.kmin[int64_t(w) * nb + b], k);
    atomicMax(&s.kmax[int64_t(w) * nb + b], k);
  }
}

__global__ void hg_flags(int k64, int64_t nb, HashScratch s) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint8_t f = kEmpty;
  if (s.cnt[b] > 0) {
    bool dirty = false;
    for (int w = 0; w < k64; ++w) {
      dirty |= s.kmin[int64_t(w) * nb + b] != s.kmax[int64_t(w) * nb + b];
    }
    f = dirty ? kDirty : kClean;
  }
  s.flag[b] = f;
}

__device__ __forceinline__ bool tok_dirty(const uint32_t* fnv, int64_t nv,
                                          int64_t nb, const uint8_t* flag,
                                          int64_t i) {
  return i < nv && flag[fnv[i] & uint32_t(nb - 1)] == kDirty;
}

__global__ void hg_tok_count(const uint32_t* fnv, int64_t t,
                             const int* n_valid, int64_t nb, HashScratch s) {
  const int64_t base = blockIdx.x * kHTile + int64_t(threadIdx.x) * kHItems;
  const int64_t nv = n_tokens(n_valid, t);
  int cnt = 0;
  for (int j = 0; j < kHItems; ++j) {
    cnt += tok_dirty(fnv, nv, nb, s.flag, base + j) ? 1 : 0;
  }
  int total;
  block_exclusive_scan<int>(cnt, total);
  if (threadIdx.x == 0) s.tok_tiles[blockIdx.x] = total;
}

__global__ void hg_tok_write(const uint64_t* keys, int k64, int64_t t,
                             const int* lengths, const uint32_t* fnv,
                             const int* n_valid, const uint32_t* extra,
                             int64_t nb, int64_t d_cap, uint64_t* dkeys,
                             int* dlen, HashScratch s) {
  const int64_t base = blockIdx.x * kHTile + int64_t(threadIdx.x) * kHItems;
  const int64_t nv = n_tokens(n_valid, t);
  int cnt = 0;
  for (int j = 0; j < kHItems; ++j) {
    cnt += tok_dirty(fnv, nv, nb, s.flag, base + j) ? 1 : 0;
  }
  int total;
  int64_t r = int64_t(s.tok_offsets[blockIdx.x]) +
              block_exclusive_scan<int>(cnt, total);
  for (int j = 0; j < kHItems && r < d_cap; ++j) {
    const int64_t i = base + j;
    if (!tok_dirty(fnv, nv, nb, s.flag, i)) continue;
    for (int w = 0; w < k64; ++w) {
      dkeys[int64_t(w) * d_cap + r] = keys[int64_t(w) * t + i];
    }
    if (extra != nullptr) dkeys[int64_t(k64) * d_cap + r] = extra[i];
    dlen[r] = lengths[i];
    ++r;
  }

  // Pad rows: key words all ones (sort last), extra 0xFFFFFFFF, length 0.
  const int64_t n_dirty = s.totals[0];
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t p = n_dirty + int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       p < d_cap; p += stride) {
    for (int w = 0; w < k64; ++w) dkeys[int64_t(w) * d_cap + p] = ~0ull;
    if (extra != nullptr) dkeys[int64_t(k64) * d_cap + p] = 0xFFFFFFFFull;
    dlen[p] = 0;
  }
}

__global__ void hg_clean_count(int64_t nb, HashScratch s) {
  const int64_t base = blockIdx.x * kHTile + int64_t(threadIdx.x) * kHItems;
  int cnt = 0;
  for (int j = 0; j < kHItems; ++j) {
    const int64_t b = base + j;
    cnt += (b < nb && s.flag[b] == kClean) ? 1 : 0;
  }
  int total;
  block_exclusive_scan<int>(cnt, total);
  if (threadIdx.x == 0) s.bkt_tiles[blockIdx.x] = total;
}

__global__ void hg_clean_write(int k64, int64_t nb, int64_t u_cap,
                               uint64_t* keys_u, int* len_u, int64_t* cnt_u,
                               uint32_t* extra_u, HashScratch s) {
  const int64_t base = blockIdx.x * kHTile + int64_t(threadIdx.x) * kHItems;
  int cnt = 0;
  for (int j = 0; j < kHItems; ++j) {
    const int64_t b = base + j;
    cnt += (b < nb && s.flag[b] == kClean) ? 1 : 0;
  }
  int total;
  int64_t r = int64_t(s.bkt_offsets[blockIdx.x]) +
              block_exclusive_scan<int>(cnt, total);
  for (int j = 0; j < kHItems && r < u_cap; ++j) {
    const int64_t b = base + j;
    if (b >= nb || s.flag[b] != kClean) continue;
    // A clean bucket's max key word IS its one word's key word.
    for (int w = 0; w < k64; ++w) {
      keys_u[int64_t(w) * u_cap + r] = s.kmax[int64_t(w) * nb + b];
    }
    len_u[r] = s.len[b];
    cnt_u[r] = s.cnt[b];
    if (extra_u != nullptr) extra_u[r] = s.ex[b];
    ++r;
  }
}

__global__ void hg_final(int k64, int64_t d_cap, int64_t u_cap,
                         const uint64_t* dgk, const int64_t* dtot,
                         const int* dupos, const int* dlen_u,
                         const int* n_du, const uint64_t* dsorted_extra,
                         uint64_t* keys_u, int* len_u, int64_t* cnt_u,
                         uint32_t* extra_u, int* scal, HashScratch s) {
  const int64_t u = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_clean = s.totals[1];
  const int64_t ndu = *n_du;
  if (u == 0) {
    scal[0] = int(n_clean + ndu);
    scal[1] = int64_t(s.totals[0]) > d_cap ? 1 : 0;
  }
  if (u >= u_cap || u < n_clean) return;
  const int64_t i = u - n_clean;  // i < u_cap: the repair's output rows
  if (i < ndu) {
    for (int w = 0; w < k64; ++w) {
      keys_u[int64_t(w) * u_cap + u] = dgk[int64_t(w) * u_cap + i];
    }
    len_u[u] = dlen_u[i];
    cnt_u[u] = dtot[i];
    if (extra_u != nullptr) extra_u[u] = uint32_t(dsorted_extra[dupos[i]]);
  } else {
    for (int w = 0; w < k64; ++w) keys_u[int64_t(w) * u_cap + u] = 0;
    len_u[u] = 0;
    cnt_u[u] = 0;
    if (extra_u != nullptr) extra_u[u] = 0;
  }
}

}  // namespace

extern "C" {

int64_t dsi_hash_group_scratch_bytes(int k64, int64_t t, int64_t nb) {
  const int64_t tt = ceil_div(t, kHTile), tb = ceil_div(nb, kHTile);
  return align8(12 * nb) + 16 * int64_t(k64) * nb + align8(nb) +
         2 * align8(4 * tt) + 2 * align8(4 * tb) + 8;
}

// keys [k64, t] u64; lengths [t] i32; fnv [t] u32; n_valid [1] i32 (rows
// below it are tokens); extra [t] u32 or null; nb a power of two; dkeys
// [k64 (+1 with extra), d_cap] u64 and dlen [d_cap] i32: the dirty rows in
// token order, then pad rows.
int dsi_hash_bucket(const void* keys, int k64, int64_t t, const void* lengths,
                    const void* fnv, const void* n_valid, const void* extra,
                    int64_t nb, int64_t d_cap, void* dkeys, void* dlen,
                    void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HashScratch s = carve(scratch, k64, t, nb);
  const cudaError_t resets[] = {
      cudaMemsetAsync(s.cnt, 0, 8 * nb, st),  // cnt, len
      cudaMemsetAsync(s.ex, 0xFF, 4 * nb, st),
      cudaMemsetAsync(s.kmin, 0xFF, 8 * int64_t(k64) * nb, st),
      cudaMemsetAsync(s.kmax, 0, 8 * int64_t(k64) * nb, st)};
  for (cudaError_t e : resets) {
    if (e != cudaSuccess) return int(e);
  }
  const uint64_t* k = static_cast<const uint64_t*>(keys);
  const int* len = static_cast<const int*>(lengths);
  const uint32_t* h = static_cast<const uint32_t*>(fnv);
  const int* nv = static_cast<const int*>(n_valid);
  const uint32_t* ex = static_cast<const uint32_t*>(extra);
  hg_accumulate<<<unsigned(ceil_div(t, 256)), 256, 0, st>>>(
      k, k64, t, len, h, nv, ex, nb, s);
  DSI_CHECK_LAUNCH();
  hg_flags<<<unsigned(ceil_div(nb, 256)), 256, 0, st>>>(k64, nb, s);
  DSI_CHECK_LAUNCH();
  const unsigned tiles = unsigned(ceil_div(t, kHTile));
  hg_tok_count<<<tiles, kHThreads, 0, st>>>(h, t, nv, nb, s);
  DSI_CHECK_LAUNCH();
  scan_exclusive_kernel<int><<<1, kScanThreads, 0, st>>>(
      s.tok_tiles, s.tok_offsets, tiles, &s.totals[0]);
  DSI_CHECK_LAUNCH();
  hg_tok_write<<<tiles, kHThreads, 0, st>>>(
      k, k64, t, len, h, nv, ex, nb, d_cap, static_cast<uint64_t*>(dkeys),
      static_cast<int*>(dlen), s);
  DSI_CHECK_LAUNCH();
  return 0;
}

// After B and C over the dirty rows: dgk [k64, u_cap] u64, dtot [u_cap]
// i64, dupos [u_cap] i32, dlen_u [u_cap] i32 and n_du [1] i32 are kernel
// C's outputs; dsorted_extra [d_cap] u64 is the sorted extra key word (or
// null).  keys_u [k64, u_cap] u64; len_u [u_cap] i32; cnt_u [u_cap] i64;
// extra_u [u_cap] u32 or null; scal [2] i32: n_unique, group_overflow.
int dsi_hash_assemble(int k64, int64_t nb, int64_t d_cap, int64_t u_cap,
                      const void* dgk, const void* dtot, const void* dupos,
                      const void* dlen_u, const void* n_du,
                      const void* dsorted_extra, void* keys_u, void* len_u,
                      void* cnt_u, void* extra_u, void* scal, void* scratch,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HashScratch s = carve(scratch, k64, 0, nb);
  const unsigned tiles = unsigned(ceil_div(nb, kHTile));
  uint64_t* ku = static_cast<uint64_t*>(keys_u);
  int* lu = static_cast<int*>(len_u);
  int64_t* cu = static_cast<int64_t*>(cnt_u);
  uint32_t* eu = static_cast<uint32_t*>(extra_u);
  hg_clean_count<<<tiles, kHThreads, 0, st>>>(nb, s);
  DSI_CHECK_LAUNCH();
  scan_exclusive_kernel<int><<<1, kScanThreads, 0, st>>>(
      s.bkt_tiles, s.bkt_offsets, tiles, &s.totals[1]);
  DSI_CHECK_LAUNCH();
  hg_clean_write<<<tiles, kHThreads, 0, st>>>(k64, nb, u_cap, ku, lu, cu,
                                              eu, s);
  DSI_CHECK_LAUNCH();
  hg_final<<<unsigned(ceil_div(u_cap, 256)), 256, 0, st>>>(
      k64, d_cap, u_cap, static_cast<const uint64_t*>(dgk),
      static_cast<const int64_t*>(dtot), static_cast<const int*>(dupos),
      static_cast<const int*>(dlen_u), static_cast<const int*>(n_du),
      static_cast<const uint64_t*>(dsorted_extra), ku, lu, cu, eu,
      static_cast<int*>(scal), s);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
