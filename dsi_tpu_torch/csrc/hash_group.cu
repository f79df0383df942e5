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
//
// Design: a representative instead of the min and max of every key word.
// Each bucket holds a 32-bit `rep`, empty at first; a token claims it with
// one atomicCAS, and a token that loses compares its k64 key words with the
// representative's and, if any differs, stores the bucket's dirty flag (a
// plain, idempotent store).  With cnt (atomicAdd), len (atomicMax) and
// extra (atomicMin) that is at most 4 atomics a token, none 64-bit.  A
// bucket is dirty exactly when some token differs from its representative,
// which is exactly when some word's min differs from its max, and a clean
// bucket's key words are its representative's, whichever token won: the
// output equals the reference's bit for bit.  Four launches around B and C:
//   dsi_hash_bucket:   (1) one pass resets the bucket state and the
//     look-back slots and fills the dirty rows with pad rows (key words
//     all ones, extra 0xFFFFFFFF, length 0); (2) one thread per token
//     accumulates; (3) one launch compacts both, in input order, with
//     single-pass decoupled look-back scans (tiles from one ticket
//     counter: the dirty tokens' tiles, then the buckets'): the dirty
//     tokens to rows below d_cap (their count, n_dirty, is B's n_sort),
//     the clean buckets to the output rows below u_cap.
//   dsi_hash_assemble: (4) one thread per output row places the dirty
//     uniques at n_clean + i and zeroes the rest, and writes n_unique and
//     group_overflow.
// Every per-bucket reduction is an integer sum, min or max, so the order
// of the atomics cannot change the result, and both compactions keep
// their input order: the output is exact and deterministic.

#include "common.cuh"

namespace {

constexpr int kHThreads = 256;
constexpr int kHItems = 16;
constexpr int64_t kHTile = int64_t(kHThreads) * kHItems;
constexpr int kEmptyRep = -1;
constexpr unsigned kAggregate = 1, kInclusive = 2;  // look-back states

struct HashScratch {
  uint32_t* cnt;               // [nb] tokens per bucket
  int* len;                    // [nb] max token length
  uint32_t* ex;                // [nb] unsigned MIN of extra
  int* rep;                    // [nb] representative token, or kEmptyRep
  uint8_t* dirty;              // [nb] 1: some token differs from rep
  unsigned long long* status;  // [tiles over t + tiles over nb] look-back
  int* totals;                 // [3]: n_dirty, n_clean, ticket
};

HashScratch carve(void* scratch, int64_t t, int64_t nb) {
  char* p = static_cast<char*>(scratch);
  HashScratch s;
  s.cnt = reinterpret_cast<uint32_t*>(p);
  p += align8(4 * nb);
  s.len = reinterpret_cast<int*>(p);
  p += align8(4 * nb);
  s.ex = reinterpret_cast<uint32_t*>(p);
  p += align8(4 * nb);
  s.rep = reinterpret_cast<int*>(p);
  p += align8(4 * nb);
  s.dirty = reinterpret_cast<uint8_t*>(p);
  p += align8(nb);
  s.totals = reinterpret_cast<int*>(p);
  p += 16;
  s.status = reinterpret_cast<unsigned long long*>(p);
  return s;
}

__device__ __forceinline__ int64_t n_tokens(const int* n_valid, int64_t t) {
  const int64_t n = *n_valid;
  return n < t ? (n < 0 ? 0 : n) : t;
}

__global__ void hg_reset(int k64, int64_t nb, int64_t d_cap, int64_t slots,
                         bool with_extra, uint64_t* dkeys, int* dlen,
                         HashScratch s) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t i0 = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t b = i0; b < nb; b += stride) {
    s.cnt[b] = 0;
    s.len[b] = 0;
    s.ex[b] = 0xFFFFFFFFu;
    s.rep[b] = kEmptyRep;
    s.dirty[b] = 0;
  }
  for (int64_t j = i0; j < slots; j += stride) s.status[j] = 0;
  if (i0 < 3) s.totals[i0] = 0;
  for (int64_t r = i0; r < d_cap; r += stride) {
    for (int w = 0; w < k64; ++w) dkeys[int64_t(w) * d_cap + r] = ~0ull;
    if (with_extra) dkeys[int64_t(k64) * d_cap + r] = 0xFFFFFFFFull;
    dlen[r] = 0;
  }
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
  const int r = atomicCAS(&s.rep[b], kEmptyRep, int(i));
  if (r == kEmptyRep) return;
  for (int w = 0; w < k64; ++w) {
    if (keys[int64_t(w) * t + i] != keys[int64_t(w) * t + r]) {
      s.dirty[b] = 1;
      return;
    }
  }
}

// Exclusive prefix of a tile's `count` over the tiles before it, by
// decoupled look-back over status[0, tile); one thread calls it.
__device__ int64_t look_back(unsigned long long* status, int64_t tile,
                             unsigned count) {
  volatile unsigned long long* v = status;
  v[tile] = (static_cast<unsigned long long>(tile == 0 ? kInclusive
                                                       : kAggregate) << 32) |
            count;
  unsigned excl = 0;
  for (int64_t j = tile - 1; j >= 0; --j) {
    unsigned long long x;
    do {
      x = v[j];
    } while ((x >> 32) == 0);
    excl += unsigned(x);
    if ((x >> 32) == kInclusive) break;
  }
  if (tile > 0) {
    v[tile] = (static_cast<unsigned long long>(kInclusive) << 32) |
              (excl + count);
  }
  return excl;
}

__device__ __forceinline__ bool tok_dirty(const uint32_t* fnv, int64_t nv,
                                          int64_t nb, const uint8_t* dirty,
                                          int64_t i) {
  return i < nv && dirty[fnv[i] & uint32_t(nb - 1)] != 0;
}

__device__ __forceinline__ bool bkt_clean(const HashScratch& s, int64_t nb,
                                          int64_t b) {
  return b < nb && s.rep[b] != kEmptyRep && s.dirty[b] == 0;
}

// One launch, two ordered compactions: tiles [0, tt) of the tokens, then
// tiles [tt, tt + tb) of the buckets, in ticket order.
__global__ void __launch_bounds__(kHThreads)
    hg_compact(const uint64_t* keys, int k64, int64_t t, const int* lengths,
               const uint32_t* fnv, const int* n_valid, const uint32_t* extra,
               int64_t nb, int64_t d_cap, int64_t u_cap, uint64_t* dkeys,
               int* dlen, int* n_dirty, uint64_t* keys_u, int* len_u,
               int64_t* cnt_u, uint32_t* extra_u, HashScratch s) {
  __shared__ int64_t ticket, excl;
  if (threadIdx.x == 0) ticket = atomicAdd(&s.totals[2], 1);
  __syncthreads();
  const int64_t tt = ceil_div(t, kHTile), tb = ceil_div(nb, kHTile);
  const bool tokens = ticket < tt;
  const int64_t tile = tokens ? ticket : ticket - tt;
  const int64_t last = tokens ? tt - 1 : tb - 1;
  unsigned long long* status = s.status + (tokens ? 0 : tt);
  const int64_t base = tile * kHTile + int64_t(threadIdx.x) * kHItems;
  const int64_t nv = n_tokens(n_valid, t);
  int cnt = 0;
  for (int j = 0; j < kHItems; ++j) {
    cnt += (tokens ? tok_dirty(fnv, nv, nb, s.dirty, base + j)
                   : bkt_clean(s, nb, base + j)) ? 1 : 0;
  }
  int total;
  const int before = block_exclusive_scan<int>(cnt, total);
  if (threadIdx.x == 0) {
    excl = look_back(status, tile, unsigned(total));
    if (tile == last) {
      if (tokens) {
        s.totals[0] = int(excl + total);
        *n_dirty = int(excl + total);
      } else {
        s.totals[1] = int(excl + total);
      }
    }
  }
  __syncthreads();
  int64_t r = excl + before;
  if (tokens) {
    for (int j = 0; j < kHItems && r < d_cap; ++j) {
      const int64_t i = base + j;
      if (!tok_dirty(fnv, nv, nb, s.dirty, i)) continue;
      for (int w = 0; w < k64; ++w) {
        dkeys[int64_t(w) * d_cap + r] = keys[int64_t(w) * t + i];
      }
      if (extra != nullptr) dkeys[int64_t(k64) * d_cap + r] = extra[i];
      dlen[r] = lengths[i];
      ++r;
    }
    return;
  }
  for (int j = 0; j < kHItems && r < u_cap; ++j) {
    const int64_t b = base + j;
    if (!bkt_clean(s, nb, b)) continue;
    // A clean bucket's key words are its representative's.
    const int64_t rep = s.rep[b];
    for (int w = 0; w < k64; ++w) {
      keys_u[int64_t(w) * u_cap + r] = keys[int64_t(w) * t + rep];
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
  (void)k64;
  const int64_t tt = ceil_div(t, kHTile), tb = ceil_div(nb, kHTile);
  return 4 * align8(4 * nb) + align8(nb) + 16 + 8 * (tt + tb);
}

// keys [k64, t] u64; lengths [t] i32; fnv [t] u32; n_valid [1] i32 (rows
// below it are tokens); extra [t] u32 or null; nb a power of two; dkeys
// [k64 (+1 with extra), d_cap] u64 and dlen [d_cap] i32: the dirty rows in
// token order, then pad rows; n_dirty [1] i32: the dirty token count (may
// exceed d_cap); keys_u [k64, u_cap] u64, len_u [u_cap] i32, cnt_u [u_cap]
// i64, extra_u [u_cap] u32 or null: the clean buckets in bucket order.
int dsi_hash_bucket(const void* keys, int k64, int64_t t, const void* lengths,
                    const void* fnv, const void* n_valid, const void* extra,
                    int64_t nb, int64_t d_cap, int64_t u_cap, void* dkeys,
                    void* dlen, void* n_dirty, void* keys_u, void* len_u,
                    void* cnt_u, void* extra_u, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HashScratch s = carve(scratch, t, nb);
  const int64_t tt = ceil_div(t, kHTile), tb = ceil_div(nb, kHTile);
  const int64_t span = nb > d_cap ? nb : d_cap;
  hg_reset<<<unsigned(ceil_div(span, 256)), 256, 0, st>>>(
      k64, nb, d_cap, tt + tb, extra != nullptr,
      static_cast<uint64_t*>(dkeys), static_cast<int*>(dlen), s);
  DSI_CHECK_LAUNCH();
  const uint64_t* k = static_cast<const uint64_t*>(keys);
  const int* len = static_cast<const int*>(lengths);
  const uint32_t* h = static_cast<const uint32_t*>(fnv);
  const int* nv = static_cast<const int*>(n_valid);
  const uint32_t* ex = static_cast<const uint32_t*>(extra);
  hg_accumulate<<<unsigned(ceil_div(t, 256)), 256, 0, st>>>(
      k, k64, t, len, h, nv, ex, nb, s);
  DSI_CHECK_LAUNCH();
  hg_compact<<<unsigned(tt + tb), kHThreads, 0, st>>>(
      k, k64, t, len, h, nv, ex, nb, d_cap, u_cap,
      static_cast<uint64_t*>(dkeys), static_cast<int*>(dlen),
      static_cast<int*>(n_dirty), static_cast<uint64_t*>(keys_u),
      static_cast<int*>(len_u), static_cast<int64_t*>(cnt_u),
      static_cast<uint32_t*>(extra_u), s);
  DSI_CHECK_LAUNCH();
  return 0;
}

// After B and C over the dirty rows: dgk [k64, u_cap] u64, dtot [u_cap]
// i64, dupos [u_cap] i32, dlen_u [u_cap] i32 and n_du [1] i32 are kernel
// C's outputs; dsorted_extra [d_cap] u64 is the sorted extra key word (or
// null).  keys_u, len_u, cnt_u, extra_u as dsi_hash_bucket left them;
// scal [2] i32: n_unique, group_overflow.
int dsi_hash_assemble(int k64, int64_t nb, int64_t d_cap, int64_t u_cap,
                      const void* dgk, const void* dtot, const void* dupos,
                      const void* dlen_u, const void* n_du,
                      const void* dsorted_extra, void* keys_u, void* len_u,
                      void* cnt_u, void* extra_u, void* scal, void* scratch,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HashScratch s = carve(scratch, 0, nb);
  hg_final<<<unsigned(ceil_div(u_cap, 256)), 256, 0, st>>>(
      k64, d_cap, u_cap, static_cast<const uint64_t*>(dgk),
      static_cast<const int64_t*>(dtot), static_cast<const int*>(dupos),
      static_cast<const int*>(dlen_u), static_cast<const int*>(n_du),
      static_cast<const uint64_t*>(dsorted_extra),
      static_cast<uint64_t*>(keys_u), static_cast<int*>(len_u),
      static_cast<int64_t*>(cnt_u), static_cast<uint32_t*>(extra_u),
      static_cast<int*>(scal), s);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
