// Kernel I: the Glushkov NFA scan of grep's fourth tier.
//
// Replaces K15, dsi_tpu/ops/nfak.py nfa_kernel (:303).  The pattern is an
// NFA of S <= 48 states (S in {16, 32, 48}); the reference holds it as a
// [256, S, S] f32 boolean table and multiplies matrices over the boolean
// semiring (f32 matmul, then > 0).  Here every state row is a bit set in
// one uint64_t: bits[b * S + s] = the states that state s reaches on byte
// b, and a boolean product is a walk over the set bits of a row, with no
// float and no tensor core.  The reference's phases are (1) the transition
// relation of every 256-byte block, (2) an exclusive prefix of those
// relations across blocks, applied to the start vector (a log-depth
// associative_scan, nfak.py:330), (3) every block re-walked from its entry
// vector, mask[i] = bit S-1 | bit S-2 of the state AFTER byte i (the
// persisting latch and the one-position $ end-latch, nfak.py:337-342),
// then (4) the line flags.  The product is exact and associative, so any
// blocking gives the reference's mask; padding bytes (0) are line ends
// that keep the latch alive, which lives in the table (_build_table).
//
// Bound: operations, by the bit-set work (about n x S row lookups and ORs
// in phase 1); the bytes (the chunk, 2 MiB, and the flags) take less.
// Design, two launches and then kernel H's one-pass line flags over the
// mask (csrc/grep.cu mask_lines, one launch), with no chain of n / 256
// dependent steps:
//
//   nfa_prep   the float table and start vector turned into bit sets (one
//              ballot a row), and the look-back words and ticket zeroed,
//              the epilogue's with them.
//   nfa_scan   one block a group of kGroup 256-byte blocks, numbered by a
//              ticket in the order blocks start.  The bit-set table lives in
//              dynamic shared memory (98 KiB at S = 48, with the opt-in; its
//              rows an odd number of words apart, so a warp's lookups of
//              one state for 32 bytes spread over the banks) and the
//              group's bytes are staged there once.  (1) Each warp walks
//              one state row through 32 blocks, a lane a block, and stops
//              when all 32 rows are empty (most rows die within a line).
//              (2) Threads s < S walk row s through the group's block
//              relations, keeping every exclusive in-group prefix P_k and
//              the group's aggregate A_g, which is published at once.  The
//              group's entry vector comes from a decoupled look-back over
//              the groups before it (Merrill & Garland, as common.cuh's
//              LookBack, with a relation for the aggregate and one u64 for
//              the inclusive vector, state and vector in one status word):
//              a window of 32 predecessors is read at a time; from the
//              nearest inclusive one its vector is stepped through the
//              aggregates after it, and a window without one is composed
//              into a relation (S row walks of 32 steps) and the walk goes
//              on.  The block entries are v_g . P_k, one step each.  (3)
//              A thread a block re-walks its 256 bytes, writing latch bytes
//              over the staged chunk, and the block stores the group's mask
//              as 16-byte words.
//
// dsi_nfa's `phases` (1, 2 or 3) stops the scan after that phase, without
// the epilogue, so each phase's device time can be read by difference.

#include "common.cuh"

extern "C" int dsi_line_flags_prezeroed(const void* chunk, int64_t n,
                                        const void* mask, int64_t l_cap,
                                        void* line_match, void* scalars,
                                        void* scratch, void* stream);
extern "C" int64_t dsi_grep_scratch_bytes(int64_t n);

namespace {

constexpr int kBlk = 256;       // bytes a block relation covers
constexpr int kGroup = 64;      // blocks a group (a CUDA block each)
constexpr int kStride = kBlk + 4;  // staged bytes of a block, bank-skewed
constexpr int kThreads = 1024;
constexpr int kWindow = 32;     // predecessors read per look-back round
constexpr int kMaxS = 64;
constexpr int64_t kGroupBytes = int64_t(kGroup) * kBlk;
constexpr unsigned long long kAgg = 1ull << 62, kInc = 2ull << 62;
constexpr unsigned long long kVecMask = (1ull << 62) - 1;

// v . M: the union of the rows of M (S u64, shared or global) of the
// states set in v.
__device__ __forceinline__ uint64_t step(uint64_t v, const uint64_t* rows) {
  uint64_t acc = 0;
  while (v) {
    const int s = __ffsll(static_cast<long long>(v)) - 1;
    v &= v - 1;
    acc |= rows[s];
  }
  return acc;
}

__global__ void nfa_prep(const float* table, const float* v0, int S,
                         uint64_t* bits, uint64_t* v0bits,
                         unsigned long long* status, int64_t words) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x;
  for (int s = warp; s < S; s += warps) {
    const float* row = table + (int64_t(b) * S + s) * S;
    const unsigned lo = __ballot_sync(kFullMask, lane < S && row[lane] > 0.f);
    const unsigned hi =
        __ballot_sync(kFullMask, lane + 32 < S && row[lane + 32] > 0.f);
    if (lane == 0) bits[b * S + s] = (uint64_t(hi) << 32) | lo;
  }
  if (b == 0 && warp == 0) {
    const unsigned lo = __ballot_sync(kFullMask, lane < S && v0[lane] > 0.f);
    const unsigned hi =
        __ballot_sync(kFullMask, lane + 32 < S && v0[lane + 32] > 0.f);
    if (lane == 0) *v0bits = (uint64_t(hi) << 32) | lo;
  }
  for (int64_t i = int64_t(b) * blockDim.x + threadIdx.x; i < words;
       i += int64_t(gridDim.x) * blockDim.x)
    status[i] = 0;
}

struct ScanArgs {
  const uint8_t* chunk;
  int64_t n;
  int S;
  const uint64_t* bits;
  const uint64_t* v0bits;
  unsigned long long* status;  // [groups]
  unsigned* ticket;
  uint64_t* agg;               // [groups, S]
  uint8_t* mask;               // [n]
  int phases;
};

__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* p) {
  unsigned long long w = ld_acquire(p);
  while ((w & ~kVecMask) == 0) {
    __nanosleep(32);
    w = ld_acquire(p);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads) nfa_scan(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int S = a.S;
  // The table's rows are S + 1 words apart: an odd stride, so lanes that
  // read one state's row of different bytes fall on different banks (a
  // stride of S words, a multiple of 128 bytes, put them all on one).
  const int ts = S + 1;
  uint64_t* table = reinterpret_cast<uint64_t*>(sm);         // [256, S + 1]
  uint64_t* rel = table + 256 * ts;                          // [kGroup, S]
  uint64_t* pre = rel + kGroup * S;                          // [kGroup, S]
  uint64_t* comp = pre + kGroup * S;                         // [kMaxS]
  uint64_t* entry = comp + kMaxS;                            // [kGroup]
  // [kGroup, kStride]
  uint8_t* text = reinterpret_cast<uint8_t*>(entry + kGroup);
  __shared__ unsigned long long lb_word[kWindow];
  __shared__ int lb_found, lb_next;
  __shared__ uint64_t lb_v;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t g = claim_tile(a.ticket);
  const int64_t g0 = g * kGroupBytes;
  const int64_t g_len = a.n - g0 < kGroupBytes ? a.n - g0 : kGroupBytes;

  // The table and the group's bytes into shared memory.
  for (int i = tid; i < 256 * S; i += kThreads)
    table[(i / S) * ts + i % S] = a.bits[i];
  const bool vec = g_len == kGroupBytes &&
                   (reinterpret_cast<uintptr_t>(a.chunk) & 15) == 0;
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(a.chunk + g0);
    for (int i = tid; i < int(kGroupBytes / 16); i += kThreads) {
      const uint4 w = src[i];
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          text + (i / (kBlk / 16)) * kStride + (i % (kBlk / 16)) * 16);
      dst[0] = w.x;
      dst[1] = w.y;
      dst[2] = w.z;
      dst[3] = w.w;
    }
  } else {
    for (int i = tid; i < g_len; i += kThreads)
      text[(i / kBlk) * kStride + i % kBlk] = a.chunk[g0 + i];
  }
  __syncthreads();

  // (1) Block relations: warp item (row r, 32 blocks), lane = block; a
  // row's halves go to neighbouring warps (the sentinel's row never dies).
  constexpr int kHalves = kGroup / 32;
  for (int it = warp; it < S * kHalves; it += kThreads / 32) {
    const int r = it / kHalves;
    const int k = (it % kHalves) * 32 + lane;
    const int64_t k0 = int64_t(k) * kBlk;
    const int len = g_len <= k0 ? 0 : (g_len - k0 < kBlk ? int(g_len - k0)
                                                         : kBlk);
    const uint8_t* p = text + k * kStride;
    uint64_t v = 1ull << r;
    for (int i0 = 0; i0 < kBlk; i0 += 32) {
      if (!__any_sync(kFullMask, v != 0 && i0 < len)) break;
      const int end = len < i0 + 32 ? len : i0 + 32;
      for (int i = i0; i < end; ++i) v = step(v, table + p[i] * ts);
    }
    rel[k * S + r] = v;
  }
  __syncthreads();

  // (2a) In-group exclusive prefixes and the group's aggregate.
  if (tid < S) {
    uint64_t v = 1ull << tid;
    for (int k = 0; k < kGroup; ++k) {
      pre[k * S + tid] = v;
      v = step(v, rel + k * S);
    }
    comp[tid] = v;  // the aggregate's row tid
    if (g > 0) {
      a.agg[g * S + tid] = v;
      __threadfence();
    }
  }
  __syncthreads();
  if (a.phases < 2) return;
  if (tid == 0) {
    if (g == 0) {
      lb_v = *a.v0bits;
      st_release(a.status, kInc | step(lb_v, comp));
    } else {
      st_release(a.status + g, kAgg);
    }
  }
  __syncthreads();

  // (2b) The group's entry vector: a decoupled look-back.  comp now holds
  // the composition of the aggregates after the current window (identity
  // to start).
  if (g > 0) {
    if (tid < S) comp[tid] = 1ull << tid;
    if (tid == 0) lb_next = int(g) - 1;
    __syncthreads();
    for (;;) {
      const int j = lb_next;  // highest predecessor not yet applied
      if (warp == 0) {
        const int p = j - lane;
        const unsigned long long w =
            p >= 0 ? wait_status(a.status + p) : kInc | *a.v0bits;
        lb_word[lane] = w;
        const unsigned inc = __ballot_sync(kFullMask, (w & ~kVecMask) == kInc);
        if (lane == 0) lb_found = inc ? __ffs(int(inc)) - 1 : -1;
      }
      __syncthreads();
      const int q0 = lb_found;                    // window slot, or -1
      const int cnt = q0 >= 0 ? q0 : kWindow;      // aggregates to apply
      // Aggregates j - cnt + 1 .. j into rel (rel is free after (2a)).
      for (int i = tid; i < cnt * S; i += kThreads) {
        const int q = i / S;
        rel[i] = __ldcg(reinterpret_cast<const unsigned long long*>(a.agg) +
                        int64_t(j - cnt + 1 + q) * S + i % S);
      }
      __syncthreads();
      if (q0 >= 0) {
        if (tid == 0) {
          uint64_t v = lb_word[q0] & kVecMask;
          for (int q = 0; q < cnt; ++q) v = step(v, rel + q * S);
          lb_v = step(v, comp);
        }
        __syncthreads();
        break;
      }
      uint64_t row = 0;
      if (tid < S) {
        row = 1ull << tid;
        for (int q = 0; q < kWindow; ++q) row = step(row, rel + q * S);
        row = step(row, comp);
      }
      __syncthreads();
      if (tid < S) comp[tid] = row;
      if (tid == 0) lb_next = j - kWindow;
      __syncthreads();
    }
    // Publish the inclusive vector: the entry through the aggregate.
    if (tid < S) comp[tid] = a.agg[g * S + tid];
    __syncthreads();
    if (tid == 0) st_release(a.status + g, kInc | step(lb_v, comp));
  }
  const uint64_t v_g = lb_v;
  if (tid < kGroup) entry[tid] = step(v_g, pre + tid * S);
  __syncthreads();
  if (a.phases < 3) return;

  // (3) The re-walk, latch bytes over the staged chunk, then the mask.
  if (tid < kGroup) {
    const int64_t k0 = int64_t(tid) * kBlk;
    const int len = g_len <= k0 ? 0 : (g_len - k0 < kBlk ? int(g_len - k0)
                                                         : kBlk);
    uint8_t* p = text + tid * kStride;
    uint64_t v = entry[tid];
    for (int i = 0; i < len; ++i) {
      v = step(v, table + p[i] * ts);
      p[i] = uint8_t(((v >> (S - 1)) | (v >> (S - 2))) & 1);
    }
  }
  __syncthreads();
  if (vec && (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0) {
    uint4* dst = reinterpret_cast<uint4*>(a.mask + g0);
    for (int i = tid; i < int(kGroupBytes / 16); i += kThreads) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          text + (i / (kBlk / 16)) * kStride + (i % (kBlk / 16)) * 16);
      dst[i] = make_uint4(src[0], src[1], src[2], src[3]);
    }
  } else {
    for (int i = tid; i < g_len; i += kThreads)
      a.mask[g0 + i] = text[(i / kBlk) * kStride + i % kBlk];
  }
}

int64_t groups_of(int64_t n) { return ceil_div(n, kGroupBytes); }

int64_t scan_smem(int S) {
  return (256 * int64_t(S + 1) + 2 * kGroup * S) * 8 + (kMaxS + kGroup) * 8 +
         int64_t(kGroup) * kStride;
}

// Scratch: mask [n] u8, bits [256, S] u64, v0bits, status [groups] u64,
// the ticket, the epilogue's look-back state, agg [groups, S] u64.  The
// status words, the ticket and the epilogue's state are contiguous, all
// zeroed by nfa_prep.
struct Layout {
  int64_t bits, v0, status, ticket, flags, agg, total;
};

Layout layout(int64_t n, int S) {
  const int64_t groups = groups_of(n);
  Layout l;
  l.bits = align8(n);
  l.v0 = l.bits + 256 * int64_t(S) * 8;
  l.status = l.v0 + 8;
  l.ticket = l.status + groups * 8;
  l.flags = l.ticket + 8;
  l.agg = l.flags + dsi_grep_scratch_bytes(n);
  l.total = l.agg + groups * S * 8;
  return l;
}

}  // namespace

extern "C" {

int64_t dsi_nfa_scratch_bytes(int64_t n, int S) { return layout(n, S).total; }

// Bytes of a group: one CUDA block's share of the chunk and one
// look-back aggregate.
int64_t dsi_nfa_group_bytes() { return kGroupBytes; }

// chunk [n] u8 (n % min(256, n) == 0); table [256, S, S] f32 and v0 [S]
// f32 (0 or 1); line_match [l_cap] i32; scalars [2] i32 = n_lines,
// overflow.  phases 3 runs everything; 1 or 2 stops the scan after that
// phase and skips the epilogue (for timing).
int dsi_nfa(const void* chunk, int64_t n, const void* table, int S,
            const void* v0, int64_t l_cap, void* line_match, void* scalars,
            void* scratch, int phases, void* stream) {
  const int64_t blk = n < kBlk ? n : kBlk;
  if (n < 1 || n % blk != 0 || S < 2 || S > 48 || l_cap < 1 || phases < 1 ||
      phases > 3)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(n, S);
  char* base = static_cast<char*>(scratch);
  ScanArgs a;
  a.chunk = static_cast<const uint8_t*>(chunk);
  a.n = n;
  a.S = S;
  a.bits = reinterpret_cast<const uint64_t*>(base + l.bits);
  a.v0bits = reinterpret_cast<const uint64_t*>(base + l.v0);
  a.status = reinterpret_cast<unsigned long long*>(base + l.status);
  a.ticket = reinterpret_cast<unsigned*>(base + l.ticket);
  a.agg = reinterpret_cast<uint64_t*>(base + l.agg);
  a.mask = reinterpret_cast<uint8_t*>(base);
  a.phases = phases;
  const int64_t groups = groups_of(n);
  // The status words, the ticket and the epilogue's state are contiguous:
  // one zeroing loop.
  nfa_prep<<<256, 128, 0, s>>>(
      static_cast<const float*>(table), static_cast<const float*>(v0), S,
      reinterpret_cast<uint64_t*>(base + l.bits),
      reinterpret_cast<uint64_t*>(base + l.v0), a.status,
      (l.agg - l.status) / 8);
  DSI_CHECK_LAUNCH();
  const int64_t smem = scan_smem(S);
  cudaError_t e = cudaFuncSetAttribute(
      nfa_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  nfa_scan<<<unsigned(groups), kThreads, size_t(smem), s>>>(a);
  DSI_CHECK_LAUNCH();
  if (phases < 3) return 0;
  return dsi_line_flags_prezeroed(chunk, n, a.mask, l_cap, line_match,
                                  scalars, base + l.flags, stream);
}

}  // extern "C"
