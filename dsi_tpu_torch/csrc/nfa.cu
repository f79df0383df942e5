// Kernel I: the Glushkov NFA scan of grep's fourth tier.
//
// Replaces K15, dsi_tpu/ops/nfak.py nfa_kernel (:303).  The pattern is an
// NFA of S <= 48 states (S in {16, 32, 48}); the reference holds it as a
// [256, S, S] f32 boolean table and multiplies matrices over the boolean
// semiring (f32 matmul, then > 0).  Here every state row is a bit set in
// one uint64_t: bits[b * S + s] = the states that state s reaches on byte
// b, and a boolean product is a walk over the set bits of a row, with no
// float and no tensor core.  Phases, as the reference's:
//
//   1. nfa_block_rel: per block of `blk` (= 256) bytes, the transition
//      relation of the whole block as S u64 rows (thread r walks row r
//      through the block's bytes);
//   2. nfa_prefix: the state vector entering every block, an exclusive
//      prefix v0 . R[0] . R[1] ... (one warp, sequential over blocks: each
//      step is S loads and a 5-step OR reduction);
//   3. nfa_walk: each block re-walked from its entry vector, one thread a
//      block, writing mask[i] = bit S-1 | bit S-2 of the state AFTER byte i
//      (the persisting latch and the one-position $ end-latch,
//      nfak.py:337-342);
//   4. kernel H's line-flag epilogue (dsi_line_flags in csrc/grep.cu).
//
// The product is exact and associative, so any blocking gives the
// reference's mask.  Padding bytes (0) are line ends that keep the latch
// alive (nfak.py _build_table :241-242): that lives in the table, not here.
//
// Bound: operations, by the bit-set work (about n x S row lookups and ORs
// in phase 1); the bytes (the chunk, 2 MiB, and the flags) take less.
// Phase 2 is latency-bound: nb = n / 256 dependent steps.

#include "common.cuh"

extern "C" int dsi_line_flags(const void* chunk, int64_t n, const void* mask,
                              int64_t l_cap, void* line_match, void* scalars,
                              void* scratch, void* stream);
extern "C" int64_t dsi_grep_scratch_bytes(int64_t n);

namespace {

constexpr int kRowThreads = 64;   // >= S: one thread a state row
constexpr int kBlocksPerCta = 4;  // NFA blocks a CUDA block of phase 1
constexpr int kWalkThreads = 128;

// v . M[b]: the union of the rows of the states set in v.
__device__ __forceinline__ uint64_t step(uint64_t v, const uint64_t* row_b) {
  uint64_t acc = 0;
  while (v) {
    const int s = __ffsll(static_cast<long long>(v)) - 1;
    v &= v - 1;
    acc |= row_b[s];
  }
  return acc;
}

__global__ void nfa_block_rel(const uint8_t* chunk, int64_t nb, int blk,
                              const uint64_t* bits, int S, uint64_t* rel) {
  const int64_t b =
      int64_t(blockIdx.x) * kBlocksPerCta + threadIdx.x / kRowThreads;
  const int r = threadIdx.x % kRowThreads;
  if (b >= nb || r >= S) return;
  const uint8_t* p = chunk + b * blk;
  uint64_t row = 1ull << r;
  for (int i = 0; i < blk; ++i) row = step(row, bits + int64_t(p[i]) * S);
  rel[b * S + r] = row;
}

__global__ void nfa_prefix(const uint64_t* rel, int64_t nb, int S,
                           const uint64_t* v0, uint64_t* entry) {
  const int lane = threadIdx.x;  // one warp
  uint64_t v = *v0;
  for (int64_t b = 0; b < nb; ++b) {
    const uint64_t* R = rel + b * S;
    // Loads first: they do not depend on v, so they overlap the chain.
    const uint64_t a0 = lane < S ? R[lane] : 0;
    const uint64_t a1 = lane + 32 < S ? R[lane + 32] : 0;
    if (lane == 0) entry[b] = v;
    uint64_t c = (((v >> lane) & 1) ? a0 : 0) |
                 (((v >> (lane + 32)) & 1) ? a1 : 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c |= __shfl_xor_sync(kFullMask, c, o);
    v = c;
  }
}

__global__ void nfa_walk(const uint8_t* chunk, int64_t nb, int blk,
                         const uint64_t* bits, int S, const uint64_t* entry,
                         uint8_t* mask) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const uint8_t* p = chunk + b * blk;
  uint8_t* out = mask + b * blk;
  uint64_t v = entry[b];
  for (int i = 0; i < blk; ++i) {
    v = step(v, bits + int64_t(p[i]) * S);
    out[i] = uint8_t(((v >> (S - 1)) | (v >> (S - 2))) & 1);
  }
}

int64_t block_bytes(int64_t n) { return n < 256 ? n : 256; }

}  // namespace

extern "C" {

int64_t dsi_nfa_scratch_bytes(int64_t n, int S) {
  const int64_t nb = n / block_bytes(n);
  return align8(n) + align8(nb * S * 8) + align8(nb * 8) +
         dsi_grep_scratch_bytes(n);
}

// chunk [n] u8 (n % min(256, n) == 0); bits [256, S] u64; v0 [1] u64, the
// start vector's bit set; line_match [l_cap] i32; scalars [2] i32 =
// n_lines, overflow.
int dsi_nfa(const void* chunk, int64_t n, const void* bits, int S,
            const void* v0,
            int64_t l_cap, void* line_match, void* scalars, void* scratch,
            void* stream) {
  const int64_t blk = block_bytes(n);
  if (n < 1 || n % blk != 0 || S < 2 || S > kRowThreads || l_cap < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nb = n / blk;
  char* base = static_cast<char*>(scratch);
  uint8_t* mask = reinterpret_cast<uint8_t*>(base);
  uint64_t* rel = reinterpret_cast<uint64_t*>(base + align8(n));
  uint64_t* entry =
      reinterpret_cast<uint64_t*>(base + align8(n) + align8(nb * S * 8));
  void* flags_scratch = base + align8(n) + align8(nb * S * 8) + align8(nb * 8);
  const uint8_t* c = static_cast<const uint8_t*>(chunk);
  const uint64_t* b = static_cast<const uint64_t*>(bits);
  nfa_block_rel<<<unsigned(ceil_div(nb, kBlocksPerCta)),
                  kRowThreads * kBlocksPerCta, 0, s>>>(c, nb, int(blk), b, S,
                                                       rel);
  DSI_CHECK_LAUNCH();
  nfa_prefix<<<1, 32, 0, s>>>(rel, nb, S, static_cast<const uint64_t*>(v0),
                              entry);
  DSI_CHECK_LAUNCH();
  nfa_walk<<<unsigned(ceil_div(nb, kWalkThreads)), kWalkThreads, 0, s>>>(
      c, nb, int(blk), b, S, entry, mask);
  DSI_CHECK_LAUNCH();
  return dsi_line_flags(chunk, n, mask, l_cap, line_match, scalars,
                        flags_scratch, stream);
}

}  // extern "C"
