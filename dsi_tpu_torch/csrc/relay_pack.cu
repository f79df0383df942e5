// Kernel P: the relay pack.
//
// Replaces K21, dsi_tpu/device/relay.py _pack_impl (:58): per row r of the
// [n_dev, cap] relay buffers, a concatenation at a dynamic offset,
//
//   out[r, i] = acc[r, i]                             for i < off[r],
//   out[r, i] = new[r, min(i - off[r], cap - 1)]      otherwise,
//
// written in place into acc (the reference donates acc to the program):
// only [max(off[r], 0), cap) of each row is written, and new's zero tail
// comes along.  new must not alias acc (the wrapper checks).
//
// Bound: memory bytes, new[r, 0 : cap - off[r]] read once and acc[r,
// off[r] : cap] written once; the prefix below off is neither read nor
// written.  One launch: a thread takes 16 destination bytes, gathers them
// from new with byte loads (the source offset i - off has any alignment)
// and stores them as one 16-byte vector where the row allows it, byte by
// byte at the row's edges and at the offset.  No index tensor: the
// reference's take_along_axis index would be 4-8 times the bytes moved.

#include "common.cuh"

namespace {

constexpr int kPThreads = 256;
constexpr int kPBytes = 16;
constexpr int64_t kPTile = int64_t(kPThreads) * kPBytes;

__global__ void relay_pack_kernel(uint8_t* acc, int64_t cap, const int* off,
                                  const uint8_t* nw, int vec) {
  const int row = blockIdx.y;
  const int64_t o = off[row];
  const int64_t d = int64_t(blockIdx.x) * kPTile +
                    int64_t(threadIdx.x) * kPBytes;
  if (d >= cap || d + kPBytes <= o) return;  // all below the fill point
  uint8_t* dst = acc + int64_t(row) * cap;
  const uint8_t* src = nw + int64_t(row) * cap;
  if (vec && d >= o && d + kPBytes <= cap) {
    union {
      uint4 v;
      uint8_t b[kPBytes];
    } u;
#pragma unroll
    for (int b = 0; b < kPBytes; ++b) {
      const int64_t j = d + b - o;
      u.b[b] = __ldg(src + (j < cap - 1 ? j : cap - 1));
    }
    *reinterpret_cast<uint4*>(dst + d) = u.v;
    return;
  }
  for (int b = 0; b < kPBytes; ++b) {
    const int64_t i = d + b;
    if (i >= cap) break;
    if (i < o) continue;
    const int64_t j = i - o;
    dst[i] = __ldg(src + (j < cap - 1 ? j : cap - 1));
  }
}

}  // namespace

extern "C" {

// acc [n_dev, cap] u8, updated in place; off [n_dev] i32; nw [n_dev, cap]
// u8, not aliasing acc.
int dsi_relay_pack(void* acc, int n_dev, int64_t cap, const void* off,
                   const void* nw, void* stream) {
  if (n_dev < 1 || cap < 1) return cudaErrorInvalidValue;
  const int vec = (cap % kPBytes == 0) &&
                  (reinterpret_cast<uintptr_t>(acc) % kPBytes == 0);
  const dim3 grid{unsigned(ceil_div(cap, kPTile)), unsigned(n_dev)};
  relay_pack_kernel<<<grid, kPThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(acc), cap, static_cast<const int*>(off),
      static_cast<const uint8_t*>(nw), vec);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
