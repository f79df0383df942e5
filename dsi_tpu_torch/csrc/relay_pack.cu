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
// comes along.  An off[r] >= cap writes nothing in row r; a negative one
// shifts new left, its tail clamped to new[r, cap - 1].  new must not
// alias acc (the wrapper checks).
//
// Bound: memory bytes, new[r, 0 : cap - off[r]] read once and acc[r,
// off[r] : cap] written once; the prefix below off is neither read nor
// written.
//
// Design: one launch, the offsets its arguments.  The caller holds the
// fill lengths on the host, so they travel in the launch's parameter space
// (PackRows, up to kPMaxRows rows a launch, more rows in more launches)
// with each row's first block: no upload, no pinned buffer, and the grid
// covers only each row's [max(off, 0), cap), from the 16-byte aligned
// address at or below the fill point.  A thread takes one aligned 16-byte
// vector of acc's row and its 16 source bytes, which start at any
// alignment (i - off): one aligned 16-byte load a lane, the next from the
// neighbour lane, funnel-shifted into place (load16_any, common.cuh), then
// one 16-byte store.  Byte stores only in the vector holding the fill point
// and at the row's ends (any row when cap % 16 != 0 puts the rows off the
// 16-byte grid).

#include "common.cuh"

namespace {

constexpr int kPThreads = 256;
constexpr int kPBytes = 16;
// Rows a launch: 424 bytes of parameters.  With 256 rows (3 KB) a launch
// took 5.5 us of host time on an H100 80GB HBM3 host, N's 7-bit launch (24
// bytes) 4.6 (slice_profile --host-profile).
constexpr int kPMaxRows = 32;

struct PackRows {
  long long off[kPMaxRows];
  int first[kPMaxRows + 1];  // the launch's blocks before each row's
  int rows;
};

// Byte k (0-15) of v, k known at compile time after unrolling.
__device__ __forceinline__ uint32_t byte_of(const uint4& v, int k) {
  const uint32_t w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> (8 * (k & 3))) & 0xFFu;
}

// Row-relative index of a row's first vector: the 16-byte aligned address
// at or below its fill point (the row starts at address `row_addr`).
__host__ __device__ inline int64_t first_vector(uintptr_t row_addr,
                                                long long off) {
  const int64_t start = off > 0 ? off : 0;
  return int64_t((row_addr + uintptr_t(start)) & ~uintptr_t(15)) -
         int64_t(row_addr);
}

__global__ void __launch_bounds__(kPThreads)
    relay_pack_kernel(uint8_t* acc, const uint8_t* nw, int64_t cap,
                      int64_t row0, PackRows p) {
  // The block's row: the last one whose first block is at or below it.
  const int b = blockIdx.x;
  int lo = 0, hi = p.rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.first[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long o = p.off[lo];
  const int64_t row = row0 + lo;
  uint8_t* dst = acc + row * cap;
  const uint8_t* src = nw + row * cap;
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(src);
  const int64_t start = o > 0 ? o : 0;
  const int64_t i0 =
      first_vector(reinterpret_cast<uintptr_t>(dst), o) +
      (int64_t(b - p.first[lo]) * kPThreads + threadIdx.x) * kPBytes;
  uint4 v = load16_any(s0 + uintptr_t(i0 - o), s0, s0 + uintptr_t(cap));
  if (i0 + kPBytes - 1 - o > cap - 1) {  // only where off < 0: the clamp
    const uint32_t last = src[cap - 1];
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < kPBytes; ++k) {
      if (i0 + k - o > cap - 1) {
        w[k >> 2] = (w[k >> 2] & ~(0xFFu << (8 * (k & 3)))) |
                    (last << (8 * (k & 3)));
      }
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (i0 >= start && i0 + kPBytes <= cap) {
    *reinterpret_cast<uint4*>(dst + i0) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < kPBytes; ++k) {
    const int64_t i = i0 + k;
    if (i >= start && i < cap) dst[i] = uint8_t(byte_of(v, k));
  }
}

}  // namespace

extern "C" {

// acc [n_dev, cap] u8, updated in place; off [n_dev] i64 in HOST memory,
// read here before the launch; nw [n_dev, cap] u8, not aliasing acc.  One
// launch for up to kPMaxRows rows; none when every off >= cap.
int dsi_relay_pack(void* acc, int n_dev, int64_t cap, const void* off,
                   const void* nw, void* stream) {
  if (n_dev < 1 || cap < 1) return cudaErrorInvalidValue;
  const long long* offs = static_cast<const long long*>(off);
  uint8_t* a = static_cast<uint8_t*>(acc);
  for (int row0 = 0; row0 < n_dev; row0 += kPMaxRows) {
    PackRows p;
    p.rows = n_dev - row0 < kPMaxRows ? n_dev - row0 : kPMaxRows;
    int64_t blocks = 0;
    for (int r = 0; r < p.rows; ++r) {
      const long long o = offs[row0 + r];
      p.off[r] = o;
      p.first[r] = int(blocks);
      if (o >= cap) continue;
      const uintptr_t row_addr =
          reinterpret_cast<uintptr_t>(a + int64_t(row0 + r) * cap);
      const int64_t vectors =
          ceil_div(cap - first_vector(row_addr, o), kPBytes);
      blocks += ceil_div(vectors, kPThreads);
    }
    p.first[p.rows] = int(blocks);
    if (blocks == 0) continue;
    relay_pack_kernel<<<unsigned(blocks), kPThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const uint8_t*>(nw), cap, row0, p);
    DSI_CHECK_LAUNCH();
  }
  return 0;
}

}  // extern "C"
