// Kernel M: the device-offset postings append.
//
// Replaces K20a, dsi_tpu/device/postings.py:57-86 _append_device (one
// shard_map body per device, the overflow a lax.pmax over the mesh axis).
// Per shard d of buf [n_dev, cap, w] u32, with nr = scal[d][0]:
//
//   new_n[d]  = n[d] + nr;
//   ov        = max over every shard e of (new_n[e] > cap);
//   no_op[d]  = max(ov, dirty[d]);
//   unless no_op[d]: buf[d][n[d] + j] = rows[d][j] for j < nr;
//   n_out[d]  = no_op[d] ? n[d] : new_n[d];  dirty_out[d] = no_op[d];
//   flags[d]  = (no_op[d], n_out[d]).
//
// The commit is all-or-nothing: a no-op leaves buf byte for byte as it was,
// and a committing shard's rows all fit (new_n <= cap), so no row past cap
// is ever written.
//
// Bound: memory bytes (the nr valid rows of each shard read once and
// written once, plus n_dev <= 8 scalars).
// Design: one launch, grid (chunk of the rows, shard).  Every block
// recomputes the global overflow from the n_dev scalars it reads, so no
// block depends on another.  The new counts go to n_out, dirty_out and
// flags, buffers other than the n and dirty that every block reads; the
// wrapper's owner swaps them in after the launch.  A shard's rows
// [0, nr) are one contiguous run of nr * w words on both sides, copied in
// 16-byte words when w and the pointers allow it.  No host sync: n, dirty
// and scal never leave the card.

#include "common.cuh"

namespace {

constexpr int kMThreads = 256;
constexpr int kMItems = 8;
// u32 words one block copies.
constexpr int64_t kMChunk = int64_t(kMThreads) * kMItems * 4;

__global__ void postings_append(uint32_t* buf, int64_t cap, int w,
                                const int* n, const int* dirty,
                                const uint32_t* rows, int64_t r,
                                const int* scal, int scal_w, int n_dev,
                                int vec4, int* n_out, int* dirty_out,
                                int* flags) {
  const int d = blockIdx.y;
  int ov = 0;
  for (int e = 0; e < n_dev; ++e) {
    ov |= int64_t(n[e]) + scal[int64_t(e) * scal_w] > cap ? 1 : 0;
  }
  const int n0 = n[d];
  const int nr = scal[int64_t(d) * scal_w];
  const int dd = dirty[d];
  const int no_op = ov > dd ? ov : dd;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int out_n = no_op > 0 ? n0 : n0 + nr;
    n_out[d] = out_n;
    dirty_out[d] = no_op;
    flags[2 * d] = no_op;
    flags[2 * d + 1] = out_n;
  }
  if (no_op > 0) return;
  const int64_t words = int64_t(nr < r ? nr : r) * w;
  const int64_t lo = int64_t(blockIdx.x) * kMChunk;
  if (lo >= words) return;
  const int64_t hi = lo + kMChunk < words ? lo + kMChunk : words;
  const uint32_t* src = rows + int64_t(d) * r * w;
  uint32_t* dst = buf + (int64_t(d) * cap + n0) * w;
  if (vec4) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t i = (lo >> 2) + threadIdx.x; i < (hi >> 2); i += kMThreads) {
      d4[i] = s4[i];
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kMThreads) dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

// buf [n_dev, cap, w] u32, updated in place; n, dirty [n_dev] i32; rows
// [n_dev, r, w] u32; scal [n_dev, scal_w] i32 (column 0 = rows to append);
// n_out, dirty_out [n_dev] i32 and flags [n_dev, 2] i32, distinct from n
// and dirty.
int dsi_postings_append(void* buf, int n_dev, int64_t cap, int w,
                        const void* n, const void* dirty, const void* rows,
                        int64_t r, const void* scal, int scal_w, void* n_out,
                        void* dirty_out, void* flags, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec4 = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(buf) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  const dim3 grid{unsigned(ceil_div(r * w, kMChunk)), unsigned(n_dev)};
  postings_append<<<grid, kMThreads, 0, st>>>(
      static_cast<uint32_t*>(buf), cap, w, static_cast<const int*>(n),
      static_cast<const int*>(dirty), static_cast<const uint32_t*>(rows), r,
      static_cast<const int*>(scal), scal_w, n_dev, vec4,
      static_cast<int*>(n_out), static_cast<int*>(dirty_out),
      static_cast<int*>(flags));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
