// Shared device helpers for the word-count kernels (tokenize, radix_sort,
// group, fnv).  Each .cu file is its own translation unit and includes this
// header; everything here has internal linkage so the objects link into one
// shared library without clashes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// [A-Za-z], == unicode.IsLetter on ASCII (dsi_tpu/ops/wordcount.py:63).
__device__ __forceinline__ bool is_letter(uint8_t b) {
  return (b >= 65 && b <= 90) || (b >= 97 && b <= 122);
}

// Exclusive scan of one value per thread across the block, in thread order.
// blockDim.x must be a multiple of 32 and at most 1024.  Every thread of the
// block must call it.  Writes the block total to `total`.
template <typename T>
__device__ T block_exclusive_scan(T v, T& total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < n_warps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  T result = (warp > 0 ? warp_sums[warp - 1] : T(0)) + x - v;
  total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return result;
}

constexpr int kScanThreads = 1024;

// Exclusive scan of in[0, n) into out[0, n) by ONE block of kScanThreads:
// each thread sums a contiguous stretch, the stretch sums are scanned across
// the block, then each thread writes its stretch.  The arrays it serves
// (per-block counts, radix histograms) hold at most a few hundred thousand
// entries, so one block is enough.  Writes the grand total to *total when
// total is not null.
template <typename T>
__global__ void scan_exclusive_kernel(const T* in, T* out, int64_t n,
                                      T* total) {
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  T s = 0;
  for (int64_t i = lo; i < hi; ++i) s += in[i];
  T all;
  T run = block_exclusive_scan<T>(s, all);
  for (int64_t i = lo; i < hi; ++i) {
    T v = in[i];
    out[i] = run;
    run += v;
  }
  if (threadIdx.x == 0 && total != nullptr) *total = all;
}

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int64_t align8(int64_t bytes) {
  return (bytes + 7) & ~int64_t(7);
}

}  // namespace

#define DSI_CHECK_LAUNCH()                       \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)
