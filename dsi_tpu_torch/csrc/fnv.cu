// Kernel D: FNV-1a 32 over each unique row's word bytes.
//
// Replaces K4, fnv1a32_packed (dsi_tpu/ops/wordcount.py:104-112): bit-exact
// Go hash/fnv.New32a over the first min(len, max_word_len) bytes of each
// row, read big-endian from the packed u64 key words ([k64, u] word-major,
// byte j in word j/8 at bits 56-8*(j%8)).  A pad row (len 0) hashes to the
// offset basis 0x811C9DC5.
//
// Bound: memory bytes (one read of the key words and lengths, one u32
// written per row).  Design: one thread per row, the byte loop unrolled by
// the compiler over the row's length.

#include "common.cuh"

namespace {

__global__ void fnv_rows(const uint64_t* keys, int64_t u, const int* lens,
                         int max_word_len, uint32_t* out) {
  const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= u) return;
  const int len = lens[r] < max_word_len ? lens[r] : max_word_len;
  uint32_t h = 0x811C9DC5u;
  for (int j = 0; j < len; ++j) {
    const uint64_t w = keys[int64_t(j >> 3) * u + r];
    const uint32_t b = uint32_t(w >> (56 - 8 * (j & 7))) & 0xFFu;
    h = (h ^ b) * 0x01000193u;
  }
  out[r] = h;
}

}  // namespace

extern "C" {

// keys [k64, u] u64; lens [u] i32; out [u] u32.
int dsi_fnv(const void* keys, int64_t u, const void* lens, int max_word_len,
            void* out, void* stream) {
  if (u == 0) return 0;
  fnv_rows<<<unsigned(ceil_div(u, 256)), 256, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(keys), u, static_cast<const int*>(lens),
      max_word_len, static_cast<uint32_t*>(out));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
