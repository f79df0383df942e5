// Kernel G: the 6-bit transport decode.
//
// Replaces K7, the inverse transform at the head of corpus_kernel_packed
// (dsi_tpu/ops/corpus_wc.py:90-117): the host ships the corpus 6 bits per
// byte when it uses at most 64 distinct byte values (pack6_encode, :208);
// every 3 wire bytes v = b0 << 16 | b1 << 8 | b2 hold four codes, high
// first, and each code maps to a byte through the 64-entry table.  Output
// is the uint8 corpus that kernel A reads.
//
// Bound: memory bytes (3n/4 wire bytes and the 64-byte table read, n bytes
// written).  Design: one thread per 3-byte group writes its 4 bytes as one
// u32 store; the table sits in shared memory.

#include "common.cuh"

namespace {

__global__ void pack6_decode(const uint8_t* wire, int64_t groups,
                             const uint8_t* table, uint32_t* out) {
  __shared__ uint8_t tab[64];
  if (threadIdx.x < 64) tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const uint32_t v = (uint32_t(wire[3 * g]) << 16) |
                     (uint32_t(wire[3 * g + 1]) << 8) |
                     uint32_t(wire[3 * g + 2]);
  // Little-endian store: byte 0 of the group is the lowest byte.
  out[g] = uint32_t(tab[(v >> 18) & 63]) |
           (uint32_t(tab[(v >> 12) & 63]) << 8) |
           (uint32_t(tab[(v >> 6) & 63]) << 16) |
           (uint32_t(tab[v & 63]) << 24);
}

}  // namespace

extern "C" {

// wire [3 * groups] u8; table [64] u8; out [4 * groups] u8, 4-byte aligned.
int dsi_pack6(const void* wire, int64_t groups, const void* table, void* out,
              void* stream) {
  pack6_decode<<<unsigned(ceil_div(groups, 256)), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), groups,
      static_cast<const uint8_t*>(table), static_cast<uint32_t*>(out));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
