// Kernel D: FNV-1a 32 over each row's key bytes, with the partition rule
// that consumes the hash fused into the same launch.
//
// Replaces K4, fnv1a32_packed (dsi_tpu/ops/wordcount.py:104-112): bit-exact
// Go hash/fnv.New32a over the first min(len, max_word_len) bytes of each
// row; a row of length 0 hashes to the offset basis 0x811C9DC5.  The
// optional epilogue is the rule the reference runs in the same jitted
// program as the hash, in K8's map_prologue (dsi_tpu/parallel/shuffle.py:
// 98-121) and K11's route_dest (dsi_tpu/ops/meshroute.py:48-63):
//
//   part = (h & 0x7fffffff) % n_part
//   dest = valid ? part % n_dest : park
//
// with valid from a bool mask, or row < *n_valid (a device scalar, read on
// the card: no host sync), or every row.
//
// The key bytes are big-endian in either of the port's two layouts:
//   kLayoutWords: u64 key words, word-major [k64, u] (A's and C's outputs;
//                 byte j in word j/8 at bits 56 - 8*(j%8));
//   kLayoutLanes: u32 lanes, row-major [u, kk] (the routed rows' layout,
//                 the reference's own; byte j in lane j/4 at bits
//                 24 - 8*(j%4)).
//
// Bound: memory bytes (each key word, length and mask read once, the
// outputs written once).  Design: one thread a row.  A row's key words are
// loaded once, 16 bytes at a time and only as far as its length reaches:
// two u64 words (consecutive threads read consecutive words of a word-major
// column), or four lanes in one 16-byte load where the lanes are 16-byte
// aligned (kk a multiple of 4).  The bytes are hashed from registers.

#include "common.cuh"

namespace {

constexpr int kLayoutWords = 0, kLayoutLanes = 1;
constexpr uint32_t kFnvOffset = 0x811C9DC5u, kFnvPrime = 0x01000193u;
constexpr int kDThreads = 256;

struct FnvArgs {
  const void* keys;
  int layout;
  int64_t u;
  int width;  // k64 (words) or kk (lanes)
  bool vec;   // lanes read 16 bytes at a time
  const int* lens;
  int max_word_len;
  uint32_t* h;
  const uint8_t* valid;  // bool [u] or null
  const int* n_valid;    // device scalar or null
  int n_part, n_dest, park;
  int* part;  // null: no epilogue
  int* dest;
};

// h after the first `nbytes` (0..4) big-endian bytes of `lane`.
__device__ __forceinline__ uint32_t fnv_lane(uint32_t h, uint32_t lane,
                                             int nbytes) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < nbytes) h = (h ^ ((lane >> (24 - 8 * b)) & 0xFFu)) * kFnvPrime;
  }
  return h;
}

__global__ void __launch_bounds__(kDThreads) fnv_rows(FnvArgs a) {
  const int64_t r = int64_t(blockIdx.x) * kDThreads + threadIdx.x;
  if (r >= a.u) return;
  const int l = a.lens[r];
  const int len = l < a.max_word_len ? l : a.max_word_len;
  uint32_t h = kFnvOffset;
  for (int j0 = 0; j0 < len; j0 += 16) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (a.layout == kLayoutWords) {
      const uint64_t* col = static_cast<const uint64_t*>(a.keys) + r;
      const int64_t q = j0 >> 3;
      const uint64_t w0 = col[q * a.u];
      v[0] = uint32_t(w0 >> 32);
      v[1] = uint32_t(w0);
      if (j0 + 8 < len) {
        const uint64_t w1 = col[(q + 1) * a.u];
        v[2] = uint32_t(w1 >> 32);
        v[3] = uint32_t(w1);
      }
    } else {
      const uint32_t* row = static_cast<const uint32_t*>(a.keys) +
                            r * a.width + (j0 >> 2);
      if (a.vec) {
        const uint4 x = *reinterpret_cast<const uint4*>(row);
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j0 + 4 * i < len) v[i] = row[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rest = len - j0 - 4 * i;
      h = fnv_lane(h, v[i], rest < 0 ? 0 : (rest > 4 ? 4 : rest));
    }
  }
  a.h[r] = h;
  if (a.part != nullptr) {
    const uint32_t p = (h & 0x7FFFFFFFu) % uint32_t(a.n_part);
    const bool ok = a.valid != nullptr ? a.valid[r] != 0
                    : a.n_valid != nullptr ? r < int64_t(*a.n_valid)
                                           : true;
    a.part[r] = int(p);
    a.dest[r] = ok ? int(p % uint32_t(a.n_dest)) : a.park;
  }
}

}  // namespace

extern "C" {

// keys: [width, u] u64 (layout 0) or [u, width] u32 (layout 1); lens [u]
// i32; h [u] u32.  With part and dest (both [u] i32) not null, the
// epilogue: valid is the bool mask `valid` [u] when not null, else row <
// *n_valid when n_valid is not null, else every row.  n_part, n_dest >= 1.
int dsi_fnv(const void* keys, int layout, int64_t u, int width,
            const void* lens, int max_word_len, void* h, const void* valid,
            const void* n_valid, int n_part, int n_dest, int park,
            void* part, void* dest, void* stream) {
  if (u == 0) return 0;
  if ((layout != kLayoutWords && layout != kLayoutLanes) ||
      max_word_len > (layout == kLayoutWords ? 8 : 4) * width ||
      (part != nullptr && (n_part < 1 || n_dest < 1 || dest == nullptr))) {
    return int(cudaErrorInvalidValue);
  }
  FnvArgs a;
  a.keys = keys;
  a.layout = layout;
  a.u = u;
  a.width = width;
  a.vec = layout == kLayoutLanes && width % 4 == 0 &&
          reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  a.lens = static_cast<const int*>(lens);
  a.max_word_len = max_word_len;
  a.h = static_cast<uint32_t*>(h);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n_valid = static_cast<const int*>(n_valid);
  a.n_part = n_part;
  a.n_dest = n_dest;
  a.park = park;
  a.part = static_cast<int*>(part);
  a.dest = static_cast<int*>(dest);
  fnv_rows<<<unsigned(ceil_div(u, kDThreads)), kDThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(a);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
