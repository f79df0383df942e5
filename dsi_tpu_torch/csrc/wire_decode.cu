// Kernel N: the chunk-upload decode.
//
// Replaces K22, the reference's decode programs (dsi_tpu/ops/wirecodec.py
// :397 _decode_impl, :417 _decode7_impl, :481 decode_chunk_device): the host
// encoder (encode_chunk) ships a [n_dev, n] uint8 batch as one packed
// tensor, and this kernel rebuilds the batch on the card.
//
//   7-bit mode, packed [n_dev, 7n/8]: every 7 bytes are a 56-bit
//   little-endian field v of eight 7-bit lanes, out byte k = (v >> 7k) & 0x7F.
//
//   nibble mode, packed [n_dev, 16 + n/2 + lit_cap] (per row: a 16-entry
//   dictionary d16 | n nibbles, high half of each byte first | literals):
//     out[r, i] = d16[nib]                                   nib != 15
//     out[r, i] = lits[r, clamp(e - 1, 0, lit_cap - 1)]      nib == 15
//   with e the escapes (nib == 15) of row r up to and including i.  The
//   clamp is the reference's, so any packed tensor decodes as it does there.
//
// Bound: memory bytes (the packed tensor read once, n_dev * n written once).
// Design.  7-bit: one thread per group reads its 7 bytes and writes its 8
// with one 64-bit store, kernel G's pattern (csrc/pack6.cu).  Nibble: the
// running escape count is a per-row scan over up to 2 Mi nibbles, built
// like kernel L (csrc/compact.cu) in three launches: (1) wire_count: block
// (tile, row) counts the escapes of its tile's packed bytes from ballots and
// __popc; (2) wire_scan: one block per row scans its tiles' counts into each
// tile's escapes before it; (3) wire_write: each tile takes two ballots per
// warp per round (high and low nibble), one thread ranks the (round, warp)
// counts in byte order, and every thread writes its byte's two output bytes
// as one 16-bit store, the dictionary in shared memory.  No atomics.

#include "common.cuh"

namespace {

constexpr int kNThreads = 256;
constexpr int kNWarps = kNThreads / 32;
constexpr int kNRounds = 8;
constexpr int64_t kNTile = int64_t(kNThreads) * kNRounds;  // packed bytes

__global__ void wire_decode7(const uint8_t* packed, int64_t groups,
                             uint64_t* out) {
  const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const uint8_t* src = packed + 7 * g;
  uint64_t v = 0;
#pragma unroll
  for (int j = 0; j < 7; ++j) v |= uint64_t(src[j]) << (8 * j);
  uint64_t o = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) o |= ((v >> (7 * k)) & 0x7Full) << (8 * k);
  out[g] = o;  // little-endian: byte k of the group is lane k
}

// Escape flags of packed nibble byte j of row s (false past the row's end).
__device__ __forceinline__ void nib_escapes(const uint8_t* nibs, int64_t half,
                                            int64_t j, bool& hi, bool& lo) {
  if (j < half) {
    const uint8_t b = nibs[j];
    hi = (b >> 4) == 15;
    lo = (b & 15) == 15;
  } else {
    hi = lo = false;
  }
}

// counts[s * tiles + tile] = escapes in `tile` of row s.
__global__ void wire_count(const uint8_t* packed, int64_t width, int64_t half,
                           int tiles, int* counts) {
  __shared__ int warp_cnt[kNWarps];
  const int s = blockIdx.y;
  const uint8_t* nibs = packed + int64_t(s) * width + 16;
  const int64_t base = int64_t(blockIdx.x) * kNTile;
  const int warp = threadIdx.x >> 5;
  int cnt = 0;
  for (int q = 0; q < kNRounds; ++q) {
    bool hi, lo;
    nib_escapes(nibs, half, base + int64_t(q) * kNThreads + threadIdx.x, hi,
                lo);
    cnt += __popc(__ballot_sync(kFullMask, hi)) +
           __popc(__ballot_sync(kFullMask, lo));
  }
  if ((threadIdx.x & 31) == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int v = 0; v < kNWarps; ++v) total += warp_cnt[v];
    counts[int64_t(s) * tiles + blockIdx.x] = total;
  }
}

// Block s scans row s of counts: offsets[s][tile] = escapes of the tiles
// before `tile`.
__global__ void wire_scan(const int* counts, int tiles, int* offsets) {
  const int64_t row = int64_t(blockIdx.x) * tiles;
  int run = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? counts[row + i] : 0;
    int sum;
    const int before = block_exclusive_scan<int>(v, sum);
    if (i < tiles) offsets[row + i] = run + before;
    run += sum;
  }
}

__global__ void wire_write(const uint8_t* packed, int64_t width, int64_t n,
                           int64_t lit_cap, int tiles, const int* offsets,
                           uint16_t* out) {
  __shared__ uint8_t d16[16];
  __shared__ unsigned hi_masks[kNRounds][kNWarps];
  __shared__ unsigned lo_masks[kNRounds][kNWarps];
  __shared__ int before[kNRounds][kNWarps];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint8_t* row = packed + int64_t(s) * width;
  const int64_t half = n / 2;
  const uint8_t* nibs = row + 16;
  const uint8_t* lits = row + 16 + half;
  const int64_t base = int64_t(blockIdx.x) * kNTile;
  if (tid < 16) d16[tid] = row[tid];
  uint8_t bytes[kNRounds];
#pragma unroll
  for (int q = 0; q < kNRounds; ++q) {
    const int64_t j = base + int64_t(q) * kNThreads + tid;
    bytes[q] = j < half ? nibs[j] : 0;
    const unsigned mh = __ballot_sync(kFullMask, (bytes[q] >> 4) == 15);
    const unsigned ml = __ballot_sync(kFullMask, (bytes[q] & 15) == 15);
    if (lane == 0) {
      hi_masks[q][warp] = mh;
      lo_masks[q][warp] = ml;
    }
  }
  __syncthreads();
  if (tid == 0) {
    // Byte order inside a tile is round-major, warp-minor.
    int run = offsets[int64_t(s) * tiles + blockIdx.x];
    for (int q = 0; q < kNRounds; ++q) {
      for (int v = 0; v < kNWarps; ++v) {
        before[q][v] = run;
        run += __popc(hi_masks[q][v]) + __popc(lo_masks[q][v]);
      }
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  uint16_t* orow = out + int64_t(s) * half;
#pragma unroll
  for (int q = 0; q < kNRounds; ++q) {
    const int64_t j = base + int64_t(q) * kNThreads + tid;
    if (j >= half) continue;
    // Escapes of this row strictly before byte j's high nibble.
    const int64_t e0 = before[q][warp] +
                       __popc(hi_masks[q][warp] & below) +
                       __popc(lo_masks[q][warp] & below);
    const int nh = bytes[q] >> 4;
    const int nl = bytes[q] & 15;
    const bool eh = nh == 15;
    // Literal index = inclusive escape count - 1, clamped as the reference.
    const int64_t ih = e0 < lit_cap - 1 ? e0 : lit_cap - 1;
    const int64_t el = e0 + (eh ? 1 : 0);
    const int64_t il = el < lit_cap - 1 ? el : lit_cap - 1;
    const uint8_t oh = eh ? lits[ih] : d16[nh];
    const uint8_t ol = nl == 15 ? lits[il] : d16[nl];
    orow[j] = uint16_t(oh) | (uint16_t(ol) << 8);  // out[2j], out[2j + 1]
  }
}

}  // namespace

extern "C" {

int64_t dsi_wire_decode_scratch_bytes(int n_dev, int64_t n) {
  return 2 * align8(4 * int64_t(n_dev) * ceil_div(n / 2, kNTile));
}

// packed [n_dev, width] u8; out [n_dev, n] u8, 8-byte aligned; n % 8 == 0.
// mode 0: nibble (width = 16 + n/2 + lit_cap, lit_cap >= 1); mode 1: 7-bit
// (width = 7n/8).  scratch: dsi_wire_decode_scratch_bytes(n_dev, n) bytes.
int dsi_wire_decode(const void* packed, int n_dev, int64_t n, int64_t width,
                    int64_t lit_cap, int mode, void* out, void* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(packed);
  if (mode == 1) {
    const int64_t groups = int64_t(n_dev) * (n / 8);
    wire_decode7<<<unsigned(ceil_div(groups, 256)), 256, 0, st>>>(
        in, groups, static_cast<uint64_t*>(out));
    DSI_CHECK_LAUNCH();
    return 0;
  }
  const int64_t half = n / 2;
  const int tiles = int(ceil_div(half, kNTile));
  int* counts = static_cast<int*>(scratch);
  int* offsets = reinterpret_cast<int*>(
      static_cast<char*>(scratch) + align8(4 * int64_t(n_dev) * tiles));
  const dim3 grid{unsigned(tiles), unsigned(n_dev)};
  wire_count<<<grid, kNThreads, 0, st>>>(in, width, half, tiles, counts);
  DSI_CHECK_LAUNCH();
  wire_scan<<<unsigned(n_dev), kScanThreads, 0, st>>>(counts, tiles, offsets);
  DSI_CHECK_LAUNCH();
  wire_write<<<grid, kNThreads, 0, st>>>(in, width, n, lit_cap, tiles,
                                         offsets,
                                         static_cast<uint16_t*>(out));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
