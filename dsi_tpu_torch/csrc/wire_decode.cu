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
// Design.  7-bit: one launch, one thread per group reads its 7 bytes and
// writes its 8 with one 64-bit store, kernel G's pattern (csrc/pack6.cu).
// Nibble: one pass, a memset of the look-back state and one kernel.  A
// thread takes 16 packed bytes with one 16-byte load (load16_any, common.cuh:
// a row's nibbles start at any alignment), which are 32 nibbles and one
// 32-bit escape mask, in each of the two rounds of its tile (8 KiB of packed
// nibbles: [1, 2 MiB] in 128 tiles, [8, 2 MiB] in 1,024), both loads issued
// at once.  __popc of the masks, one block scan of the rounds' counts in
// 16-bit fields and a decoupled look-back over the row's earlier tiles
// (tiles claimed from a ticket, as kernels A, C and J do) give the escapes
// before each vector.  The dictionary sits in four registers: __byte_perm
// looks up four nibbles at once.  The tile's escapes name one contiguous
// range of literals, which the block stages in shared memory with 16-byte
// loads once it knows where the range starts (a thread reading its literals
// from device memory one escape after another: 0.0076 ms at [1, 2 MiB]);
// each escape takes its literal from there, in ascending order, and each
// vector's 32 output bytes go out as two 16-byte stores.  The nibbles and
// the literals are read once; no atomic decides an order.

#include "common.cuh"

namespace {

constexpr int kNThreads = 256;
constexpr int kNBytes = 16;  // packed bytes a thread
constexpr int kNRounds = 2;  // vectors a thread
constexpr int64_t kNTile =
    int64_t(kNRounds) * kNThreads * kNBytes;  // packed bytes
constexpr int kNTicketBytes = 8;

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

// The nibbles of a packed word in output order: byte b's high nibble first.
__device__ __forceinline__ uint32_t swap_nibbles(uint32_t x) {
  return ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
}

// Bit k of the result: nibble k of sw (k = 0..7, from the low end) is 15.
__device__ __forceinline__ uint32_t escapes8(uint32_t sw) {
  uint32_t t = sw & (sw >> 1) & (sw >> 2) & (sw >> 3) & 0x11111111u;
  t = (t | (t >> 3)) & 0x03030303u;
  t = (t | (t >> 6)) & 0x000F000Fu;
  return (t | (t >> 12)) & 0xFFu;
}

// d16[nibble k of sel] for the four low nibbles of sel, as four bytes.
__device__ __forceinline__ uint32_t lookup4(const uint32_t d[4],
                                            uint32_t sel) {
  const uint32_t idx = sel & 0x7777u;
  const uint32_t lo = __byte_perm(d[0], d[1], idx);
  const uint32_t hi = __byte_perm(d[2], d[3], idx);
  return __byte_perm(lo, hi, 0x3210u | ((sel & 0x8888u) >> 1));
}

struct NibArgs {
  const uint8_t* packed;
  int64_t width, n, lit_cap;
  int64_t tiles;  // tiles a row
  unsigned* ticket;
  unsigned long long* status;  // [n_dev, tiles] look-back words
  uint8_t* out;
};

// One tile of kNRounds rounds: in round q, thread t takes packed bytes
// [16 (256 q + t), +16) of the tile (consecutive lanes on consecutive
// vectors, so every load and store of a round is coalesced), all its loads
// issued at once.
__global__ void __launch_bounds__(kNThreads) wire_decode_nib(NibArgs a) {
  __shared__ __align__(16) uint8_t d16[16];
  __shared__ __align__(16) uint8_t lstage[2 * kNTile + 16];
  const int64_t item = claim_tile(a.ticket);  // rows one after another
  const int64_t s = item / a.tiles;
  const int64_t tile = item - s * a.tiles;
  const uint8_t* row = a.packed + s * a.width;
  const int64_t half = a.n / 2;
  const uint8_t* nibs = row + 16;
  const uint8_t* lits = nibs + half;
  const uint8_t dict = threadIdx.x < 16 ? row[threadIdx.x] : 0;

  const uintptr_t nb = reinterpret_cast<uintptr_t>(nibs);
  uint32_t sw[kNRounds][4];
  uint32_t mask[kNRounds];
  int valid[kNRounds];
  long long counts = 0;  // round q's escapes in bits [16 q, 16 q + 16)
#pragma unroll
  for (int q = 0; q < kNRounds; ++q) {
    const int64_t j0 = tile * kNTile + int64_t(q * kNThreads + threadIdx.x) *
                                          kNBytes;
    const uint4 v = load16_any(nb + uintptr_t(j0), nb, nb + uintptr_t(half));
    const int64_t left = half - j0;
    valid[q] = left <= 0 ? 0 : left >= kNBytes ? kNBytes : int(left);
    sw[q][0] = swap_nibbles(v.x);
    sw[q][1] = swap_nibbles(v.y);
    sw[q][2] = swap_nibbles(v.z);
    sw[q][3] = swap_nibbles(v.w);
  }
  if (threadIdx.x < 16) d16[threadIdx.x] = dict;
#pragma unroll
  for (int q = 0; q < kNRounds; ++q) {
    uint32_t m = escapes8(sw[q][0]) | (escapes8(sw[q][1]) << 8) |
                 (escapes8(sw[q][2]) << 16) | (escapes8(sw[q][3]) << 24);
    if (valid[q] < kNBytes) m &= (1u << (2 * valid[q])) - 1u;  // % 4 == 0
    mask[q] = m;
    counts |= static_cast<long long>(__popc(m)) << (16 * q);
  }

  // A round's escapes in a block are at most 8,192: no carry between the
  // 16-bit fields of the scan.
  long long totals;
  const long long before = block_exclusive_scan<long long>(counts, totals);
  int total = 0;
#pragma unroll
  for (int q = 0; q < kNRounds; ++q) {
    total += int((totals >> (16 * q)) & 0xFFFF);
  }
  LookBack lb;
  lb.status = a.status + s * a.tiles;
  lb.sums = nullptr;
  if (threadIdx.x == 0) {
    lb_publish(lb, tile, tile == 0 ? kLbInclusive : kLbAggregate,
               unsigned(total), 0);
  }
  unsigned ex = 0;
  if (tile > 0) {
    long long unused;
    lb_exclusive<kNThreads>(lb, tile, ex, unused);
    if (threadIdx.x == 0) {
      lb_publish(lb, tile, kLbInclusive, ex + unsigned(total), 0);
    }
  }

  // The tile's literals, lits[clamp(ex .. ex + total - 1)], one contiguous
  // range: staged in shared memory with aligned 16-byte loads, so no
  // thread waits on device memory for each escape in turn.
  const int64_t last = a.lit_cap - 1;
  const int64_t lo = int64_t(ex) < last ? int64_t(ex) : last;
  const int64_t hi = int64_t(ex) + total - 1 < last ? int64_t(ex) + total - 1
                                                    : last;
  const uintptr_t l0 = reinterpret_cast<uintptr_t>(lits + lo);
  const int head = int(l0 & 15);
  if (total > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(l0 - head);
    const int vecs =
        int((reinterpret_cast<uintptr_t>(lits + hi) - (l0 - head)) >> 4) + 1;
    for (int v = threadIdx.x; v < vecs; v += kNThreads) {
      reinterpret_cast<uint4*>(lstage)[v] = __ldg(src + v);
    }
  }
  __syncthreads();

  const uint32_t* dw = reinterpret_cast<const uint32_t*>(d16);
  const uint32_t d[4] = {dw[0], dw[1], dw[2], dw[3]};
  int64_t e = int64_t(ex);  // escapes of the row before this round's vector
#pragma unroll
  for (int q = 0; q < kNRounds; ++q) {
    const int64_t mine = e + ((before >> (16 * q)) & 0xFFFF);
    e += (totals >> (16 * q)) & 0xFFFF;
    if (valid[q] == 0) continue;
    uint32_t o[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[2 * k] = lookup4(d, sw[q][k]);
      o[2 * k + 1] = lookup4(d, sw[q][k] >> 16);
    }
    // Escapes: literal index = the row's escapes before this one, clamped.
    if (mask[q] != 0) {
      int64_t x = mine;
#pragma unroll
      for (int m = 0; m < 32; ++m) {
        if ((mask[q] >> m) & 1u) {
          const uint32_t lit = lstage[head + ((x < last ? x : last) - lo)];
          o[m >> 2] = (o[m >> 2] & ~(0xFFu << (8 * (m & 3)))) |
                      (lit << (8 * (m & 3)));
          ++x;
        }
      }
    }
    const int64_t j0 = tile * kNTile + int64_t(q * kNThreads + threadIdx.x) *
                                          kNBytes;
    uint8_t* dst = a.out + s * a.n + 2 * j0;
    if (valid[q] == kNBytes &&
        (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
      continue;
    }
    // A row's last vector, or rows off the 16-byte grid (n % 16 != 0):
    // whole 8-byte words (n % 8 == 0 keeps every row and every 4 nibbles on
    // them).
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * k < valid[q]) {
        reinterpret_cast<uint2*>(dst)[k] = make_uint2(o[2 * k], o[2 * k + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Packed nibble bytes a tile of the nibble mode (the edges chip_smoke.py
// places escapes across).
int64_t dsi_wire_decode_tile_bytes() { return kNTile; }

// Nibble mode's look-back state: a ticket and one status word a tile.
int64_t dsi_wire_decode_scratch_bytes(int n_dev, int64_t n) {
  return kNTicketBytes + 8 * int64_t(n_dev) * ceil_div(n / 2, kNTile);
}

// packed [n_dev, width] u8; out [n_dev, n] u8, 8-byte aligned; n % 8 == 0.
// mode 0: nibble (width = 16 + n/2 + lit_cap, lit_cap >= 1; scratch:
// dsi_wire_decode_scratch_bytes(n_dev, n) bytes, zeroed here); mode 1: 7-bit
// (width = 7n/8; scratch unused, may be null).
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
  NibArgs a;
  a.packed = in;
  a.width = width;
  a.n = n;
  a.lit_cap = lit_cap;
  a.tiles = ceil_div(n / 2, kNTile);
  a.ticket = static_cast<unsigned*>(scratch);
  a.status = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + kNTicketBytes);
  a.out = static_cast<uint8_t*>(out);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, size_t(dsi_wire_decode_scratch_bytes(n_dev, n)), st);
  if (e != cudaSuccess) return int(e);
  wire_decode_nib<<<unsigned(n_dev * a.tiles), kNThreads, 0, st>>>(a);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
