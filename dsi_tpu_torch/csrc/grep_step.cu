// Kernel J: the streaming grep step.
//
// Replaces K16, dsi_tpu/parallel/grepstream.py _grep_step_device (:243),
// run by the reference under shard_map once per device; here one row of
// the [n_dev, N] batch per virtual shard.  Per row, with dlen valid bytes:
//
//   match[i]  = chunk[i + j] == pat[j] for every j (0 past N);
//   line_id[i] = VALID newlines (pos < dlen) strictly before i;
//   n_lines   = valid newlines + 1 if the last valid byte is not '\n'
//               (0 when dlen == 0); overflow = n_lines > l_cap;
//   occ[l]    = sum of match over line l, for l < l_cap (a match whose
//               line is l_cap or later is dropped);
//   over the lines l < min(n_lines, l_cap): hist[min(occ, bins-1)] += 1,
//               matched = lines with occ > 0, occurrences = sum of occ;
//   the k candidates by (occ desc, line asc) among matched lines, as rows
//   [hi, lo, 8, occ, 0] of the global line number base + l (u64 base);
//   rows past n_cand = min(matched, k) are all zeros;
//   hist_ext = [hist, n_lines, matched, occurrences] u32;
//   scal = [n_cand, n_lines, overflow, matched, occurrences] i32.
//
// Bound: memory bytes (the batch read once; the outputs are tiny).  The
// occurrence counts go to an [n_dev, l_cap] scratch by int atomicAdd (one
// atomic per match; integer sums do not depend on their order).  The top-k
// is a selection, not a sort of l_cap rows: candidate keys (0x7FFFFFFF -
// occ) << 32 | line are unique, so k rounds of "the least key above the
// last one taken" give lax.sort's first k.  Launches: (1) gs_count, valid
// newlines per 4 KiB tile; (2) gs_scan, one block a row: tile offsets and
// n_lines; (3) gs_occ, the match and the occurrence atomics; (4) gs_lines,
// per 2,048-line tile: histogram, totals and the tile's k least keys;
// (5) gs_final, one block a row: the k least of the tiles' keys, the rows
// and the scalars.
//
// The emit epilogue (K16e, the reference's emit=True branch, :324-339), a
// separate entry point run right after the step on the same stream and
// scratch: per row,
//
//   keep[i]  = i < dlen && occ[min(line_id[i], l_cap - 1)] > 0 (a line's
//              terminating newline has the line's own id, so it is kept
//              with the line; occ is gs_occ's, which equals the reference's
//              line-valid-masked count at every valid byte);
//   comp     = the kept bytes in stream order, then zeros to N;
//   kept_n   = the count of kept bytes.
//
// Bound: memory bytes (the row read once, comp written once).  L's
// structure (csrc/compact.cu), no atomics and no sort: (6) ge_count, per
// 4 KiB tile (the tiles of gs_scan): each byte's line id from the tile's
// newline offset (gs_scan's) and newline ballots, then keep, then the
// tile's kept count from keep ballots; (7) ge_scan, one block a row: the
// tiles' kept offsets and kept_n; (8) ge_write, per tile: the same ballots
// rank each kept byte, and every byte at or past kept_n is written zero.
// Bytes are taken round-major (byte q * 256 + thread of a tile), so a
// ballot covers 32 neighbouring bytes and the ranks follow stream order.

#include "common.cuh"

namespace {

constexpr int kSThreads = 256;
constexpr int kSItems = 16;
constexpr int64_t kSTile = int64_t(kSThreads) * kSItems;
constexpr int kLineItems = 8;
constexpr int64_t kLineTile = int64_t(kSThreads) * kLineItems;
constexpr int kMaxBins = 64;
constexpr uint64_t kNoKey = ~0ull;
constexpr int kBig = 0x7FFFFFFF;

__device__ __forceinline__ uint64_t block_min_u64(uint64_t v) {
  __shared__ uint64_t sh[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t y = __shfl_xor_sync(kFullMask, v, o);
    v = y < v ? y : v;
  }
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? sh[lane] : kNoKey;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t y = __shfl_xor_sync(kFullMask, v, o);
      v = y < v ? y : v;
    }
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  v = sh[0];
  __syncthreads();  // sh is reused by the next call
  return v;
}

__device__ __forceinline__ int64_t clamp_dlen(const int* dlen, int row,
                                              int64_t N) {
  const int64_t d = dlen[row];
  return d < 0 ? 0 : (d > N ? N : d);
}

__global__ void gs_count(const uint8_t* chunks, int64_t N, const int* dlen,
                         int tiles, int* tile_counts) {
  const int row = blockIdx.y;
  const uint8_t* c = chunks + int64_t(row) * N;
  const int64_t dl = clamp_dlen(dlen, row, N);
  const int64_t base = blockIdx.x * kSTile + int64_t(threadIdx.x) * kSItems;
  int cnt = 0;
  for (int j = 0; j < kSItems; ++j) {
    const int64_t i = base + j;
    cnt += (i < dl && c[i] == 10) ? 1 : 0;
  }
  int total;
  block_exclusive_scan<int>(cnt, total);
  if (threadIdx.x == 0) tile_counts[int64_t(row) * tiles + blockIdx.x] = total;
}

// One block of kScanThreads a row: tile offsets, and n_lines.
__global__ void gs_scan(const uint8_t* chunks, int64_t N, const int* dlen,
                        int tiles, const int* tile_counts, int* tile_offsets,
                        int* n_lines) {
  const int row = blockIdx.x;
  const int* in = tile_counts + int64_t(row) * tiles;
  int* out = tile_offsets + int64_t(row) * tiles;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < tiles ? lo + per : tiles;
  int s = 0;
  for (int i = lo; i < hi; ++i) s += in[i];
  int all;
  int run = block_exclusive_scan<int>(s, all);
  for (int i = lo; i < hi; ++i) {
    const int v = in[i];
    out[i] = run;
    run += v;
  }
  if (threadIdx.x == 0) {
    const int64_t dl = clamp_dlen(dlen, row, N);
    const bool tail = dl > 0 && chunks[int64_t(row) * N + dl - 1] != 10;
    n_lines[row] = all + (tail ? 1 : 0);
  }
}

__global__ void gs_occ(const uint8_t* chunks, int64_t N, const uint8_t* pats,
                       int m, const int* dlen, int tiles,
                       const int* tile_offsets, int64_t l_cap, int* occ) {
  const int row = blockIdx.y;
  const uint8_t* c = chunks + int64_t(row) * N;
  const uint8_t* p = pats + int64_t(row) * m;
  const int64_t dl = clamp_dlen(dlen, row, N);
  const int64_t base = blockIdx.x * kSTile + int64_t(threadIdx.x) * kSItems;
  int cnt = 0;
  for (int j = 0; j < kSItems; ++j) {
    const int64_t i = base + j;
    cnt += (i < dl && c[i] == 10) ? 1 : 0;
  }
  int total;
  int64_t lid = int64_t(tile_offsets[int64_t(row) * tiles + blockIdx.x]) +
                block_exclusive_scan<int>(cnt, total);
  int* occ_row = occ + int64_t(row) * l_cap;
  for (int j = 0; j < kSItems; ++j) {
    const int64_t i = base + j;
    if (i >= N) break;
    bool hit = true;
    for (int t = 0; t < m; ++t) {
      const int64_t q = i + t;
      if ((q < N ? c[q] : uint8_t(0)) != __ldg(p + t)) {
        hit = false;
        break;
      }
    }
    if (hit && lid < l_cap) atomicAdd(&occ_row[lid], 1);
    if (i < dl && c[i] == 10) ++lid;
  }
}

__global__ void gs_lines(const int* occ, int64_t l_cap, const int* n_lines,
                         int bins, int k, int ltiles, int* hist_ext,
                         int* totals, uint64_t* tile_keys) {
  __shared__ int sh_hist[kMaxBins];
  const int row = blockIdx.y;
  const int64_t lim = n_lines[row] < l_cap ? int64_t(n_lines[row]) : l_cap;
  const int64_t first = blockIdx.x * kLineTile;
  if (first >= lim) return;  // gs_final reads only the tiles below lim
  for (int b = threadIdx.x; b < bins; b += blockDim.x) sh_hist[b] = 0;
  __syncthreads();
  const int* occ_row = occ + int64_t(row) * l_cap;
  uint64_t key[kLineItems];
  int matched = 0, occurrences = 0;
#pragma unroll
  for (int j = 0; j < kLineItems; ++j) {
    const int64_t l = first + j * kSThreads + threadIdx.x;
    key[j] = kNoKey;
    if (l < lim) {
      const int o = occ_row[l];
      atomicAdd(&sh_hist[o < bins - 1 ? o : bins - 1], 1);
      if (o > 0) {
        ++matched;
        occurrences += o;
        key[j] = (uint64_t(kBig - o) << 32) | uint64_t(l);
      }
    }
  }
  int sum_m, sum_o;
  block_exclusive_scan<int>(matched, sum_m);
  block_exclusive_scan<int>(occurrences, sum_o);
  __syncthreads();
  if (int(threadIdx.x) < bins && sh_hist[threadIdx.x] != 0)
    atomicAdd(&hist_ext[int64_t(row) * (bins + 3) + threadIdx.x],
              sh_hist[threadIdx.x]);
  if (threadIdx.x == 0) {
    atomicAdd(&totals[2 * row], sum_m);
    atomicAdd(&totals[2 * row + 1], sum_o);
  }
  uint64_t* out = tile_keys + (int64_t(row) * ltiles + blockIdx.x) * k;
  uint64_t prev = 0;  // every key is > 0: its high word is >= kBig - N
  for (int r = 0; r < k; ++r) {
    uint64_t mn = kNoKey;
#pragma unroll
    for (int j = 0; j < kLineItems; ++j)
      if (key[j] > prev && key[j] < mn) mn = key[j];
    mn = block_min_u64(mn);
    if (threadIdx.x == 0) out[r] = mn;
    prev = mn;  // kNoKey once the tile runs out: later rounds write kNoKey
  }
}

// cand [n_dev, k, 5] and hist_ext are zeroed by the caller.
__global__ void gs_final(const uint64_t* tile_keys, int ltiles, int k,
                         const int* n_lines, int64_t l_cap, const int* totals,
                         const int64_t* bases, int bins, int* hist_ext,
                         int* cand, int* scal) {
  const int row = blockIdx.x;
  const int64_t lim = n_lines[row] < l_cap ? int64_t(n_lines[row]) : l_cap;
  const int64_t count = (lim + kLineTile - 1) / kLineTile * k;
  const uint64_t* keys = tile_keys + int64_t(row) * ltiles * k;
  uint64_t prev = 0;
  int n_cand = 0;
  for (int r = 0; r < k; ++r) {
    uint64_t mn = kNoKey;
    for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
      const uint64_t x = keys[i];
      if (x > prev && x < mn) mn = x;
    }
    mn = block_min_u64(mn);
    if (mn == kNoKey) break;  // uniform: every thread holds the same mn
    if (threadIdx.x == 0) {
      const uint64_t g = uint64_t(bases[row]) + (mn & 0xFFFFFFFFull);
      int* c = cand + (int64_t(row) * k + r) * 5;
      c[0] = int(uint32_t(g >> 32));
      c[1] = int(uint32_t(g));
      c[2] = 8;
      c[3] = kBig - int(mn >> 32);
    }
    prev = mn;
    ++n_cand;
  }
  if (threadIdx.x == 0) {
    const int nl = n_lines[row];
    const int matched = totals[2 * row];
    const int occurrences = totals[2 * row + 1];
    int* h = hist_ext + int64_t(row) * (bins + 3);
    h[bins] = nl;
    h[bins + 1] = matched;
    h[bins + 2] = occurrences;
    int* sc = scal + int64_t(row) * 5;
    sc[0] = n_cand;
    sc[1] = nl;
    sc[2] = int64_t(nl) > l_cap ? 1 : 0;
    sc[3] = matched;
    sc[4] = occurrences;
  }
}

struct StepScratch {
  int* tile_counts;
  int* tile_offsets;
  int* n_lines;
  int* totals;
  int* occ;
  uint64_t* tile_keys;
};

StepScratch carve(void* scratch, int n_dev, int64_t tiles, int64_t l_cap,
                  int64_t ltiles, int k) {
  char* p = static_cast<char*>(scratch);
  StepScratch s;
  s.tile_keys = reinterpret_cast<uint64_t*>(p);
  p += align8(8 * int64_t(n_dev) * ltiles * k);
  s.tile_counts = reinterpret_cast<int*>(p);
  p += align8(4 * int64_t(n_dev) * tiles);
  s.tile_offsets = reinterpret_cast<int*>(p);
  p += align8(4 * int64_t(n_dev) * tiles);
  s.n_lines = reinterpret_cast<int*>(p);
  p += align8(4 * int64_t(n_dev));
  s.totals = reinterpret_cast<int*>(p);
  p += align8(8 * int64_t(n_dev));
  s.occ = reinterpret_cast<int*>(p);
  return s;
}

// ── K16e: the emit epilogue ──────────────────────────────────────────────

constexpr int kEWarps = kSThreads / 32;

// One tile's ballots: newline and keep masks by (round, warp), and the
// newline offsets before each (round, warp) inside the tile.
struct EmitTile {
  unsigned nl[kSItems][kEWarps];
  unsigned keep[kSItems][kEWarps];
  int before[kSItems][kEWarps];
};

// Fills t.nl, t.keep (and t.before with the newline offsets) for the tile
// at `base`; byte[q] and keep[q] are this thread's byte of round q.
__device__ __forceinline__ void emit_tile(
    const uint8_t* c, int64_t N, int64_t dl, int64_t base, int64_t line0,
    const int* occ_row, int64_t l_cap, EmitTile& t, uint8_t (&byte)[kSItems],
    bool (&keep)[kSItems]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int q = 0; q < kSItems; ++q) {
    const int64_t i = base + int64_t(q) * kSThreads + tid;
    byte[q] = i < N ? c[i] : uint8_t(0);
    const unsigned m = __ballot_sync(kFullMask, i < dl && byte[q] == 10);
    if (lane == 0) t.nl[q][warp] = m;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int q = 0; q < kSItems; ++q)
      for (int v = 0; v < kEWarps; ++v) {
        t.before[q][v] = run;
        run += __popc(t.nl[q][v]);
      }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kSItems; ++q) {
    const int64_t i = base + int64_t(q) * kSThreads + tid;
    const int64_t lid =
        line0 + t.before[q][warp] + __popc(t.nl[q][warp] & below);
    const int64_t l = lid < l_cap - 1 ? lid : l_cap - 1;
    keep[q] = i < dl && occ_row[l] > 0;
    const unsigned m = __ballot_sync(kFullMask, keep[q]);
    if (lane == 0) t.keep[q][warp] = m;
  }
  __syncthreads();
}

__global__ void ge_count(const uint8_t* chunks, int64_t N, const int* dlen,
                         int tiles, const int* tile_offsets, const int* occ,
                         int64_t l_cap, int* kept_counts) {
  __shared__ EmitTile t;
  const int row = blockIdx.y;
  uint8_t byte[kSItems];
  bool keep[kSItems];
  emit_tile(chunks + int64_t(row) * N, N, clamp_dlen(dlen, row, N),
            int64_t(blockIdx.x) * kSTile,
            tile_offsets[int64_t(row) * tiles + blockIdx.x],
            occ + int64_t(row) * l_cap, l_cap, t, byte, keep);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int q = 0; q < kSItems; ++q)
      for (int v = 0; v < kEWarps; ++v) n += __popc(t.keep[q][v]);
    kept_counts[int64_t(row) * tiles + blockIdx.x] = n;
  }
}

// Block `row` scans its tiles' kept counts: kept_offsets[row][tile] and
// kept_n[row].
__global__ void ge_scan(const int* kept_counts, int tiles, int* kept_offsets,
                        int* kept_n) {
  const int64_t row = int64_t(blockIdx.x) * tiles;
  int run = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? kept_counts[row + i] : 0;
    int sum;
    const int before = block_exclusive_scan<int>(v, sum);
    if (i < tiles) kept_offsets[row + i] = run + before;
    run += sum;
  }
  if (threadIdx.x == 0) kept_n[blockIdx.x] = run;
}

__global__ void ge_write(const uint8_t* chunks, int64_t N, const int* dlen,
                         int tiles, const int* tile_offsets, const int* occ,
                         int64_t l_cap, const int* kept_offsets,
                         const int* kept_n, uint8_t* comp) {
  __shared__ EmitTile t;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t base = int64_t(blockIdx.x) * kSTile;
  uint8_t byte[kSItems];
  bool keep[kSItems];
  emit_tile(chunks + int64_t(row) * N, N, clamp_dlen(dlen, row, N), base,
            tile_offsets[int64_t(row) * tiles + blockIdx.x],
            occ + int64_t(row) * l_cap, l_cap, t, byte, keep);
  // emit_tile's last barrier: every thread has read t.before, so thread 0
  // may overwrite it with the kept offsets.
  if (tid == 0) {
    int run = kept_offsets[int64_t(row) * tiles + blockIdx.x];
    for (int q = 0; q < kSItems; ++q)
      for (int v = 0; v < kEWarps; ++v) {
        t.before[q][v] = run;
        run += __popc(t.keep[q][v]);
      }
  }
  __syncthreads();
  const int64_t kn = kept_n[row];
  const unsigned below = (1u << lane) - 1u;
  uint8_t* out = comp + int64_t(row) * N;
#pragma unroll
  for (int q = 0; q < kSItems; ++q) {
    const int64_t i = base + int64_t(q) * kSThreads + tid;
    if (keep[q])
      out[t.before[q][warp] + __popc(t.keep[q][warp] & below)] = byte[q];
    if (i < N && i >= kn) out[i] = 0;  // the zero tail; kept ranks < kn
  }
}

}  // namespace

extern "C" {

int64_t dsi_grep_step_scratch_bytes(int n_dev, int64_t N, int64_t l_cap,
                                    int k) {
  const int64_t tiles = ceil_div(N, kSTile);
  const int64_t ltiles = ceil_div(l_cap, kLineTile);
  return align8(8 * int64_t(n_dev) * ltiles * k) +
         2 * align8(4 * int64_t(n_dev) * tiles) + align8(4 * int64_t(n_dev)) +
         align8(8 * int64_t(n_dev)) + align8(4 * int64_t(n_dev) * l_cap);
}

// chunks [n_dev, N] u8; pats [n_dev, m] u8; dlen [n_dev] i32; bases
// [n_dev] u64; hist_ext [n_dev, bins + 3] u32; cand [n_dev, k, 5] u32;
// scal [n_dev, 5] i32.
int dsi_grep_step(const void* chunks, int n_dev, int64_t N, const void* pats,
                  int m, const void* dlen, const void* bases, int64_t l_cap,
                  int bins, int k, void* hist_ext, void* cand, void* scal,
                  void* scratch, void* stream) {
  if (n_dev < 1 || N < 1 || m < 1 || l_cap < 1 || bins < 1 ||
      bins > kMaxBins || k < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = ceil_div(N, kSTile);
  const int64_t ltiles = ceil_div(l_cap, kLineTile);
  StepScratch w = carve(scratch, n_dev, tiles, l_cap, ltiles, k);
  const uint8_t* c = static_cast<const uint8_t*>(chunks);
  const int* dl = static_cast<const int*>(dlen);
  int* h = static_cast<int*>(hist_ext);
  if (cudaMemsetAsync(w.occ, 0, 4 * size_t(n_dev) * l_cap, s) != cudaSuccess ||
      cudaMemsetAsync(w.totals, 0, 8 * size_t(n_dev), s) != cudaSuccess ||
      cudaMemsetAsync(h, 0, 4 * size_t(n_dev) * (bins + 3), s) !=
          cudaSuccess ||
      cudaMemsetAsync(cand, 0, 20 * size_t(n_dev) * k, s) != cudaSuccess)
    return int(cudaGetLastError());
  gs_count<<<dim3(unsigned(tiles), unsigned(n_dev)), kSThreads, 0, s>>>(
      c, N, dl, int(tiles), w.tile_counts);
  DSI_CHECK_LAUNCH();
  gs_scan<<<unsigned(n_dev), kScanThreads, 0, s>>>(
      c, N, dl, int(tiles), w.tile_counts, w.tile_offsets, w.n_lines);
  DSI_CHECK_LAUNCH();
  gs_occ<<<dim3(unsigned(tiles), unsigned(n_dev)), kSThreads, 0, s>>>(
      c, N, static_cast<const uint8_t*>(pats), m, dl, int(tiles),
      w.tile_offsets, l_cap, w.occ);
  DSI_CHECK_LAUNCH();
  gs_lines<<<dim3(unsigned(ltiles), unsigned(n_dev)), kSThreads, 0, s>>>(
      w.occ, l_cap, w.n_lines, bins, k, int(ltiles), h, w.totals,
      w.tile_keys);
  DSI_CHECK_LAUNCH();
  gs_final<<<unsigned(n_dev), kScanThreads, 0, s>>>(
      w.tile_keys, int(ltiles), k, w.n_lines, l_cap, w.totals,
      static_cast<const int64_t*>(bases), bins, h, static_cast<int*>(cand),
      static_cast<int*>(scal));
  DSI_CHECK_LAUNCH();
  return 0;
}

int64_t dsi_grep_emit_scratch_bytes(int n_dev, int64_t N) {
  return 2 * align8(4 * int64_t(n_dev) * ceil_div(N, kSTile));
}

// The emit epilogue: run after dsi_grep_step on the same stream with the
// same chunks, dlen, l_cap, k and step scratch (it reads gs_scan's tile
// offsets and gs_occ's counts there).  comp [n_dev, N] u8 (not aliasing
// chunks); kept [n_dev] i32.
int dsi_grep_emit(const void* chunks, int n_dev, int64_t N, const void* dlen,
                  int64_t l_cap, int k, void* step_scratch, void* scratch,
                  void* comp, void* kept, void* stream) {
  if (n_dev < 1 || N < 1 || l_cap < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = ceil_div(N, kSTile);
  const int64_t ltiles = ceil_div(l_cap, kLineTile);
  StepScratch w = carve(step_scratch, n_dev, tiles, l_cap, ltiles, k);
  int* kept_counts = static_cast<int*>(scratch);
  int* kept_offsets = reinterpret_cast<int*>(
      static_cast<char*>(scratch) + align8(4 * int64_t(n_dev) * tiles));
  const uint8_t* c = static_cast<const uint8_t*>(chunks);
  const int* dl = static_cast<const int*>(dlen);
  const dim3 grid{unsigned(tiles), unsigned(n_dev)};
  ge_count<<<grid, kSThreads, 0, s>>>(c, N, dl, int(tiles), w.tile_offsets,
                                      w.occ, l_cap, kept_counts);
  DSI_CHECK_LAUNCH();
  ge_scan<<<unsigned(n_dev), kSThreads, 0, s>>>(
      kept_counts, int(tiles), kept_offsets, static_cast<int*>(kept));
  DSI_CHECK_LAUNCH();
  ge_write<<<grid, kSThreads, 0, s>>>(c, N, dl, int(tiles), w.tile_offsets,
                                      w.occ, l_cap, kept_offsets,
                                      static_cast<const int*>(kept),
                                      static_cast<uint8_t*>(comp));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
