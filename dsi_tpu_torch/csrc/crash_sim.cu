// Kernel O: the crash model checker.
//
// Replaces K23, the reference's batched scheduler state machine
// (dsi_tpu/parallel/simulate.py:76 _sim_step, :179 simulate_job under the
// jax.vmap of run_crash_model_check :223): every instance is a MapReduce job
// (per-task logs, first-untouched assignment, map barrier, timeout requeue,
// completion counting) whose workers draw exit / stall / ok fates, run tick
// by tick until c_reduce == n_reduce or t == horizon.
//
// The draws are JAX's threefry-2x32 (20 rounds) under
// jax_threefry_partitionable, bit for bit: the instance key is
// threefry(root, (0, i)), the tick key fold_in(key, t) = threefry(key,
// (0, t)), a worker's draw uniform(fold_in(tick_key, w)), and uniform(k)
// takes ((x0 ^ x1) >> 9) | 0x3F800000 of threefry(k, (0, 0)) as a float in
// [1, 2), minus 1.  The fate thresholds arrive as float32 (the host rounds
// exit_prob and exit_prob + stall_prob, as JAX's weak-typed constants are),
// and an ok duration is 1 + (uint32)(u * 977.0f) % 3, one float32 multiply
// and a truncating conversion (__fmul_rn: never contracted).
//
// A draw is made only where a worker takes a task, and the tick key only on
// a tick where one does: the reference computes every worker's draw and
// reads it only under `assigned`, and the draws are counter-based, so the
// outputs are the same.
//
// Bound: integer operations (the threefry rounds and the state updates; the
// outputs are 16 bytes an instance).  Design: one thread an instance, its
// key derived in the thread, so no key array is built and instance i of a run
// of n equals instance i of any larger run.  The per-task and per-worker
// state lives in global memory as [field][task or worker][instance], the
// instance fastest, so a warp's loads coalesce and any n_map, n_reduce and
// n_workers fit; the scalars live in registers.  Instances that finish early
// idle in their warp until the warp's last one finishes.

#include "common.cuh"

namespace {

constexpr int kU = 0, kP = 1, kC = 2;  // task-log states

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ float uniform01(uint32_t k0, uint32_t k1) {
  uint32_t a, b;
  threefry2x32(k0, k1, 0u, 0u, a, b);
  return __fsub_rn(__uint_as_float(((a ^ b) >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 addition that wraps, as XLA's does.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return int(uint32_t(a) + uint32_t(b));
}

__global__ void crash_sim(uint32_t root0, uint32_t root1, int64_t first,
                          int64_t n, int n_map, int n_reduce, int n_workers,
                          int timeout, int horizon, float exit_f,
                          float stall_f, int* state, int* out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Field planes of n ints each, instance fastest.
  int* map_log = state;
  int* map_dl = map_log + int64_t(n_map) * n;
  int* red_log = map_dl + int64_t(n_map) * n;
  int* red_dl = red_log + int64_t(n_reduce) * n;
  int* busy = red_dl + int64_t(n_reduce) * n;
  int* wkind = busy + int64_t(n_workers) * n;
  int* wtask = wkind + int64_t(n_workers) * n;
  int* wfate = wtask + int64_t(n_workers) * n;
#define AT(plane, j) plane[int64_t(j) * n + i]
  for (int j = 0; j < n_map; ++j) AT(map_log, j) = kU, AT(map_dl, j) = 0;
  for (int j = 0; j < n_reduce; ++j) AT(red_log, j) = kU, AT(red_dl, j) = 0;
  for (int w = 0; w < n_workers; ++w) {
    AT(busy, w) = 0;
    AT(wkind, w) = -1;
    AT(wtask, w) = 0;
    AT(wfate, w) = 0;
  }
  const uint64_t inst = uint64_t(first + i);
  uint32_t key0, key1;
  threefry2x32(root0, root1, 0u, uint32_t(inst), key0, key1);

  int t = 0, c_map = 0, c_map_b = 0, c_red = 0, c_red_b = 0;
  int requeues = 0, dups = 0;
  bool barrier_viol = false, buggy_early = false;
  while (c_red < n_reduce && t < horizon) {
    t = wrap_add(t, 1);
    uint32_t tk0 = 0, tk1 = 0;
    bool tick_keyed = false;

    // 1. requeue of presumed-dead tasks
    for (int j = 0; j < n_map; ++j) {
      if (AT(map_log, j) == kP && AT(map_dl, j) <= t) {
        AT(map_log, j) = kU;
        ++requeues;
      }
    }
    for (int j = 0; j < n_reduce; ++j) {
      if (AT(red_log, j) == kP && AT(red_dl, j) <= t) {
        AT(red_log, j) = kU;
        ++requeues;
      }
    }

    // 2. completions and silent deaths, in worker order
    for (int w = 0; w < n_workers; ++w) {
      if (AT(busy, w) != t) continue;
      const int kind = AT(wkind, w);
      if (AT(wfate, w) != 2) {  // an exited worker reports nothing
        const int task = AT(wtask, w);
        if (kind == 0) {
          const int tm = clampi(task, 0, n_map - 1);
          if (AT(map_log, tm) == kC) {
            ++dups;
          } else {
            ++c_map;
          }
          ++c_map_b;
          AT(map_log, tm) = kC;
        } else if (kind == 1) {
          const int tr = clampi(task, 0, n_reduce - 1);
          if (AT(red_log, tr) == kC) {
            ++dups;
          } else {
            ++c_red;
          }
          ++c_red_b;
          AT(red_log, tr) = kC;
        }
      }
      AT(busy, w) = 0;
      AT(wkind, w) = -1;
    }

    // 3. pull-based assignment, in worker order; the first untouched task
    // is rescanned after each worker's assignment.
    for (int w = 0; w < n_workers; ++w) {
      const bool idle = AT(busy, w) == 0;
      const bool maps_open = c_map < n_map;
      const bool reds_open = !maps_open && c_red < n_reduce;
      int tba_m = n_map, tba_r = n_reduce;
      for (int j = n_map - 1; j >= 0; --j)
        if (AT(map_log, j) == kU) tba_m = j;
      for (int j = n_reduce - 1; j >= 0; --j)
        if (AT(red_log, j) == kU) tba_r = j;
      bool maps_left = false;
      for (int j = 0; j < n_map; ++j) maps_left |= AT(map_log, j) != kC;
      const bool take_map = idle && maps_open && tba_m < n_map;
      const bool take_red = idle && reds_open && tba_r < n_reduce;
      barrier_viol |= take_red && maps_left;
      buggy_early |= c_map_b >= n_map && maps_left;

      if (!(take_map || take_red)) continue;

      if (!tick_keyed) {
        threefry2x32(key0, key1, 0u, uint32_t(t), tk0, tk1);
        tick_keyed = true;
      }
      uint32_t wk0, wk1;
      threefry2x32(tk0, tk1, 0u, uint32_t(w), wk0, wk1);
      const float u = uniform01(wk0, wk1);
      const int fate = u < exit_f ? 2 : (u < stall_f ? 1 : 0);
      const int ok_dur = 1 + int(uint32_t(__fmul_rn(u, 977.0f)) % 3u);
      const int dur =
          fate == 1 ? wrap_add(timeout, 2) : (fate == 2 ? 1 : ok_dur);
      if (take_map) {
        AT(map_log, tba_m) = kP;
        AT(map_dl, tba_m) = wrap_add(t, timeout);
        AT(wkind, w) = 0;
        AT(wtask, w) = tba_m;
      } else {
        AT(red_log, tba_r) = kP;
        AT(red_dl, tba_r) = wrap_add(t, timeout);
        AT(wkind, w) = 1;
        AT(wtask, w) = tba_r;
      }
      AT(busy, w) = wrap_add(t, dur);
      AT(wfate, w) = fate;
    }
  }

  bool all_c = c_map == n_map;
  for (int j = 0; j < n_map; ++j) all_c &= AT(map_log, j) == kC;
  for (int j = 0; j < n_reduce; ++j) all_c &= AT(red_log, j) == kC;
#undef AT
  const bool finished = c_red == n_reduce;
  out[0 * n + i] = finished;
  out[1 * n + i] = !finished || all_c;  // consistent
  out[2 * n + i] = !barrier_viol;       // safe
  out[3 * n + i] = t;                   // ticks
  out[4 * n + i] = requeues;
  out[5 * n + i] = dups;
  out[6 * n + i] = buggy_early;         // buggy_would_break_barrier
}

}  // namespace

extern "C" {

// state: (2 n_map + 2 n_reduce + 4 n_workers) * n int32 scratch; out [7, n]
// int32 in the order finished, consistent, safe, ticks, requeues,
// duplicates, buggy_would_break_barrier.  n >= 1; n_map, n_reduce >= 1.
int dsi_crash_sim(int64_t root0, int64_t root1, int64_t first, int64_t n,
                  int n_map, int n_reduce, int n_workers, int timeout,
                  int horizon, float exit_f, float stall_f, void* state,
                  void* out, void* stream) {
  crash_sim<<<unsigned(ceil_div(n, 128)), 128, 0,
              static_cast<cudaStream_t>(stream)>>>(
      uint32_t(root0), uint32_t(root1), first, n, n_map, n_reduce, n_workers,
      timeout, horizon, exit_f, stall_f, static_cast<int*>(state),
      static_cast<int*>(out));
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
