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
// and a truncating conversion (__fmul_rn: never contracted).  The clock and
// every deadline and busy-until add wrap as int32, as XLA's do.
//
// Bound: integer operations (the threefry rounds and the state updates; the
// outputs are 16 bytes an instance).  Design, one lane an instance at a
// time:
//
//   * The state stays out of device memory.  A task log is two bit masks,
//     untouched and completed (in progress is neither).  The first
//     untouched task is the lowest set bit, and the reference's rescan
//     after each worker's take (simulate.py:129-130) is one bit cleared.
//     `maps_left` is "completed != all".  Deadlines are read only for tasks
//     in progress and live in shared memory, each lane's own slice
//     ([field][lane], conflict-free); the earliest of them is kept in a
//     register (a lower bound: it is recomputed by the scan), so the
//     requeue scan runs only on a tick that reaches it.  Where both logs
//     have at most 32 tasks and there are three workers (the CLI's 8 / 10
//     / 3, which every configuration the model checker runs has), one
//     instance of the kernel keeps the masks and the workers' state
//     (busy-until, task, kind and fate) in registers, its worker loops
//     unrolled; every other size runs the other instance, whose masks (one
//     word per 32 tasks) and workers are shared memory too.  The instances a block
//     holds are sized from this footprint, down to one warp; where one
//     warp's state does not fit, the deadlines, then everything, move to a
//     device-memory spill sized by the grid's lanes (not by the
//     instances), lane fastest.  Each instance's dynamic shared-memory cap
//     is set once a device to the most the device allows, so calls of
//     different sizes can alternate.
//   * Lanes are refilled.  The grid is persistent; a lane whose instance
//     ends writes its seven outputs at the instance's own index (the four
//     flags as bytes, read as bool tensors) and takes the next index from
//     a counter, one atomic a warp for all its lanes that need one, so no
//     lane idles until its warp's last instance ends.
//   * The draws stay lazy: the tick key is derived only on a tick where
//     some worker takes a task, and a draw only for a worker that takes
//     one.  A worker's draw depends only on the tick key and w, so the
//     warp's takes of a tick (three workers a lane, or four at a time) are
//     queued in shared memory and drawn 32 at a time by whichever lanes
//     are free, rather than each lane drawing for every worker any lane of
//     its warp needs.
//
// One call is a 4-byte memset of the counter and one launch.

#include <climits>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr int kWide = 4;                  // workers a chunk of takes
constexpr int kRegWorkers = 3;            // the register instance's workers
constexpr int kBlockThreads = 128;        // most instances a block
// Static shared bytes of a block (the draw requests), beside the state.
constexpr int64_t kStaticSmem = kBlockThreads * (8 + 4 * kWide + kWide);
constexpr int kRegTasks = 32;             // a log in one register mask
constexpr int64_t kSpillLanesMax = 65536; // lanes of the device-memory spill

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
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

// uniform(fold_in(tick_key, w)): two threefry blocks.
__device__ __forceinline__ float worker_draw(uint32_t tk0, uint32_t tk1,
                                             uint32_t w) {
  uint32_t wk0, wk1, a, b;
  threefry2x32(tk0, tk1, 0u, w, wk0, wk1);
  threefry2x32(wk0, wk1, 0u, 0u, a, b);
  return __fsub_rn(__uint_as_float(((a ^ b) >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 addition that wraps, as XLA's does.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return int(uint32_t(a) + uint32_t(b));
}

// The valid bits of mask word j of a log of n tasks.
__device__ __forceinline__ uint32_t valid_bits(int j, int n) {
  const int rest = n - 32 * j;
  return rest >= 32 ? 0xffffffffu : ((1u << rest) - 1u);
}

struct Params {
  uint32_t root0, root1;
  int64_t first, n;
  int n_map, n_reduce, n_workers, timeout, horizon;
  float exit_f, stall_f;
  int wm, wr;  // mask words of the map and reduce logs (0 in registers)
  // Each region of a lane's state: where it starts, in fields, in shared
  // memory (smem_* >= 0) or in the spill (smem_* < 0, spill_* >= 0).
  int smem_workers, smem_masks, smem_dl;
  int spill_workers, spill_masks, spill_dl;
  void* out;       // int32 [3, n], then u8 [4, n]
  unsigned* next;  // the refill counter, zeroed before the launch
  int* spill;      // [fields][lanes]
};

// A lane's view of one region: field f at base[f * stride].
struct Region {
  int* base;
  int64_t stride;
  __device__ __forceinline__ int& operator[](int64_t f) const {
    return base[f * stride];
  }
};

// kNW > 0: both logs have at most 32 tasks and there are kNW workers, so
// the masks and the workers are registers and the deadlines shared memory
// (its accesses compile to shared loads and stores).  kNW = -1: any size,
// each region's place read from Params.
template <int kNW>
__global__ void __launch_bounds__(kBlockThreads) crash_sim(Params P) {
  constexpr bool kReg = kNW > 0;
  // Workers a chunk of takes: all of them when they are registers.
  constexpr int kW = kReg ? kNW : kWide;
  extern __shared__ int smem[];
  // The warp's draw requests: each lane's tick key, the queue of (lane,
  // worker) pairs, the draws.
  __shared__ uint2 tk_s[kBlockThreads];
  __shared__ uint8_t q_s[kBlockThreads / 32][kWide * 32];
  __shared__ float u_s[kWide][kBlockThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t lanes = int64_t(gridDim.x) * blockDim.x;
  const int64_t glane = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  auto region = [&](int at_smem, int at_spill) {
    if (kReg || at_smem >= 0)
      return Region{smem + at_smem * blockDim.x + threadIdx.x,
                    int64_t(blockDim.x)};
    return Region{P.spill + at_spill * lanes + glane, lanes};
  };
  const Region KR = region(P.smem_workers, P.spill_workers);
  const Region MR = region(P.smem_masks, P.spill_masks);
  const Region DR = region(P.smem_dl, P.spill_dl);
  const int n_map = P.n_map, n_reduce = P.n_reduce;
  const int nw = kReg ? kNW : P.n_workers;
  const int wm = P.wm, wr = P.wr;

  // Registers of the instance a lane holds.
  int64_t inst = 0;
  bool have = false, exhausted = false;
  uint32_t key0 = 0, key1 = 0;
  int t = 0, c_map = 0, c_map_b = 0, c_red = 0, c_red_b = 0;
  int requeues = 0, dups = 0, min_dl = INT_MAX;
  bool barrier_viol = false, buggy_early = false;
  uint32_t um = 0, cm = 0, ur = 0, cr = 0;  // kReg
  // kReg: busy-until, task, and kind + 1 | fate << 2.
  int busy[kReg ? kNW : 1], wtask[kReg ? kNW : 1], wkf[kReg ? kNW : 1];

  // Mask word j of a log: plane 0 untouched / 1 completed, log 0 map /
  // 1 reduce (kReg: the register).
  auto mword = [&](int log, int plane, int j) -> uint32_t {
    if constexpr (kReg) {
      return log == 0 ? (plane == 0 ? um : cm) : (plane == 0 ? ur : cr);
    } else {
      const int off = log == 0 ? plane * wm : 2 * wm + plane * wr;
      return uint32_t(MR[off + j]);
    }
  };
  auto set_mword = [&](int log, int plane, int j, uint32_t v) {
    if constexpr (kReg) {
      if (log == 0) {
        (plane == 0 ? um : cm) = v;
      } else {
        (plane == 0 ? ur : cr) = v;
      }
    } else {
      const int off = log == 0 ? plane * wm : 2 * wm + plane * wr;
      MR[off + j] = int(v);
    }
  };
  auto words = [&](int log) {
    return kReg ? 1 : (log == 0 ? wm : wr);
  };
  auto tasks = [&](int log) { return log == 0 ? n_map : n_reduce; };
  auto all_completed = [&](int log) -> bool {
    const int nwd = words(log), nt = tasks(log);
    bool all = true;
    for (int j = 0; j < nwd; ++j) all &= mword(log, 1, j) == valid_bits(j, nt);
    return all;
  };
  // A report of `task` of log `log`: completed, counted once.
  auto complete = [&](int log, int task) {
    const int j = task >> 5;
    const uint32_t bit = 1u << (task & 31);
    const uint32_t c = mword(log, 1, j);
    const bool dup = (c & bit) != 0u;
    dups += dup;
    if (log == 0) {
      c_map += !dup;
      ++c_map_b;
    } else {
      c_red += !dup;
      ++c_red_b;
    }
    set_mword(log, 1, j, c | bit);
    const uint32_t u = mword(log, 0, j);
    if (u & bit) set_mword(log, 0, j, u & ~bit);
  };
  // Requeue of the tasks in progress whose deadline has come; returns the
  // earliest deadline still in progress.
  auto requeue = [&](int log, int nmin) -> int {
    const int nwd = words(log), nt = tasks(log);
    const int dl0 = log == 0 ? 0 : n_map;
    for (int j = 0; j < nwd; ++j) {
      const uint32_t u = mword(log, 0, j);
      uint32_t prog = ~(u | mword(log, 1, j)) & valid_bits(j, nt);
      uint32_t back = 0u;
      while (prog != 0u) {
        const int b = __ffs(int(prog)) - 1;
        prog &= prog - 1u;
        const int dl = DR[dl0 + 32 * j + b];
        if (dl <= t) {
          back |= 1u << b;
          ++requeues;
        } else {
          nmin = min(nmin, dl);
        }
      }
      if (back != 0u) set_mword(log, 0, j, u | back);
    }
    return nmin;
  };
  // Takes the first untouched task of `log` for one worker, or returns -1.
  auto take = [&](int log) -> int {
    const int nwd = words(log);
    for (int j = 0; j < nwd; ++j) {
      const uint32_t u = mword(log, 0, j);
      if (u != 0u) {
        const int b = __ffs(int(u)) - 1;
        set_mword(log, 0, j, u & (u - 1u));
        return 32 * j + b;
      }
    }
    return -1;
  };
  auto draw_outcome = [&](float u, int& fate, int& dur) {
    fate = u < P.exit_f ? 2 : (u < P.stall_f ? 1 : 0);
    const int ok_dur = 1 + int(uint32_t(__fmul_rn(u, 977.0f)) % 3u);
    dur = fate == 1 ? wrap_add(P.timeout, 2) : (fate == 2 ? 1 : ok_dur);
  };

  for (;;) {
    // Refill: one atomic for the warp's lanes that need an instance.
    const bool want = !have && !exhausted;
    const unsigned need = __ballot_sync(kFullMask, want);
    if (need != 0u) {
      const int leader = __ffs(int(need)) - 1;
      unsigned base = 0u;
      if (lane == leader)
        base = atomicAdd(P.next, unsigned(__popc(int(need))));
      base = __shfl_sync(kFullMask, base, leader);
      if (want) {
        const int64_t idx =
            int64_t(base) + __popc(int(need & ((1u << lane) - 1u)));
        if (idx < P.n) {
          have = true;
          inst = idx;
          threefry2x32(P.root0, P.root1, 0u, uint32_t(P.first + idx), key0,
                       key1);
          t = c_map = c_map_b = c_red = c_red_b = requeues = dups = 0;
          min_dl = INT_MAX;
          barrier_viol = buggy_early = false;
          if constexpr (kReg) {
            um = valid_bits(0, n_map);
            ur = valid_bits(0, n_reduce);
            cm = cr = 0u;
          } else {
            for (int j = 0; j < wm; ++j) {
              MR[j] = int(valid_bits(j, n_map));
              MR[wm + j] = 0;
            }
            for (int j = 0; j < wr; ++j) {
              MR[2 * wm + j] = int(valid_bits(j, n_reduce));
              MR[2 * wm + wr + j] = 0;
            }
          }
          if constexpr (kReg) {
#pragma unroll
            for (int w = 0; w < kW; ++w) busy[w] = wtask[w] = wkf[w] = 0;
          } else {
            for (int w = 0; w < nw; ++w)
              KR[w] = KR[nw + w] = KR[2 * nw + w] = 0;
          }
        } else {
          exhausted = true;
        }
      }
    }
    if (!__any_sync(kFullMask, have)) break;

    // Every lane of the warp runs the tick's code below (its warp-wide
    // steps need all 32); `live` lanes tick.
    const bool live = have && c_red < n_reduce && t < P.horizon;
    bool maps_open = false, reds_open = false, maps_left = false;
    if (live) {
      t = wrap_add(t, 1);

      // 1. requeue of presumed-dead tasks, only on a tick that reaches the
      // earliest deadline in progress.
      if (min_dl <= t) min_dl = requeue(1, requeue(0, INT_MAX));

      // 2. completions and silent deaths, in worker order
      auto report = [&](int b, int task, int kf) -> bool {
        if (b != t) return false;
        if ((kf >> 2) != 2) {  // an exited worker reports nothing
          const int kind = (kf & 3) - 1;
          if (kind == 0) {
            complete(0, clampi(task, 0, n_map - 1));
          } else if (kind == 1) {
            complete(1, clampi(task, 0, n_reduce - 1));
          }
        }
        return true;
      };
      if constexpr (kReg) {
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          if (report(busy[w], wtask[w], wkf[w])) {
            busy[w] = 0;
            wkf[w] &= ~3;
          }
        }
      } else {
        for (int w = 0; w < nw; ++w) {
          if (report(KR[w], KR[nw + w], KR[2 * nw + w])) {
            KR[w] = 0;
            KR[2 * nw + w] &= ~3;
          }
        }
      }

      // 3. pull-based assignment, in worker order.  maps_open, reds_open
      // and maps_left hold for the whole step (a take turns untouched into
      // in progress, neither of which is completed).
      maps_open = c_map < n_map;
      reds_open = !maps_open && c_red < n_reduce;
      maps_left = !all_completed(0);
      if (nw > 0) buggy_early |= c_map_b >= n_map && maps_left;
    }
    const int log = maps_open ? 0 : 1;
    const bool open = maps_open || reds_open;
    bool keyed = false;
    uint32_t tk0 = 0u, tk1 = 0u;
    // Chunks of kW workers (kReg: one chunk, w0 = 0, so worker w0 + k is
    // register k).
    for (int w0 = 0; w0 < nw; w0 += kW) {
      int task[kW];
      bool mine = false;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int w = w0 + k;
        int b = 1;
        if (open && w < nw) {
          if constexpr (kReg) {
            b = busy[k];
          } else {
            b = KR[w];
          }
        }
        task[k] = b == 0 ? take(log) : -1;
        mine |= task[k] >= 0;
      }
      // The warp's takes, worker-major: worker k's are requests cum_k ..
      unsigned m[kW];
      int R = 0;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        m[k] = __ballot_sync(kFullMask, task[k] >= 0);
        R += __popc(int(m[k]));
      }
      if (R == 0) continue;
      if (mine) {
        barrier_viol |= log == 1 && maps_left;
        if (!keyed) {
          threefry2x32(key0, key1, 0u, uint32_t(t), tk0, tk1);
          keyed = true;
        }
        tk_s[threadIdx.x] = make_uint2(tk0, tk1);
        int cum = 0;
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          if (task[k] >= 0)
            q_s[warp][cum + __popc(int(m[k] & ((1u << lane) - 1u)))] =
                uint8_t(lane | (k << 5));
          cum += __popc(int(m[k]));
        }
      }
      __syncwarp();
      // The warp's draws, 32 at a time, whoever asked for them.
      for (int r = lane; r < R; r += 32) {
        const int e = q_s[warp][r];
        const int src = e & 31, k = e >> 5;
        const uint2 tk = tk_s[warp * 32 + src];
        u_s[k][warp * 32 + src] = worker_draw(tk.x, tk.y, uint32_t(w0 + k));
      }
      __syncwarp();
      if (mine) {
        const int dl = wrap_add(t, P.timeout);
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          if (task[k] < 0) continue;
          const int w = w0 + k;
          int fate, dur;
          draw_outcome(u_s[k][threadIdx.x], fate, dur);
          const int kf = (log + 1) | (fate << 2);
          if constexpr (kReg) {
            busy[k] = wrap_add(t, dur);
            wtask[k] = task[k];
            wkf[k] = kf;
          } else {
            KR[w] = wrap_add(t, dur);
            KR[nw + w] = task[k];
            KR[2 * nw + w] = kf;
          }
          DR[(log == 0 ? 0 : n_map) + task[k]] = dl;
          min_dl = min(min_dl, dl);
        }
      }
      __syncwarp();  // tk_s, q_s and u_s are rewritten by the next chunk
    }

    if (have && !(c_red < n_reduce && t < P.horizon)) {
      const bool all_c = c_map == n_map && all_completed(0) &&
                         all_completed(1);
      const bool finished = c_red == n_reduce;
      const int64_t n = P.n;
      int* ints = static_cast<int*>(P.out);
      uint8_t* flags = static_cast<uint8_t*>(P.out) + 12 * n;
      ints[0 * n + inst] = t;  // ticks
      ints[1 * n + inst] = requeues;
      ints[2 * n + inst] = dups;
      flags[0 * n + inst] = finished;
      flags[1 * n + inst] = !finished || all_c;  // consistent
      flags[2 * n + inst] = !barrier_viol;       // safe
      flags[3 * n + inst] = buggy_early;  // buggy_would_break_barrier
      have = false;
    }
  }
}

using Kernel = void (*)(Params);
constexpr int kKernels = 2;
const Kernel kKernel[kKernels] = {crash_sim<-1>, crash_sim<kRegWorkers>};

// A launch's shape: the kernel, its threads a block and shared bytes, and
// where each region of a lane's state lives.
struct Plan {
  int kernel = 0;  // index into kKernel
  int threads = 0;
  int64_t smem = 0;
  int smem_workers = -1, smem_masks = -1, smem_dl = -1;
  int spill_workers = -1, spill_masks = -1, spill_dl = -1;
  int spill_fields = 0;
  int wm = 0, wr = 0;
};

int shared_optin(int dev, int64_t* bytes) {
  int v = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = v;
  return int(e);
}

// The plan for these sizes (no device query beyond the shared-memory cap).
int plan_for(int n_map, int n_reduce, int n_workers, Plan* p) {
  int dev = 0;
  int64_t cap = 0;
  int e = int(cudaGetDevice(&dev));
  if (e == 0) e = shared_optin(dev, &cap);
  if (e != 0) return e;
  const bool reg = n_map <= kRegTasks && n_reduce <= kRegTasks &&
                   n_workers == kRegWorkers;
  p->kernel = reg ? 1 : 0;
  p->wm = reg ? 0 : int(ceil_div(n_map, 32));
  p->wr = reg ? 0 : int(ceil_div(n_reduce, 32));
  const int64_t f_workers = reg ? 0 : 3 * int64_t(n_workers);
  const int64_t f_masks = 2 * int64_t(p->wm) + 2 * int64_t(p->wr);
  const int64_t f_dl = int64_t(n_map) + n_reduce;
  // Instances a block: 128, 64 or 32, as the footprint allows (kReg's 64
  // deadlines at most always fit 128).
  cap -= kStaticSmem;
  auto fit = [&](int64_t fields) -> int {
    for (int b = kBlockThreads; b >= 32; b /= 2)
      if (fields * 4 * b <= cap) return b;
    return 0;
  };
  int64_t in_smem = 0;
  int threads = fit(f_workers + f_masks + f_dl);
  if (threads > 0) {
    p->smem_workers = 0;
    p->smem_masks = int(f_workers);
    p->smem_dl = int(f_workers + f_masks);
    in_smem = f_workers + f_masks + f_dl;
  } else if ((threads = fit(f_workers + f_masks)) > 0) {
    p->smem_workers = 0;
    p->smem_masks = int(f_workers);
    p->spill_dl = 0;
    p->spill_fields = int(f_dl);
    in_smem = f_workers + f_masks;
  } else {
    threads = kBlockThreads;
    p->spill_workers = 0;
    p->spill_masks = int(f_workers);
    p->spill_dl = int(f_workers + f_masks);
    p->spill_fields = int(f_workers + f_masks + f_dl);
  }
  p->threads = threads;
  p->smem = in_smem * 4 * threads;
  return 0;
}

// Lanes of the spill: no more than the instances, rounded to a block.
int64_t spill_lanes(const Plan& p, int64_t n) {
  const int64_t lanes = ceil_div(n, p.threads) * p.threads;
  return lanes < kSpillLanesMax ? lanes : kSpillLanesMax;
}

// Blocks of a kernel resident on one SM at once, per (device, kernel,
// threads, shared bytes).  Each kernel's dynamic shared-memory cap is set
// once per device to all that the device allows beside its static shared
// memory, so no launch of any size finds it lowered by another's.
constexpr int kMaxDevices = 64;
std::mutex g_mu;
std::map<std::tuple<int, int, int, int64_t>, int> g_per_sm;
int g_sms[kMaxDevices];
bool g_opted_in[kMaxDevices][kKernels];

int resident(const Plan& p, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 0 || dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  const void* fn = reinterpret_cast<const void*>(kKernel[p.kernel]);
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return int(e);
  }
  if (!g_opted_in[dev][p.kernel]) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return int(e);
    int64_t cap = 0;
    const int se = shared_optin(dev, &cap);
    if (se != 0) return se;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(cap - int64_t(attr.sharedSizeBytes)));
    if (e != cudaSuccess) return int(e);
    g_opted_in[dev][p.kernel] = true;
  }
  const auto key = std::make_tuple(dev, p.kernel, p.threads, p.smem);
  auto it = g_per_sm.find(key);
  if (it == g_per_sm.end()) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, p.threads,
                                                      size_t(p.smem));
    if (e != cudaSuccess) return int(e);
    if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
    it = g_per_sm.emplace(key, per_sm).first;
  }
  *blocks = it->second * g_sms[dev];
  return 0;
}

}  // namespace

extern "C" {

// Bytes of scratch a call takes after `out`: the 4-byte refill counter,
// then the device-memory spill (0 bytes where every instance's state fits
// one warp's shared memory).  Negative on a CUDA error.
int64_t dsi_crash_sim_scratch_bytes(int64_t n, int n_map, int n_reduce,
                                    int n_workers) {
  Plan p;
  const int e = plan_for(n_map, n_reduce, n_workers, &p);
  if (e != 0) return -int64_t(e);
  return 4 + 4 * int64_t(p.spill_fields) * spill_lanes(p, n);
}

// out: int32 [3, n] (ticks, requeues, duplicates), then u8 [4, n]
// (finished, consistent, safe, buggy_would_break_barrier), 4-byte
// aligned; scratch dsi_crash_sim_scratch_bytes(n, ...) bytes, 4-byte
// aligned.  1 <= n <= 2^31; n_map, n_reduce >= 1; n_workers >= 0.
int dsi_crash_sim(int64_t root0, int64_t root1, int64_t first, int64_t n,
                  int n_map, int n_reduce, int n_workers, int timeout,
                  int horizon, float exit_f, float stall_f, void* out,
                  void* scratch, void* stream) {
  if (n < 1 || n > (int64_t(1) << 31) || n_map < 1 || n_reduce < 1 ||
      n_workers < 0)
    return cudaErrorInvalidValue;
  Plan p;
  int e = plan_for(n_map, n_reduce, n_workers, &p);
  if (e != 0) return e;
  int blocks = 0;
  e = resident(p, &blocks);
  if (e != 0) return e;
  const int64_t lanes = p.spill_fields > 0
                            ? spill_lanes(p, n)
                            : ceil_div(n, p.threads) * p.threads;
  const int64_t want = lanes / p.threads;
  if (want < blocks) blocks = int(want);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params P;
  P.root0 = uint32_t(root0);
  P.root1 = uint32_t(root1);
  P.first = first;
  P.n = n;
  P.n_map = n_map;
  P.n_reduce = n_reduce;
  P.n_workers = n_workers;
  P.timeout = timeout;
  P.horizon = horizon;
  P.exit_f = exit_f;
  P.stall_f = stall_f;
  P.wm = p.wm;
  P.wr = p.wr;
  P.smem_workers = p.smem_workers;
  P.smem_masks = p.smem_masks;
  P.smem_dl = p.smem_dl;
  P.spill_workers = p.spill_workers;
  P.spill_masks = p.spill_masks;
  P.spill_dl = p.spill_dl;
  P.out = out;
  P.next = static_cast<unsigned*>(scratch);
  P.spill = static_cast<int*>(scratch) + 1;
  cudaError_t ce = cudaMemsetAsync(P.next, 0, 4, s);
  if (ce != cudaSuccess) return int(ce);
  kKernel[p.kernel]<<<unsigned(blocks), unsigned(p.threads),
                    size_t(p.smem), s>>>(P);
  DSI_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
