"""Kernel O's design as a numpy model, held against the JAX package.

``csrc/crash_sim.cu`` keeps each instance's task logs as two bit masks
(untouched, completed; in progress is neither) in words of 32 tasks, reads
a deadline only for a task in progress and scans for requeues only on a
tick that reaches the earliest deadline kept in a register, derives the
tick key only where some worker takes a task, and refills each lane from
a counter, one atomic a warp.  ``crash_model`` below is that design in
numpy, lane by lane over a grid of two warps; on every case of
``dsi_tpu_torch/utils/kernel_cases.py crash_cases`` each instance's seven
outputs must equal ``dsi_tpu.parallel.simulate.simulate_job`` on
``split(PRNGKey(seed), first + n)[first:]``.  Tolerance: exact.
``chip_smoke.py`` holds the kernel itself against the plain version on
the same cases.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import numpy as np
import pytest

from dsi_tpu.parallel import simulate as jsim
from dsi_tpu_torch.kernels import build
from dsi_tpu_torch.parallel import simulate as tsim
from dsi_tpu_torch.utils.kernel_cases import CRASH_SEED, crash_cases

M32 = np.uint64(0xFFFFFFFF)
INT_MAX = (1 << 31) - 1
CASES = {c[0]: c[1:] for c in crash_cases()}
DEFAULTS = dict(n_map=8, n_reduce=10, n_workers=3, timeout=10, horizon=500,
                exit_prob=0.25, stall_prob=0.2)


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint64 arrays holding u32 values."""
    k0, k1, x0, x1 = (np.asarray(v, np.uint64) & M32 for v in (k0, k1, x0,
                                                              x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r))) & M32) \
                ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & M32
    return x0, x1


def _uniform(k0, k1):
    a, b = _threefry(k0, k1, 0, 0)
    bits = (((a ^ b) >> np.uint64(9)) | np.uint64(0x3F800000))
    return bits.astype(np.uint32).view(np.float32) - np.float32(1.0)


def _wrap(x):
    """int32 wrap-around of int64 values."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _valid(words: int, tasks: int) -> np.ndarray:
    rest = tasks - 32 * np.arange(words)
    return np.where(rest >= 32, 0xFFFFFFFF,
                    (np.uint64(1) << np.clip(rest, 0, 31).astype(np.uint64))
                    - np.uint64(1)).astype(np.uint64)


def _unpack(words: np.ndarray, tasks: int) -> np.ndarray:
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint64)) \
        & np.uint64(1)
    return bits.astype(bool).reshape(words.shape[0], -1)[:, :tasks]


def _pack(bits: np.ndarray, words: int) -> np.ndarray:
    full = np.zeros((bits.shape[0], 32 * words), bool)
    full[:, :bits.shape[1]] = bits
    return (full.reshape(-1, words, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint64)


def crash_model(seed, n, first, *, n_map, n_reduce, n_workers, timeout,
                horizon, exit_prob, stall_prob, lanes=64, wide=4):
    """Kernel O's design over ``lanes`` lanes (warps of 32).  Returns (the
    seven outputs as numpy arrays [n], the refill log [(lane, instance)],
    counts: requeue scans, keyed ticks, draws, ticks)."""
    exit_f = np.float32(exit_prob)
    stall_f = np.float32(exit_prob + stall_prob)
    tasks = (n_map, n_reduce)
    words = tuple(-(-k // 32) for k in tasks)
    valid = tuple(_valid(w, k) for w, k in zip(words, tasks))
    dl_at = (0, n_map)
    L, nw, ar = lanes, n_workers, np.arange(lanes)
    U = [np.zeros((L, w), np.uint64) for w in words]
    C = [np.zeros((L, w), np.uint64) for w in words]
    DL = np.zeros((L, n_map + n_reduce), np.int64)
    busy, wtask, wkind, wfate = (np.zeros((L, nw), np.int64)
                                 for _ in range(4))
    z = lambda: np.zeros(L, np.int64)  # noqa: E731
    t, c_map, c_map_b, c_red, c_red_b, req, dup = (z() for _ in range(7))
    min_dl = np.full(L, INT_MAX, np.int64)
    key0, key1, inst = z(), z(), np.full(L, -1, np.int64)
    have, exhausted = np.zeros(L, bool), np.zeros(L, bool)
    bv, be = np.zeros(L, bool), np.zeros(L, bool)
    out = {k: np.zeros(n, np.int32 if k in ("ticks", "requeues",
                                            "duplicates") else bool)
           for k in tsim.OUTPUTS}
    log, counter = [], 0
    counts = dict(scans=0, keyed_ticks=0, draws=0, ticks=0)

    def first_set(words_):
        nz = words_ != 0
        has = nz.any(1)
        j = nz.argmax(1)
        w = words_[ar, j]
        low = w & ((~w + np.uint64(1)) & M32)
        b = np.frexp(low.astype(np.float64))[1] - 1
        return has, j, 32 * j + b

    def all_completed(k):
        return (C[k] == valid[k][None, :]).all(1)

    while True:
        # The refill: each warp's lanes that need an instance, ranked by
        # lane, take consecutive indices from one atomic.
        for w0 in range(0, L, 32):
            want = ~have[w0:w0 + 32] & ~exhausted[w0:w0 + 32]
            if not want.any():
                continue
            idx = counter + np.cumsum(want) - 1
            counter += int(want.sum())
            for q in np.nonzero(want)[0]:
                lane = w0 + q
                if idx[q] >= n:
                    exhausted[lane] = True
                    continue
                have[lane], inst[lane] = True, idx[q]
                log.append((lane, int(idx[q])))
                k0, k1 = _threefry(0, seed & 0xFFFFFFFF, 0, first + idx[q])
                key0[lane], key1[lane] = int(k0), int(k1)
                for arr in (t, c_map, c_map_b, c_red, c_red_b, req, dup):
                    arr[lane] = 0
                min_dl[lane], bv[lane], be[lane] = INT_MAX, False, False
                for k in (0, 1):
                    U[k][lane], C[k][lane] = valid[k], 0
                busy[lane] = wtask[lane] = wfate[lane] = 0
                wkind[lane] = -1
        if not have.any():
            break
        A = have & (c_red < n_reduce) & (t < horizon)
        counts["ticks"] += int(A.sum())
        t = np.where(A, _wrap(t + 1), t)

        # 1. requeue, only where the tick reaches the earliest deadline
        R = A & (min_dl <= t)
        counts["scans"] += int(R.sum())
        if R.any():
            nmin = np.full(L, INT_MAX, np.int64)
            for k in (0, 1):
                prog = ~_unpack(U[k], tasks[k]) & ~_unpack(C[k], tasks[k])
                dl = DL[:, dl_at[k]:dl_at[k] + tasks[k]]
                stale = R[:, None] & prog & (dl <= t[:, None])
                keep = R[:, None] & prog & ~stale
                U[k] |= _pack(stale, words[k])
                req += stale.sum(1)
                nmin = np.minimum(nmin, np.where(keep, dl, INT_MAX).min(1))
            min_dl = np.where(R, nmin, min_dl)

        # 2. completions, in worker order: one bit each
        for w in range(nw):
            fires = A & (busy[:, w] == t)
            rep = fires & (wfate[:, w] != 2)
            for k in (0, 1):
                is_k = rep & (wkind[:, w] == k)
                task = np.clip(wtask[:, w], 0, tasks[k] - 1)
                j, bit = task >> 5, np.uint64(1) << (task & 31).astype(
                    np.uint64)
                cw, uw = C[k][ar, j], U[k][ar, j]
                d = is_k & ((cw & bit) != 0)
                dup += d
                if k == 0:
                    c_map += is_k & ~d
                    c_map_b += is_k
                else:
                    c_red += is_k & ~d
                    c_red_b += is_k
                C[k][ar, j] = np.where(is_k, cw | bit, cw)
                U[k][ar, j] = np.where(is_k, uw & ~bit, uw)
            busy[:, w] = np.where(fires, 0, busy[:, w])
            wkind[:, w] = np.where(fires, -1, wkind[:, w])

        # 3. assignment, in worker order, in chunks of `wide` workers; the
        # tick key once a tick where any worker takes a task, a draw only
        # for a worker that takes one
        maps_open = c_map < n_map
        reds_open = ~maps_open & (c_red < n_reduce)
        maps_left = ~all_completed(0)
        if nw:
            be |= A & (c_map_b >= n_map) & maps_left
        keyed = np.zeros(L, bool)
        tk0, tk1 = z(), z()
        for w0 in range(0, nw, wide):
            takes = []
            for w in range(w0, min(w0 + wide, nw)):
                idle = A & (busy[:, w] == 0)
                tk = []
                for k, open_ in ((0, maps_open), (1, reds_open)):
                    has, j, task = first_set(U[k])
                    take = idle & open_ & has
                    uw = U[k][ar, j]
                    U[k][ar, j] = np.where(take, uw & (uw - np.uint64(1)), uw)
                    tk.append((take, task))
                takes.append((w, tk))
            anyt = np.zeros(L, bool)
            for _, tk in takes:
                anyt |= tk[0][0] | tk[1][0]
                bv |= tk[1][0] & maps_left
            new = anyt & ~keyed
            if new.any():
                a, b = _threefry(key0, key1, 0, t)
                tk0 = np.where(new, a.astype(np.int64), tk0)
                tk1 = np.where(new, b.astype(np.int64), tk1)
                keyed |= new
            for w, tk in takes:
                u = _uniform(*_threefry(tk0, tk1, 0, w))
                fate = np.where(u < exit_f, 2, np.where(u < stall_f, 1, 0))
                ok = 1 + (u * np.float32(977.0)).astype(np.uint32) % 3
                dur = np.where(fate == 1, _wrap(timeout + 2),
                               np.where(fate == 2, 1, ok))
                dl = _wrap(t + timeout)
                for k, (take, task) in enumerate(tk):
                    counts["draws"] += int(take.sum())
                    busy[:, w] = np.where(take, _wrap(t + dur), busy[:, w])
                    wtask[:, w] = np.where(take, task, wtask[:, w])
                    wkind[:, w] = np.where(take, k, wkind[:, w])
                    wfate[:, w] = np.where(take, fate, wfate[:, w])
                    col = dl_at[k] + np.clip(task, 0, tasks[k] - 1)
                    DL[ar, col] = np.where(take, dl, DL[ar, col])
                    min_dl = np.where(take, np.minimum(min_dl, dl), min_dl)
        counts["keyed_ticks"] += int(keyed.sum())

        # The register's earliest deadline never passes one in progress
        # (checked every 8th tick of the grid: the check costs a tick).
        for k in (0, 1) if counts["ticks"] % 8 == 0 else ():
            prog = ~_unpack(U[k], tasks[k]) & ~_unpack(C[k], tasks[k])
            dl = DL[:, dl_at[k]:dl_at[k] + tasks[k]]
            assert not (have[:, None] & prog & (dl < min_dl[:, None])).any()

        done = have & ~((c_red < n_reduce) & (t < horizon))
        if done.any():
            i = inst[done]
            fin = c_red[done] == n_reduce
            all_c = ((c_map[done] == n_map) & all_completed(0)[done]
                     & all_completed(1)[done])
            out["finished"][i] = fin
            out["consistent"][i] = ~fin | all_c
            out["safe"][i] = ~bv[done]
            out["ticks"][i] = t[done]
            out["requeues"][i] = req[done]
            out["duplicates"][i] = dup[done]
            out["buggy_would_break_barrier"][i] = be[done]
            have &= ~done
    return out, log, counts


@functools.lru_cache(maxsize=None)
def _reference_run(config: tuple, count: int):
    """``simulate_job`` on each key of ``split(PRNGKey(seed), count)``,
    one compile a configuration (unbatched, it compiles in about half the
    time of its ``jax.vmap``, and each instance's outputs are the same)."""
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.PRNGKey(CRASH_SEED), count)
        outs = jax.device_get([jsim.simulate_job(k, **dict(config))
                               for k in keys])
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def _reference(name: str):
    """The reference's outputs for a case; cases of one configuration
    share one run of their largest ``first + n``."""
    n, first, kw = CASES[name]
    config = tuple(sorted(kw.items()))
    count = max(c[0] + c[1] for c in CASES.values()
                if tuple(sorted(c[2].items())) == config)
    return {k: v[first:first + n]
            for k, v in _reference_run(config, count).items()}


@functools.lru_cache(maxsize=None)
def _model(name: str):
    n, first, kw = CASES[name]
    return crash_model(CRASH_SEED, n, first, **{**DEFAULTS, **kw})


@pytest.mark.parametrize("name", sorted(CASES))
def test_crash_model_matches_reference(name):
    n, first, kw = CASES[name]
    want = _reference(name)
    got, log, counts = _model(name)
    for k in tsim.OUTPUTS:
        assert np.array_equal(got[k], want[k]), (name, k)
    # The refill order: every instance once, each lane's in rising order.
    assert sorted(i for _, i in log) == list(range(n))
    for lane in range(64):
        mine = [i for q, i in log if q == lane]
        assert mine == sorted(mine)
    assert counts["ticks"] == int(want["ticks"].sum())
    assert counts["keyed_ticks"] <= min(counts["ticks"], counts["draws"])
    assert counts["scans"] <= counts["ticks"]


def test_crash_model_scans_and_keys_less_than_every_tick():
    """Under the CLI's faults the requeue scan and the tick key are each
    skipped on most ticks, and the draws equal the plain version's
    assignments."""
    n, first, kw = CASES["cli"]
    _, _, counts = _model("cli")
    work: dict = {}
    tsim.simulate_batch_plain(CRASH_SEED, n, first=first, device="cpu",
                              work=work, **kw)
    assert counts["draws"] == work["assignments"]
    assert counts["keyed_ticks"] == work["keyed_ticks"]
    assert counts["scans"] < counts["ticks"] // 2


def test_crash_c_interface():
    """The wrapper's one C call and the scratch query it makes once per
    configuration: the counter and any spill after the outputs."""
    p, i64, c_int, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_float)
    assert build.SIGNATURES["dsi_crash_sim"] == (
        c_int, [i64, i64, i64, i64, c_int, c_int, c_int, c_int, c_int, f32,
                f32, p, p, p])
    assert build.SIGNATURES["dsi_crash_sim_scratch_bytes"] == (
        i64, [i64, c_int, c_int, c_int])
