"""Batched crash-test model checking of the scheduler state machine.

Port of ``dsi_tpu/parallel/simulate.py``: every instance is a full
MapReduce job (``mr/coordinator.go``'s per-task logs, first-untouched
assignment, map barrier, requeue of tasks presumed dead by timeout, and
completion counting) with randomized worker exits, stalls and duplicate
completions, and the checker machine-checks liveness (every instance
finishes within the horizon), safety (finished implies every log
COMPLETED) and the reduce barrier, beside the reference's double-count
defect (counters bumped on every completion report).

The draws are the reference's, bit for bit: JAX's threefry-2x32
(Salmon et al., SC'11; 20 rounds) under ``jax_threefry_partitionable``,
written out here as int64 torch functions masked to 32 bits.
``prng_key(seed)`` is ``(0, seed)``, ``split(key, n)[i]`` and
``fold_in(key, i)`` are ``threefry(key, (0, i))``, and ``uniform(key)``
takes the top 23 bits of ``x0 ^ x1`` of ``threefry(key, (0, 0))`` as a
float32 mantissa.  So instance ``i`` of the port equals instance ``i`` of
``jax.vmap(simulate_job)`` over ``split(PRNGKey(seed), n)`` in all seven
outputs, and does not depend on ``n``.

:func:`simulate_batch` runs the instances on ``device``: kernel O
(``csrc/crash_sim.cu``: a persistent grid whose lanes each run one
instance at a time out of registers and shared memory, refilled from a
counter) on the card, and on the CPU the plain version, which steps all
instances as batched tensors tick by tick and freezes each on the tick
where it finishes, as the vmapped ``while_loop`` does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ops.wordcount import (
    _launch,
    _lib,
    _on_device,
    _ptr,
    _stream,
    resolve_device,
)

U = 0  # LOG_UNTOUCHED   (mr/coordinator.go task-log states)
P = 1  # LOG_IN_PROGRESS
C = 2  # LOG_COMPLETED

OUTPUTS = ("finished", "consistent", "safe", "ticks", "requeues",
           "duplicates", "buggy_would_break_barrier")
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


# ── threefry-2x32 (JAX's default PRNG), u32 values in int64 tensors ──────


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on broadcastable int64 tensors holding
    u32 values: key ``(k0, k1)``, counter ``(x0, x1)``; returns
    ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 ``seed`` (the range JAX
    takes without x64): the int64 tensor ``[0, seed mod 2^32]``."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is not a 32-bit int")
    return torch.tensor([0, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and data (an int or a
    tensor broadcasting against ``key[..., 0]``) → keys ``[..., 2]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, n: int, first: int = 0) -> torch.Tensor:
    """``jax.random.split(key, n)`` (``[n, 2]``), or its rows ``first``
    to ``first + n`` of any larger split."""
    return fold_in(key, torch.arange(first, first + n, dtype=torch.int64,
                                     device=key.device))


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` in [0, 1) as float32, for keys
    ``[..., 2]``."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# ── the plain version: all instances as batched tensors ──────────────────


def _first_untouched(log: torch.Tensor) -> torch.Tensor:
    """Per instance, the first UNTOUCHED task of ``log`` [n, tasks], or
    ``tasks`` if none (mr/coordinator.go:50-55)."""
    idx = torch.arange(log.shape[1], dtype=torch.int32, device=log.device)
    return torch.where(log == U, idx, log.shape[1]).amin(dim=1)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return x.gather(1, i[:, None].long())[:, 0]


def _put(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> None:
    x.scatter_(1, i[:, None].long(), v[:, None])


# The work a run's data needs, per instance: ticks on which some worker
# takes a task (each derives a tick key), assignments (each draws a fate),
# and completion reports.
WORK = ("keyed_ticks", "assignments", "reports")


def _simulate_plain(keys: torch.Tensor, *, n_map: int, n_reduce: int,
                    n_workers: int, timeout: int, horizon: int,
                    exit_f: float, stall_f: float,
                    work: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    n, dev, i32 = keys.shape[0], keys.device, torch.int32
    z = torch.zeros(n, dtype=i32, device=dev)
    st = {"t": z, "map_log": torch.zeros((n, n_map), dtype=i32, device=dev),
          "map_dl": torch.zeros((n, n_map), dtype=i32, device=dev),
          "c_map": z, "c_map_b": z,
          "red_log": torch.zeros((n, n_reduce), dtype=i32, device=dev),
          "red_dl": torch.zeros((n, n_reduce), dtype=i32, device=dev),
          "c_red": z, "c_red_b": z,
          "busy": torch.zeros((n, n_workers), dtype=i32, device=dev),
          "wkind": torch.full((n, n_workers), -1, dtype=i32, device=dev),
          "wtask": torch.zeros((n, n_workers), dtype=i32, device=dev),
          "wfate": torch.zeros((n, n_workers), dtype=i32, device=dev),
          "req": z, "dup": z, "keyed_ticks": z, "assignments": z,
          "reports": z,
          "bv": torch.zeros(n, dtype=torch.bool, device=dev),
          "be": torch.zeros(n, dtype=torch.bool, device=dev)}
    workers = torch.arange(n_workers, dtype=torch.int64, device=dev)
    while True:
        active = (st["c_red"] < n_reduce) & (st["t"] < horizon)
        if not bool(active.any()):
            break
        new = _sim_step(st, keys, workers, n_map=n_map, n_reduce=n_reduce,
                        timeout=timeout, exit_f=exit_f, stall_f=stall_f)
        for name, v in new.items():
            a = active.view((n,) + (1,) * (v.dim() - 1))
            st[name] = torch.where(a, v, st[name])
    if work is not None:
        work.update({k: int(st[k].sum()) for k in WORK})
    finished = st["c_red"] == n_reduce
    consistent = ((st["map_log"] == C).all(dim=1)
                  & (st["red_log"] == C).all(dim=1) & (st["c_map"] == n_map))
    return {"finished": finished,
            "consistent": (finished & consistent) | ~finished,
            "safe": ~st["bv"], "ticks": st["t"], "requeues": st["req"],
            "duplicates": st["dup"], "buggy_would_break_barrier": st["be"]}


def _sim_step(st, keys, workers, *, n_map, n_reduce, timeout, exit_f,
              stall_f):
    """One tick of every instance: the reference's ``_sim_step``
    (``dsi_tpu/parallel/simulate.py:76``), returning the new state."""
    t = st["t"] + 1
    tick_key = fold_in(keys, t.to(torch.int64))
    # Every worker's draw, used only where the worker is assigned.
    u = uniform(fold_in(tick_key[:, None, :], workers[None, :]))
    fate = torch.where(u < exit_f, 2, torch.where(u < stall_f, 1, 0))
    ok_dur = 1 + (u * 977).to(torch.int64) % 3
    dur = torch.where(fate == 1, timeout + 2,
                      torch.where(fate == 2, 1, ok_dur)).to(torch.int32)

    # 1. requeue of presumed-dead tasks (coordinator.go:70-77,99-106)
    map_stale = (st["map_log"] == P) & (st["map_dl"] <= t[:, None])
    red_stale = (st["red_log"] == P) & (st["red_dl"] <= t[:, None])
    map_log = torch.where(map_stale, U, st["map_log"])
    red_log = torch.where(red_stale, U, st["red_log"])
    req = st["req"] + map_stale.sum(dim=1, dtype=torch.int32) \
        + red_stale.sum(dim=1, dtype=torch.int32)
    c_map, c_map_b = st["c_map"], st["c_map_b"]
    c_red, c_red_b = st["c_red"], st["c_red_b"]
    busy, wkind = st["busy"].clone(), st["wkind"].clone()
    wtask, wfate = st["wtask"].clone(), st["wfate"].clone()
    map_dl, red_dl = st["map_dl"].clone(), st["red_dl"].clone()
    dup, bv, be = st["dup"], st["bv"], st["be"]
    assignments, n_reports = st["assignments"], st["reports"]

    # 2. completions and silent deaths, in worker order
    for w in range(workers.shape[0]):
        fires = busy[:, w] == t
        reports = fires & (wfate[:, w] != 2)
        is_map = reports & (wkind[:, w] == 0)
        is_red = reports & (wkind[:, w] == 1)
        tm = wtask[:, w].clamp(0, n_map - 1)
        tr = wtask[:, w].clamp(0, n_reduce - 1)
        dup_m = is_map & (_at(map_log, tm) == C)
        dup_r = is_red & (_at(red_log, tr) == C)
        dup = dup + dup_m + dup_r
        c_map = c_map + (is_map & ~dup_m)
        c_red = c_red + (is_red & ~dup_r)
        c_map_b = c_map_b + is_map
        c_red_b = c_red_b + is_red
        n_reports = n_reports + is_map + is_red
        _put(map_log, tm, torch.where(is_map, C, _at(map_log, tm)))
        _put(red_log, tr, torch.where(is_red, C, _at(red_log, tr)))
        busy[:, w] = torch.where(fires, 0, busy[:, w])
        wkind[:, w] = torch.where(fires, -1, wkind[:, w])

    # 3. pull-based assignment of idle workers, in worker order
    for w in range(workers.shape[0]):
        idle = busy[:, w] == 0
        maps_open = c_map < n_map
        reds_open = ~maps_open & (c_red < n_reduce)
        tba_m = _first_untouched(map_log)
        tba_r = _first_untouched(red_log)
        take_map = idle & maps_open & (tba_m < n_map)
        take_red = idle & reds_open & (tba_r < n_reduce)
        maps_left = (map_log != C).any(dim=1)
        bv = bv | (take_red & maps_left)
        be = be | ((c_map_b >= n_map) & maps_left)
        assigned = take_map | take_red
        assignments = assignments + assigned
        busy[:, w] = torch.where(assigned, t + dur[:, w], busy[:, w])
        wkind[:, w] = torch.where(take_map, 0,
                                  torch.where(take_red, 1, wkind[:, w]))
        wtask[:, w] = torch.where(take_map, tba_m,
                                  torch.where(take_red, tba_r, wtask[:, w]))
        wfate[:, w] = torch.where(assigned, fate[:, w].to(torch.int32),
                                  wfate[:, w])
        im = tba_m.clamp(0, n_map - 1)
        ir = tba_r.clamp(0, n_reduce - 1)
        _put(map_log, im, torch.where(take_map, P, _at(map_log, im)))
        _put(map_dl, im, torch.where(take_map, t + timeout, _at(map_dl, im)))
        _put(red_log, ir, torch.where(take_red, P, _at(red_log, ir)))
        _put(red_dl, ir, torch.where(take_red, t + timeout, _at(red_dl, ir)))

    return {"t": t, "map_log": map_log, "map_dl": map_dl, "c_map": c_map,
            "c_map_b": c_map_b, "red_log": red_log, "red_dl": red_dl,
            "c_red": c_red, "c_red_b": c_red_b, "busy": busy,
            "wkind": wkind, "wtask": wtask, "wfate": wfate, "req": req,
            "dup": dup, "bv": bv, "be": be,
            "keyed_ticks": st["keyed_ticks"]
            + (assignments > st["assignments"]).to(torch.int32),
            "assignments": assignments, "reports": n_reports}


# ── kernel O and the entry points ────────────────────────────────────────


def _thresholds(exit_prob: float, stall_prob: float) -> Tuple[float, float]:
    """The fate thresholds as the reference compares them: each Python
    float (the sum formed in double) rounded to float32, as JAX's
    weak-typed constants are against a float32 draw."""
    return (float(np.float32(exit_prob)),
            float(np.float32(exit_prob + stall_prob)))


def _check_sizes(n_instances, n_map, n_reduce, n_workers) -> None:
    if n_instances < 0 or n_map < 1 or n_reduce < 1 or n_workers < 0:
        raise ValueError(f"simulate: bad sizes n_instances={n_instances} "
                         f"n_map={n_map} n_reduce={n_reduce} "
                         f"n_workers={n_workers}")


def simulate_batch(seed: int, n_instances: int, *, n_map: int = 8,
                   n_reduce: int = 10, n_workers: int = 3, timeout: int = 10,
                   horizon: int = 500, exit_prob: float = 0.25,
                   stall_prob: float = 0.2, first: int = 0,
                   device=None) -> Dict[str, torch.Tensor]:
    """Instances ``first`` to ``first + n_instances`` of the fleet seeded
    by ``seed`` (instance ``i`` keyed by ``split(prng_key(seed), ...)[i]``),
    each run to completion or the horizon.  Returns the reference's seven
    per-instance outputs (:data:`OUTPUTS`) as ``[n_instances]`` tensors on
    ``device`` (None = the card): bool ``finished``, ``consistent``,
    ``safe``, ``buggy_would_break_barrier`` and int32 ``ticks``,
    ``requeues``, ``duplicates``.  Kernel O on the card, the plain version
    on the CPU."""
    _check_sizes(n_instances, n_map, n_reduce, n_workers)
    dev = resolve_device(device)
    exit_f, stall_f = _thresholds(exit_prob, stall_prob)
    kw = dict(n_map=n_map, n_reduce=n_reduce, n_workers=n_workers,
              timeout=timeout, horizon=horizon)
    if dev.type == "cpu":
        return _simulate_plain(split(prng_key(seed), n_instances, first),
                               exit_f=exit_f, stall_f=stall_f, **kw)
    return _crash_sim(dev, seed, n_instances, first, exit_f=exit_f,
                      stall_f=stall_f, **kw)


def simulate_batch_plain(seed: int, n_instances: int, *, n_map: int = 8,
                         n_reduce: int = 10, n_workers: int = 3,
                         timeout: int = 10, horizon: int = 500,
                         exit_prob: float = 0.25, stall_prob: float = 0.2,
                         first: int = 0, device=None,
                         work: Optional[dict] = None
                         ) -> Dict[str, torch.Tensor]:
    """:func:`simulate_batch` through the plain version on any device: what
    kernel O is held against on the card.  A ``work`` dict receives the
    run's summed :data:`WORK` counts, from which a bound is counted."""
    _check_sizes(n_instances, n_map, n_reduce, n_workers)
    root = prng_key(seed, device=resolve_device(device))
    exit_f, stall_f = _thresholds(exit_prob, stall_prob)
    return _simulate_plain(split(root, n_instances, first), n_map=n_map,
                           n_reduce=n_reduce, n_workers=n_workers,
                           timeout=timeout, horizon=horizon, exit_f=exit_f,
                           stall_f=stall_f, work=work)


@functools.lru_cache(maxsize=64)
def crash_scratch_bytes(n: int, n_map: int, n_reduce: int,
                        n_workers: int) -> int:
    """Bytes kernel O takes after its outputs in a call of ``n`` instances:
    the refill counter (4), then the device-memory spill, 0 bytes unless
    one warp's state does not fit shared memory (``csrc/crash_sim.cu``)."""
    nbytes = _lib().dsi_crash_sim_scratch_bytes(n, n_map, n_reduce,
                                                n_workers)
    if nbytes < 0:
        raise RuntimeError(f"crash_sim scratch: CUDA error {-nbytes}")
    return nbytes


def _crash_sim(dev, seed, n, first, *, n_map, n_reduce, n_workers, timeout,
               horizon, exit_f, stall_f):
    """Kernel O (``csrc/crash_sim.cu``): replaces ``_sim_step`` (:76),
    ``simulate_job`` (:179) and the ``vmap`` of ``run_crash_model_check``
    (:223).  Lane by lane, instance ``i`` keys itself as ``threefry(root,
    (0, first + i))`` and writes its outputs at ``i``: the counts as int32,
    the flags as bytes viewed as bool.  One allocation (the outputs, the
    counter and any spill), one C call: a memset and a launch, no host
    sync."""
    with _on_device(dev):
        extra = crash_scratch_bytes(n, n_map, n_reduce, n_workers) if n else 0
        buf = torch.empty(16 * n + extra, dtype=torch.uint8, device=dev)
        if n:
            r0, r1 = (int(v) for v in prng_key(seed))
            _launch("crash_sim", _lib().dsi_crash_sim(
                r0, r1, first, n, n_map, n_reduce, n_workers, timeout,
                horizon, exit_f, stall_f, _ptr(buf), _ptr(buf) + 16 * n,
                _stream(buf)))
    ints = buf[:12 * n].view(torch.int32).view(3, n)
    flags = buf[12 * n:16 * n].view(torch.bool).view(4, n)
    return {"finished": flags[0], "consistent": flags[1], "safe": flags[2],
            "ticks": ints[0], "requeues": ints[1], "duplicates": ints[2],
            "buggy_would_break_barrier": flags[3]}


def simulate_job(key: torch.Tensor, *, n_map: int = 8, n_reduce: int = 10,
                 n_workers: int = 3, timeout: int = 10, horizon: int = 500,
                 exit_prob: float = 0.25,
                 stall_prob: float = 0.2) -> Dict[str, torch.Tensor]:
    """Run ONE randomized job keyed by ``key`` (int64 ``[2]``, as
    :func:`prng_key` or a row of :func:`split`) to completion or the
    horizon, with the plain version on the key's device; returns the
    seven outputs as 0-d tensors."""
    _check_sizes(1, n_map, n_reduce, n_workers)
    exit_f, stall_f = _thresholds(exit_prob, stall_prob)
    out = _simulate_plain(key.reshape(1, 2).to(torch.int64), n_map=n_map,
                          n_reduce=n_reduce, n_workers=n_workers,
                          timeout=timeout, horizon=horizon, exit_f=exit_f,
                          stall_f=stall_f)
    return {k: v[0] for k, v in out.items()}


def run_crash_model_check(n_instances: int = 1000, seed: int = 0,
                          device=None, **kwargs) -> dict:
    """Model-check ``n_instances`` randomized jobs on ``device`` (None =
    the card) and aggregate: the reference's dict
    (``dsi_tpu/parallel/simulate.py:226-236``), key for key, computed in
    numpy as there."""
    out = {k: v.cpu().numpy() for k, v in simulate_batch(
        seed, n_instances, device=device, **kwargs).items()}
    return {
        "instances": n_instances,
        "all_finished": bool(out["finished"].all()),
        "all_consistent": bool(out["consistent"].all()),
        "all_safe": bool(out["safe"].all()),
        "mean_ticks": float(out["ticks"].mean()),
        "total_requeues": int(out["requeues"].sum()),
        "total_duplicate_completions": int(out["duplicates"].sum()),
        "instances_where_reference_counter_breaks_barrier":
            int(out["buggy_would_break_barrier"].sum()),
    }
