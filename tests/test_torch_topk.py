"""The port's device top-k and histogram services (K17) against the JAX
package, on the CPU.

The same seeded candidate steps (grep's ``[n_dev, k, 5]`` rows: line
number hi/lo, len 8, count, part 0) fold into
``dsi_tpu.device.topk.DeviceTopK`` on the virtual CPU mesh and into the
port's ``DeviceTopK`` (kernel B's plain version sorts the snapshot).
Snapshots after every sync, the final drain and the counters must be
equal, including shards holding fewer than k rows and empty shards.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from dsi_tpu.device import table as jt
from dsi_tpu.device import topk as jtopk
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch.device import topk as ttopk
from dsi_tpu_torch.interop import to_tensor


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


def _cand_steps(n_dev: int, k: int, n_steps: int, seed: int):
    """Candidate steps as the grep step emits them: per shard up to k
    rows of unique line numbers (some shards short, some empty), zeros
    past each shard's count; counts collide across lines so order ties
    break on the key."""
    rng = np.random.default_rng(seed)
    steps, line = [], 1 << 31  # line numbers cross into the hi word
    for s in range(n_steps):
        packed = np.zeros((n_dev, k, 5), np.uint32)
        scal = np.zeros((n_dev, 5), np.int32)
        for d in range(n_dev):
            n = int(rng.choice([0, 1, 3, k, k]))
            if d == 0 and s == 0:
                n = 2  # a shard with fewer than k rows at the first sync
            if s in (3, 4):
                n = k  # enough rows to overflow the smallest capacity
            for i in range(n):
                packed[d, i] = (line >> 32, line & 0xFFFFFFFF, 8,
                                int(rng.integers(1, 6)), 0)
                line += int(rng.integers(1, 40))
            scal[d] = (n, 0, 0, 0, 0)
        steps.append((packed, scal))
    return steps


_COUNTERS = ("folds", "fold_overflows", "sync_pulls", "widens", "table_cap",
             "topk_snapshots", "pull_bytes", "shard_widens")


def _run(mod, n_dev, steps, *, cap, k, lag, sync_every, mesh_shards):
    stats: dict = {}
    acc = mod.KeyCounts()
    if mod is jtopk:
        svc = jtopk.DeviceTopK(_mesh(n_dev), kk=2, cap=cap, k=k, acc=acc,
                               lag=lag, stats=stats, mesh_shards=mesh_shards)
    else:
        svc = ttopk.DeviceTopK(n_dev, kk=2, cap=cap, k=k, acc=acc,
                               device="cpu", lag=lag, stats=stats,
                               mesh_shards=mesh_shards)
    snaps = []
    for i, (packed, scal) in enumerate(steps):
        if mod is jtopk:
            pd, sd = jnp.asarray(packed), jnp.asarray(scal)
        else:
            pd, sd = to_tensor(packed), to_tensor(scal)
        with jt._quiet_unusable_donation():
            if scal[:, 0].max() > 0:
                svc.fold(pd, sd, scal)
            if (i + 1) % sync_every == 0:
                svc.sync()
                snaps.append(svc.snapshot)
        if i == 0:
            snaps.append(svc.sync())  # an empty-window sync pulls nothing
    with jt._quiet_unusable_donation():
        svc.close()
    return snaps, acc.finalize(), {c: stats.get(c) for c in _COUNTERS}


@pytest.mark.parametrize("n_dev,mesh_shards", [(1, 0), (8, 0), (8, 8),
                                               (8, 4)])
@pytest.mark.parametrize("cap,lag", [(64, 1), (8, 2)])
@pytest.mark.parametrize("k", (4, 16))
def test_device_topk_snapshots_match_reference(n_dev, mesh_shards, cap, lag,
                                               k):
    steps = _cand_steps(n_dev, k, 7, seed=n_dev + cap + k)
    kw = dict(cap=cap, k=k, lag=lag, sync_every=2, mesh_shards=mesh_shards)
    want = _run(jtopk, n_dev, steps, **kw)
    got = _run(ttopk, n_dev, steps, **kw)
    assert got[0] == want[0]  # every snapshot, in order
    assert any(len(s) for s in got[0] if isinstance(s, tuple))
    assert got[1] == want[1]  # the exact drain
    assert got[2] == want[2]
    if cap == 8:
        assert got[2]["widens"] >= 1


def test_topk_rows_orders_by_count_then_key():
    """Kernel B's words: ~count first, then the key lanes (unsigned),
    then len; empty rows last."""
    keys = np.array([[[0, 5], [1, 0], [0, 0xFFFFFFF0], [0xFFFFFFFF] * 2]],
                    np.uint32)
    lens = np.array([[8, 8, 8, 0]], np.int32)
    cnts = np.array([[3, 7, 3, 0]], np.uint64)
    skeys, slens, scnts = ttopk.topk_rows(to_tensor(keys), to_tensor(lens),
                                          to_tensor(cnts), k=4)
    assert skeys.numpy().view(np.uint32)[0].tolist() == [
        [1, 0], [0, 5], [0, 0xFFFFFFF0], [0xFFFFFFFF] * 2]
    assert scnts.numpy()[0].tolist() == [7, 3, 3, 0]
    want = jtopk._topk_jit(jnp.asarray(keys), jnp.asarray(lens),
                           jnp.asarray(cnts), k=4)
    assert np.array_equal(skeys.numpy().view(np.uint32), np.asarray(want[0]))


@pytest.mark.parametrize("n_dev,mesh_shards", [(1, 0), (8, 0), (8, 8)])
def test_device_histogram_matches_reference(n_dev, mesh_shards):
    rng = np.random.default_rng(n_dev)
    slots = 11
    wst: dict = {}
    gst: dict = {}
    ref = jtopk.DeviceHistogram(_mesh(n_dev), slots=slots, stats=wst,
                                mesh_shards=mesh_shards)
    mine = ttopk.DeviceHistogram(n_dev, slots=slots, device="cpu",
                                 stats=gst, mesh_shards=mesh_shards)
    pulls = []
    for i in range(5):
        step = rng.integers(0, 1 << 32, (n_dev, slots),
                            dtype=np.uint64).astype(np.uint32)
        with jt._quiet_unusable_donation():
            ref.fold(jnp.asarray(step))
        mine.fold(to_tensor(step))
        if i % 2:
            pulls.append((mine.pull(), ref.pull()))
    pulls.append((mine.close(), ref.close()))
    for got, want in pulls:
        assert np.array_equal(got, want)  # u32 sums past 2**32 stay exact
    for key in ("hist_folds", "hist_pulls", "pull_bytes", "mesh_shards"):
        assert gst.get(key) == wst.get(key)


def test_key_counts_matches_reference():
    keys = np.array([[0, 1], [1, 0], [0, 1], [0xFFFFFFFF, 5]], np.uint32)
    cnts = np.array([2, 3, 4, 1], np.int64)
    mine, ref = ttopk.KeyCounts(), jtopk.KeyCounts()
    for acc in (mine, ref):
        acc.add(keys, None, cnts, None)
        acc.add(keys[:1], None, cnts[:1], None)
    assert mine.finalize() == ref.finalize() == {
        1: 8, 1 << 32: 3, (0xFFFFFFFF << 32) | 5: 1}
