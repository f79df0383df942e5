"""The checkpoint images of the port's grep, indexer and TF-IDF services
against the JAX package's, on the CPU.

One sequence of appends, folds and syncs goes through the reference's
service on a 4-device virtual CPU mesh and through the port's over 4
virtual shards: ``DevicePostings`` (with and without ``mesh_shards``, and
across an overflow's recovery), ``DeviceHistogram``, ``DeviceTopK`` over
``KeyCounts``, and the host ``PostingsTable``.  ``checkpoint_state()``
arrays are equal bit for bit, dtypes included, and so are the
``take_delta`` entries once materialized; a capture that is followed by a
sync and more appends (or folds) before it materializes still gives the
image of the capture instant; ``restore_state`` then more appends gives
the reference's drain, and ``drain_image`` the same sink calls.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dsi_tpu import ckpt as jck
from dsi_tpu.device import postings as jp
from dsi_tpu.device import table as jt
from dsi_tpu.device import topk as jk
from dsi_tpu.parallel import merge as jm
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch.ckpt import DeltaSteps, drain_posting_steps
from dsi_tpu_torch.device import postings as tp
from dsi_tpu_torch.device import topk as tk
from dsi_tpu_torch.interop import to_tensor
from dsi_tpu_torch.ops.meshroute import pack_host_rows
from dsi_tpu_torch.parallel import merge as tm

N = 4
KK = 4
W = KK + 4  # key lanes + (len, tf, doc, part)


@functools.lru_cache(maxsize=None)
def _mesh():
    return js.default_mesh(N)


def _put(a, spec):
    return jax.device_put(a, NamedSharding(_mesh(), spec))


def _assert_image(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_deltas(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        assert len(got) == len(want)
        _assert_image(DeltaSteps(got).materialize(),
                      jck.DeltaSteps(want).materialize())


# ── the postings buffer ────────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _waves(seed: int):
    """Waves of posting rows [N, 24, W] (letter words of 1-16 bytes, random
    payload; rows past each shard's count are garbage) and their [N, 5]
    scalars, 12-24 valid rows a shard, so a 32-row buffer overflows by the
    third wave.  One row count: the reference compiles one append."""
    rng = np.random.default_rng(seed)
    out = []
    for r in (24,) * 6:
        rows = rng.integers(0, 1 << 32, (N, r, W), dtype=np.uint64) \
            .astype(np.uint32)
        for d in range(N):
            words = [bytes(rng.integers(97, 123, int(rng.integers(1, 17)))
                           .astype(np.uint8)) for _ in range(r)]
            keys, lens, _ = pack_host_rows(words, 1, KK)
            rows[d, :, :KK] = keys
            rows[d, :, KK] = lens
        scal = np.zeros((N, 5), np.int32)
        scal[:, 0] = rng.integers(r // 2, r + 1, N)
        out.append((rows, scal))
    return out


class _Pair:
    """The reference's and the port's buffer fed the same waves, each
    sink's rows kept."""

    def __init__(self, *, cap: int, lag: int, mesh_shards: int):
        self.want_rows, self.got_rows = [], []
        self.ref = jp.DevicePostings(
            _mesh(), width=W, cap=cap,
            sink=lambda r: self.want_rows.append(np.array(r)), lag=lag,
            mesh_shards=mesh_shards, kk=KK)
        self.port = tp.DevicePostings(
            N, width=W, cap=cap,
            sink=lambda r: self.got_rows.append(np.array(r)), device="cpu",
            lag=lag, mesh_shards=mesh_shards, kk=KK)

    def append(self, i: int, seed: int = 0) -> None:
        rows, scal = _waves(seed)[i]
        nvalid = scal[:, 0].astype(np.int64)
        self.ref.append(_put(rows, P(js.AXIS, None, None)),
                        _put(scal, P(js.AXIS, None)), nvalid=nvalid)
        self.port.append(to_tensor(rows), to_tensor(scal), nvalid=nvalid)

    def assert_sinks_equal(self) -> None:
        assert len(self.got_rows) == len(self.want_rows)
        for g, w in zip(self.got_rows, self.want_rows):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["plain", "mesh", "overflow"])
def test_postings_images_match_reference(case):
    """Appends, a capture, then a sync (which lets the next append
    overwrite the buffer from row 0) and two more appends before the
    capture materializes: the image is the capture instant's, equal to
    the reference's bit for bit, and so are both windows' delta entries.
    ``overflow``: a 32-row buffer whose appends overflow, so the capture's
    flush recovers (drain, re-append) first."""
    cap = 32 if case == "overflow" else 256
    pair = _Pair(cap=cap, lag=1 if case != "overflow" else 2,
                 mesh_shards=N if case == "mesh" else 0)
    pair.ref.enable_delta()
    pair.port.enable_delta()
    for i in range(3):
        pair.append(i)
    captured = pair.port.checkpoint_capture()
    want = pair.ref.checkpoint_state()
    d_got, d_want = pair.port.take_delta(), pair.ref.take_delta()
    assert pair.port.pending_rows == pair.ref.pending_rows > 0
    mp = want["buf"].shape[1]
    live = pair.port._buf[:, :mp].clone()
    pair.port.sync()
    pair.ref.sync()
    pair.append(3)
    pair.append(4)
    img = captured.materialize()
    assert not np.array_equal(pair.port._buf[:, :mp].numpy(), live.numpy())
    _assert_image(img, want)
    assert img["buf"].dtype == np.uint32 and img["nrows"].dtype == np.int64
    assert img["cap"].dtype == np.int64 and img["cap"].shape == ()
    np.testing.assert_array_equal(img["buf"], live.numpy().view(np.uint32))
    _assert_deltas(d_got, d_want)
    _assert_deltas(pair.port.take_delta(), pair.ref.take_delta())
    _assert_image(pair.port.checkpoint_state(), pair.ref.checkpoint_state())
    pair.port.close()
    pair.ref.close()
    pair.assert_sinks_equal()
    if case == "overflow":
        assert pair.port.stats["append_overflows"] >= 1
        assert pair.port.stats == pair.ref.stats | {
            k: pair.port.stats[k] for k in ("append_s", "drain_s")}


@pytest.mark.parametrize("mesh_shards", (0, N))
def test_postings_restore_and_drain_image_match_reference(mesh_shards):
    """The reference's image restored into a fresh port buffer re-images
    bit for bit, and more appends then give the reference's drain; the
    image's ``drain_image`` and a delta's ``drain_posting_steps`` give the
    reference's sink calls."""
    pair = _Pair(cap=256, lag=1, mesh_shards=mesh_shards)
    pair.ref.enable_delta()
    for i in range(3):
        pair.append(i)
    img = pair.ref.checkpoint_state()
    entries = pair.ref.take_delta()
    got_rows = []
    fresh = tp.DevicePostings(N, width=W, cap=8,
                              sink=lambda r: got_rows.append(np.array(r)),
                              device="cpu", lag=1, mesh_shards=mesh_shards,
                              kk=KK)
    fresh.restore_state(img)
    assert fresh.cap == int(img["cap"])
    _assert_image(fresh.checkpoint_state(), img)
    pair.want_rows.clear()
    for i in (3, 4):
        rows, scal = _waves(0)[i]
        fresh.append(to_tensor(rows), to_tensor(scal))
        pair.append(i)
    fresh.close()
    pair.ref.close()
    assert len(got_rows) == len(pair.want_rows)
    for g, w in zip(got_rows, pair.want_rows):
        np.testing.assert_array_equal(g, w)
    calls = {"port": [], "ref": []}
    tp.DevicePostings.drain_image(lambda r: calls["port"].append(r), img)
    jp.DevicePostings.drain_image(lambda r: calls["ref"].append(r), img)
    arrays = jck.DeltaSteps(entries).materialize()
    assert drain_posting_steps(lambda r: calls["port"].append(r),
                               arrays) == 3
    jck.drain_posting_steps(lambda r: calls["ref"].append(r), arrays)
    assert len(calls["port"]) == len(calls["ref"]) > 0
    for g, w in zip(calls["port"], calls["ref"]):
        np.testing.assert_array_equal(g, w)


# ── the histogram ──────────────────────────────────────────────────────


@pytest.mark.parametrize("mesh_shards", (0, N))
def test_histogram_image_and_capture_then_fold(mesh_shards):
    """Folds, a capture, two more folds, then the capture materializes: the
    image is the capture instant's, equal to the reference's (uint64 [N,
    slots]); restored into a fresh histogram, the next fold and pull equal
    the reference's."""
    rng = np.random.default_rng(7)
    steps = [rng.integers(0, 1 << 32, (N, 11), dtype=np.uint64)
             .astype(np.uint32) for _ in range(5)]
    ref = jk.DeviceHistogram(_mesh(), slots=11, mesh_shards=mesh_shards)
    port = tk.DeviceHistogram(N, slots=11, device="cpu",
                              mesh_shards=mesh_shards)
    for s in steps[:3]:
        ref.fold(_put(s, P(js.AXIS, None)))
        port.fold(to_tensor(s))
    captured = port.checkpoint_capture()
    want = ref.checkpoint_state()
    for s in steps[3:]:
        port.fold(to_tensor(s))
    img = captured.materialize()
    _assert_image(img, want)
    assert img["hist"].dtype == np.uint64
    fresh = tk.DeviceHistogram(N, slots=11, device="cpu",
                               mesh_shards=mesh_shards)
    fresh.restore_state(want)
    _assert_image(fresh.checkpoint_state(), want)
    for s in steps[3:]:
        ref.fold(_put(s, P(js.AXIS, None)))
        fresh.fold(to_tensor(s))
    np.testing.assert_array_equal(fresh.pull(), ref.pull())
    np.testing.assert_array_equal(port.close(), ref.close())


# ── the top-k table over KeyCounts ─────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _cand_steps():
    """Grep candidate steps in the table's packed layout [N, 32, 5]: two
    key lanes (a global line number's hi, lo), len, count, part; some
    line numbers repeat across steps so folds merge."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(5):
        packed = np.zeros((N, 32, 5), np.uint32)
        packed[..., 1] = rng.integers(0, 200, (N, 32))
        packed[..., 0] = rng.integers(0, 3, (N, 32))
        packed[..., 3] = rng.integers(1, 9, (N, 32))
        scal = np.zeros((N, 5), np.int32)
        scal[:, 0] = rng.integers(10, 33, N)
        out.append((packed, scal))
    return out


def test_topk_images_keycounts_match_reference():
    """``DeviceTopK`` with its delta log armed: folds, a snapshot sync (no
    drain, so the log keeps every confirmed fold), more folds; the delta
    entries and the image equal the reference's, the close drains into
    ``KeyCounts`` whose snapshot (uint64 keys, int64 counts) equals the
    reference's, and each restores the other's."""
    ja, ta = jk.KeyCounts(), tk.KeyCounts()
    ref = jk.DeviceTopK(_mesh(), kk=2, cap=32, k=8, acc=ja, lag=1)
    port = tk.DeviceTopK(N, kk=2, cap=32, k=8, acc=ta, device="cpu", lag=1)
    ref.enable_delta()
    port.enable_delta()

    def fold(i):
        packed, scal = _cand_steps()[i]
        with jt._quiet_unusable_donation():
            ref.fold(_put(packed, P(js.AXIS, None, None)),
                     _put(scal, P(js.AXIS, None)), scal)
        port.fold(to_tensor(packed), to_tensor(scal), scal)

    fold(0)
    fold(1)
    assert port.sync() and ref.sync()
    assert port.snapshot == ref.snapshot
    fold(2)
    got = port.take_delta()
    assert len(got) == 3  # the sync dropped no confirmed fold's entry
    _assert_deltas(got, ref.take_delta())
    _assert_image(port.checkpoint_state(), ref.checkpoint_state())
    fold(3)
    fold(4)
    for key in ("folds", "widens", "topk_snapshots", "table_cap"):
        assert port.stats[key] == ref.stats[key], key
    with jt._quiet_unusable_donation():
        ref.close()
    port.close()
    snap, jsnap = ta.snapshot(), ja.snapshot()
    _assert_image(snap, jsnap)
    assert snap["keys"].dtype == np.uint64 and snap["cnts"].dtype == np.int64
    back, jback = tk.KeyCounts(), jk.KeyCounts()
    back.restore(jsnap)
    jback.restore(snap)
    assert back.finalize() == jback.finalize() == ja.finalize()
    empty = tk.KeyCounts()
    empty.restore({})
    assert empty.snapshot() == {} and empty.finalize() == {}


# ── the host postings table ────────────────────────────────────────────


def test_postings_table_snapshot_restore_match_reference():
    """The snapshot keeps insertion order (per-word doc order): equal to
    the reference's bit for bit, and a table restored from either finalizes
    as the original, more rows added after the restore included."""
    (rows0, scal0), (rows1, scal1) = _waves(1)[:2]
    batches = [rows0[d, :scal0[d, 0]] for d in range(N)]
    more = rows1[0, :scal1[0, 0]]
    mine, ref = tm.PostingsTable(), jm.PostingsTable()
    for b in batches:
        mine.add(b, KK)
        ref.add(b, KK)
    snap = mine.snapshot()
    _assert_image(snap, ref.snapshot())
    back, jback = tm.PostingsTable(), jm.PostingsTable()
    back.restore(ref.snapshot())
    jback.restore(snap)
    for t in (mine, ref, back, jback):
        t.add(more, KK)
    assert back.finalize() == jback.finalize() == ref.finalize() \
        == mine.finalize()
    empty = tm.PostingsTable()
    empty.restore({})
    assert empty.snapshot() == {} and empty.finalize() == {}
