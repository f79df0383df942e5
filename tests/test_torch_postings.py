"""The port's postings append (K20a, kernel M's plain version) and its
``DevicePostings`` against the JAX package, on the CPU.

The same numpy buffer, counts and wave rows go into the reference's
``_append_step`` (``_append_device`` under ``shard_map``) on the
virtual CPU mesh and into ``dsi_tpu_torch.device.postings
.postings_append`` over the same number of virtual shards: the buffer
(stale rows past the write offsets included), the counts, the dirty bits
and the flags equal bit for bit.  Then one sequence of waves, some larger
than the buffer, goes through both services with lagged flags: the rows
handed to the sink, in order, and the counters agree.  Kernel M's
received entry (the mesh append's compaction fused into the append) goes
through the same check against the reference's ``compact_received`` then
``_append_step``: only each pair's routed rows count, and those whose lane
0 is all ones are dropped.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dsi_tpu.device import postings as jp
from dsi_tpu.ops import meshroute as jmr
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch.device import postings as tp
from dsi_tpu_torch.interop import to_numpy, to_tensor

W = 8  # kk 4 key lanes + (len, tf, doc, part)


@functools.lru_cache(maxsize=None)
def _mesh(n: int):
    return js.default_mesh(n)


def _case(kind: str, n_dev: int, seed: int):
    rng = np.random.default_rng(seed)
    cap, r = 64, 40
    buf = rng.integers(0, 1 << 32, (n_dev, cap, W), dtype=np.uint64) \
        .astype(np.uint32)
    n = rng.integers(0, 20, n_dev).astype(np.int32)
    dirty = np.zeros(n_dev, np.int32)
    rows = rng.integers(0, 1 << 32, (n_dev, r, W), dtype=np.uint64) \
        .astype(np.uint32)
    scal = np.zeros((n_dev, 5), np.int32)
    scal[:, 0] = rng.integers(0, r + 1, n_dev)
    scal[:, 1:] = rng.integers(0, 9, (n_dev, 4))
    scal[:, 0] = np.minimum(scal[:, 0], cap - n)  # every shard fits
    if kind == "overflow_one_shard":
        d = n_dev - 1
        n[d] = cap - 5
        scal[d, 0] = 6
    elif kind == "sticky_dirty":
        dirty[:] = 1
    elif kind == "exact_fill":
        scal[:, 0] = np.minimum(cap - n, r)
        n[:] = cap - scal[:, 0]
    return buf, n, dirty, rows, scal


def _ref_append(buf, n, dirty, rows, scal):
    mesh = _mesh(buf.shape[0])
    out = jp._append_step(jax.numpy.asarray(buf), jax.numpy.asarray(n),
                          jax.numpy.asarray(dirty), jax.numpy.asarray(rows),
                          jax.numpy.asarray(scal), mesh=mesh)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("kind", ("fits", "overflow_one_shard",
                                  "sticky_dirty", "exact_fill"))
@pytest.mark.parametrize("n_dev", (1, 8))
def test_append_matches_reference(kind, n_dev):
    buf, n, dirty, rows, scal = _case(kind, n_dev, seed=n_dev)
    want_buf, want_n, want_dirty, want_flags = _ref_append(
        buf, n, dirty, rows, scal)
    tbuf = to_tensor(buf)
    got_n, got_dirty, got_flags = tp.postings_append(
        tbuf, to_tensor(n), to_tensor(dirty), to_tensor(rows),
        to_tensor(scal))
    np.testing.assert_array_equal(to_numpy(tbuf, np.uint32), want_buf)
    np.testing.assert_array_equal(to_numpy(got_n), want_n)
    np.testing.assert_array_equal(to_numpy(got_dirty), want_dirty)
    np.testing.assert_array_equal(to_numpy(got_flags), want_flags)
    no_op = bool(want_flags[:, 0].any())
    assert no_op == (kind in ("overflow_one_shard", "sticky_dirty"))
    if no_op:  # a no-op keeps the old buffer byte for byte
        np.testing.assert_array_equal(to_numpy(tbuf, np.uint32), buf)


def _received_case(kind: str, n_dev: int, seed: int):
    """A buffer and what kernel E hands the mesh append: recv [n_dev,
    n_dev*r, W] whose pair blocks hold ``totals[s, d]`` rows (about one in
    six with lane 0 alone all ones), then E's pad rows."""
    buf, n, dirty, _, _ = _case(kind, n_dev, seed)
    rng = np.random.default_rng(seed + 1)
    r = 12 if n_dev == 1 else 5  # 64 - max(n) rows fit every shard
    totals = rng.integers(0, r + 1, (n_dev, n_dev)).astype(np.int32)
    if kind == "overflow_one_shard":
        totals[0, -1] = max(totals[0, -1], 2)
    recv = np.zeros((n_dev, n_dev * r, W), np.uint32)
    recv[..., :W - 4] = 0xFFFFFFFF
    for s in range(n_dev):
        for d in range(n_dev):
            h = rng.integers(0, 1 << 31, (totals[s, d], W)).astype(np.uint32)
            h[rng.random(len(h)) < 0.15, 0] = 0xFFFFFFFF
            recv[d, s * r:s * r + len(h)] = h
    if kind == "overflow_one_shard":  # the last shard keeps two rows
        n[-1] = 64 - 1
        recv[-1, :2, 0] = 0
    return buf, n, dirty, recv, totals


_REF_RECEIVED = jax.jit(jmr.compact_received)


@pytest.mark.parametrize("kind", ("fits", "overflow_one_shard",
                                  "sticky_dirty"))
@pytest.mark.parametrize("n_dev", (1, 8))
def test_append_received_matches_reference(kind, n_dev):
    # Kernel M's received entry (plain) against the reference's
    # compact_received of each shard's received rows, then _append_device.
    buf, n, dirty, recv, totals = _received_case(kind, n_dev, seed=n_dev)
    crows, n_recv = zip(*(_REF_RECEIVED(jax.numpy.asarray(recv[d]))
                          for d in range(n_dev)))
    scal = np.asarray(n_recv, np.int32)[:, None]
    want = _ref_append(buf, n, dirty, np.stack(crows), scal)
    tbuf = to_tensor(buf)
    got = tp.postings_append_received(tbuf, to_tensor(n), to_tensor(dirty),
                                      to_tensor(recv), to_tensor(totals))
    np.testing.assert_array_equal(to_numpy(tbuf, np.uint32), want[0])
    for g, w in zip(got, want[1:]):
        np.testing.assert_array_equal(to_numpy(g), w)
    assert bool(want[3][:, 0].any()) == (kind != "fits")
    heads = sum(int(totals[s, d]) for s in range(n_dev) for d in range(n_dev))
    assert int(scal.sum()) < heads  # lane-0 rows were dropped


def test_append_received_rejects_bad_operands():
    z1 = torch.zeros(2, dtype=torch.int32)
    buf = torch.zeros((2, 8, W), dtype=torch.int32)
    recv = torch.zeros((2, 6, W), dtype=torch.int32)
    with pytest.raises(ValueError):  # totals not [n_dev, n_dev]
        tp.postings_append_received(buf, z1, z1, recv,
                                    torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):  # recv rows not n_dev blocks
        tp.postings_append_received(buf, z1, z1, recv[:, :5].contiguous(),
                                    torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):  # no key lane to test
        tp.mesh_postings_append(buf, z1, z1, recv[:, :3].contiguous(),
                                torch.zeros((2, 5), dtype=torch.int32),
                                kk=0, n_shards=2)


def _waves(n_dev: int, seed: int):
    """Wave (rows, scal) pairs with growing row counts: the later ones
    overflow a 64-row buffer, and the last is larger than 4x it."""
    rng = np.random.default_rng(seed)
    out = []
    for r in (16, 24, 32, 40, 64, 300, 20):
        rows = rng.integers(0, 1 << 32, (n_dev, r, W), dtype=np.uint64) \
            .astype(np.uint32)
        scal = np.zeros((n_dev, 5), np.int32)
        scal[:, 0] = rng.integers(r // 2, r + 1, n_dev)
        out.append((rows, scal))
    return out


@pytest.mark.parametrize("n_dev,lag", ((1, 0), (1, 2), (8, 1)))
def test_device_postings_matches_reference(n_dev, lag):
    waves = _waves(n_dev, seed=lag + n_dev)
    mesh = _mesh(n_dev)
    sh3 = NamedSharding(mesh, P(js.AXIS, None, None))
    sh2 = NamedSharding(mesh, P(js.AXIS, None))
    want_rows, got_rows = [], []
    want_st, got_st = {}, {}
    ref = jp.DevicePostings(mesh, width=W, cap=64,
                            sink=lambda r: want_rows.append(np.array(r)),
                            lag=lag, stats=want_st)
    port = tp.DevicePostings(n_dev, width=W, cap=64,
                             sink=lambda r: got_rows.append(np.array(r)),
                             device="cpu", lag=lag, stats=got_st)
    for i, (rows, scal) in enumerate(waves):
        ref.append(jax.device_put(rows, sh3), jax.device_put(scal, sh2))
        port.append(to_tensor(rows), to_tensor(scal))
        if i == 2:
            ref.sync()
            port.sync()
    ref.close()
    port.close()
    assert len(got_rows) == len(want_rows)
    for g, w in zip(got_rows, want_rows):
        np.testing.assert_array_equal(g, w)
    for key in ("appends", "append_overflows", "sync_pulls",
                "postings_widens", "pull_bytes"):
        assert got_st[key] == want_st[key], key
    assert got_st["append_overflows"] >= 1
    assert got_st["postings_widens"] >= 1
    if n_dev == 1:  # every valid row reached the sink once, wave order
        np.testing.assert_array_equal(
            np.concatenate(got_rows),
            np.concatenate([rows[0, :scal[0, 0]] for rows, scal in waves]))


def test_checkpoint_methods_not_ported():
    """The five checkpoint methods are ported: they run, and an image
    round-trips through ``restore_state``, delta entries included."""
    port = tp.DevicePostings(1, width=W, cap=8, sink=lambda r: None,
                             device="cpu")
    port.enable_delta()
    rows = torch.arange(4 * W, dtype=torch.int32).view(1, 4, W)
    scal = torch.tensor([[3, 0, 0, 0, 0]], dtype=torch.int32)
    port.append(rows, scal, nvalid=np.array([3]))
    (got, nus), = port.take_delta()
    np.testing.assert_array_equal(got.wait()[0, :3], rows[0, :3].numpy())
    assert nus.tolist() == [3] and port.take_delta() == []
    img = port.checkpoint_capture().materialize()
    assert img["nrows"].tolist() == [3] and int(img["cap"]) == 8
    back = tp.DevicePostings(1, width=W, cap=2, sink=lambda r: None,
                             device="cpu")
    back.restore_state(img)
    for k, v in back.checkpoint_state().items():
        np.testing.assert_array_equal(v, img[k])
    with pytest.raises(ValueError):
        tp.postings_append(torch.zeros((1, 8, W), dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros((1, 4, W), dtype=torch.int32),
                           torch.zeros((1, 5), dtype=torch.int32))
