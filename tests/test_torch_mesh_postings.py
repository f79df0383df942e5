"""The port's mesh-sharded postings append (K20b: kernels D, E, L and M's
plain versions) and ``mesh_shards`` in ``tfidf_sharded`` against the JAX
package, on the CPU.

The same numpy buffer, counts and wave rows go into the reference's
``_mesh_append_step`` on the virtual CPU mesh and into
``dsi_tpu_torch.device.postings.mesh_postings_append`` over the same
number of virtual shards: the buffer (stale rows past the write offsets
included), the counts, the dirty bits and the flags equal bit for bit,
and every appended row sits on the shard its word hashes to.  Then
``DevicePostings(mesh_shards=)`` and ``tfidf_sharded(mesh_shards=)``
against the reference's: the rows handed to the sink, the result
(per-word posting order included) and the counters.  Rows E routes as
valid whose lane 0 alone is all ones are dropped as the reference's
``compact_received`` drops them; ``exchange_rows``' per-pair totals equal
the destination counts; and a numpy model of kernel M's received entry
(chunks of each pair's routed rows, mask words, ranks from counts) gives
the reference's buffer, counts and flags when it fits, overflows one
shard, or is dirty.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dsi_tpu.device import postings as jp
from dsi_tpu.ops import meshroute as jmr
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import tfidf as jtf
from dsi_tpu.utils.jaxcompat import shard_map
from dsi_tpu_torch.device import postings as tp
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.ops import meshroute as tmr
from dsi_tpu_torch.ops.meshroute import host_shard_of, pack_host_rows
from dsi_tpu_torch.parallel import tfidf as ttf

KK = 4
W = KK + 4  # key lanes + (len, tf, doc, part)


@pytest.fixture(autouse=True)
def _hermetic_env(monkeypatch):
    """Engine knobs another test file may have left set take no part."""
    for var in ("DSI_STREAM_MESH_SHARDS", "DSI_DEVICE_POSTINGS_CAP",
                "DSI_WC_GROUPER", "DSI_STREAM_SYNC_EVERY",
                "DSI_STREAM_PIPELINE_DEPTH"):
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=None)
def _mesh(n: int):
    return js.default_mesh(n)


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(800)]


def _word(rng) -> bytes:
    return bytes(rng.integers(97, 123, int(rng.integers(1, 4 * KK + 1)))
                 .astype(np.uint8))


def _wave_rows(rng, n_dev: int, r: int, n_valid=None):
    """One wave's [n_dev, r, W] posting rows (letter words of 1-16
    bytes, random payload; rows past each shard's count are garbage, as
    a wave's pad rows may be) and its [n_dev, 5] scalars."""
    rows = rng.integers(0, 1 << 32, (n_dev, r, W), dtype=np.uint64) \
        .astype(np.uint32)
    for d in range(n_dev):
        keys, lens, _ = pack_host_rows([_word(rng) for _ in range(r)], 1, KK)
        rows[d, :, :KK] = keys
        rows[d, :, KK] = lens
    scal = np.zeros((n_dev, 5), np.int32)
    scal[:, 0] = (rng.integers(0, r + 1, n_dev) if n_valid is None
                  else n_valid)
    scal[:, 1:] = rng.integers(0, 9, (n_dev, 4))
    return rows, scal


def _case(kind: str, n_dev: int, seed: int):
    rng = np.random.default_rng(seed)
    cap, r = 256, 40
    buf = rng.integers(0, 1 << 32, (n_dev, cap, W), dtype=np.uint64) \
        .astype(np.uint32)
    n = rng.integers(0, 20, n_dev).astype(np.int32)
    dirty = np.zeros(n_dev, np.int32)
    rows, scal = _wave_rows(rng, n_dev, r)
    if kind == "overflow_one_shard":
        # Shard 0 has one free row and receives more than one.
        n[0] = cap - 1
        scal[:, 0] = r
    elif kind == "sticky_dirty":
        dirty[:] = 1
    return buf, n, dirty, rows, scal


@functools.lru_cache(maxsize=None)
def _ref_mesh_append(kind: str, n_shards: int, lane0: bool = False):
    """One case and the reference's ``_mesh_append_step`` outputs on it
    (buffer, counts, dirty bits, flags)."""
    n_dev = 8
    case = _case(kind, n_dev, seed=n_shards)
    if lane0:
        _lane0_rows(case[3], case[4], seed=n_shards)
    want = [np.asarray(x) for x in jp._mesh_append_step(
        *(jnp.asarray(x) for x in case), mesh=_mesh(n_dev), kk=KK,
        n_shards=n_shards)]
    return case, want


@pytest.mark.parametrize("n_shards", (8, 3))
@pytest.mark.parametrize("kind", ("fits", "overflow_one_shard",
                                  "sticky_dirty"))
def test_mesh_append_matches_reference(kind, n_shards):
    n_dev = 8
    (buf, n, dirty, rows, scal), want = _ref_mesh_append(kind, n_shards)
    tbuf = to_tensor(buf)
    got = tp.mesh_postings_append(tbuf, to_tensor(n), to_tensor(dirty),
                                  to_tensor(rows), to_tensor(scal), kk=KK,
                                  n_shards=n_shards)
    np.testing.assert_array_equal(to_numpy(tbuf, np.uint32), want[0])
    for g, w in zip(got, want[1:]):
        np.testing.assert_array_equal(to_numpy(g), w)
    flags = want[3]
    assert bool(flags[:, 0].any()) == (kind != "fits")
    if kind != "fits":  # a no-op keeps the old buffer byte for byte
        np.testing.assert_array_equal(to_numpy(tbuf, np.uint32), buf)
        return
    # Every appended row sits on the shard its word hashes to, each
    # source shard's rows in order; shards past n_shards receive none.
    out = to_numpy(tbuf, np.uint32)
    sent = sum(int(scal[d, 0]) for d in range(n_dev))
    assert int((flags[:, 1] - n).sum()) == sent
    for d in range(n_dev):
        new = out[d, n[d]:flags[d, 1]]
        if d >= n_shards:
            assert len(new) == 0
        for row in new:
            word = row[:KK].astype(">u4").tobytes()[:int(row[KK])]
            assert host_shard_of(word, n_shards) == d
        want_rows = [rows[s, j] for s in range(n_dev)
                     for j in range(int(scal[s, 0]))
                     if host_shard_of(rows[s, j, :KK].astype(">u4")
                                      .tobytes()[:int(rows[s, j, KK])],
                                      n_shards) == d]
        np.testing.assert_array_equal(new.reshape(-1, W),
                                      np.array(want_rows,
                                               np.uint32).reshape(-1, W))


def _lane0_rows(rows, scal, seed: int) -> None:
    """Sets lane 0 of about one valid row in six to all ones (lane 1 a
    letter): rows E routes as valid that ``compact_received`` drops."""
    rng = np.random.default_rng(seed + 100)
    valid = np.arange(rows.shape[1])[None, :] < scal[:, :1]
    sel = valid & (rng.random(valid.shape) < 0.15)
    rows[sel, 0] = 0xFFFFFFFF
    rows[sel, 1] = 0x61626364
    rows[sel, KK] = np.maximum(rows[sel, KK], 5)


@pytest.mark.parametrize("n_shards", (8, 3))
def test_mesh_append_drops_lane0_rows_as_reference(n_shards):
    # An E-routed valid row whose lane 0 alone is all ones is a pad row to
    # compact_received: the reference drops it, and so does the port.
    (buf, n, dirty, rows, scal), want = _ref_mesh_append("fits", n_shards,
                                                         lane0=True)
    tbuf = to_tensor(buf)
    got = tp.mesh_postings_append(tbuf, to_tensor(n), to_tensor(dirty),
                                  to_tensor(rows), to_tensor(scal), kk=KK,
                                  n_shards=n_shards)
    np.testing.assert_array_equal(to_numpy(tbuf, np.uint32), want[0])
    for g, w in zip(got, want[1:]):
        np.testing.assert_array_equal(to_numpy(g), w)
    sent = int(scal[:, 0].sum())
    dropped = sent - int((want[3][:, 1] - n).sum())
    valid = np.arange(rows.shape[1])[None, :] < scal[:, :1]
    assert dropped == int((valid & (rows[..., 0] == 0xFFFFFFFF)).sum()) > 0


@functools.lru_cache(maxsize=None)
def _ref_exchange(n_dev: int, r: int, w: int):
    """The reference's ``exchange_rows`` under ``shard_map``."""
    def body(rows, dest):
        return jmr.exchange_rows(rows.reshape(r, w), dest.reshape(r),
                                 n_dev=n_dev, kk=KK)[None]

    return jax.jit(shard_map(
        body, mesh=_mesh(n_dev),
        in_specs=(P(js.AXIS, None, None), P(js.AXIS, None)),
        out_specs=P(js.AXIS, None, None)))


@pytest.mark.parametrize("dests", ("routed", "parked_and_skewed"))
def test_exchange_totals_match_destination_counts(dests):
    n_dev, r = 8, 40
    rng = np.random.default_rng(7)
    rows, scal = _wave_rows(rng, n_dev, r)
    if dests == "routed":
        valid = np.arange(r)[None, :] < scal[:, :1]
        dest = np.where(valid, [[host_shard_of(
            rows[s, j, :KK].astype(">u4").tobytes()[:int(rows[s, j, KK])],
            n_dev) for j in range(r)] for s in range(n_dev)], n_dev)
    else:  # every row of source 0 to shard 5; parked rows elsewhere
        dest = rng.integers(0, n_dev + 1, (n_dev, r))
        dest[0] = 5
    dest = dest.astype(np.int32)
    recv, totals = tmr.exchange_rows(to_tensor(rows), to_tensor(dest),
                                     n_dev=n_dev, kk=KK, totals=True)
    want = np.asarray(_ref_exchange(n_dev, r, W)(jnp.asarray(rows),
                                                 jnp.asarray(dest)))
    np.testing.assert_array_equal(to_numpy(recv, np.uint32), want)
    counts = np.stack([np.bincount(dest[s], minlength=n_dev + 1)[:n_dev]
                       for s in range(n_dev)])
    np.testing.assert_array_equal(to_numpy(totals), counts)
    for s in range(n_dev):  # each pair's block: its rows, then pad rows
        for d in range(n_dev):
            block = want[d, s * r:(s + 1) * r]
            np.testing.assert_array_equal(block[:counts[s, d]],
                                          rows[s][dest[s] == d])
            assert (block[counts[s, d]:, :KK] == 0xFFFFFFFF).all()


# ── kernel M's received entry as a numpy model ───────────────────────────


def _received_chunks(n_dev: int) -> int:
    """``csrc/postings_append.cu received_chunks``: 512 blocks at least."""
    return 1 if n_dev * n_dev >= 512 else -(-512 // (n_dev * n_dev))


def _received_tile(w: int) -> int:
    """``received_tile``: 32 rows at least, else 16 KB and 1,024 rows."""
    t = 32
    while 2 * t <= 1024 and 2 * t * w <= 4096:
        t *= 2
    return t


def received_model(buf, n, dirty, recv, totals, chunks: int, tile: int):
    """Kernel M's received entry as ``csrc/postings_append.cu`` computes
    it.  Blocks (chunk b of pair p = d * n_dev + s) cut pair (s, d)'s
    routed rows ``recv[d, s*r : s*r + totals[s, d]]`` into chunks of a
    multiple of 32 rows; ``postings_append_count`` keeps one ballot of
    lane-0 tests a warp per 32 rows as a mask word and the chunk's count;
    ``postings_append_write`` sums every destination's counts (the
    overflow) and those before its own chunk (its first rank), and writes
    the chunk's kept rows tile by tile at ``n[d]`` plus their rank.
    Returns (buf, n_out, dirty_out, flags)."""
    buf = buf.copy()
    n_dev, cap, w = buf.shape
    r = recv.shape[1] // n_dev
    lanes = np.arange(32, dtype=np.uint64)
    masks = np.zeros((n_dev * n_dev, -(-r // 32)), np.uint32)
    counts = np.zeros(n_dev * n_dev * chunks, np.int64)

    def chunk(s, d, b):
        h = min(max(int(totals[s, d]), 0), r)
        cs = (-(-h // chunks) + 31) & ~31
        return b * cs, min(b * cs + cs, h)

    for p in range(n_dev * n_dev):
        d, s = divmod(p, n_dev)
        keep = recv[d, s * r:(s + 1) * r, 0] != 0xFFFFFFFF
        for b in range(chunks):
            lo, hi = chunk(s, d, b)
            if lo >= hi:
                continue
            bits = np.zeros(-(-(hi - lo) // 32) * 32, bool)
            bits[:hi - lo] = keep[lo:hi]
            masks[p, lo // 32:lo // 32 + len(bits) // 32] = (
                bits.reshape(-1, 32).astype(np.uint64) << lanes).sum(1)
            counts[p * chunks + b] = int(bits.sum())
    seg = n_dev * chunks
    tot = counts.reshape(n_dev, seg).sum(1)
    ov = int((n.astype(np.int64) + tot > cap).any())
    no_op = np.maximum(ov, dirty).astype(np.int32)
    n_out = np.where(no_op > 0, n, n + tot).astype(np.int32)
    for p in range(n_dev * n_dev):
        d, s = divmod(p, n_dev)
        if no_op[d]:
            continue
        for b in range(chunks):
            at = n[d] + int(counts[d * seg:p * chunks + b].sum())
            lo, hi = chunk(s, d, b)
            for a in range(lo, hi, tile):
                i = np.arange(a, min(hi, a + tile))
                kept = (masks[p, i >> 5].astype(np.int64) >> (i & 31)) & 1
                rows = recv[d, s * r + i[kept == 1]]
                buf[d, at:at + len(rows)] = rows
                at += len(rows)
    return buf, n_out, no_op, np.stack([no_op, n_out], 1)


@pytest.mark.parametrize("lane0", (False, True))
@pytest.mark.parametrize("kind", ("fits", "overflow_one_shard",
                                  "sticky_dirty"))
def test_received_model_matches_reference(kind, lane0):
    n_dev, n_shards = 8, 3
    (buf, n, dirty, rows, scal), want = _ref_mesh_append(kind, n_shards,
                                                         lane0=lane0)
    valid = np.arange(rows.shape[1])[None, :] < scal[:, :1]
    dest = np.where(valid, [[host_shard_of(
        rows[s, j, :KK].astype(">u4").tobytes()[:int(rows[s, j, KK])],
        n_shards) for j in range(rows.shape[1])] for s in range(n_dev)],
        n_dev).astype(np.int32)
    recv, totals = tmr.exchange_rows(to_tensor(rows), to_tensor(dest),
                                     n_dev=n_dev, kk=KK, totals=True)
    recv, totals = to_numpy(recv, np.uint32), to_numpy(totals)
    # The kernel's chunks and tiles, then small ones: several chunks a
    # pair's rows (3, 32), several tiles a chunk (1, 32).
    for chunks, tile in ((_received_chunks(n_dev), _received_tile(W)),
                         (3, 32), (1, 32)):
        got = received_model(buf, n, dirty, recv, totals, chunks, tile)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _waves(n_dev: int, seed: int):
    """Waves of growing size: later ones overflow a 64-row buffer, and
    one re-routes more rows onto a shard than 4x the buffer holds."""
    rng = np.random.default_rng(seed)
    return [_wave_rows(rng, n_dev, r) for r in (8, 16, 24, 40, 300, 12)]


@pytest.mark.parametrize("lag", (0, 2))
def test_device_postings_mesh_matches_reference(lag):
    n_dev = 8
    waves = _waves(n_dev, seed=lag)
    mesh = _mesh(n_dev)
    sh3 = NamedSharding(mesh, P(js.AXIS, None, None))
    sh2 = NamedSharding(mesh, P(js.AXIS, None))
    want_rows, got_rows = [], []
    want_st, got_st = {}, {}
    ref = jp.DevicePostings(mesh, width=W, cap=64,
                            sink=lambda r: want_rows.append(np.array(r)),
                            lag=lag, stats=want_st, mesh_shards=n_dev,
                            kk=KK)
    port = tp.DevicePostings(n_dev, width=W, cap=64,
                             sink=lambda r: got_rows.append(np.array(r)),
                             device="cpu", lag=lag, stats=got_st,
                             mesh_shards=n_dev, kk=KK)
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
    # The widen bound is n_dev x the wave's rows under mesh_shards.
    assert port.cap == ref.cap >= 300


def test_mesh_shards_bound_and_default_kk():
    with pytest.raises(ValueError, match="mesh_shards"):
        tp.DevicePostings(2, width=W, cap=8, sink=lambda r: None,
                          device="cpu", mesh_shards=3)
    port = tp.DevicePostings(4, width=20, cap=8, sink=lambda r: None,
                             device="cpu", mesh_shards=4)
    assert port.kk == 16 and port.mesh_shards == 4


# ── tfidf_sharded(mesh_shards=) ──────────────────────────────────────────


def _docs(n_docs: int, seed: int, vocab: int = 300, words: int = 200):
    """``tests/test_torch_tfidf.py``'s documents."""
    rng = np.random.default_rng(seed)
    seps = (" ", ", ", "\n", " 12 ")
    out = []
    for _ in range(n_docs):
        n = int(rng.integers(words // 2, words + 1))
        ws = rng.integers(0, vocab, n)
        out.append("".join(VOCAB[j] + seps[j % 4] for j in ws).encode())
    return out


DOCS = _docs(11, seed=17)
_COUNTERS = ("waves", "replays", "step_pulls", "appends",
             "append_overflows", "sync_pulls", "postings_widens",
             "pull_bytes", "max_inflight_waves", "mesh_shards",
             "device_accumulate")


@pytest.fixture(scope="module")
def base():
    """The reference's depth-1 host-merge TF-IDF, the parity anchor."""
    res = jtf.tfidf_sharded(DOCS, mesh=_mesh(8), n_reduce=10, u_cap=1 << 9,
                            depth=1)
    assert res is not None
    return res


def _both(docs, **kw):
    jst, tst = {}, {}
    want = jtf.tfidf_sharded(docs, mesh=_mesh(8), wave_stats=jst, **kw)
    got = ttf.tfidf_sharded(docs, n_dev=8, wave_stats=tst, device="cpu",
                            **kw)
    return want, jst, got, tst


def _same_counters(jst, tst):
    for key in _COUNTERS:
        if key in jst:
            assert tst[key] == jst[key], key


@pytest.mark.parametrize("mesh_shards", (8, 3))
def test_tfidf_mesh_shards_match_reference(base, mesh_shards):
    want, jst, got, tst = _both(DOCS, n_reduce=10, u_cap=1 << 9, depth=2,
                                sync_every=2, mesh_shards=mesh_shards)
    # dict equality holds each word's (doc, tf) list in order
    assert got == want == base
    _same_counters(jst, tst)
    assert tst["mesh_shards"] == mesh_shards
    assert tst["device_accumulate"] and tst["appends"] >= 1
    assert tst["step_pulls"] == 0


def test_tfidf_mesh_shards_from_environment(base, monkeypatch):
    monkeypatch.setenv("DSI_STREAM_MESH_SHARDS", "1")
    st: dict = {}
    got = ttf.tfidf_sharded(DOCS, n_dev=8, n_reduce=10, u_cap=1 << 9,
                            depth=2, wave_stats=st, device="cpu")
    assert got == base
    assert st["mesh_shards"] == 1 and st["appends"] >= 1


def test_tfidf_mesh_recovery_and_widen_match_reference(base, monkeypatch):
    # A forced-tiny buffer under the mesh route: appends no-op
    # mid-window, recovery drains and re-appends, and a wave whose rows
    # all land past the buffer widens it to n_dev x its rows.
    monkeypatch.setenv("DSI_DEVICE_POSTINGS_CAP", "64")
    want, jst, got, tst = _both(DOCS, n_reduce=10, u_cap=1 << 9, depth=3,
                                mesh_shards=8, sync_every=10_000)
    assert got == want == base
    assert tst["append_overflows"] >= 1 and tst["postings_widens"] >= 1
    _same_counters(jst, tst)


def test_tfidf_mesh_packed_matches_reference():
    want = jtf.tfidf_sharded(DOCS, mesh=_mesh(8), n_reduce=10, u_cap=1 << 9,
                             packed=True, mesh_shards=8)
    got = ttf.tfidf_sharded(DOCS, n_dev=8, n_reduce=10, u_cap=1 << 9,
                            packed=True, mesh_shards=8, device="cpu")
    for name in ("skeys", "lens", "parts", "starts", "ends", "tfs", "docs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
