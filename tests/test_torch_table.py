"""The port's device table (K10 fold, widen, sync) against the JAX
package, on the CPU.

Steps come from the reference's ``mapreduce_step`` on the 8-device (or a
1-device) virtual CPU mesh, packed as the streaming engine packs them;
the same numpy arrays go into ``dsi_tpu.device.table`` and
``dsi_tpu_torch.device.table`` (plain versions: the tensors lie on the
CPU).  Every output is an integer: equal bit for bit, shard for shard.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from dsi_tpu.device import table as jt
from dsi_tpu.device.policy import SyncPolicy as JSyncPolicy
from dsi_tpu.parallel import merge as jm
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch.device import table as tt
from dsi_tpu_torch.device.policy import SyncPolicy, sync_every_default
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.parallel import merge as tm


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(800)]


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


def _step(n_dev: int, words, mwl: int = 16, u_cap: int = 64):
    """One reference step over identical per-shard chunks, packed at full
    capacity: (packed uint32, scal int32) numpy."""
    text = (" ".join(words) + " ").encode()[:512]
    chunks = np.zeros((n_dev, 512), np.uint8)
    chunks[:, :len(text)] = np.frombuffer(text, np.uint8)
    keys, lens, cnts, parts, scal = js.mapreduce_step(
        jnp.asarray(chunks), n_dev=n_dev, n_reduce=10, max_word_len=mwl,
        u_cap=u_cap, mesh=_mesh(n_dev), t_cap_frac=4, grouper="sort")
    packed = js._slice_pack(keys, lens, cnts, parts, mp=keys.shape[1])
    return np.asarray(packed), np.asarray(scal)


def _empty(n_dev: int, cap: int, kk: int = 4):
    return (np.full((n_dev, cap, kk), 0xFFFFFFFF, np.uint32),
            np.zeros((n_dev, cap), np.int32),
            np.zeros((n_dev, cap), np.uint64),
            np.zeros((n_dev, cap), np.int32),
            np.zeros(n_dev, np.int32))


def _ref_fold(n_dev, state, packed, scal):
    with jt._quiet_unusable_donation():
        out = jt.fold_step(*state, packed, scal, mesh=_mesh(n_dev))
    return [np.asarray(x) for x in out]


def _port_fold(state, packed, scal):
    out = tt.fold_step(*(to_tensor(a) for a in state), to_tensor(packed),
                       to_tensor(scal))
    return [to_numpy(x) for x in out]


def _assert_same(got, want):
    names = ("keys", "lens", "counts", "parts", "n", "flags")
    for what, g, w in zip(names, got, want):
        assert g.shape == w.shape, what
        np.testing.assert_array_equal(g.view(w.dtype), w, err_msg=what)


@pytest.mark.parametrize("n_dev", (1, 8))
def test_fold_step_matches_reference(n_dev):
    a = _step(n_dev, VOCAB[0:60])
    b = _step(n_dev, VOCAB[30:90])
    state = _empty(n_dev, 4 * tt._pow2(a[0].shape[1]))
    for packed, scal in (a, b):
        want = _ref_fold(n_dev, state, packed, scal)
        got = _port_fold(state, packed, scal)
        _assert_same(got, want)
        assert not want[5][:, 0].any()
        state = tuple(want[:5])
    assert state[4].sum() > 0


@pytest.mark.parametrize("n_dev", (1, 8))
def test_fold_overflow_keeps_every_shard(n_dev):
    """A fold whose merged uniques overflow one shard's capacity is a
    no-op on EVERY shard, and the flags say so on every shard."""
    a = _step(n_dev, VOCAB[0:12])
    b = _step(n_dev, VOCAB[100:160])
    state = _empty(n_dev, 16)
    want = _ref_fold(n_dev, state, *a)
    _assert_same(_port_fold(state, *a), want)
    state = tuple(want[:5])
    want = _ref_fold(n_dev, state, *b)
    _assert_same(_port_fold(state, *b), want)
    assert want[5][:, 0].all()
    for new, old in zip(want[:5], state):
        np.testing.assert_array_equal(new, old)


def test_grow_table_matches_reference():
    n_dev = 8
    a = _step(n_dev, VOCAB[0:40])
    state = tuple(_ref_fold(n_dev, _empty(n_dev, 512), *a)[:5])
    keep = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
    with jt._quiet_unusable_donation():
        want = [np.asarray(x) for x in jt.grow_table(
            *state, keep, mesh=_mesh(n_dev), new_cap=2048)]
    got = tt.grow_table(*(to_tensor(s) for s in state),
                        to_tensor(keep > 0), new_cap=2048)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g).view(w.dtype), w)


# ── DeviceTable: the service around the fold ─────────────────────────────


def _run_tables(n_dev, steps, *, cap, lag, sync_at=(), kk=4):
    """Drive the reference's and the port's DeviceTable over the same
    steps; return (reference dict, stats), (port dict, stats)."""
    out = []
    for mod, merge in ((jt, jm), (tt, tm)):
        stats: dict = {}
        acc = merge.PackedCounts()
        if mod is jt:
            tab = jt.DeviceTable(_mesh(n_dev), kk=kk, cap=cap, acc=acc,
                                 lag=lag, stats=stats)
        else:
            tab = tt.DeviceTable(n_dev, kk=kk, cap=cap, acc=acc,
                                 device="cpu", lag=lag, stats=stats)
        for i, (packed, scal) in enumerate(steps):
            if mod is jt:
                pd, sd = jnp.asarray(packed), jnp.asarray(scal)
            else:
                pd, sd = to_tensor(packed), to_tensor(scal)
            with jt._quiet_unusable_donation():
                tab.fold(pd, sd, scal)
                if i in sync_at:
                    tab.sync()
        with jt._quiet_unusable_donation():
            tab.close()
        out.append((acc.finalize(), stats))
    return out


_COUNTERS = ("folds", "fold_overflows", "sync_pulls", "widens", "table_cap")


@pytest.mark.parametrize("n_dev", (1, 8))
def test_device_table_widen_never_drops_keys(n_dev):
    """A rung-0 capacity far below the vocabulary: folds overflow, the
    table drains, widens and re-folds, and no key is lost."""
    steps = [_step(n_dev, VOCAB[o:o + 20]) for o in (0, 20, 40)]
    (want, wst), (got, gst) = _run_tables(n_dev, steps, cap=2, lag=2)
    assert got == want and len(got) == 60
    assert {k: gst[k] for k in _COUNTERS} == {k: wst[k] for k in _COUNTERS}
    assert gst["widens"] >= 1 and gst["fold_overflows"] >= 1


@pytest.mark.parametrize("n_dev", (1, 8))
def test_device_table_fold_and_sync_match_reference(n_dev):
    steps = [_step(n_dev, VOCAB[o:o + 20]) for o in (0, 10, 40, 45)]
    rows = steps[0][0].shape[1]
    (want, wst), (got, gst) = _run_tables(n_dev, steps, cap=rows, lag=1,
                                          sync_at=(1,))
    assert got == want
    assert {k: gst[k] for k in _COUNTERS} == {k: wst[k] for k in _COUNTERS}
    assert gst["sync_pulls"] == 2 and gst["widens"] == 0


def test_device_table_rekeys_on_a_wider_word_window():
    """A step at the 64-byte window after 16-byte steps re-keys the
    table (drain + reallocate at the new width), as the reference does."""
    n_dev = 8
    long_words = ["abcdefghijklmnopqrst" + w for w in VOCAB[:10]]
    steps = [_step(n_dev, VOCAB[:30]),
             _step(n_dev, long_words + VOCAB[:10], mwl=64)]
    (want, wst), (got, gst) = _run_tables(n_dev, steps, cap=512, lag=1)
    assert got == want
    assert {k: gst[k] for k in _COUNTERS} == {k: wst[k] for k in _COUNTERS}
    assert gst["widens"] == 1


def test_sync_policy_matches_reference(monkeypatch):
    for k in (1, 3):
        mine, ref = SyncPolicy(k), JSyncPolicy(k)
        for _ in range(7):
            mine.note_fold()
            ref.note_fold()
            assert mine.due() == ref.due()
            if mine.due():
                mine.reset()
                ref.reset()
    monkeypatch.setenv("DSI_STREAM_SYNC_EVERY", "5")
    assert sync_every_default() == 5
    assert sync_every_default(2) == 2
    monkeypatch.setenv("DSI_STREAM_SYNC_EVERY", "junk")
    assert sync_every_default() == 8
    assert sync_every_default(0) == 1


def test_packed_counts_matches_reference():
    rng = np.random.default_rng(5)
    mine, ref = tm.PackedCounts(compact_rows=50), jm.PackedCounts(
        compact_rows=50)
    for width in (4, 16, 4):
        n = 40
        keys = np.zeros((n, width), np.uint32)
        words = [VOCAB[i] for i in rng.integers(0, 60, n)]
        for r, w in enumerate(words):
            keys[r, 0] = int.from_bytes(w.encode().ljust(4, b"\0"), "big")
        lens = np.array([len(w) for w in words], np.uint32)
        cnts = rng.integers(1, 9, n).astype(np.uint32)
        parts = np.array([VOCAB.index(w) % 10 for w in words], np.uint32)
        for acc in (mine, ref):
            acc.add(keys, lens, cnts, parts)
    assert mine.finalize() == ref.finalize()
