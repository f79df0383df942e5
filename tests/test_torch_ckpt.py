"""The port's checkpoint core (``dsi_tpu_torch/ckpt``, ``obs``, the rest of
``utils/atomicio``, ``CommitWorker``) and the device table's images,
against the JAX package, on the CPU.

The host-only half runs the cases of ``tests/test_checkpoint.py``
(cadence and env, store round trip, chain-aware GC, torn chains and
manifests, ``skip_stream``, fault counts, one commit in flight) on the
port's copies, and each store reads the chains the other wrote.  The
device half drives the same folds (the reference's ``mapreduce_step``
outputs, as ``tests/test_torch_table.py`` makes them) through the
reference's ``DeviceTable`` on the 8-device virtual CPU mesh and the
port's with 8 virtual shards: the images and delta entries must be equal
bit for bit (keys uint32 with pad ``0xFFFFFFFF``, counts uint64), also
when the port's live table is cleared and folded again between the
capture and its materialization.
"""

from __future__ import annotations

import functools
import os
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from dsi_tpu import ckpt as jck
from dsi_tpu import obs as jobs
from dsi_tpu.device import table as jt
from dsi_tpu.device.policy import SyncPolicy as JSyncPolicy
from dsi_tpu.parallel import merge as jm
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch import obs
from dsi_tpu_torch.ckpt import (
    FAULT_POINTS,
    CheckpointMismatch,
    CheckpointPolicy,
    CheckpointStore,
    DeltaSteps,
    FaultInjected,
    HostDeltaLog,
    checkpoint_every_default,
    drain_packed_steps,
    fault_point,
    reset_faults,
    skip_stream,
)
from dsi_tpu_torch.device import table as tt
from dsi_tpu_torch.device.policy import SyncPolicy
from dsi_tpu_torch.interop import to_tensor
from dsi_tpu_torch.parallel import merge as tm
from dsi_tpu_torch.parallel.pipeline import CommitWorker
from dsi_tpu_torch.utils.atomicio import (
    read_bytes_verified,
    reap_tmp_files,
    write_bytes_durable,
)

# ── cadence, store, atomicio, faults, the commit worker ────────────────


def test_policy_cadence_env_and_names_match_reference(monkeypatch):
    mine, ref = CheckpointPolicy(3), jck.CheckpointPolicy(3)
    for _ in range(7):
        mine.note_step()
        ref.note_step()
        assert mine.due() == ref.due()
        if mine.due():
            mine.reset()
            ref.reset()
    monkeypatch.setenv("DSI_STREAM_CKPT_EVERY", "7")
    assert checkpoint_every_default() == 7 == jck.checkpoint_every_default()
    assert checkpoint_every_default(2) == 2
    monkeypatch.setenv("DSI_STREAM_CKPT_EVERY", "junk")
    assert checkpoint_every_default() == 32
    for name in ("async", "delta", "rebase", "compress"):
        fn = f"checkpoint_{name}_default"
        for val in ("1", "off", "all", "3"):
            monkeypatch.setenv(f"DSI_STREAM_CKPT_{name.upper()}", val)
            assert getattr(jck, fn)() == getattr(
                __import__("dsi_tpu_torch.ckpt", fromlist=[fn]), fn)()
    assert FAULT_POINTS == jck.FAULT_POINTS
    assert jck.CKPT_VERSION == __import__(
        "dsi_tpu_torch.ckpt", fromlist=["CKPT_VERSION"]).CKPT_VERSION


def test_policy_time_trigger():
    p = CheckpointPolicy(1000, secs=0.01)
    p.note_step()
    time.sleep(0.02)
    assert p.due()
    p.reset()
    assert not p.due()  # no step since the reset: time alone never fires


def test_store_roundtrip_gc_and_fallback(tmp_path):
    st = CheckpointStore(str(tmp_path), "wc", {"n_dev": 4})
    for i in range(3):
        st.save({"a": np.arange(i + 1)}, {"cursor": 10 * i})
    names = sorted(os.listdir(str(tmp_path)))
    assert "manifest-000001.json" not in names
    assert "manifest-000002.json" in names and "manifest-000003.json" in names
    meta, arrays = st.load_latest()
    assert meta["cursor"] == 20 and np.array_equal(arrays["a"], np.arange(3))
    with open(str(tmp_path / "state-000003.npz"), "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    meta, arrays = st.load_latest()
    assert meta["cursor"] == 10 and np.array_equal(arrays["a"], np.arange(2))


def test_store_chain_gc_protects_live_base(tmp_path):
    st = CheckpointStore(str(tmp_path), "wc", {})
    st.save({"a": np.arange(3)}, {"cursor": 0})
    for i in range(3):
        st.save_delta({"d": np.arange(i + 1)}, {"cursor": 10 * (i + 1)})
    assert "state-000001.npz" in os.listdir(str(tmp_path))
    meta, _, deltas = st.load_latest_chain()
    assert meta["cursor"] == 0
    assert [m["cursor"] for m, _ in deltas] == [10, 20, 30]
    st.save({"a": np.arange(9)}, {"cursor": 99})
    st.save({"a": np.arange(9)}, {"cursor": 100})
    names = os.listdir(str(tmp_path))
    assert "state-000001.npz" not in names
    assert not any(n.startswith("delta-") for n in names)


def test_store_torn_chain_and_unreadable_link(tmp_path):
    """A torn middle delta falls back to the last complete chain; GC keeps
    everything at or below a missing manifest."""
    st = CheckpointStore(str(tmp_path / "a"), "wc", {})
    st.save({"a": np.arange(2)}, {"cursor": 0})
    for c in (10, 20, 30):
        st.save_delta({"d": np.arange(c // 10)}, {"cursor": c})
    p = str(tmp_path / "a" / "delta-000003.npz")
    with open(p, "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 0xFF]))
    _, _, deltas = st.load_latest_chain()
    assert len(deltas) == 1 and deltas[0][0]["cursor"] == 10
    os.remove(str(tmp_path / "a" / "delta-000002.npz"))
    meta, _, deltas = st.load_latest_chain()
    assert deltas == [] and meta["cursor"] == 0
    assert st.load_latest()[0]["cursor"] == 0

    st = CheckpointStore(str(tmp_path / "b"), "wc", {})
    st.save({"a": np.arange(2)}, {"cursor": 0})
    for c in (10, 20, 30):
        st.save_delta({"d": np.arange(c // 10)}, {"cursor": c})
    os.remove(str(tmp_path / "b" / "manifest-000003.json"))
    for c in (40, 50):
        st.save_delta({"d": np.arange(c // 10)}, {"cursor": c})
    names = os.listdir(str(tmp_path / "b"))
    assert "state-000001.npz" in names and "delta-000002.npz" in names
    meta, _, deltas = st.load_latest_chain()
    assert meta["cursor"] == 0 and [m["cursor"] for m, _ in deltas] == [10]


def test_store_refusals_reset_and_torn_manifest(tmp_path):
    st = CheckpointStore(str(tmp_path / "a"), "wc", {"chunk": 1024})
    with pytest.raises(RuntimeError):
        st.save_delta({"d": np.arange(1)}, {"cursor": 1})
    st.save({"a": np.zeros(1)}, {"cursor": 1})
    other = CheckpointStore(str(tmp_path / "a"), "wc", {"chunk": 2048})
    with pytest.raises(CheckpointMismatch):
        other.load_latest()
    other.reset()
    assert st.load_latest() is None

    st = CheckpointStore(str(tmp_path / "b"), "wc", {})
    st.save({"a": np.ones(2)}, {"cursor": 5})
    st.save({"a": np.ones(3)}, {"cursor": 9})
    with open(str(tmp_path / "b" / "manifest-000002.json"), "ab") as f:
        f.write(b" ")
    assert st.load_latest()[0]["cursor"] == 5


def test_host_delta_log_trims_copies_and_bounds():
    log, ref = HostDeltaLog(max_steps=2), jck.HostDeltaLog(max_steps=2)
    big = np.arange(2 * 100 * 5, dtype=np.uint32).reshape(2, 100, 5)
    for lg in (log, ref):
        lg.append(big, np.array([3, 7]))
    (rows, nus), = log.take()
    assert rows.shape == (2, 7, 5) and rows.base is None
    np.testing.assert_array_equal(rows, ref.take()[0][0])
    assert log.take() == []
    for _ in range(3):
        log.append(big, np.array([1, 1]))
    assert log.take() is None
    log.append(big, np.array([2, 2]))
    assert len(log.take()) == 1
    log.append(big, np.array([1, 1]))
    log.reset()
    assert log.take() == []


def test_skip_stream_matches_reference():
    blocks = [b"abc", b"", b"defg", b"hi"]
    for skip in (0, 1, 3, 4, 9, 50):
        assert (b"".join(skip_stream(blocks, skip))
                == b"".join(jck.skip_stream(blocks, skip)))
    assert b"".join(skip_stream(blocks, 4)) == b"efghi"


def test_atomicio_durable_write_verify_and_reap(tmp_path):
    p = str(tmp_path / "blob")
    crc = write_bytes_durable(p, b"hello world")
    assert crc == zlib.crc32(b"hello world")
    assert read_bytes_verified(p) == b"hello world"
    with open(p, "ab") as f:
        f.write(b"!")
    assert read_bytes_verified(p) is None
    assert read_bytes_verified(str(tmp_path / "absent")) is None
    open(str(tmp_path / ".tmp-orphan.x"), "w").close()
    assert reap_tmp_files(str(tmp_path)) == 1


def test_fault_point_counts_per_point(monkeypatch):
    reset_faults()
    monkeypatch.setenv("DSI_FAULT_MODE", "raise")
    monkeypatch.setenv("DSI_FAULT_POINT", "mid-fold")
    monkeypatch.setenv("DSI_FAULT_STEP", "2")
    fault_point("post-dispatch")  # other points never use the budget
    fault_point("mid-fold")
    fault_point("post-dispatch")
    with pytest.raises(FaultInjected):
        fault_point("mid-fold")
    reset_faults()


def test_commit_worker_single_in_flight_and_errors():
    """With one slot a second submit blocks while the first thunk is
    still running; a thunk's error re-raises at the next drain."""
    w = CommitWorker(name="t-cw")
    release, running = threading.Event(), threading.Event()

    def slow():
        running.set()
        release.wait(5.0)

    assert w.submit(slow) == 0.0
    running.wait(5.0)
    threading.Timer(0.15, release.set).start()
    done = []
    assert w.submit(lambda: done.append(1)) >= 0.1
    assert w.drain() >= 0.0 and done == [1]

    def boom():
        raise ValueError("commit failed")

    w.submit(boom)
    with pytest.raises(ValueError, match="commit failed"):
        w.drain()
    w.shutdown()


def test_obs_copy_matches_reference():
    """The copied schema and span names are the reference's, and a span
    with a stats sink adds its seconds under the reference's key."""
    assert obs.SCHEMA_KEYS == jobs.SCHEMA_KEYS
    assert obs.SPAN_NAMES == jobs.SPAN_NAMES
    stats: dict = {}
    with obs.span("ckpt_capture", lane="ckpt", stats=stats,
                  key="ckpt_capture_s"):
        time.sleep(0.001)
    assert stats["ckpt_capture_s"] > 0.0
    h, jh = obs.LatencyHistogram(), jobs.LatencyHistogram()
    for x in np.random.default_rng(3).exponential(0.01, 200):
        h.record(float(x))
        jh.record(float(x))
    assert h.percentile(0.99) == jh.percentile(0.99)


@pytest.mark.parametrize("writer,compress", [("ref", "deltas"),
                                             ("port", "all")])
def test_stores_read_each_others_chains(tmp_path, writer, compress):
    rng = np.random.default_rng(11)
    job = {"n_dev": 4, "n_reduce": 10, "chunk_bytes": 1024,
           "device_accumulate": True}
    pkg, other = ((jck, __import__("dsi_tpu_torch.ckpt",
                                   fromlist=["x"])) if writer == "ref"
                  else (__import__("dsi_tpu_torch.ckpt", fromlist=["x"]),
                        jck))
    w = pkg.CheckpointStore(str(tmp_path), "wordcount", job,
                            compress=compress)
    base = {"table_keys": rng.integers(0, 2 ** 32, (4, 8, 2),
                                       dtype=np.uint32),
            "table_cnts": rng.integers(0, 2 ** 63, (4, 8)).astype(
                np.uint64),
            "acc_lens": rng.integers(0, 9, 5).astype(np.int32)}
    deltas = [{"d000_rows": rng.integers(0, 2 ** 32, (4, 3, 5),
                                         dtype=np.uint32),
               "d000_nus": np.array([1, 2, 3, 0])} for _ in range(2)]
    w.save(base, {"cursor": 0, "table_cap": 8})
    for i, d in enumerate(deltas):
        w.save_delta(d, {"cursor": 100 * (i + 1)})
    r = other.CheckpointStore(str(tmp_path), "wordcount", job)
    meta, arrays, got = r.load_latest_chain()
    assert meta == {"cursor": 0, "table_cap": 8}
    for k, v in base.items():
        assert arrays[k].dtype == v.dtype
        np.testing.assert_array_equal(arrays[k], v)
    assert [m["cursor"] for m, _ in got] == [100, 200]
    for (_, a), d in zip(got, deltas):
        for k, v in d.items():
            np.testing.assert_array_equal(a[k], v)


# ── the device table's images ──────────────────────────────────────────


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(800)]
N = 8


@functools.lru_cache(maxsize=None)
def _mesh():
    return js.default_mesh(N)


@functools.lru_cache(maxsize=None)
def _step(lo: int, hi: int):
    """One reference step over per-shard chunks of different words,
    packed at full capacity: (packed uint32, scal int32) numpy."""
    chunks = np.zeros((N, 512), np.uint8)
    for d in range(N):
        text = (" ".join(VOCAB[lo + 3 * d:hi + 3 * d]) + " ").encode()[:512]
        chunks[d, :len(text)] = np.frombuffer(text, np.uint8)
    keys, lens, cnts, parts, scal = js.mapreduce_step(
        jnp.asarray(chunks), n_dev=N, n_reduce=10, max_word_len=16,
        u_cap=64, mesh=_mesh(), t_cap_frac=4, grouper="sort")
    packed = js._slice_pack(keys, lens, cnts, parts, mp=keys.shape[1])
    return np.asarray(packed), np.asarray(scal)


STEPS = ((0, 20), (10, 30), (40, 60), (45, 65))


def _tables(mesh_shards: int):
    """(reference table, its acc), (port table, its acc), both with the
    delta log armed, at the step's row count."""
    rows = _step(*STEPS[0])[0].shape[1]
    ja, ta = jm.PackedCounts(), tm.PackedCounts()
    ref = jt.DeviceTable(_mesh(), kk=4, cap=rows, acc=ja, lag=1,
                         mesh_shards=mesh_shards)
    port = tt.DeviceTable(N, kk=4, cap=rows, acc=ta, device="cpu", lag=1,
                          mesh_shards=mesh_shards)
    ref.enable_delta()
    port.enable_delta()
    return (ref, ja), (port, ta)


def _fold(ref, port, i):
    packed, scal = _step(*STEPS[i])
    with jt._quiet_unusable_donation():
        ref.fold(jnp.asarray(packed), jnp.asarray(scal), scal)
    port.fold(to_tensor(packed), to_tensor(scal), scal)


def _assert_image(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_deltas(got, want):
    assert len(got) == len(want)
    g, w = DeltaSteps(got).materialize(), jck.DeltaSteps(want).materialize()
    _assert_image(g, w)


@pytest.mark.parametrize("mesh_shards", (0, N))
def test_table_images_match_reference(mesh_shards):
    """Folds, a capture, then a sync that clears the port's table in place
    and two more folds before the capture materializes: the image is the
    capture instant's, equal to the reference's bit for bit, and so are
    the delta entries of both windows."""
    with jt._quiet_unusable_donation():
        (ref, ja), (port, ta) = _tables(mesh_shards)
        _fold(ref, port, 0)
        _fold(ref, port, 1)
        captured = port.checkpoint_capture()
        want = ref.checkpoint_state()
        d_port, d_ref = port.take_delta(), ref.take_delta()
        live = port._state[2].clone()
        port.sync()
        ref.sync()
        assert not port._state[2].any()  # the live counts were cleared
        _fold(ref, port, 2)
        _fold(ref, port, 3)
        img = captured.materialize()
        _assert_image(img, want)
        assert img["keys"].dtype == np.uint32 and img["cnts"].dtype == \
            np.uint64
        np.testing.assert_array_equal(img["cnts"], live.numpy().view(
            np.uint64))
        assert (img["keys"][img["nrows"] == 0] == 0xFFFFFFFF).all()
        _assert_deltas(d_port, d_ref)
        _assert_deltas(port.take_delta(), ref.take_delta())
        _assert_image(port.checkpoint_state(), ref.checkpoint_state())
        port.close()
        ref.close()
    assert ta.finalize() == ja.finalize()


@pytest.mark.parametrize("mesh_shards", (0, N))
def test_restore_and_drain_image_match_reference(mesh_shards):
    """The reference's image restored into the port's table re-images bit
    for bit; draining it (``close``) and ``drain_image`` both give the
    reference's accumulator."""
    with jt._quiet_unusable_donation():
        (ref, ja), (port, _) = _tables(mesh_shards)
        for i in range(3):
            _fold(ref, port, i)
        img = ref.checkpoint_state()
        fresh_acc = tm.PackedCounts()
        fresh = tt.DeviceTable(N, kk=4, cap=16, acc=fresh_acc,
                               device="cpu", mesh_shards=mesh_shards)
        fresh.restore_state(img)
        assert fresh.cap == img["keys"].shape[1]
        _assert_image(fresh.checkpoint_state(), img)
        drained = tm.PackedCounts()
        tt.DeviceTable.drain_image(drained, img)
        jdrained = jm.PackedCounts()
        jt.DeviceTable.drain_image(jdrained, img)
        fresh.close()
        _fold(ref, port, 3)  # both go on folding after the image
        port.close()
        ref.close()
    assert drained.finalize() == fresh_acc.finalize() == jdrained.finalize()


def test_sync_policy_and_packed_counts_restore_match_reference():
    mine, ref = SyncPolicy(4), JSyncPolicy(4)
    for p in (mine, ref):
        p.note_fold()
        p.note_fold()
    assert mine.snapshot() == ref.snapshot() == 2
    mine.restore(3)
    ref.restore(3)
    mine.note_fold()
    ref.note_fold()
    assert mine.due() and ref.due()
    acc, jacc = tm.PackedCounts(), jm.PackedCounts()
    packed, scal = _step(*STEPS[0])
    for a in (acc, jacc):
        a.add_packed_step(packed, scal[:, 0], 4)
    snap = jacc.snapshot()
    restored, jrestored = tm.PackedCounts(), jm.PackedCounts()
    restored.restore(snap)
    jrestored.restore(acc.snapshot())
    # A delta's steps drain on top of a restored accumulator.
    arrays = jck.DeltaSteps([(packed, scal[:, 0].astype(np.int64))
                             ]).materialize()
    assert drain_packed_steps(restored, arrays) == 1
    assert jck.drain_packed_steps(jrestored, arrays) == 1
    assert restored.finalize() == jrestored.finalize()
    empty = tm.PackedCounts()
    empty.restore({})
    assert empty.finalize() == {}
