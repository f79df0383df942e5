"""The port's mesh-sharded device table (K11) against the JAX package, on
the CPU.

The same numpy table and step arrays go into the reference's
``_mesh_fold_impl`` (through ``mesh_fold_step``) on the 8-device virtual
CPU mesh and into ``dsi_tpu_torch.device.table.mesh_fold_step`` with 8
virtual shards (plain versions: the tensors lie on the CPU): every output
equal bit for bit, shard for shard.  The routing (``ops/meshroute.py``)
is held against the reference's and against the host oracle, and the
streaming word count with ``mesh_shards`` against the reference's and
against the same stream without it, as ``tests/test_mesh_shard.py``
does.
"""

from __future__ import annotations

import functools
import itertools
import os
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.device import table as jt
from dsi_tpu.ops import meshroute as jmr
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import streaming as jst
from dsi_tpu_torch.device import table as tt
from dsi_tpu_torch.device.policy import mesh_shards_default
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.ops import meshroute as tmr
from dsi_tpu_torch.parallel import merge as tm
from dsi_tpu_torch.parallel import streaming as tst

N = 8


@functools.lru_cache(maxsize=None)
def _mesh():
    return js.default_mesh(N)


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(800)]


def _shard_words(shard: int, n: int):
    """``n`` words that route to ``shard``."""
    return [w for w in VOCAB
            if tmr.host_shard_of(w.encode(), N) == shard][:n]


# ── routing ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize("kk", (4, 16))
def test_route_dest_matches_reference_and_host(kk):
    rng = np.random.default_rng(kk)
    words = [bytes(rng.integers(97, 123, int(rng.integers(1, 4 * kk + 1)))
                   .astype(np.uint8)) for _ in range(300)]
    keys, lens, shards = tmr.pack_host_rows(words, N, kk)
    for want, got in zip(jmr.pack_host_rows(words, N, kk),
                         (keys, lens, shards)):
        np.testing.assert_array_equal(got, want)
    assert shards.tolist() == [jmr.host_shard_of(w, N) for w in words]
    valid = rng.random(len(words)) < 0.8
    want = np.asarray(jax.jit(functools.partial(
        jmr.route_dest, n_shards=N, park=N))(
        jnp.asarray(keys), jnp.asarray(lens), jnp.asarray(valid)))
    got = to_numpy(tmr.route_dest(to_tensor(keys), to_tensor(lens),
                                  torch.from_numpy(valid), n_shards=N,
                                  park=N))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.where(valid, shards, N))


# ── the mesh fold ────────────────────────────────────────────────────────


def _step(words, u_cap: int = 64):
    """One reference step over identical per-shard chunks, packed at full
    capacity: (packed uint32, scal int32) numpy."""
    text = (" ".join(words) + " ").encode()[:512]
    chunks = np.zeros((N, 512), np.uint8)
    chunks[:, :len(text)] = np.frombuffer(text, np.uint8)
    keys, lens, cnts, parts, scal = js.mapreduce_step(
        jnp.asarray(chunks), n_dev=N, n_reduce=10, max_word_len=16,
        u_cap=u_cap, mesh=_mesh(), t_cap_frac=4, grouper="sort")
    packed = js._slice_pack(keys, lens, cnts, parts, mp=keys.shape[1])
    return np.asarray(packed), np.asarray(scal)


def _empty(cap: int, kk: int = 4):
    return (np.full((N, cap, kk), 0xFFFFFFFF, np.uint32),
            np.zeros((N, cap), np.int32), np.zeros((N, cap), np.uint64),
            np.zeros((N, cap), np.int32), np.zeros(N, np.int32))


def _ref_mesh_fold(state, packed, scal, apply):
    with jt._quiet_unusable_donation():
        out = jt.mesh_fold_step(*state, packed, scal,
                                np.asarray(apply, np.int32), mesh=_mesh(),
                                n_shards=N)
    return [np.asarray(x) for x in out]


def _port_mesh_fold(state, packed, scal, apply):
    out = tt.mesh_fold_step(*(to_tensor(a) for a in state),
                            to_tensor(packed), to_tensor(scal),
                            torch.tensor(apply, dtype=torch.bool),
                            n_shards=N)
    return [to_numpy(x) for x in out]


def _assert_same(got, want):
    for what, g, w in zip(("keys", "lens", "counts", "parts", "n", "flags"),
                          got, want):
        assert g.shape == w.shape, what
        np.testing.assert_array_equal(g.view(w.dtype), w, err_msg=what)


APPLY = {"all": [1] * N, "partial": [1, 0, 1, 0, 1, 1, 0, 1]}


@pytest.mark.parametrize("apply", sorted(APPLY))
def test_mesh_fold_step_matches_reference(apply):
    steps = [_step(VOCAB[:60]), _step(VOCAB[30:90])]
    want = got = _empty(256)
    for packed, scal in steps:
        want = _ref_mesh_fold(want[:5], packed, scal, APPLY[apply])
        got = _port_mesh_fold(got[:5], packed, scal, APPLY[apply])
        _assert_same(got, want)
    occ = got[5][:, 1]
    applied = np.asarray(APPLY[apply], bool)
    assert (occ[~applied] == 0).all() and (occ[applied] > 0).all()


def test_mesh_fold_one_shard_overflows_alone():
    """Shard 3's words exceed the capacity: it keeps its old rows and
    flags its overflow while every other shard commits."""
    hot = _shard_words(3, 24)
    cold = [w for s in range(N) if s != 3 for w in _shard_words(s, 2)]
    packed, scal = _step(hot + cold)
    want = _ref_mesh_fold(_empty(16), packed, scal, APPLY["all"])
    got = _port_mesh_fold(_empty(16), packed, scal, APPLY["all"])
    _assert_same(got, want)
    flags = got[5]
    assert flags[3, 0] == 1 and flags[3, 1] == 0
    assert (np.delete(flags[:, 0], 3) == 0).all()
    assert (np.delete(flags[:, 1], 3) == 2).all()


def test_device_table_refuses_more_shards_than_the_mesh():
    with pytest.raises(ValueError, match="mesh_shards"):
        tt.DeviceTable(N, kk=4, cap=64, acc=tm.PackedCounts(), device="cpu",
                       mesh_shards=N + 1)
    from dsi_tpu.parallel.merge import PackedCounts

    with pytest.raises(ValueError):
        jt.DeviceTable(_mesh(), kk=4, cap=64, acc=PackedCounts(),
                       mesh_shards=N + 1)


def test_mesh_shards_default_matches_reference(monkeypatch):
    from dsi_tpu.device.policy import mesh_shards_default as ref

    for env, arg in (("3", None), ("junk", None), ("5", 2), ("-4", None)):
        monkeypatch.setenv("DSI_STREAM_MESH_SHARDS", env)
        assert mesh_shards_default(arg) == ref(arg)
    monkeypatch.delenv("DSI_STREAM_MESH_SHARDS")
    assert mesh_shards_default() == 0


# ── the stream (the cases of tests/test_mesh_shard.py) ───────────────────

WC_TEXT = ("alpha beta gamma delta the fox jumps over lazy dogs "
           "epsilon zeta eta theta iota kappa " * 2500).encode()

_COUNTERS = ("steps", "replays", "folds", "fold_overflows", "sync_pulls",
             "widens", "pull_bytes", "mesh_shards", "shard_widens",
             "shard_imbalance", "device_accumulate")


def _streams(text, mesh_shards, depth):
    kw = dict(n_reduce=10, chunk_bytes=1 << 12, u_cap=256, depth=depth,
              mesh_shards=mesh_shards, sync_every=2)
    wst: dict = {}
    gst: dict = {}
    want = jst.wordcount_streaming([text], mesh=_mesh(), pipeline_stats=wst,
                                   **kw)
    got = tst.wordcount_streaming([text], n_dev=N, device="cpu",
                                  pipeline_stats=gst, **kw)
    return want, wst, got, gst


@pytest.mark.parametrize("depth", (1, 3))
def test_wordcount_mesh_matches_reference_and_unsharded(depth):
    base = tst.wordcount_streaming([WC_TEXT], n_dev=N, n_reduce=10,
                                   chunk_bytes=1 << 12, u_cap=256, depth=1,
                                   mesh_shards=0, sync_every=2,
                                   device="cpu")
    want, wst, got, gst = _streams(WC_TEXT, N, depth)
    assert want is not None and got == want == base
    assert {k: gst.get(k) for k in _COUNTERS} == \
        {k: wst.get(k) for k in _COUNTERS}
    assert gst["mesh_shards"] == N and gst["device_accumulate"]
    assert gst["folds"] > 0 and gst["pull_bytes"] > 0


def _skewed_text(hot_shard: int, n_hot: int = 300, n_cold: int = 8):
    hot, cold = [], []
    for t in itertools.product(string.ascii_lowercase, repeat=4):
        w = "".join(t).encode()
        (hot if tmr.host_shard_of(w, N) == hot_shard else cold).append(w)
        if len(hot) >= n_hot and len(cold) >= n_cold:
            break
    return (b" ".join(hot[:n_hot] + cold[:n_cold]) + b"\n") * 24


def test_hot_shard_widens_alone(monkeypatch):
    """Skewed keys and a small table: only the hot shard drains, widens
    and re-folds, and the counts stay those of the unsharded stream."""
    text = _skewed_text(3)
    base = tst.wordcount_streaming([text], n_dev=N, n_reduce=10,
                                   chunk_bytes=1 << 12, u_cap=256, depth=1,
                                   sync_every=2, device="cpu")
    monkeypatch.setenv("DSI_DEVICE_TABLE_CAP", "64")
    want, wst, got, gst = _streams(text, N, 2)
    assert got == want == base
    assert {k: gst.get(k) for k in _COUNTERS} == \
        {k: wst.get(k) for k in _COUNTERS}
    widens = gst["shard_widens"]
    assert widens[3] >= 1 and sum(widens) == widens[3]
    assert gst["shard_imbalance"] > 2.0


def test_wcstream_cli_mesh_hash(tmp_path, monkeypatch):
    """``wcstream --grouper hash --mesh-shards 8 --devices 8 --check``."""
    from dsi_tpu_torch.cli import wcstream

    monkeypatch.setenv("DSI_WC_GROUPER", "sort")  # restored after the test
    p = tmp_path / "in.txt"
    p.write_bytes(_skewed_text(5, n_hot=120) + WC_TEXT[:20000])
    rc = wcstream.main(["--device", "cpu", "--grouper", "hash",
                        "--mesh-shards", "8", "--devices", "8", "--check",
                        "--chunk-bytes", "4096", "--workdir",
                        str(tmp_path / "out"), str(p)])
    assert rc == 0
    assert os.environ["DSI_WC_GROUPER"] == "hash"
