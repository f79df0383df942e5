"""The port's streaming indexer (K19 wave step, the wave walk, the df
top-k, ``mr-out-*``) against the JAX package, on the CPU.

The same documents, made from a numpy seed, go through the reference's
indexer wave program / ``indexer_streaming`` on the virtual CPU mesh and
through ``dsi_tpu_torch.parallel.grepstream`` with ``device="cpu"``
(plain versions of kernels A-E, L and M, and of B and C for the df
fold): the wave step's posting rows, df rows (pad rows included) and
scalars, and the walk's postings (per-word doc order included), df top-k
and counters, equal bit for bit.  The whole slice writes ``mr-out-*``
byte-equal to the port's sequential indexer oracle and to the reference's
writer.
"""

from __future__ import annotations

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.parallel import grepstream as jg
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch.apps import indexer as tapp
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.mr.sequential import run_sequential
from dsi_tpu_torch.parallel import grepstream as tg
from dsi_tpu_torch.parallel.tfidf import _wave_chunk

WORDS = re.compile(r"[A-Za-z]+")


@pytest.fixture(autouse=True)
def _hermetic_env(monkeypatch):
    """Engine knobs another test file may have left set take no part."""
    for var in ("DSI_STREAM_MESH_SHARDS", "DSI_DEVICE_POSTINGS_CAP",
                "DSI_DEVICE_TOPK_CAP", "DSI_WC_GROUPER",
                "DSI_STREAM_SYNC_EVERY", "DSI_STREAM_PIPELINE_DEPTH"):
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=None)
def _mesh(n: int):
    return js.default_mesh(n)


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(800)]


def _idx_docs(n_docs: int, seed: int, vocab: int = 180):
    """``tests/test_grep_stream.py``'s indexer documents."""
    rng = np.random.default_rng(seed)
    return [(" ".join(VOCAB[j] for j in
                      rng.integers(0, vocab, int(rng.integers(30, 120))))
             + "\n").encode() for _ in range(n_docs)]


def _oracle(docs):
    """{word: [doc indices]} from the host tokenizer, and the df top-16
    from it (df descending, word ascending)."""
    posts: dict = {}
    for d, doc in enumerate(docs):
        for w in sorted(set(WORDS.findall(doc.decode()))):
            posts.setdefault(w, []).append(d)
    top = tuple(sorted(((len(ds), w) for w, ds in posts.items()),
                       key=lambda r: (-r[0], r[1]))[:16])
    return posts, top


# ── K19: the wave step ───────────────────────────────────────────────────


def _ref_wave(chunks, ids, *, n_dev, max_word_len, u_cap, grouper):
    c, i = jnp.asarray(chunks), jnp.asarray(ids)
    fn = jg._idx_fn((c, i), n_dev=n_dev, n_reduce=10,
                    max_word_len=max_word_len, u_cap=u_cap,
                    size=chunks.shape[1], mesh=_mesh(n_dev), t_cap_frac=4,
                    grouper=grouper)
    return [np.asarray(x) for x in fn(c, i)]


def _same_wave(got, want):
    rows, df, scal = got
    np.testing.assert_array_equal(to_numpy(rows, np.uint32), want[0])
    np.testing.assert_array_equal(to_numpy(df, np.uint32), want[1])
    np.testing.assert_array_equal(to_numpy(scal), want[2])


@pytest.mark.parametrize("n_dev,u_cap,grouper", (
    (1, 256, "sort"), (1, 256, "hash"), (8, 64, "sort"), (8, 16, "hash")))
def test_wave_step_matches_reference(n_dev, u_cap, grouper):
    docs = _idx_docs(n_dev, seed=n_dev + u_cap)
    size = 1 << max(8, max(len(d) for d in docs).bit_length())
    chunks = _wave_chunk(docs, range(n_dev), n_dev, size)
    ids = np.arange(n_dev, dtype=np.int32)
    ids[-1] = 99  # a padding document's id rides its rows unchanged
    kw = dict(n_dev=n_dev, max_word_len=16, u_cap=u_cap, grouper=grouper)
    want = _ref_wave(chunks, ids, **kw)
    got = tg.indexer_wave_step(to_tensor(chunks), to_tensor(ids),
                               n_reduce=10, t_cap_frac=4, **kw)
    _same_wave(got, want)
    rows, df, scal = got
    assert rows.shape == (n_dev, n_dev * u_cap, 8)
    assert df.shape == (n_dev, n_dev * u_cap, 7)
    # tf is 1 on every posting row, and df carries it as the count
    for d in range(n_dev):
        nr = int(scal[d, 0])
        assert bool((rows[d, :nr, 5] == 1).all())
        assert bool((df[d, :nr, 5] == 1).all())
    if u_cap == 16:  # the overflow scalars the host ladder reads
        assert int(scal[:, 1].max()) > u_cap


def test_wave_step_wide_window_matches_reference():
    docs = [b"short words and a twentyletterwordzzzz here", b"plain text"]
    chunks = _wave_chunk(docs, range(2), 2, 256)
    ids = np.arange(2, dtype=np.int32)
    for mwl in (16, 64):
        kw = dict(n_dev=2, max_word_len=mwl, u_cap=32, grouper="sort")
        want = _ref_wave(chunks, ids, **kw)
        got = tg.indexer_wave_step(to_tensor(chunks), to_tensor(ids),
                                   n_reduce=10, **kw)
        _same_wave(got, want)
        assert got[1].shape[2] == mwl // 4 + 3
        assert int(got[2][:, 2].max()) == 20  # max_len is exact


# ── the wave walk ────────────────────────────────────────────────────────

_COUNTERS = ("waves", "replays", "step_pulls", "appends",
             "append_overflows", "sync_pulls", "postings_widens",
             "max_inflight_waves", "folds", "fold_overflows", "widens",
             "topk_snapshots", "mesh_shards")

DOCS = _idx_docs(21, seed=9)


@pytest.fixture(scope="module")
def base():
    """The reference's depth-1 host-merge result, the parity anchor of
    every configuration (as ``tests/test_grep_stream.py`` holds it)."""
    res = jg.indexer_streaming(DOCS, mesh=_mesh(8), n_reduce=10,
                               u_cap=1 << 9, depth=1)
    assert res is not None
    return res


def _both(docs, *, n_dev=8, **kw):
    """(reference result, its stats, port result, its stats)."""
    jst, tst = {}, {}
    want = jg.indexer_streaming(docs, mesh=_mesh(n_dev), stats=jst, **kw)
    got = tg.indexer_streaming(docs, n_dev=n_dev, stats=tst, device="cpu",
                               **kw)
    return want, jst, got, tst


def _same_counters(jst, tst):
    for key in _COUNTERS:
        if key in jst:
            assert tst[key] == jst[key], key


def test_indexer_matches_oracle(base):
    posts, top = _oracle(DOCS)
    got = tg.indexer_streaming(DOCS, n_dev=8, n_reduce=10, u_cap=1 << 9,
                               depth=1, device="cpu")
    assert got == base
    postings, got_top = got
    assert {w: sorted(ds) for w, (_, ds) in postings.items()} == posts
    assert got_top == top


@pytest.mark.parametrize("depth", (1, 3))
@pytest.mark.parametrize("dacc,sync_every", ((False, None), (True, 2),
                                             (True, 7)))
def test_indexer_matches_reference(base, depth, dacc, sync_every):
    want, jst, got, tst = _both(DOCS, n_reduce=10, u_cap=1 << 9,
                                depth=depth, device_accumulate=dacc,
                                sync_every=sync_every)
    assert got == want == base
    _same_counters(jst, tst)
    if dacc:
        assert tst["step_pulls"] == 0
        assert tst["appends"] >= 1 and tst["folds"] >= 1


@pytest.mark.parametrize("mesh_shards", (8, 3))
def test_indexer_mesh_shards_match_reference(base, mesh_shards):
    want, jst, got, tst = _both(DOCS, n_reduce=10, u_cap=1 << 9, depth=2,
                                sync_every=2, mesh_shards=mesh_shards)
    assert got == want == base
    _same_counters(jst, tst)
    assert tst["mesh_shards"] == mesh_shards and tst["appends"] >= 1
    assert tst["device_accumulate"] and tst["step_pulls"] == 0


def test_indexer_mesh_shards_from_environment(base, monkeypatch):
    monkeypatch.setenv("DSI_STREAM_MESH_SHARDS", "8")
    st: dict = {}
    got = tg.indexer_streaming(DOCS, n_dev=8, n_reduce=10, u_cap=1 << 9,
                               depth=2, stats=st, device="cpu")
    assert got == base
    assert st["mesh_shards"] == 8 and st["appends"] >= 1


def test_indexer_forced_topk_widen(monkeypatch):
    # The df table forced below the vocabulary widens mid-walk.
    monkeypatch.setenv("DSI_DEVICE_TOPK_CAP", "32")
    docs = _idx_docs(16, seed=3)
    ref = jg.indexer_streaming(docs, mesh=_mesh(8), n_reduce=10,
                               u_cap=1 << 9, depth=1)
    want, jst, got, tst = _both(docs, n_reduce=10, u_cap=1 << 9, depth=2,
                                device_accumulate=True, sync_every=2)
    assert got == want == ref
    assert tst["widens"] >= 1 and tst["fold_overflows"] >= 1
    assert tst["step_pulls"] == 0
    _same_counters(jst, tst)


@pytest.mark.parametrize("mesh_shards", (None, 8))
def test_indexer_forced_postings_overflow(monkeypatch, mesh_shards):
    # A postings buffer trimmed below the window drains early while the
    # df folds ride the same confirmations.
    monkeypatch.setenv("DSI_DEVICE_POSTINGS_CAP", "256")
    docs = _idx_docs(40, seed=13)
    ref = jg.indexer_streaming(docs, mesh=_mesh(8), n_reduce=10,
                               u_cap=1 << 9, depth=1)
    want, jst, got, tst = _both(docs, n_reduce=10, u_cap=1 << 9, depth=2,
                                device_accumulate=True, sync_every=10_000,
                                mesh_shards=mesh_shards)
    assert got == want == ref
    assert tst["append_overflows"] >= 1
    _same_counters(jst, tst)


def test_indexer_forced_replay_matches_reference():
    # Early waves fit u_cap 64, later high-vocabulary ones overflow it.
    rng = np.random.default_rng(31)
    docs = [(" ".join(VOCAB[j] for j in rng.integers(0, 8 if i < 9 else 400,
                                                     300)) + "\n").encode()
            for i in range(18)]
    want, jst, got, tst = _both(docs, n_reduce=10, u_cap=64, depth=2,
                                device_accumulate=True, sync_every=3)
    assert want is not None and got == want
    assert tst["replays"] >= 1
    _same_counters(jst, tst)
    assert {w: sorted(ds) for w, (_, ds) in got[0].items()} == \
        _oracle(docs)[0]


def test_indexer_wide_word_and_host_path():
    docs = _idx_docs(3, seed=2)
    docs[1] += b" abcdefghijklmnopqrst "  # 20 letters: the 64-byte rung
    want, _, got, _ = _both(docs, n_reduce=10, u_cap=1 << 9)
    assert want is not None and got == want
    assert "abcdefghijklmnopqrst" in got[0]
    # Non-ASCII bytes, and a word past 64 bytes (the reference's own
    # test_indexer_host_path_rejections pins its None there): the host
    # path.
    bad = "caf\xe9".encode("utf-8")
    assert jg.indexer_streaming([bad], mesh=_mesh(1), n_reduce=10,
                                u_cap=1 << 9) is None
    for bad in (bad, b"x" * 80 + b" y"):
        assert tg.indexer_streaming([bad], n_reduce=10, u_cap=1 << 9,
                                    device="cpu") is None


def test_not_ported_and_device_default(monkeypatch):
    docs = [b"a b c"]
    for kw, item in (({"checkpoint_dir": "ck"}, "checkpoints"),
                     ({"resume": True}, "checkpoints"),
                     ({"checkpoint_delta": True}, "checkpoints")):
        with pytest.raises(NotImplementedError, match=item):
            tg.indexer_streaming(docs, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="plan and serving"):
        tg.IndexerStep(docs, device="cpu", input_range=(0, 1))
    with pytest.raises(ValueError, match="mesh_shards"):
        tg.indexer_streaming(docs, n_dev=2, mesh_shards=3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.indexer_streaming(docs)


# ── the whole slice: pg-*.txt to mr-out-* ────────────────────────────────


def _merged(paths) -> list:
    lines = []
    for p in paths:
        with open(p, "rb") as f:
            lines.extend(x for x in f.read().split(b"\n") if x)
    return sorted(lines)


def test_mr_out_matches_oracle_and_reference(tmp_path):
    docs = _idx_docs(9, seed=21)
    names = []
    for i, doc in enumerate(docs):
        p = tmp_path / f"pg-{i}.txt"
        p.write_bytes(doc)
        names.append(str(p))
    oracle = _merged([run_sequential(tapp.Map, tapp.Reduce, names,
                                     str(tmp_path / "mr-correct.txt"))])
    res = tg.indexer_streaming(docs, n_dev=8, n_reduce=10, u_cap=1 << 9,
                               mesh_shards=8, device="cpu")
    ref = jg.indexer_streaming(docs, mesh=_mesh(8), n_reduce=10,
                               u_cap=1 << 9)
    assert res == ref
    got_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    os.makedirs(got_dir)
    os.makedirs(ref_dir)
    got = _merged(tg.write_indexer_output(res, names, 10, str(got_dir)))
    want = _merged(jg.write_indexer_output(ref, names, 10, str(ref_dir)))
    assert got == oracle == want
    for r in range(10):
        with open(got_dir / f"mr-out-{r}", "rb") as f, \
                open(ref_dir / f"mr-out-{r}", "rb") as g:
            assert f.read() == g.read()


def test_app_matches_reference():
    from dsi_tpu.apps import indexer as japp

    text = "red fish blue fish, one FISH two"
    assert [(kv.key, kv.value) for kv in tapp.Map("docA", text)] == \
        [(kv.key, kv.value) for kv in japp.Map("docA", text)]
    vals = ["docB", "docA", "docB"]
    assert tapp.Reduce("fish", vals) == japp.Reduce("fish", vals) \
        == "2 docA,docB"
