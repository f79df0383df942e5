"""The port's TF-IDF (K18 wave step, the wave walk, ``mr-out-*``) against
the JAX package, on the CPU.

The same documents, made from a numpy seed, go through the reference's
``tfidf_wave_step`` / ``tfidf_sharded`` on the virtual CPU mesh and
through ``dsi_tpu_torch.parallel.tfidf`` with ``device="cpu"`` (plain
versions of kernels A-E, L and M): the wave step's rows (pad rows
included) and scalars, and the walk's result (dict or packed, per-word
posting order included) and counters, equal bit for bit.  The whole
slice writes ``mr-out-*`` byte-equal to the port's sequential TF-IDF
oracle and to the reference's writer, as ``tests/test_tfidf.py`` does.
"""

from __future__ import annotations

import collections
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import tfidf as jtf
from dsi_tpu_torch.apps import tfidf as tapp
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.mr.sequential import run_sequential
from dsi_tpu_torch.parallel import tfidf as ttf
from dsi_tpu_torch.utils.corpus import ensure_corpus

WORDS = re.compile(r"[A-Za-z]+")


@functools.lru_cache(maxsize=None)
def _mesh(n: int):
    return js.default_mesh(n)


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(800)]


def _docs(n_docs: int, seed: int, vocab: int = 300, words: int = 200):
    rng = np.random.default_rng(seed)
    seps = (" ", ", ", "\n", " 12 ")
    out = []
    for _ in range(n_docs):
        n = int(rng.integers(words // 2, words + 1))
        ws = rng.integers(0, vocab, n)
        out.append("".join(VOCAB[j] + seps[j % 4] for j in ws).encode())
    return out


def _overflow_docs(n_docs: int = 18, seed: int = 31):
    """``tests/test_tfidf_pipeline.py``'s shape: early waves fit u_cap 64,
    later (shorter, high-vocab) ones overflow it mid-walk."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        if i < n_docs // 2:
            words = [VOCAB[j] for j in rng.integers(0, 8, 500)]
        else:
            words = [VOCAB[j] for j in rng.integers(0, 400, 300)]
        docs.append((" ".join(words) + "\n").encode())
    return docs


def _df_oracle(docs):
    df = collections.Counter()
    for d in docs:
        for w in set(WORDS.findall(d.decode())):
            df[w] += 1
    return dict(df)


# ── K18: the wave step ───────────────────────────────────────────────────


@pytest.mark.parametrize("grouper", ("sort", "hash"))
@pytest.mark.parametrize("n_dev,u_cap", ((1, 256), (8, 64), (8, 16)))
def test_wave_step_matches_reference(n_dev, u_cap, grouper):
    docs = _docs(n_dev, seed=n_dev + u_cap, words=150)
    if n_dev == 1:
        docs[0] += b" anotherword" + " ".join(VOCAB[300:340]).encode()
    size = 1 << max(8, max(len(d) for d in docs).bit_length())
    chunks = ttf._wave_chunk(docs, range(n_dev), n_dev, size)
    ids = np.arange(n_dev, dtype=np.int32)
    ids[-1] = 99  # a padding document's id rides its rows unchanged
    kw = dict(n_dev=n_dev, n_reduce=10, max_word_len=16, u_cap=u_cap,
              t_cap_frac=4, grouper=grouper)
    want_rows, want_scal = jtf.tfidf_wave_step(
        jnp.asarray(chunks), jnp.asarray(ids), mesh=_mesh(n_dev), **kw)
    rows, scal = ttf.tfidf_wave_step(to_tensor(chunks), to_tensor(ids), **kw)
    np.testing.assert_array_equal(to_numpy(rows, np.uint32),
                                  np.asarray(want_rows))
    np.testing.assert_array_equal(to_numpy(scal), np.asarray(want_scal))
    assert rows.shape == (n_dev, n_dev * u_cap, 8)
    if u_cap == 16:  # the overflow scalars the host ladder reads
        assert int(scal[:, 1].max()) > u_cap


def test_wave_step_wide_window_matches_reference():
    docs = [b"short words and a twentyletterwordzzzz here", b"plain text"]
    chunks = ttf._wave_chunk(docs, range(2), 2, 256)
    ids = np.arange(2, dtype=np.int32)
    for mwl in (16, 64):
        kw = dict(n_dev=2, n_reduce=5, max_word_len=mwl, u_cap=32)
        want = jtf.tfidf_wave_step(jnp.asarray(chunks), jnp.asarray(ids),
                                   mesh=_mesh(2), **kw)
        got = ttf.tfidf_wave_step(to_tensor(chunks), to_tensor(ids), **kw)
        np.testing.assert_array_equal(to_numpy(got[0], np.uint32),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(want[1]))
        assert int(got[1][:, 2].max()) == 20  # max_len is exact


# ── the wave walk ────────────────────────────────────────────────────────

_COUNTERS = ("waves", "replays", "step_pulls", "appends",
             "append_overflows", "sync_pulls", "postings_widens",
             "pull_bytes", "max_inflight_waves")


def _both(docs, *, n_dev, **kw):
    """(reference result, its stats, port result, its stats)."""
    jst, tst = {}, {}
    want = jtf.tfidf_sharded(docs, mesh=_mesh(n_dev), wave_stats=jst, **kw)
    got = ttf.tfidf_sharded(docs, n_dev=n_dev, wave_stats=tst,
                            device="cpu", **kw)
    return want, jst, got, tst


def _same_counters(jst, tst):
    for key in _COUNTERS:
        if key in jst:
            assert tst[key] == jst[key], key


@pytest.mark.parametrize("n_dev,depth,dacc", (
    (1, 1, False), (1, 2, True), (8, 2, False), (8, 3, True)))
def test_tfidf_sharded_matches_reference(n_dev, depth, dacc):
    docs = _docs(11, seed=n_dev * 10 + depth)
    want, jst, got, tst = _both(docs, n_dev=n_dev, n_reduce=10,
                                u_cap=1 << 9, depth=depth,
                                device_accumulate=dacc, sync_every=2)
    assert want is not None and got == want
    _same_counters(jst, tst)
    if dacc:
        assert tst["step_pulls"] == 0 and tst["appends"] >= 1


def test_tfidf_packed_and_file_docs_match_reference(tmp_path):
    docs = _docs(9, seed=5)
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"doc-{i}.txt"
        p.write_bytes(d)
        paths.append(str(p))
    lazy = ttf.FileDocs(paths)
    assert lazy.lengths == [len(d) for d in docs] == jtf.FileDocs(
        paths).lengths
    want = jtf.tfidf_sharded(docs, mesh=_mesh(4), n_reduce=10, u_cap=1 << 9,
                             packed=True)
    got = ttf.tfidf_sharded(lazy, n_dev=4, n_reduce=10, u_cap=1 << 9,
                            packed=True, device="cpu")
    for name in ("skeys", "lens", "parts", "starts", "ends", "tfs", "docs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.n_postings == want.n_postings
    np.testing.assert_array_equal(got.postings_per_word(),
                                  want.postings_per_word())
    d = want.to_dict()
    assert got.to_dict() == d
    some = list(d)[:15] + ["notaword", "café"]
    assert got.lookup_many(some) == want.lookup_many(some)


def test_tfidf_partition_slices_match_reference():
    docs = _docs(10, seed=9)
    full = ttf.tfidf_sharded(docs, n_dev=8, n_reduce=6, u_cap=1 << 9,
                             depth=2, device="cpu")
    parts = {}
    for sl in ({0, 1, 2}, {3, 4, 5}):
        want, _, got, _ = _both(docs, n_dev=8, n_reduce=6, u_cap=1 << 9,
                                depth=2, partitions=sl)
        assert got == want
        assert all(p in sl for p, _ in got.values())
        parts.update(got)
    assert parts == full


@pytest.mark.parametrize("depth,dacc", ((1, False), (2, False), (3, True)))
def test_tfidf_forced_replay_matches_reference(depth, dacc):
    docs = _overflow_docs()
    want, jst, got, tst = _both(docs, n_dev=8, n_reduce=10, u_cap=64,
                                depth=depth, device_accumulate=dacc,
                                sync_every=3)
    assert want is not None and got == want
    assert tst["replays"] >= 1
    _same_counters(jst, tst)
    assert {w: len(p) for w, (_, p) in got.items()} == _df_oracle(docs)


def test_tfidf_postings_recovery_and_widen_match_reference(monkeypatch):
    # A forced-tiny buffer: appends no-op mid-window, recovery drains and
    # re-appends, and a wave larger than the buffer widens it.
    monkeypatch.setenv("DSI_DEVICE_POSTINGS_CAP", "64")
    rng = np.random.default_rng(7)
    docs = [(" ".join(VOCAB[j] for j in rng.integers(0, 300, 350))
             + "\n").encode() for _ in range(16)]
    base = ttf.tfidf_sharded(docs, n_dev=8, n_reduce=10, u_cap=1 << 9,
                             depth=1, device="cpu")
    want, jst, got, tst = _both(docs, n_dev=8, n_reduce=10, u_cap=1 << 9,
                                depth=3, device_accumulate=True,
                                sync_every=10_000)
    assert got == want == base
    assert tst["append_overflows"] >= 1 and tst["postings_widens"] >= 1
    _same_counters(jst, tst)


def test_tfidf_wide_word_and_host_path_match_reference():
    docs = _docs(3, seed=2)
    docs[1] += b" abcdefghijklmnopqrst "  # 20 letters: the 64-byte rung
    want, _, got, _ = _both(docs, n_dev=2, n_reduce=5, u_cap=1 << 9)
    assert want is not None and got == want
    assert "abcdefghijklmnopqrst" in got
    docs[2] += "café".encode()
    want, _, got, _ = _both(docs, n_dev=2, n_reduce=5, u_cap=1 << 9)
    assert want is None and got is None
    docs[2] = b"x" * 70  # a word past 64 bytes: the host path too
    assert ttf.tfidf_sharded(docs, n_dev=2, u_cap=1 << 9,
                             device="cpu") is None


def test_plan_waves_matches_reference():
    lens = [1000] * 15 + [10_000, 3, 0]
    for n_dev in (1, 3, 8):
        assert ttf.plan_waves(lens, n_dev) == jtf.plan_waves(lens, n_dev)


def test_not_ported_and_device_default(monkeypatch):
    docs = [b"a b c"]
    for kw, item in (({"checkpoint_dir": "ck"}, "checkpoints"),
                     ({"resume": True}, "checkpoints"),
                     ({"checkpoint_async": True}, "checkpoints"),
                     ({"input_range": (0, 1)}, "plan and serving")):
        with pytest.raises(NotImplementedError, match=item):
            ttf.tfidf_sharded(docs, device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttf.tfidf_sharded(docs)


# ── the whole slice: pg-*.txt to mr-out-* ────────────────────────────────


def _merged(paths) -> list:
    lines = []
    for p in paths:
        with open(p, "rb") as f:
            lines.extend(x for x in f.read().split(b"\n") if x)
    return sorted(lines)


def test_mr_out_matches_oracle_and_reference(tmp_path, monkeypatch):
    n_docs = 11
    files = ensure_corpus(str(tmp_path / "inputs"), n_files=n_docs,
                          file_size=3_000)
    monkeypatch.setenv("DSI_TFIDF_NDOCS", str(n_docs))
    oracle = _merged([run_sequential(tapp.Map, tapp.Reduce, files,
                                     str(tmp_path / "mr-correct.txt"))])
    docs = []
    for p in files:
        with open(p, "rb") as f:
            docs.append(f.read())
    res = ttf.tfidf_sharded(docs, n_dev=8, n_reduce=10, u_cap=1 << 11,
                            device="cpu")
    assert res is not None
    got_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    os.makedirs(got_dir)
    os.makedirs(ref_dir)
    got = _merged(ttf.write_tfidf_output(res, files, 10, str(got_dir)))
    ref_res = jtf.tfidf_sharded(docs, mesh=_mesh(8), n_reduce=10,
                                u_cap=1 << 11)
    want = _merged(jtf.write_tfidf_output(ref_res, files, 10, str(ref_dir)))
    assert got == oracle == want
    for r in range(10):
        with open(got_dir / f"mr-out-{r}", "rb") as f, \
                open(ref_dir / f"mr-out-{r}", "rb") as g:
            assert f.read() == g.read()


def test_app_matches_reference(monkeypatch):
    from dsi_tpu.apps import tfidf as japp

    text = "red fish blue fish, one FISH two"
    assert [(kv.key, kv.value) for kv in tapp.Map("docA", text)] == \
        [(kv.key, kv.value) for kv in japp.Map("docA", text)]
    monkeypatch.setenv("DSI_TFIDF_NDOCS", "4")
    vals = ["docB\t3", "docA\t2"]
    assert tapp.Reduce("fish", vals) == japp.Reduce("fish", vals)
    monkeypatch.delenv("DSI_TFIDF_NDOCS")
    with pytest.raises(RuntimeError, match="DSI_TFIDF_NDOCS"):
        tapp.Reduce("w", ["d\t1"])
