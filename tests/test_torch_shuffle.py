"""The port's SPMD step against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through
``dsi_tpu.parallel.shuffle`` on the 8-device (or a 1-device) virtual CPU
mesh of ``tests/conftest.py`` and through ``dsi_tpu_torch.parallel.shuffle``
with ``n_dev`` virtual shards on the CPU (the plain versions: the tensors
lie on the CPU).  Every output is an integer, so the tolerance is exact:
equal bit for bit, shard for shard.
"""

from __future__ import annotations

import collections
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dsi_tpu.parallel import shuffle as js
from dsi_tpu.utils.jaxcompat import shard_map
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.mr.sequential import ihash
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.parallel import shuffle as ts

WORDS = re.compile(r"[A-Za-z]+")


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


@functools.lru_cache(maxsize=None)
def _ref_shuffle_fn(n_dev: int, r: int, w: int, k: int):
    """The reference's ``shuffle_rows`` under ``shard_map``, one jit per
    shape."""
    def body(rows, dest):
        return js.shuffle_rows(rows.reshape(r, w), dest.reshape(r),
                               n_dev=n_dev, u_cap=r, k=k)[None]

    return jax.jit(shard_map(
        body, mesh=_mesh(n_dev),
        in_specs=(P(js.AXIS, None, None), P(js.AXIS, None)),
        out_specs=P(js.AXIS, None, None)))


def _rows_and_dest(seed: int, n_dev: int, r: int, w: int, mode: str):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (n_dev, r, w), dtype=np.uint64) \
        .astype(np.uint32)
    if mode == "random":
        dest = rng.integers(0, n_dev + 1, (n_dev, r))
    elif mode == "one_dest":
        dest = np.full((n_dev, r), n_dev - 1)
    else:  # "all_parked": no valid row at all
        dest = np.full((n_dev, r), n_dev)
    return rows, dest.astype(np.int32)


SHUFFLE_CASES = [(n_dev, mode, w, k) for n_dev in (1, 8)
                 for mode in ("random", "one_dest", "all_parked")
                 for w, k in ((7, 4), (3, 2))]


@pytest.mark.parametrize("n_dev,mode,w,k", SHUFFLE_CASES)
def test_shuffle_rows_plain_matches_reference(n_dev, mode, w, k):
    r = 96
    rows, dest = _rows_and_dest(n_dev * 31 + w, n_dev, r, w, mode)
    want = np.asarray(_ref_shuffle_fn(n_dev, r, w, k)(jnp.asarray(rows),
                                                      jnp.asarray(dest)))
    got = ts.shuffle_rows(to_tensor(rows), to_tensor(dest), n_dev=n_dev, k=k)
    np.testing.assert_array_equal(to_numpy(got, np.uint32), want)
    plain = tw.shuffle_rows_plain(to_tensor(rows), to_tensor(dest),
                                  n_dev=n_dev, k=k)
    np.testing.assert_array_equal(to_numpy(plain, np.uint32), want)


def test_shuffle_rows_rejects_bad_shapes():
    rows = torch.zeros((2, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ts.shuffle_rows(rows, torch.zeros((2, 4), dtype=torch.int32),
                        n_dev=3, k=2)
    with pytest.raises(ValueError):
        ts.shuffle_rows(rows, torch.zeros((2, 5), dtype=torch.int32),
                        n_dev=2, k=2)


# ── mapreduce_step ───────────────────────────────────────────────────────


def _random_text(seed: int, n_words: int, vocab) -> bytes:
    rng = np.random.default_rng(seed)
    seps = [b" ", b"\n", b", ", b". "]
    return b"".join(vocab[i] + seps[i % 4]
                    for i in rng.integers(0, len(vocab), n_words))


def _letters(i: int) -> bytes:
    return bytes(97 + (i // 26 ** j) % 26 for j in range(3))


_VOCAB = [_letters(i) for i in range(300)]


def _skewed_vocab(n_dev: int):
    """Words whose reduce partition lands on shard n_dev - 1, so every
    map row is bound for one destination."""
    return [w for w in _VOCAB
            if ihash(w.decode()) % 10 % n_dev == n_dev - 1][:40]


# name -> (text for n_dev shards, max_word_len, u_cap, t_cap_frac)
STEP_CASES = {
    "random": (lambda nd: _random_text(1, 1500, _VOCAB), 16, 64, 4),
    "unique_overflow": (lambda nd: _random_text(2, 1500, _VOCAB), 16, 16, 4),
    "token_overflow": (lambda nd: b"a b c d e f g h " * 100, 16, 64, 4),
    "word17_mwl16": (lambda nd: b"abcdefghijklmnopq x y " * 40, 16, 64, 4),
    "word17_mwl64": (lambda nd: b"abcdefghijklmnopq x y " * 40, 64, 64, 4),
    "skewed": (lambda nd: _random_text(3, 900, _skewed_vocab(nd)), 16, 64,
               4),
}


@pytest.mark.parametrize("n_dev", (1, 8))
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_mapreduce_step_matches_reference(name, n_dev):
    text_for, mwl, u_cap, frac = STEP_CASES[name]
    chunks, _ = js.shard_text(text_for(n_dev), n_dev)
    want = [np.asarray(x) for x in js.mapreduce_step(
        jnp.asarray(chunks), n_dev=n_dev, n_reduce=10, max_word_len=mwl,
        u_cap=u_cap, mesh=_mesh(n_dev), t_cap_frac=frac, grouper="sort")]
    got = ts.mapreduce_step(torch.from_numpy(chunks), n_dev=n_dev,
                            n_reduce=10, max_word_len=mwl, u_cap=u_cap,
                            t_cap_frac=frac)
    names = ("keys", "lens", "counts", "parts", "scalars")
    for what, g, wnt in zip(names, got, want):
        g = to_numpy(g, wnt.dtype)  # same bits: int32 carries the u32s
        assert g.shape == wnt.shape, what
        np.testing.assert_array_equal(g, wnt, err_msg=what)
    scal = want[4]
    if name == "token_overflow":
        assert scal[:, 4].any()
    if name == "unique_overflow":
        assert scal[:, 1].max() > u_cap
    if name.startswith("word17"):
        assert scal[:, 2].max() == 17
    if name == "skewed":
        assert (scal[:n_dev - 1, 0] == 0).all() and scal[n_dev - 1, 0] > 0


def test_shard_text_matches_reference():
    data = _random_text(4, 2000, _VOCAB)
    for n in (1, 3, 8):
        got, size = ts.shard_text(data, n)
        want, wsize = js.shard_text(data, n)
        assert size == wsize
        np.testing.assert_array_equal(got, want)


def test_occupied_prefix_matches_reference():
    for m in (1, 63, 64, 65, 1000, 5000):
        for cap in (64, 512, 4096):
            assert ts.occupied_prefix(m, cap) == js.occupied_prefix(m, cap)


# ── wordcount_sharded (the cases of tests/test_parallel_shuffle.py) ──────


def make_text(n_bytes: int, seed: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"alpha", b"Bet", b"gamma", b"d", b"epsilonlongword", b"Zz",
             b"supercalifragilistic", b"mid"]
    parts = []
    size = 0
    while size < n_bytes:
        w = vocab[int(rng.integers(len(vocab)))]
        sep = b" " if rng.random() < 0.8 else b"\n"
        parts.append(w + sep)
        size += len(w) + 1
    return b"".join(parts)[:n_bytes]


SHARDED_CASES = {
    "counter": (make_text(20000), 256),
    "word_overflow": (b"abcdefghijklmnopqrst " * 50 + b"tail word", 256),
    "token_overflow": (b"a b c d e f g h " * 200, 256),
    "unique_widen": (_random_text(5, 3000, _VOCAB), 16),
}


@pytest.fixture
def sort_grouper(monkeypatch):
    """The reference walks the sort grouper only, as on an accelerator."""
    monkeypatch.setenv("DSI_WC_GROUPER", "sort")


@pytest.mark.parametrize("n_dev", (1, 8))
@pytest.mark.parametrize("name", sorted(SHARDED_CASES))
def test_wordcount_sharded_matches_reference(name, n_dev, sort_grouper):
    data, u_cap = SHARDED_CASES[name]
    want = js.wordcount_sharded(data, mesh=_mesh(n_dev), u_cap=u_cap)
    got = ts.wordcount_sharded(data, n_dev=n_dev, u_cap=u_cap, device="cpu")
    assert got is not None and got == want
    counts = collections.Counter(WORDS.findall(data.decode("ascii")))
    assert {w: c for w, (c, _) in got.items()} == dict(counts)
    assert all(p == ihash(w) % 10 for w, (_, p) in got.items())


def test_wordcount_sharded_non_ascii_is_none(sort_grouper):
    data = "héllo world".encode("utf-8")
    assert js.wordcount_sharded(data, mesh=_mesh(8)) is None
    assert ts.wordcount_sharded(data, n_dev=8, device="cpu") is None


def test_write_partitioned_output_matches_reference(tmp_path, sort_grouper):
    res = ts.wordcount_sharded(make_text(4000), n_dev=8, u_cap=256,
                               device="cpu")
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = js.write_partitioned_output(res, 10, str(tmp_path / "ref"))
    got = ts.write_partitioned_output(res, 10, str(tmp_path / "port"))
    assert len(got) == 10
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()


def test_entry_points_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        ts.wordcount_sharded(b"some words", n_dev=1)
    with pytest.raises(RuntimeError):
        tw.resolve_device(None)
