"""The port's streaming grep (kernel J, the device services) against the
JAX package, on the CPU.

``grep_step_plain`` is held row for row against the reference's step
program (``_grep_fn``, on the 8-device or a 1-device virtual CPU mesh):
hist, candidate rows and scalars, bit for bit.  ``grep_streaming`` is
held against the reference's and against ``grep_host_oracle`` over the
same seeded block streams — depth x ``device_accumulate`` at ``n_dev`` 1
and 8, ``mesh_shards``, a forced ``l_cap`` replay and a forced top-k
widen — with the sync counters equal to the reference's.  Kept small
(2 KiB chunks, a 600-word vocabulary), as ``tests/test_grep_stream.py``.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dsi_tpu.device import table as jt
from dsi_tpu.parallel import grepstream as jgs
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.utils.jaxcompat import enable_x64
from dsi_tpu_torch.cli import grepstream as cli
from dsi_tpu_torch.interop import to_numpy
from dsi_tpu_torch.parallel import grepstream as tgs


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(600)]


def _grep_blocks(seed: int, n_blocks: int = 8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_blocks):
        words = [VOCAB[j] for j in rng.integers(0, 400, 120)]
        lines, cur = [], []
        for w in words:
            cur.append(w)
            if rng.random() < 0.2:
                lines.append(" ".join(cur))
                cur = []
        lines.append(" ".join(cur))
        out.append(("\n".join(lines) + "\n").encode())
    return out


# ── the step (K16) ─────────────────────────────────────────────────────


def _ref_step(chunks, pats, lens, bases, *, l_cap, bins, k):
    n_dev, n = chunks.shape
    mesh = _mesh(n_dev)
    sh2 = NamedSharding(mesh, P(js.AXIS, None))
    sh1 = NamedSharding(mesh, P(js.AXIS))
    args = [jax.device_put(chunks, sh2), jax.device_put(pats, sh2),
            jax.device_put(lens, sh1)]
    with enable_x64(True):
        args.append(jax.device_put(bases.astype(np.uint64), sh1))
    fn = jgs._grep_fn(tuple(args), n_dev=n_dev, chunk_bytes=n,
                      m=pats.shape[1], l_cap=l_cap, bins=bins, k=k,
                      mesh=mesh)
    with jt._quiet_unusable_donation():
        return [np.asarray(x) for x in fn(*args)]


def _step_batch(n_dev: int, n: int = 2048, seed: int = 1):
    """Rows: full text cut at a newline, an unterminated tail, dlen 0,
    lines that all match (matched > k), and garbage past dlen that holds
    the pattern (the reference counts it on the last line)."""
    rng = np.random.default_rng(seed)
    text = b"".join(_grep_blocks(seed, 4))
    batch = np.zeros((n_dev, n), np.uint8)
    lens = np.zeros(n_dev, np.int32)
    for r in range(n_dev):
        kind = r % 5
        if kind == 0:
            row = text[:text.rfind(b"\n", 0, n) + 1]
        elif kind == 1:
            row = text[:n - 100]  # ends mid-line
        elif kind == 2:
            row = b""
        elif kind == 3:
            row = (b"aba x aba\n" * 200)[:n - 5]
        else:
            row = text[r * 37:r * 37 + 600]
        batch[r, :len(row)] = np.frombuffer(row, np.uint8)
        lens[r] = len(row)
        if kind == 4:
            batch[r, len(row):len(row) + 19] = np.frombuffer(
                b"zzaba\nqaba aba q\nab", np.uint8)
    bases = rng.integers(0, 1 << 40, n_dev).astype(np.int64)
    bases[0] = (1 << 32) - 3  # base + line crosses into the hi word
    return batch, lens, bases


@pytest.mark.parametrize("n_dev", (1, 8))
@pytest.mark.parametrize("l_cap,k", [(256, 16), (2049, 16), (40, 4),
                                     (256, 1)])
@pytest.mark.parametrize("pattern", ["aba", "a", "x aba"])
def test_grep_step_matches_reference(n_dev, l_cap, k, pattern):
    batch, lens, bases = _step_batch(n_dev)
    pats = np.tile(np.frombuffer(pattern.encode(), np.uint8), (n_dev, 1))
    want = _ref_step(batch, pats, lens, bases, l_cap=l_cap, bins=8, k=k)
    got = tgs.grep_step(torch.from_numpy(batch), torch.from_numpy(pats),
                        torch.from_numpy(lens), torch.from_numpy(bases),
                        l_cap=l_cap, bins=8, k=k)
    assert np.array_equal(to_numpy(got[0], np.uint32), want[0])
    assert np.array_equal(to_numpy(got[1], np.uint32), want[1])
    assert np.array_equal(to_numpy(got[2]), want[2])


def test_grep_step_rows_may_carry_different_patterns():
    """One dispatch, one pattern a row (the packed serving shape)."""
    n_dev = 8
    batch, lens, bases = _step_batch(n_dev, seed=4)
    pats = np.stack([np.frombuffer(_letters(i).encode(), np.uint8)
                     for i in range(0, 80, 10)])
    want = _ref_step(batch, pats, lens, bases, l_cap=256, bins=8, k=16)
    got = tgs.grep_step_plain(torch.from_numpy(batch),
                              torch.from_numpy(pats), torch.from_numpy(lens),
                              torch.from_numpy(bases), l_cap=256, bins=8,
                              k=16)
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g).view(w.dtype), w)


# ── batching and the oracle ────────────────────────────────────────────


@pytest.mark.parametrize("n_dev,chunk", [(2, 16), (1, 17), (3, 64)])
def test_batch_lines_matches_reference(n_dev, chunk):
    """A line of 16 bytes and its newline: too wide for 16-byte rows."""
    blocks = [b"alpha\nbeta\n", b"gam", b"ma\ndelta\nepsilon\n", b"y" * 16,
              b"\n\nz"]
    if chunk < 17:
        with pytest.raises(tgs._LineTooLong):
            list(tgs.batch_lines(blocks, n_dev, chunk))
        with pytest.raises(jgs._LineTooLong):
            list(jgs.batch_lines(blocks, n_dev, chunk))
        return
    got = list(tgs.batch_lines(blocks, n_dev, chunk))
    want = list(jgs.batch_lines(blocks, n_dev, chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


def test_oracle_and_merge_match_reference():
    blocks = _grep_blocks(2) + [b"aaaa\naa", b"a\n", b"tail aa"]
    for pat in ("aba", "aa", "a"):
        assert (tgs.grep_host_oracle(list(blocks), pat, topk=5)
                == jgs.grep_host_oracle(list(blocks), pat, topk=5))
    cands = [(5, 2), (1, 2), (9, 7), (3, 1)]
    assert tgs.merge_topk(cands, 3) == jgs.merge_topk(cands, 3)


# ── the stream ─────────────────────────────────────────────────────────

_COUNTERS = ("steps", "replays", "step_pulls", "sync_pulls", "l_cap",
             "folds", "fold_overflows", "widens", "table_cap",
             "topk_snapshots", "hist_folds", "hist_pulls", "pull_bytes",
             "mesh_shards", "shard_widens")


def _both(blocks, pattern, n_dev, **kw):
    wst: dict = {}
    want = jgs.grep_streaming(list(blocks), pattern, mesh=_mesh(n_dev),
                              pipeline_stats=wst, **kw)
    gst: dict = {}
    got = tgs.grep_streaming(list(blocks), pattern, n_dev=n_dev,
                             device="cpu", pipeline_stats=gst, **kw)
    return got, want, gst, wst


def _check(got, want, gst, wst, oracle):
    assert got == want == oracle
    assert isinstance(got, tgs.GrepStreamResult)
    assert ({k: gst.get(k) for k in _COUNTERS}
            == {k: wst.get(k) for k in _COUNTERS})


@pytest.mark.parametrize("n_dev", (1, 8))
@pytest.mark.parametrize("depth", (1, 2))
@pytest.mark.parametrize("dacc", (False, True))
def test_grep_streaming_matches_reference(n_dev, depth, dacc):
    blocks = _grep_blocks(7, 40 if n_dev == 8 else 6)
    oracle = jgs.grep_host_oracle(list(blocks), "aba")
    got, want, gst, wst = _both(blocks, "aba", n_dev, chunk_bytes=1 << 11,
                                depth=depth, device_accumulate=dacc,
                                sync_every=2)
    _check(got, want, gst, wst, oracle)
    if dacc:
        assert gst["step_pulls"] == 0 and gst["folds"] >= 1
    else:
        assert gst["step_pulls"] == gst["steps"] >= 2


@pytest.mark.parametrize("depth", (1, 2))
def test_grep_streaming_mesh_shards_matches_reference(depth):
    blocks = _grep_blocks(9, 16)
    oracle = jgs.grep_host_oracle(list(blocks), "ab")
    got, want, gst, wst = _both(blocks, "ab", 8, chunk_bytes=1 << 11,
                                depth=depth, mesh_shards=8, sync_every=1)
    _check(got, want, gst, wst, oracle)
    assert gst["mesh_shards"] == 8 and gst["device_accumulate"] is True
    plain = tgs.grep_streaming(list(blocks), "ab", n_dev=8,
                               chunk_bytes=1 << 11, depth=depth,
                               device_accumulate=True, device="cpu")
    assert got == plain


@pytest.mark.parametrize("dacc", (False, True))
def test_grep_forced_l_cap_replay_sticks(dacc):
    """Short lines overflow the optimistic rung: the step replays at the
    n+1 rung, which sticks."""
    blocks = [b"a\n" * 2000, b"aba\nx\n" * 500, b"a\n" * 2000]
    oracle = jgs.grep_host_oracle(list(blocks), "aba")
    got, want, gst, wst = _both(blocks, "aba", 8, chunk_bytes=1 << 11,
                                depth=2, device_accumulate=dacc,
                                sync_every=2)
    _check(got, want, gst, wst, oracle)
    assert gst["replays"] >= 1 and gst["l_cap"] == (1 << 11) + 1
    assert gst["replays"] <= gst["steps"]


@pytest.mark.parametrize("n_dev,mesh", [(8, 0), (8, 8), (1, 0)])
def test_grep_forced_topk_widen_never_drops(n_dev, mesh, monkeypatch):
    monkeypatch.setenv("DSI_DEVICE_TOPK_CAP", "32")
    blocks = [(" aba x" * 8 + "\n").encode() * 30] * (60 if n_dev == 8
                                                      else 12)
    oracle = jgs.grep_host_oracle(list(blocks), "aba")
    got, want, gst, wst = _both(blocks, "aba", n_dev, chunk_bytes=1 << 11,
                                depth=2, device_accumulate=True,
                                mesh_shards=mesh, sync_every=3)
    _check(got, want, gst, wst, oracle)
    assert gst["widens"] >= 1 and gst["fold_overflows"] >= 1
    assert gst["table_cap"] > 32 and gst["step_pulls"] == 0


@pytest.mark.parametrize("k", (3, 8))
def test_grep_sync_accounting_windows_plus_close(k):
    line = (" ".join(VOCAB[:30]) + " aba\n").encode() * 6
    blocks = [line] * 150
    got, want, gst, wst = _both(blocks, "aba", 8, chunk_bytes=1 << 11,
                                depth=2, device_accumulate=True,
                                sync_every=k)
    _check(got, want, gst, wst, jgs.grep_host_oracle(list(blocks), "aba"))
    windows = gst["folds"] // k
    assert gst["folds"] == gst["steps"] >= k
    assert gst["sync_pulls"] == gst["hist_pulls"] == windows + 1
    assert gst["topk_snapshots"] == windows


def test_grep_streaming_host_path_and_empty():
    assert tgs.grep_streaming([b"x\n"], "th.e", device="cpu") is None
    assert tgs.grep_streaming([b"z" * 5000], "z", chunk_bytes=1 << 11,
                              device="cpu") is None
    res = tgs.grep_streaming([], "the", chunk_bytes=1 << 11, device="cpu")
    assert res == jgs.grep_streaming([], "the", mesh=_mesh(1),
                                     chunk_bytes=1 << 11)
    assert res.lines == 0 and res.topk == ()


def test_grep_streaming_not_ported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgs.grep_streaming([b"a\n"], "a", device="cpu", aot=True)
    # Checkpoints are ported: a checkpointed run, and a resume of its
    # finished chain, give the run without checkpoints.
    want = tgs.grep_streaming([b"a\nba\n"], "a", device="cpu")
    ck = str(tmp_path / "ck")
    for kw in ({"checkpoint_dir": ck, "checkpoint_every": 1},
               {"checkpoint_dir": ck, "resume": True}):
        assert tgs.grep_streaming([b"a\nba\n"], "a", device="cpu",
                                  **kw) == want


@pytest.mark.parametrize("extra", ([], ["--device-accumulate",
                                        "--mesh-shards", "4",
                                        "--devices", "4"]))
def test_cli_check_against_the_oracle(tmp_path, capsys, extra):
    paths = []
    for i, block in enumerate(_grep_blocks(3, 6)):
        p = tmp_path / f"pg-{i}.txt"
        p.write_bytes(block * 3)
        paths.append(str(p))
    rc = cli.main(["--pattern", "aba", "--chunk-bytes", "2048", "--check",
                   "--stats", "--device", "cpu", *extra, *paths])
    out, err = capsys.readouterr()
    assert rc == 0 and "parity OK" in err
    want = jgs.grep_host_oracle(
        [open(p, "rb").read() + b"\n" for p in paths[:-1]]
        + [open(paths[-1], "rb").read()], "aba")
    assert f"lines={want.lines} matched={want.matched} " in out
    rc = cli.main(["--pattern", "a.b", "--device", "cpu", *paths])
    out, err = capsys.readouterr()
    assert rc == 0 and "host scan" in err
