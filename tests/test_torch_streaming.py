"""The port's streaming word count against the JAX package, on the CPU.

The same seeded block streams go through
``dsi_tpu.parallel.streaming.wordcount_streaming`` on the 8-device (or a
1-device) virtual CPU mesh and through
``dsi_tpu_torch.parallel.streaming.wordcount_streaming`` with ``n_dev``
virtual shards and ``device="cpu"``.  The result dicts must be equal
(counts and partitions), and so must the deterministic counters: steps,
replays, folds, fold overflows, sync pulls and widens.  The CLI is held
against the sequential oracle.
"""

from __future__ import annotations

import collections
import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import streaming as jst
from dsi_tpu_torch.apps import wc
from dsi_tpu_torch.mr.sequential import run_sequential
from dsi_tpu_torch.parallel import streaming as tst
from dsi_tpu_torch.parallel.stepobj import HostPathStep
from dsi_tpu_torch.utils.corpus import ensure_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = re.compile(r"[A-Za-z]+")


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


def _blocks(seed: int = 23, n: int = 40):
    """A stream whose vocabulary jumps mid-stream past u_cap=64 uniques
    per shard, so the optimistic dispatch overflows and replays."""
    rng = np.random.default_rng(seed)
    small = ["aa", "bb", "cc", "dd"]
    big = [_letters(i) for i in range(700)]
    out = []
    for i in range(n):
        vocab = small if i < n // 3 else big
        picks = rng.integers(0, len(vocab), 400)
        out.append((" ".join(vocab[j] for j in picks) + "\n").encode())
    return out


_COUNTERS = ("steps", "replays", "step_pulls", "folds", "fold_overflows",
             "sync_pulls", "widens")

# (n_dev, depth, device_accumulate, DSI_DEVICE_TABLE_CAP)
GRID = [(8, depth, dacc, cap) for depth in (1, 2)
        for dacc, cap in ((False, None), (True, None), (True, "32"))]
GRID += [(1, 2, False, None), (1, 2, True, "32")]


@pytest.mark.parametrize("grouper", ("sort", "hash"))
@pytest.mark.parametrize("n_dev,depth,dacc,table_cap", GRID)
def test_wordcount_streaming_matches_reference(n_dev, depth, dacc, table_cap,
                                               grouper, monkeypatch):
    """Both packages pinned to one grouper: the hash grouper is the CPU
    default of both, the sort grouper the card's."""
    monkeypatch.setenv("DSI_WC_GROUPER", grouper)
    if table_cap:
        monkeypatch.setenv("DSI_DEVICE_TABLE_CAP", table_cap)
    blocks = _blocks(n=40 if n_dev == 8 else 12)
    kw = dict(n_reduce=10, chunk_bytes=1 << 11, u_cap=64, depth=depth,
              device_accumulate=dacc, sync_every=3)
    wst: dict = {}
    want = jst.wordcount_streaming(list(blocks), mesh=_mesh(n_dev),
                                   pipeline_stats=wst, **kw)
    gst: dict = {}
    got = tst.wordcount_streaming(list(blocks), n_dev=n_dev, device="cpu",
                                  pipeline_stats=gst, **kw)
    assert want is not None and got == want
    text = b"".join(blocks).decode()
    assert {w: c for w, (c, _) in got.items()} == dict(
        collections.Counter(WORDS.findall(text)))
    assert ({k: gst.get(k) for k in _COUNTERS}
            == {k: wst.get(k) for k in _COUNTERS})
    assert gst["replays"] >= 1
    if dacc:
        assert gst["folds"] >= 1 and gst["step_pulls"] == 0
        if table_cap:
            assert gst["widens"] >= 1
    assert gst["max_inflight_chunks"] <= depth
    assert gst["batch_allocs"] <= 2 * depth + 3


def test_streaming_word_window_rung_matches_reference():
    """A 20-letter word mid-stream moves the sticky rung to the 64-byte
    window; with accumulation the table re-keys."""
    blocks = [b"alpha beta gamma " * 40,
              b"abcdefghijklmnopqrst delta " * 30, b"alpha tail " * 20]
    for dacc in (False, True):
        wst: dict = {}
        gst: dict = {}
        kw = dict(n_reduce=10, chunk_bytes=1 << 10, u_cap=64, depth=2,
                  device_accumulate=dacc, sync_every=2)
        want = jst.wordcount_streaming(list(blocks), mesh=_mesh(8),
                                       pipeline_stats=wst, **kw)
        got = tst.wordcount_streaming(list(blocks), n_dev=8, device="cpu",
                                      pipeline_stats=gst, **kw)
        assert got == want and got["abcdefghijklmnopqrst"][0] == 30
        assert ({k: gst.get(k) for k in _COUNTERS}
                == {k: wst.get(k) for k in _COUNTERS})


def test_wordcount_step_lifecycle_matches_reference():
    """The step object driven a few turns at a time: confirmed counts
    after each confirm() and the closed result equal the reference's."""
    blocks = _blocks(n=24)
    kw = dict(n_reduce=10, chunk_bytes=1 << 11, u_cap=64, depth=2)
    ref = jst.WordcountStep(list(blocks), mesh=_mesh(8), **kw)
    port = tst.WordcountStep(list(blocks), n_dev=8, device="cpu", **kw)
    while True:
        turns = port.advance_slice(2)
        assert turns == ref.advance_slice(2)
        assert port.confirm() == ref.confirm()
        assert port.phase == ref.phase
        if not turns:
            break
    assert port.close() == ref.close() and port.phase == "done"
    aborted = tst.WordcountStep(list(blocks), n_dev=8, device="cpu", **kw)
    aborted.advance()
    aborted.abort()
    assert aborted.phase == "cancelled" and aborted.close() is None
    routed = HostPathStep()
    assert routed.phase == "hostpath" and not routed.advance()
    assert routed.close() is None


@pytest.mark.parametrize("blocks", [
    [b"plain words ", "café".encode("utf-8"), b" more words"],
    [b"ok words here ", b"x" * 5000, b" tail"],
], ids=["non_ascii", "giant_token"])
def test_streaming_host_path_is_none(blocks):
    kw = dict(chunk_bytes=1 << 10, u_cap=1 << 8)
    assert jst.wordcount_streaming(list(blocks), mesh=_mesh(8), **kw) is None
    assert tst.wordcount_streaming(list(blocks), n_dev=8, device="cpu",
                                   **kw) is None


@pytest.mark.parametrize("kw", [
    {"aot": True}, {"checkpoint_dir": "ck"}, {"resume": True},
    {"input_range": (0, 10)},
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kw, tmp_path):
    """``aot`` and ``input_range`` are not ported yet; ``checkpoint_dir``
    and ``resume`` now run and give the uncheckpointed run's counts."""
    if "checkpoint_dir" in kw or "resume" in kw:
        kw = {k: str(tmp_path / v) if k == "checkpoint_dir" else v
              for k, v in kw.items()}
        want = tst.wordcount_streaming([b"a b c a"], device="cpu")
        assert want == {"a": (2, want["a"][1]), "b": want["b"],
                        "c": want["c"]} and want["b"][0] == 1
        assert tst.wordcount_streaming([b"a b c a"], device="cpu",
                                       **kw) == want
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.wordcount_streaming([b"a b c"], device="cpu", **kw)


def test_batch_stream_matches_reference():
    text = ("alpha beta gamma delta epsilon " * 400).encode()
    blocks = [text[i:i + 997] for i in range(0, len(text), 997)]
    for n_dev, chunk in ((4, 64), (8, 1 << 10), (1, 300)):
        got = [b.copy() for b in tst.batch_stream(blocks, n_dev, chunk)]
        want = [b.copy() for b in jst.batch_stream(blocks, n_dev, chunk)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cut_at_boundary_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(300):
        n = int(rng.integers(1, 400))
        buf = bytearray(rng.choice(list(b"ab .xyz"), n).astype(np.uint8))
        if rng.random() < 0.3:
            run = int(rng.integers(1, 200))
            at = int(rng.integers(0, max(1, n - run)))
            buf[at:at + run] = b"q" * min(run, n - at)
        size = int(rng.integers(1, 300))
        try:
            want = jst._cut_at_boundary(buf, size)
        except jst._TokenTooLong:
            with pytest.raises(tst._TokenTooLong):
                tst._cut_at_boundary(buf, size)
            continue
        assert tst._cut_at_boundary(buf, size) == want


def test_stream_files_matches_reference(tmp_path):
    a = tmp_path / "a.txt"
    b = tmp_path / "b.txt"
    a.write_bytes(b"ends with word")
    b.write_bytes(b"word starts here" * 100)
    got = list(tst.stream_files([str(a), str(b)], block_bytes=64))
    assert got == list(jst.stream_files([str(a), str(b)], block_bytes=64))


def test_cycle_files_is_the_bench_stream_input(tmp_path):
    """``cycle_files`` yields the bytes of ``bench.py run_stream_row``'s
    ``blocks()``: the reference's ``stream_files`` per cycle, a newline
    between cycles."""
    paths = []
    for name, text in (("a.txt", b"ends with word"), ("b.txt", b"tail")):
        (tmp_path / name).write_bytes(text)
        paths.append(str(tmp_path / name))
    want = b"\n".join(b"".join(jst.stream_files(paths, block_bytes=8))
                      for _ in range(3))
    assert b"".join(tst.cycle_files(paths, 3, block_bytes=8)) == want


# ── the CLI ──────────────────────────────────────────────────────────────


def _merged(workdir) -> list:
    lines = []
    for r in range(10):
        with open(os.path.join(workdir, f"mr-out-{r}"),
                  encoding="utf-8") as f:
            lines.extend(l for l in f if l.strip())
    return sorted(lines)


def _oracle(files, workdir) -> list:
    out = run_sequential(wc.Map, wc.Reduce, files,
                         os.path.join(workdir, "mr-correct.txt"))
    with open(out, encoding="utf-8") as f:
        return sorted(l for l in f if l.strip())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wcstream")
    files = ensure_corpus(str(root / "inputs"), n_files=2, file_size=20_000)
    return files, _oracle(files, str(root))


def test_wcstream_cli_module_matches_oracle(corpus, tmp_path):
    files, want = corpus
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "dsi_tpu_torch.cli.wcstream", "--device",
         "cpu", "--check", "--chunk-bytes", "4096", "--workdir",
         str(tmp_path)] + files,
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "parity OK" in res.stderr
    assert _merged(str(tmp_path)) == want


def test_wcstream_cli_device_accumulate_matches_oracle(corpus, tmp_path,
                                                       capsys):
    from dsi_tpu_torch.cli import wcstream

    files, want = corpus
    rc = wcstream.main(["--device", "cpu", "--devices", "8", "--check",
                        "--chunk-bytes", "2048", "--device-accumulate",
                        "--sync-every", "2", "--ingest-readers", "2",
                        "--stats", "--workdir", str(tmp_path)] + files)
    assert rc == 0
    assert _merged(str(tmp_path)) == want
    err = capsys.readouterr().err
    assert "pipeline_stats=" in err and "'folds'" in err


def test_wcstream_cli_host_fallback(tmp_path):
    from dsi_tpu_torch.cli import wcstream

    p = tmp_path / "in.txt"
    p.write_bytes("héllo wörld plain words héllo".encode("utf-8"))
    rc = wcstream.main(["--device", "cpu", "--check", "--workdir",
                        str(tmp_path / "out"), str(p)])
    assert rc == 0
    assert _merged(str(tmp_path / "out")) == _oracle([str(p)],
                                                     str(tmp_path))
