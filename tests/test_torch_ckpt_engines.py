"""Crash-resume of the port's streaming grep, indexer and TF-IDF against the
JAX package, on the CPU.

The shapes of ``tests/test_checkpoint.py``: a ~45 KB grep stream of 3,000
lines at 2 KiB chunks and 20 indexer documents (5 waves), both over 4
virtual shards, a checkpoint every 2 confirmed steps or waves, a fault
armed at a named point (``DSI_FAULT_MODE=raise``, so the grid runs in one
process), then a resume from whatever chain survived.  The port's resumed
result must equal the reference's uninterrupted run (``dsi_tpu``'s
engines on a 4-device virtual CPU mesh, computed once per configuration)
bit for bit: grep's totals, histogram and top-k; the indexer's postings
with their per-word doc order and its df top-k; TF-IDF's postings.
Chains cross between the packages in both directions, and the grep CLI is
killed for real (``os._exit(87)`` in a subprocess) and finished with
``--resume``.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from dsi_tpu.ckpt import FaultInjected as JFaultInjected
from dsi_tpu.ckpt import reset_faults as j_reset_faults
from dsi_tpu.parallel import grepstream as jg
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import tfidf as jtf
from dsi_tpu_torch.ckpt import (
    FAULT_EXIT,
    FAULT_POINTS,
    FaultInjected,
    reset_faults,
)
from dsi_tpu_torch.parallel import grepstream as tg
from dsi_tpu_torch.parallel import tfidf as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 4


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


WORDS = [_letters(i) for i in range(120)]
GREP_TEXT = b"\n".join(b"ab " * (i % 5) + b"line" + str(i).encode()
                       for i in range(3000)) + b"\n"  # ~45 KB, ~6 steps
GREP_KW = dict(chunk_bytes=1 << 11, sync_every=2, topk=8)
IDX_DOCS = [(" ".join(WORDS[(3 * i) % 90:(3 * i) % 90 + 14])
             + " common words").encode() for i in range(20)]  # 5 waves
IDX_KW = dict(n_reduce=10, u_cap=1 << 9, sync_every=2, topk=8)
TF_KW = dict(n_reduce=10, u_cap=1 << 9)

#: The occurrence to kill at: a checkpoint exists before every crash
#: (every=2), so a resume restores real state.
FAULT_AT = {"post-dispatch": 4, "mid-fold": 4, "pre-sync": 2,
            "post-ckpt": 2, "mid-capture": 2, "mid-commit": 2}


@pytest.fixture(autouse=True)
def _hermetic_env(monkeypatch):
    """Engine knobs another test file may have left set take no part.  The
    top-k tables start at 256 rows a shard (both packages read
    ``DSI_DEVICE_TOPK_CAP``), not grep's default 16,384: every fold of the
    plain version sorts the whole table, which on a busy host costs
    seconds a case, and a table that widens gives the same result."""
    for var in ("DSI_STREAM_MESH_SHARDS", "DSI_DEVICE_POSTINGS_CAP",
                "DSI_STREAM_SYNC_EVERY", "DSI_STREAM_PIPELINE_DEPTH",
                "DSI_STREAM_CKPT_ASYNC", "DSI_STREAM_CKPT_DELTA",
                "DSI_STREAM_CKPT_EVERY", "DSI_STREAM_CKPT_REBASE",
                "DSI_FAULT_MODE", "DSI_FAULT_POINT", "DSI_FAULT_STEP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DSI_DEVICE_TOPK_CAP", "256")


@functools.lru_cache(maxsize=None)
def _mesh():
    return js.default_mesh(N_DEV)


@functools.lru_cache(maxsize=None)
def _want(engine: str, dacc: bool):
    """The reference's uninterrupted run, once per configuration."""
    if engine == "grep":
        got = jg.grep_streaming([GREP_TEXT], "ab", mesh=_mesh(), depth=2,
                                device_accumulate=dacc, **GREP_KW)
    elif engine == "idx":
        got = jg.indexer_streaming(IDX_DOCS, mesh=_mesh(), depth=2,
                                   device_accumulate=dacc, **IDX_KW)
    else:
        got = jtf.tfidf_sharded(IDX_DOCS, mesh=_mesh(), **TF_KW)
    assert got is not None
    return got


def _arm(monkeypatch, point, step):
    monkeypatch.setenv("DSI_FAULT_MODE", "raise")
    monkeypatch.setenv("DSI_FAULT_POINT", point)
    monkeypatch.setenv("DSI_FAULT_STEP", str(step))


def _disarm(monkeypatch):
    for k in ("DSI_FAULT_MODE", "DSI_FAULT_POINT", "DSI_FAULT_STEP"):
        monkeypatch.delenv(k, raising=False)


def _run(engine, ckpt=None, resume=False, dacc=False, stats=None,
         async_=None, delta=None, every=2, **kw):
    reset_faults()
    common = dict(n_dev=N_DEV, device="cpu", depth=2, checkpoint_dir=ckpt,
                  checkpoint_every=every, checkpoint_async=async_,
                  checkpoint_delta=delta, resume=resume)
    if engine == "grep":
        return tg.grep_streaming([GREP_TEXT], "ab", device_accumulate=dacc,
                                 pipeline_stats=stats, **common,
                                 **{**GREP_KW, **kw})
    if engine == "idx":
        return tg.indexer_streaming(IDX_DOCS, device_accumulate=dacc,
                                    stats=stats, **common,
                                    **{**IDX_KW, **kw})
    return ttf.tfidf_sharded(IDX_DOCS, device_accumulate=dacc,
                             sync_every=2, wave_stats=stats, **common,
                             **{**TF_KW, **kw})


def _crash_resume(monkeypatch, tmp_path, engine, point, dacc, step=None,
                  **kw):
    """A run with the fault armed (it must fire), then a resume; returns
    (result, the crashed run's stats, the resumed run's stats)."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, point, step or FAULT_AT[point])
    crashed: dict = {}
    with pytest.raises(FaultInjected):
        _run(engine, ckpt=ck, dacc=dacc, stats=crashed, **kw)
    _disarm(monkeypatch)
    stats: dict = {}
    res = _run(engine, ckpt=ck, resume=True, dacc=dacc, stats=stats, **kw)
    return res, crashed, stats


def _cursor(stats) -> int:
    return stats.get("resume_cursor", stats.get("resume_wave", 0))


# ── the grid: every fault point, services off and on ──────────────────

GRID = [(e, p, d) for e in ("grep", "idx") for p in FAULT_POINTS
        for d in (False, True)
        if d or p != "pre-sync"]  # pre-sync is a services' sync point


@pytest.mark.parametrize("engine,point,dacc", GRID)
def test_crash_resume_matches_reference(monkeypatch, tmp_path, engine,
                                        point, dacc):
    res, _, stats = _crash_resume(monkeypatch, tmp_path, engine, point,
                                  dacc)
    assert res == _want(engine, dacc)
    if point in ("post-ckpt", "mid-fold"):
        # A checkpoint existed before the crash: the resume restored it
        # instead of starting over.
        assert _cursor(stats) > 0


@pytest.mark.parametrize("engine,point,dacc", [
    (e, p, True) for e in ("grep", "idx")
    for p in ("mid-capture", "mid-commit", "post-ckpt")]
    + [("grep", "mid-fold", False), ("idx", "mid-fold", False)])
def test_async_delta_crash_resume_matches_reference(monkeypatch, tmp_path,
                                                    engine, point, dacc):
    """A death during a capture, during a background commit or after a
    delta landed: the surviving chain (a base, then its deltas drained in
    save order) restores to the uninterrupted result.  The services-off
    cases run grep's candidate watermark and the indexer's host delta
    log."""
    res, _, stats = _crash_resume(monkeypatch, tmp_path, engine, point,
                                  dacc, async_=True, delta=True)
    assert res == _want(engine, dacc)
    assert stats["ckpt_async"] and stats["ckpt_delta"]


def test_grep_resume_across_forced_topk_widen(monkeypatch, tmp_path):
    """A candidate table far below the candidates (``DSI_DEVICE_TOPK_CAP``)
    widens before the crash; the full image keeps the widened capacity."""
    monkeypatch.setenv("DSI_DEVICE_TOPK_CAP", "8")
    res, crashed, stats = _crash_resume(monkeypatch, tmp_path, "grep",
                                        "mid-fold", True, step=6)
    assert crashed["widens"] >= 1
    assert res == _want("grep", True)
    assert stats["table_cap"] >= crashed["table_cap"] > 8
    assert "resharded_resume" not in stats


@pytest.mark.parametrize("engine", ["grep", "idx"])
def test_resume_across_mesh_degrees(monkeypatch, tmp_path, engine):
    """A full image saved with the services mesh-sharded 2 ways resumes
    with them unsharded, through the images' drains."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, "mid-fold", 4)
    with pytest.raises(FaultInjected):
        _run(engine, ckpt=ck, dacc=True, mesh_shards=2)
    _disarm(monkeypatch)
    stats: dict = {}
    assert _run(engine, ckpt=ck, resume=True, dacc=True,
                stats=stats) == _want(engine, True)
    assert stats["resharded_resume"] == 2 and _cursor(stats) > 0


# ── TF-IDF ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize("case", ["sync", "async_delta", "buffer_overflow",
                                  "host_delta"])
def test_tfidf_crash_resume_matches_reference(monkeypatch, tmp_path, case):
    """``tests/test_checkpoint.py``'s two TF-IDF cases (the postings buffer
    on, sync every 2 waves; async delta every wave), the buffer at 16
    rows so appends overflow and recover across the checkpoints, and the
    buffer off with a delta chain of the pulled waves."""
    kw = {"sync": dict(dacc=True),
          "async_delta": dict(dacc=True, every=1, async_=True, delta=True),
          "buffer_overflow": dict(dacc=True, every=1),
          "host_delta": dict(dacc=False, every=1, delta=True)}[case]
    if case == "buffer_overflow":
        monkeypatch.setenv("DSI_DEVICE_POSTINGS_CAP", "16")
    res, crashed, stats = _crash_resume(monkeypatch, tmp_path, "tfidf",
                                        "mid-fold", **kw)
    assert res == _want("tfidf", False)
    assert stats["resume_wave"] > 0
    if case == "buffer_overflow":
        assert crashed["append_overflows"] >= 1


# ── chains across the two packages ─────────────────────────────────────


def _ref_run(engine, ck, **kw):
    j_reset_faults()
    if engine == "grep":
        return jg.grep_streaming([GREP_TEXT], "ab", mesh=_mesh(), depth=2,
                                 device_accumulate=True, checkpoint_dir=ck,
                                 checkpoint_every=2, **GREP_KW, **kw)
    return jg.indexer_streaming(IDX_DOCS, mesh=_mesh(), depth=2,
                                device_accumulate=True, checkpoint_dir=ck,
                                checkpoint_every=2, **IDX_KW, **kw)


@pytest.mark.parametrize("engine", ["grep", "idx"])
def test_port_resumes_a_reference_chain(monkeypatch, tmp_path, engine):
    """The reference crashes mid-fold with the services on; the port
    resumes its chain (the reference's images through ``restore_state``)."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, "mid-fold", 4)
    with pytest.raises(JFaultInjected):
        _ref_run(engine, ck)
    _disarm(monkeypatch)
    stats: dict = {}
    assert _run(engine, ckpt=ck, resume=True, dacc=True,
                stats=stats) == _want(engine, True)
    assert _cursor(stats) > 0 and "resharded_resume" not in stats


@pytest.mark.parametrize("engine", ["grep", "idx"])
def test_reference_resumes_a_port_chain(monkeypatch, tmp_path, engine):
    """The port crashes after a delta landed (async, services on); the
    reference resumes the port's chain to its own uninterrupted result."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, "post-ckpt", 2)
    with pytest.raises(FaultInjected):
        _run(engine, ckpt=ck, dacc=True, async_=True, delta=True)
    _disarm(monkeypatch)
    assert any(n.startswith("delta-") for n in os.listdir(ck))
    stats: dict = {}
    key = "pipeline_stats" if engine == "grep" else "stats"
    got = _ref_run(engine, ck, checkpoint_async=True, checkpoint_delta=True,
                   resume=True, **{key: stats})
    assert got == _want(engine, True) and _cursor(stats) > 0


# ── the CLI: a real crash and a fresh process ──────────────────────────


def test_cli_real_crash_then_resume(tmp_path, monkeypatch, capsys):
    """``grepstream --device cpu`` dies at ``mid-fold`` with exit 87 (an
    ``os._exit`` in a subprocess, no unwind); ``--resume --check`` (in this
    process) prints the host oracle's result and parity OK."""
    from dsi_tpu_torch.cli import grepstream

    corpus = tmp_path / "g.txt"
    corpus.write_bytes(GREP_TEXT * 2)
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("DSI_FAULT_MODE", "DSI_FAULT_POINT", "DSI_FAULT_STEP"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "dsi_tpu_torch.cli.grepstream", "--device",
           "cpu", "--devices", "2", "--pattern", "ab", "--chunk-bytes",
           "8192", "--device-accumulate", "--sync-every", "2",
           "--checkpoint-dir", ck, "--checkpoint-every", "1", str(corpus)]
    p = subprocess.run(cmd, env=dict(env, DSI_FAULT_POINT="mid-fold",
                                     DSI_FAULT_STEP="3"),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == FAULT_EXIT, p.stderr[-2000:]
    assert p.stdout == ""
    _disarm(monkeypatch)
    reset_faults()
    assert grepstream.main(cmd[3:] + ["--resume", "--check"]) == 0
    out, err = capsys.readouterr()
    assert "parity OK" in err and "no usable checkpoint" not in err
    want = jg.grep_host_oracle([GREP_TEXT * 2], "ab")
    assert out.splitlines()[0] == (f"lines={want.lines} "
                                   f"matched={want.matched} "
                                   f"occurrences={want.occurrences}")


def test_cli_resume_refusals(tmp_path, capsys):
    """``--resume`` without a checkpoint dir is a usage error; a chain of
    another pattern is refused (rc 1); an empty dir warns and starts over."""
    from dsi_tpu_torch.cli import grepstream

    corpus = tmp_path / "g.txt"
    corpus.write_bytes(GREP_TEXT)
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--chunk-bytes", "8192", "--checkpoint-dir",
            ck, "--checkpoint-every", "1", str(corpus)]
    with pytest.raises(SystemExit):
        grepstream.main(["--pattern", "ab", "--resume", str(corpus)])
    assert grepstream.main(["--pattern", "ab", "--resume", *base]) == 0
    assert "no usable checkpoint" in capsys.readouterr().err
    assert grepstream.main(["--pattern", "line", "--resume", *base]) == 1
    assert "job" in capsys.readouterr().err


def test_batch_lines_offsets_match_reference():
    """The cursor hook: the offset after each batch, and a resume from
    any of them reproduces the rest of the batches, as the reference's."""
    from dsi_tpu_torch.ckpt import skip_stream

    blocks = [GREP_TEXT[i:i + 997] for i in range(0, len(GREP_TEXT), 997)]
    mine, ref = [], []
    got = [(b.copy(), n.copy(), r.copy())
           for b, n, r in tg.batch_lines(blocks, 4, 1024, offsets=mine)]
    want = [(b.copy(), n.copy(), r.copy())
            for b, n, r in jg.batch_lines(blocks, 4, 1024, offsets=ref)]
    assert mine == ref and len(got) == len(want) == len(mine)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    at = len(mine) // 2
    tail = [b.copy() for b, _, _ in tg.batch_lines(
        skip_stream(blocks, mine[at - 1]), 4, 1024)]
    assert len(tail) == len(got) - at
    for g, w in zip(tail, got[at:]):
        np.testing.assert_array_equal(g, w[0])
