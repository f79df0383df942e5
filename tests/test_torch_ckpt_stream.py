"""Crash-resume of the port's streaming word count against the JAX package,
on the CPU.

The shapes of ``tests/test_checkpoint.py``: a ~38 KB stream of 120 words
at 1 KiB chunks over 4 virtual shards (~10 steps), a checkpoint every 2
confirmed steps, a fault armed at a named point (``DSI_FAULT_MODE=raise``,
so the grid runs in one process), then a resume from whatever chain
survived.  The port's resumed result must equal the reference's
uninterrupted run (``dsi_tpu.parallel.streaming.wordcount_streaming`` on
a 4-device virtual CPU mesh, computed once per configuration), counts
and partitions, bit for bit.  Chains cross between the packages in both
directions, and the CLI is killed for real (``os._exit(87)`` in a
subprocess) and finished with ``--resume``.
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
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import streaming as jst
from dsi_tpu_torch.ckpt import (
    FAULT_EXIT,
    FAULT_POINTS,
    FaultInjected,
    reset_faults,
)
from dsi_tpu_torch.parallel import streaming as tst
from dsi_tpu_torch.utils.ioread import ParallelBlocks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 4


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


WC_WORDS = [_letters(i) for i in range(120)]
WC_TEXT = ((" ".join(WC_WORDS) + "\n") * 80).encode()  # ~38 KB, ~10 steps
WC_CHUNK = 1 << 10
KW = dict(n_reduce=10, chunk_bytes=WC_CHUNK, u_cap=256, sync_every=2)

#: The occurrence to kill at: a checkpoint exists before every crash
#: (every=2), so a resume restores real state.
FAULT_AT = {"post-dispatch": 4, "mid-fold": 4, "pre-sync": 2,
            "post-ckpt": 2, "mid-capture": 2, "mid-commit": 2}


@functools.lru_cache(maxsize=None)
def _want(dacc: bool):
    """The reference's uninterrupted run, once per configuration."""
    got = jst.wordcount_streaming([WC_TEXT], mesh=js.default_mesh(N_DEV),
                                  depth=2, device_accumulate=dacc, **KW)
    assert got is not None
    return got


def _arm(monkeypatch, point, step):
    monkeypatch.setenv("DSI_FAULT_MODE", "raise")
    monkeypatch.setenv("DSI_FAULT_POINT", point)
    monkeypatch.setenv("DSI_FAULT_STEP", str(step))


def _disarm(monkeypatch):
    for k in ("DSI_FAULT_MODE", "DSI_FAULT_POINT", "DSI_FAULT_STEP"):
        monkeypatch.delenv(k, raising=False)


def _run(blocks=None, ckpt=None, resume=False, dacc=False, depth=2,
         stats=None, async_=None, delta=None, every=2, **kw):
    reset_faults()
    return tst.wordcount_streaming(
        [WC_TEXT] if blocks is None else blocks, n_dev=N_DEV,
        device="cpu", depth=depth, device_accumulate=dacc,
        checkpoint_dir=ckpt, checkpoint_every=every,
        checkpoint_async=async_, checkpoint_delta=delta, resume=resume,
        pipeline_stats=stats, **{**KW, **kw})


def _crash_resume(monkeypatch, tmp_path, point, dacc, **kw):
    """A run with the fault armed (it must fire), then a resume; returns
    (result, the crashed run's stats, the resumed run's stats)."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, point, FAULT_AT[point])
    crashed: dict = {}
    with pytest.raises(FaultInjected):
        _run(ckpt=ck, dacc=dacc, stats=crashed, **kw)
    _disarm(monkeypatch)
    stats: dict = {}
    res = _run(ckpt=ck, resume=True, dacc=dacc, stats=stats, **kw)
    return res, crashed, stats


# ── the grid: every fault point, table off and on ─────────────────────

GRID = [(p, d) for p in FAULT_POINTS for d in (False, True)
        if d or p != "pre-sync"]  # pre-sync is a table sync point


@pytest.mark.parametrize("point,dacc", GRID)
def test_crash_resume_matches_reference(monkeypatch, tmp_path, point, dacc):
    res, _, stats = _crash_resume(monkeypatch, tmp_path, point, dacc)
    assert res == _want(dacc)
    if point in ("post-ckpt", "mid-fold"):
        # A checkpoint existed before the crash: the resume sought past
        # its cursor instead of replaying from byte 0.
        assert stats["resume_cursor"] > 0


@pytest.mark.parametrize("point,dacc", [
    ("mid-capture", True), ("mid-commit", True), ("post-ckpt", True),
    ("mid-fold", False)])
def test_async_delta_crash_resume_matches_reference(monkeypatch, tmp_path,
                                                    point, dacc):
    """A death during a capture, during a background commit or after a
    delta landed: the chain that survived restores (base, then its deltas
    drained in save order) to the uninterrupted result.  The table-off
    case runs the host delta log."""
    res, _, stats = _crash_resume(monkeypatch, tmp_path, point, dacc,
                                  async_=True, delta=True)
    assert res == _want(dacc)
    assert stats["ckpt_async"] and stats["ckpt_delta"]


def test_resume_across_forced_widen(monkeypatch, tmp_path):
    """A table far below the vocabulary (``DSI_DEVICE_TABLE_CAP``) widens
    before the crash; the full image carries the widened capacity, which
    the resumed table keeps (restore_state, not a drain)."""
    monkeypatch.setenv("DSI_DEVICE_TABLE_CAP", "16")
    monkeypatch.setitem(FAULT_AT, "mid-fold", 6)
    res, crashed, stats = _crash_resume(monkeypatch, tmp_path, "mid-fold",
                                        True)
    assert crashed["widens"] >= 1
    assert res == _want(True)
    assert stats["table_cap"] >= crashed["table_cap"] > 16
    assert "resharded_resume" not in stats


def test_resume_across_mesh_degrees(monkeypatch, tmp_path):
    """A full image saved with the table mesh-sharded 2 ways resumes with
    the table unsharded through ``DeviceTable.drain_image`` (a delta chain
    drains on every resume, so the grid above covers that)."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, "mid-fold", 6)
    with pytest.raises(FaultInjected):
        _run(ckpt=ck, dacc=True, mesh_shards=2)
    _disarm(monkeypatch)
    stats: dict = {}
    res = _run(ckpt=ck, resume=True, dacc=True, stats=stats)
    assert res == _want(True)
    assert stats["resharded_resume"] == 2 and stats["resume_cursor"] > 0


@pytest.mark.parametrize("point", ["mid-fold", "post-ckpt"])
def test_crash_resume_with_reader_pool(monkeypatch, tmp_path, point):
    """Readahead in flight at the crash (3 readers, 2 KiB blocks): the
    cursor counts only what the batcher consumed, so a resume with 2
    readers reads the same bytes on."""
    path = tmp_path / "c.txt"
    path.write_bytes(WC_TEXT)
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, point, FAULT_AT[point])
    with pytest.raises(FaultInjected):
        _run(ParallelBlocks([str(path)], block_bytes=2048, readers=3),
             ckpt=ck)
    _disarm(monkeypatch)
    stats: dict = {}
    res = _run(ParallelBlocks([str(path)], block_bytes=2048, readers=2),
               ckpt=ck, resume=True, stats=stats)
    assert res == _want(False)
    assert stats["resume_cursor"] > 0 and stats["ingest_readers"] == 2


def test_resume_skips_confirmed_work(monkeypatch, tmp_path):
    """A resume restores and replays the tail: it dispatches fewer steps
    than the whole stream holds, at depth 3 too."""
    full: dict = {}
    assert _run(stats=full) == _want(False)
    res, _, stats = _crash_resume(monkeypatch, tmp_path, "post-ckpt", False,
                                  depth=3)
    assert res == _want(False)
    assert 0 < stats["resume_cursor"] < len(WC_TEXT)
    assert stats["steps"] < full["steps"]


def test_delta_rebase_cadence_and_counters(monkeypatch, tmp_path):
    """Cadence-1 deltas with ``DSI_STREAM_CKPT_REBASE=4``: the first save
    is full, at most 3 deltas chain on each full, the byte counters are
    filled and the chain restores to the uninterrupted result."""
    monkeypatch.setenv("DSI_STREAM_CKPT_REBASE", "4")
    ck = str(tmp_path / "ck")
    stats: dict = {}
    assert _run(ckpt=ck, dacc=True, every=1, async_=True, delta=True,
                stats=stats) == _want(True)
    saves, deltas = stats["ckpt_saves"], stats["ckpt_deltas"]
    fulls = saves - deltas
    assert saves >= 5 and 0 < deltas < saves and fulls >= (saves + 3) // 4
    assert stats["ckpt_full_bytes"] > 0 and stats["ckpt_delta_bytes"] > 0
    for key in ("ckpt_s", "ckpt_capture_s", "ckpt_commit_s"):
        assert stats[key] > 0.0
    assert _run(ckpt=ck, resume=True, dacc=True, every=1, async_=True,
                delta=True) == _want(True)


def test_suspend_then_resume(tmp_path):
    """The step object's eviction: ``suspend()`` commits a snapshot at a
    confirmed boundary and releases; a fresh ``resume=True`` step
    continues to the uninterrupted result and reports its cursor."""
    ck = str(tmp_path / "ck")
    kw = dict(n_dev=N_DEV, device="cpu", depth=2, device_accumulate=True,
              checkpoint_dir=ck, checkpoint_every=100, **KW)
    step = tst.WordcountStep([WC_TEXT], **kw)
    assert step.advance_slice(5) == 5
    assert step.suspend() and step.phase == "suspended"
    assert step.cursor > 0 and step.close() is None
    resumed = tst.WordcountStep([WC_TEXT], resume=True, **kw)
    assert resumed.restore()["resume_cursor"] == step.cursor
    assert resumed.close() == _want(True)


# ── chains across the two packages ─────────────────────────────────────


def test_port_resumes_a_reference_chain(monkeypatch, tmp_path):
    """The reference crashes mid-fold with the table on; the port resumes
    its chain (the reference's image through ``restore_state``)."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, "mid-fold", 4)
    j_reset_faults()
    with pytest.raises(JFaultInjected):
        jst.wordcount_streaming([WC_TEXT], mesh=js.default_mesh(N_DEV),
                                depth=2, device_accumulate=True,
                                checkpoint_dir=ck, checkpoint_every=2, **KW)
    _disarm(monkeypatch)
    stats: dict = {}
    assert _run(ckpt=ck, resume=True, dacc=True, stats=stats) == _want(True)
    assert stats["resume_cursor"] > 0 and "resharded_resume" not in stats


def test_reference_resumes_a_port_chain(monkeypatch, tmp_path):
    """The port crashes after a delta landed (async, table on); the
    reference resumes the port's chain to its own uninterrupted result."""
    ck = str(tmp_path / "ck")
    _arm(monkeypatch, "post-ckpt", 3)
    with pytest.raises(FaultInjected):
        _run(ckpt=ck, dacc=True, async_=True, delta=True)
    _disarm(monkeypatch)
    assert any(n.startswith("delta-") for n in os.listdir(ck))
    j_reset_faults()
    stats: dict = {}
    got = jst.wordcount_streaming(
        [WC_TEXT], mesh=js.default_mesh(N_DEV), depth=2,
        device_accumulate=True, checkpoint_dir=ck, checkpoint_every=2,
        checkpoint_async=True, checkpoint_delta=True, resume=True,
        pipeline_stats=stats, **KW)
    assert got == _want(True) and stats["resume_cursor"] > 0


# ── the CLI: a real crash and a fresh process ──────────────────────────


def test_cli_real_crash_then_resume(tmp_path, monkeypatch, capsys):
    """``wcstream --device cpu`` dies at ``post-ckpt`` with exit 87 (an
    ``os._exit`` in a subprocess, no unwind); ``--resume`` (in this
    process) writes ``mr-out-*`` whose sorted lines equal the sequential
    oracle's."""
    from dsi_tpu_torch.apps import wc
    from dsi_tpu_torch.cli import wcstream
    from dsi_tpu_torch.mr.sequential import run_sequential

    corpus = tmp_path / "c.txt"
    corpus.write_bytes(WC_TEXT)
    ck, wd = str(tmp_path / "ck"), str(tmp_path / "wd")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("DSI_FAULT_MODE", "DSI_FAULT_POINT", "DSI_FAULT_STEP"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "dsi_tpu_torch.cli.wcstream", "--device",
           "cpu", "--devices", "2", "--chunk-bytes", "4096",
           "--device-accumulate", "--sync-every", "2", "--checkpoint-dir",
           ck, "--checkpoint-every", "1", "--workdir", wd, str(corpus)]
    p = subprocess.run(cmd, env=dict(env, DSI_FAULT_POINT="post-ckpt",
                                     DSI_FAULT_STEP="2"),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == FAULT_EXIT, p.stderr[-2000:]
    assert not os.path.exists(wd)
    _disarm(monkeypatch)
    reset_faults()
    assert wcstream.main(cmd[3:] + ["--resume"]) == 0
    assert "no usable checkpoint" not in capsys.readouterr().err
    got = []
    for r in range(10):
        with open(os.path.join(wd, f"mr-out-{r}"), "rb") as f:
            got += [ln for ln in f.read().split(b"\n") if ln]
    oracle = str(tmp_path / "mr-correct.txt")
    run_sequential(wc.Map, wc.Reduce, [str(corpus)], oracle)
    with open(oracle, "rb") as f:
        want = sorted(ln for ln in f.read().split(b"\n") if ln)
    assert sorted(got) == want


def test_batch_stream_offsets_match_reference():
    """The cursor hook: the offset after each batch, and a resume from any
    of them reproduces the rest of the batches, as the reference's."""
    text = ("alpha beta gamma delta epsilon " * 300).encode()
    blocks = [text[i:i + 997] for i in range(0, len(text), 997)]
    mine, ref = [], []
    got = [b.copy() for b in tst.batch_stream(blocks, 4, 256, offsets=mine)]
    jst_batches = [b.copy() for b in jst.batch_stream(blocks, 4, 256,
                                                      offsets=ref)]
    assert mine == ref and len(got) == len(jst_batches) == len(mine)
    for g, w in zip(got, jst_batches):
        np.testing.assert_array_equal(g, w)
    from dsi_tpu_torch.ckpt import skip_stream

    at = len(mine) // 2
    tail = [b.copy() for b in tst.batch_stream(
        skip_stream(blocks, mine[at - 1]), 4, 256)]
    assert len(tail) == len(got) - at
    for g, w in zip(tail, got[at:]):
        np.testing.assert_array_equal(g, w)
