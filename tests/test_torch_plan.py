"""The port's plan layer against the JAX package's, on the CPU.

The emit epilogue's plain version (``grep_step_plain(emit=True)``, K16e)
is held to the reference's emit program at 1 and 8 rows, on the
optimistic ``l_cap`` rung and on one that overflows.  ``GrepStep``'s line
sink and ``WordcountStep``'s device batches are held to the reference's
engines.  ``run_plan`` is held to the reference's ``run_plan`` (on its
8-device virtual mesh) over ``tests/test_plan.py``'s corpora: the depth x
device_accumulate x mesh_shards grid chained, staged and pipelined,
``stage_shards`` over files, the grep→grep cascade, word count → top-k,
the indexer chain with the device services off and on, forced table and
top-k widens, a spill and the short-lines replay; ``planrun --device
cpu --check`` for every chain writes what the reference's CLI writes.
Everything is compared exactly.  Each reference result is computed once.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dsi_tpu import plan as jp
from dsi_tpu.cli import planrun as jcli
from dsi_tpu.device import relay as jr
from dsi_tpu.device import table as jt
from dsi_tpu.parallel import grepstream as jgs
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import streaming as jst
from dsi_tpu.utils.jaxcompat import enable_x64
from dsi_tpu_torch import plan as tp
from dsi_tpu_torch.cli import planrun as tcli
from dsi_tpu_torch.device import relay as tr
from dsi_tpu_torch.parallel import grepstream as tgs
from dsi_tpu_torch.parallel import streaming as tst

N_DEV = 8


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


def corpus(n=420, wide_vocab=False, short_lines=False):
    """``tests/test_plan.py``'s corpus: matching lines carry 'the' plus a
    vocabulary; fillers do not."""
    lines = []
    for i in range(n):
        if i % 3 == 0:
            if wide_vocab:
                lines.append("the " + " ".join(
                    f"w{chr(97 + (i * 7 + j) % 26)}"
                    f"{chr(97 + (i * 3 + j) % 26)}q" for j in range(12)))
            elif short_lines:
                lines.append(f"the a{i % 9}")
            else:
                lines.append(f"the quick w{i % 29} fox likes the pond")
        else:
            lines.append("x" if short_lines else
                         f"unrelated filler row{i} content")
    return ("\n".join(lines) + "\n").encode()


DOCS = [f"alpha beta w{i % 7} gamma shared doc{i % 3} tail".encode()
        for i in range(13)]


# ── K16e: the emit epilogue ──────────────────────────────────────────────


def _emit_batch(n_dev: int, n: int = 2048, seed: int = 5):
    """Rows of short and long lines, some with 'the', and bytes past the
    valid length that would match if they counted."""
    rng = np.random.default_rng(seed)
    chunks = np.zeros((n_dev, n), np.uint8)
    lens = np.zeros(n_dev, np.int32)
    for d in range(n_dev):
        text = b""
        while len(text) < n - 64:
            text += (b"the cat " if rng.random() < 0.3 else b"xy ") * int(
                rng.integers(0, 4)) + b"\n"
        text = text[:n - 64 - int(rng.integers(0, 8))]
        chunks[d, :len(text)] = np.frombuffer(text, np.uint8)
        chunks[d, len(text):len(text) + 6] = np.frombuffer(b"thethe",
                                                           np.uint8)
        lens[d] = len(text)
    pats = np.tile(np.frombuffer(b"the", np.uint8), (n_dev, 1))
    bases = (np.arange(n_dev) * 1000).astype(np.int64)
    return chunks, pats, lens, bases


def _ref_emit(chunks, pats, lens, bases, *, l_cap, bins, k):
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
                      mesh=mesh, emit=True)
    with jt._quiet_unusable_donation():
        return [np.asarray(x) for x in fn(*args)]


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("l_cap", [2049, 64])  # optimistic, overflowing
def test_grep_step_emit_matches_reference(n_dev, l_cap):
    chunks, pats, lens, bases = _emit_batch(n_dev)
    want = _ref_emit(chunks, pats, lens, bases, l_cap=l_cap, bins=8, k=4)
    got = tgs.grep_step_plain(torch.from_numpy(chunks),
                              torch.from_numpy(pats), torch.from_numpy(lens),
                              torch.from_numpy(bases), l_cap=l_cap, bins=8,
                              k=4, emit=True)
    got = [g.numpy() for g in got]
    for w, g in zip(want, got):
        assert np.array_equal(w.view(g.dtype) if w.dtype.itemsize
                              == g.dtype.itemsize else w, g)
    assert bool(want[2][:, 2].any()) == (l_cap == 64)
    # The grep_step wrapper on the CPU: the same outputs, comp its own.
    got2 = tgs.grep_step(*(torch.from_numpy(a) for a in (chunks, pats, lens,
                                                         bases)),
                         l_cap=l_cap, bins=8, k=4, emit=True)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(got2, got))


# ── the engines' handoff hooks ───────────────────────────────────────────


def _blocks(data: bytes, n: int = 3):
    step = len(data) // n + 1
    return [data[i:i + step] for i in range(0, len(data), step)]


@functools.lru_cache(maxsize=None)
def _ref_line_sink(short_lines: bool):
    relay = jr.HostRelay()
    st = jgs.GrepStep(_blocks(corpus(short_lines=short_lines)), "the",
                      mesh=_mesh(N_DEV), chunk_bytes=512, depth=2,
                      line_sink=relay)
    return st.close(), b"".join(relay.blocks())


@pytest.mark.parametrize("short_lines", [False, True])
def test_grep_step_line_sink_matches_reference(short_lines):
    want_res, want_bytes = _ref_line_sink(short_lines)
    relay, stats = tr.HostRelay(), {}
    res = tgs.GrepStep(_blocks(corpus(short_lines=short_lines)), "the",
                       n_dev=N_DEV, chunk_bytes=512, depth=2,
                       line_sink=relay, pipeline_stats=stats,
                       device="cpu").close()
    assert res == want_res
    assert b"".join(relay.blocks()) == want_bytes
    lines = [ln for ln in corpus(short_lines=short_lines).split(b"\n")
             if b"the" in ln]
    assert sorted(want_bytes.split(b"\n")[:-1]) == sorted(lines)
    assert (stats["replays"] >= 1) == short_lines


@functools.lru_cache(maxsize=None)
def _batches():
    relay = jr.HostRelay()
    jgs.GrepStep(_blocks(corpus(wide_vocab=True)), "the", mesh=_mesh(N_DEV),
                 chunk_bytes=512, line_sink=relay).close()
    data = b"".join(relay.blocks())
    return [b.copy() for b in jst.batch_stream([data], N_DEV, 512)]


@functools.lru_cache(maxsize=None)
def _ref_device_batches():
    sh = NamedSharding(_mesh(N_DEV), P(js.AXIS, None))
    return jst.WordcountStep(
        [], mesh=_mesh(N_DEV), chunk_bytes=512, u_cap=1 << 8,
        device_batches=[jax.device_put(b, sh) for b in _batches()]).close()


@pytest.mark.parametrize("kind", ["tensors", "arrays"])
def test_wordcount_device_batches_matches_reference(kind):
    batches = [torch.from_numpy(b.copy()) if kind == "tensors" else b.copy()
               for b in _batches()]
    stats = {}
    got = tst.WordcountStep([], n_dev=N_DEV, chunk_bytes=512, u_cap=1 << 8,
                            device_batches=batches, pipeline_stats=stats,
                            device="cpu").close()
    assert got == _ref_device_batches()
    assert stats["steps"] == len(batches) and stats["batch_allocs"] == 0


def test_handoff_hooks_refuse_checkpoint_dir(tmp_path):
    with pytest.raises(ValueError, match="exclusive"):
        tst.WordcountStep([], device_batches=iter(()), device="cpu",
                          checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="exclusive"):
        tgs.GrepStep([b"x\n"], "x", line_sink=tr.HostRelay(), device="cpu",
                     checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(NotImplementedError, match="plan and serving"):
        tst.WordcountStep([], input_range=(0, 1), device="cpu")


# ── the plan ─────────────────────────────────────────────────────────────


def _plans(pkg, files):
    data = corpus()
    return {
        "grep-wc": pkg.grep_wordcount_plan("the", data=data, chunk_bytes=512,
                                           depth=2),
        "grep-wc-paths": pkg.grep_wordcount_plan("the", paths=files,
                                                 chunk_bytes=1 << 20),
        "grep-grep": pkg.grep_cascade_plan("the", "pond", data=data,
                                           device_accumulate=True),
        "wc-topk": pkg.wordcount_topk_plan(7, data=data, mesh_shards=8),
        "indexer": pkg.indexer_join_plan(DOCS, topk=5, u_cap=1 << 8),
    }


def test_plan_signature_and_validation():
    files = ["a.txt", "b.txt"]
    ref, port = _plans(jp, files), _plans(tp, files)
    for name in ref:
        assert port[name].signature() == ref[name].signature(), name
    assert port["grep-wc"].signature() != tp.grep_wordcount_plan(
        "the", data=corpus(n=99), chunk_bytes=512, depth=2).signature()
    p = tp.Plan("t")
    p.add(tp.Stage("a", "grep", pattern="x"))
    with pytest.raises(tp.PlanError):
        p.add(tp.Stage("a", "grep", pattern="x"))
    with pytest.raises(tp.PlanError):
        p.add(tp.Stage("b", "wordcount", deps=["nope"]))
    with pytest.raises(tp.PlanError):
        tp.Stage("c", "sort")


def _ref_run(make, **kw):
    return jp.run_plan(make(jp), mesh=_mesh(N_DEV), **kw)


def _port_run(make, **kw):
    st = {}
    res = tp.run_plan(make(tp), n_dev=N_DEV, device="cpu", stats=st, **kw)
    return res, st


GRID = [(1, False, 0), (2, True, 0), (2, True, 8)]


@functools.lru_cache(maxsize=None)
def _ref_grid(depth, dacc, shards):
    return _ref_run(lambda pkg: pkg.grep_wordcount_plan(
        "the", data=corpus(), chunk_bytes=512, depth=depth,
        device_accumulate=dacc, mesh_shards=shards))


@pytest.mark.parametrize("depth,dacc,shards", GRID)
@pytest.mark.parametrize("mode", ["chained", "staged", "pipelined"])
def test_grep_wc_chain_matches_reference(depth, dacc, shards, mode):
    want = _ref_grid(depth, dacc, shards)
    got, st = _port_run(lambda pkg: pkg.grep_wordcount_plan(
        "the", data=corpus(), chunk_bytes=512, depth=depth,
        device_accumulate=dacc, mesh_shards=shards),
        staged=mode == "staged", pipelined=mode == "pipelined")
    assert got.results == want.results and len(got.final) > 0
    assert st["plan_handoff"] == ("host" if mode == "staged" else "device")
    assert st["plan_pipelined"] == int(mode == "pipelined")
    if mode == "staged":
        assert st["plan_intermediate_bytes"] > 0
    else:
        # The device-resident handoff moves no intermediate byte through
        # the host, and the relay sealed at least one buffer.
        assert st["plan_intermediate_bytes"] == 0
        assert st["plan_relay_buffers"] >= 1
    assert set(st["plan_engine_stats"]) == {"grep", "wc"}
    assert st["plan_handoff_bytes"] == sum(
        len(ln) + 1 for ln in corpus().split(b"\n") if b"the" in ln)


def test_grep_wc_stage_shards_matches_reference(tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"pg-{i}.txt"
        p.write_bytes(corpus(n=300 + 50 * i))
        files.append(str(p))

    def make(pkg):
        return pkg.grep_wordcount_plan("the", paths=files, chunk_bytes=512)

    want = _ref_run(make, stage_shards=3)
    assert want.results["grep"].topk == ()  # a sharded merge drops it
    for kw in ({}, {"pipelined": True}, {"staged": True}):
        got, st = _port_run(make, stage_shards=3, **kw)
        assert got.results == want.results, kw
        assert len(st["plan_engine_stats"]["grep"]) == 3
    got, _ = _port_run(make)
    assert got.final == want.final


@pytest.mark.parametrize("chain", ["grep-grep", "wc-topk"])
def test_cascade_and_topk_match_reference(chain):
    def make(pkg):
        if chain == "grep-grep":
            return pkg.grep_cascade_plan("the", "pond", data=corpus(),
                                         chunk_bytes=512)
        return pkg.wordcount_topk_plan(7, data=corpus(), chunk_bytes=512)

    want = _ref_run(make)
    got, st = _port_run(make)
    staged, _ = _port_run(make, staged=True)
    assert got.results == want.results == staged.results
    if chain == "grep-grep":
        # The cascade reads the first relay through the host, counted.
        assert st["plan_intermediate_bytes"] == st["plan_handoff_bytes"] \
            - sum(len(ln) + 1 for ln in corpus().split(b"\n")
                  if b"pond" in ln)
        assert got.final.topk == ()
    else:
        assert len(got.final) == 7


@pytest.mark.parametrize("dacc", [False, True])
def test_indexer_chain_matches_reference(dacc):
    def make(pkg):
        return pkg.indexer_join_plan(DOCS, topk=5, device_accumulate=dacc,
                                     u_cap=1 << 8)

    want = _ref_run(make)
    got, st = _port_run(make)
    staged, _ = _port_run(make, staged=True)
    assert got.results["dftopk"] == want.results["dftopk"] \
        == staged.results["dftopk"]
    assert got.final == want.final == staged.final and len(got.final) == 5
    assert got.results["indexer"] is None  # the chained handoff marker


def test_forced_widens_match_reference(monkeypatch):
    # A tiny device-table rung and a wide matching-line vocabulary force
    # the word-count stage's widen inside the chain.
    def gw(pkg):
        return pkg.grep_wordcount_plan("the", data=corpus(wide_vocab=True),
                                       chunk_bytes=512,
                                       device_accumulate=True, sync_every=3)

    def idx(pkg):
        return pkg.indexer_join_plan(DOCS, topk=5, device_accumulate=True,
                                     u_cap=1 << 8)

    want_gw, want_idx = _ref_run(gw, staged=True), _ref_run(idx, staged=True)
    monkeypatch.setenv("DSI_DEVICE_TABLE_CAP", "32")
    got, st = _port_run(gw)
    assert got.results == want_gw.results
    assert st["plan_engine_stats"]["wc"]["widens"] >= 1
    # One shard and a 4-row df table: the walk widens, its drains land in
    # the host accumulator, and the df top-k takes the exact drain path.
    monkeypatch.setenv("DSI_DEVICE_TOPK_CAP", "4")
    st = {}
    got = tp.run_plan(idx(tp), n_dev=1, device="cpu", stats=st)
    assert st["plan_engine_stats"]["indexer"]["widens"] >= 1
    assert got.results["dftopk"] == want_idx.results["dftopk"]
    assert got.final == want_idx.final


def test_short_lines_replay_and_spill_match_reference(monkeypatch):
    def make(pkg):
        return pkg.grep_wordcount_plan("the", data=corpus(short_lines=True),
                                       chunk_bytes=512, depth=2)

    want = _ref_run(make)
    got, st = _port_run(make)
    assert got.results == want.results
    assert st["plan_engine_stats"]["grep"]["replays"] >= 1
    # A budget under one buffer: every sealed buffer spills to the host
    # and the consumer uploads it again.
    monkeypatch.setenv("DSI_PLAN_SPILL_MB", "0.001")
    got, st = _port_run(lambda pkg: pkg.grep_wordcount_plan(
        "the", data=corpus(), chunk_bytes=512, depth=2,
        device_accumulate=True, mesh_shards=0))
    assert got.results == _ref_grid(2, True, 0).results
    assert st["plan_spilled_bytes"] > 0
    assert st["plan_intermediate_bytes"] == st["plan_spilled_bytes"]


def test_run_plan_refuses_what_is_not_ported(tmp_path, monkeypatch):
    from dsi_tpu_torch.ckpt import CheckpointMismatch

    plan = tp.grep_wordcount_plan("the", data=corpus(n=9))
    # Stage commits are ported: another plan's store is refused.
    tp.run_plan(plan, device="cpu", checkpoint_dir=str(tmp_path))
    with pytest.raises(CheckpointMismatch):
        tp.run_plan(tp.grep_wordcount_plan("the", data=corpus(n=12)),
                    device="cpu", checkpoint_dir=str(tmp_path), resume=True)
    with pytest.raises(tp.PlanError):
        tp.run_plan(plan, device="cpu", resume=True)
    with pytest.raises(tp.PlanHostPath):
        tp.run_plan(tp.grep_wordcount_plan("th.", data=corpus(n=9)),
                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.run_plan(plan)


# ── planrun ──────────────────────────────────────────────────────────────


CLI_CHAINS = {
    "grep-wc": ["--chain", "grep-wc", "--pattern", "the"],
    "grep-grep": ["--chain", "grep-grep", "--pattern", "the",
                  "--pattern2", "pond"],
    "wc-topk": ["--chain", "wc-topk", "--topk", "5"],
    "indexer": ["--chain", "indexer", "--topk", "5", "--u-cap", "256"],
}


def _outputs(workdir) -> dict:
    out = {}
    for name in sorted(os.listdir(workdir)):
        if name.startswith(("mr-out-", "plan-")) and name != "plan.json":
            with open(os.path.join(workdir, name), "rb") as f:
                out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("planrun")
    files = []
    for i in range(3):
        p = d / f"pg-{i}.txt"
        p.write_bytes(corpus(n=200 + 40 * i))
        files.append(str(p))
    return files


@pytest.mark.parametrize("chain", sorted(CLI_CHAINS))
def test_planrun_matches_reference_cli(chain, cli_files, tmp_path, capsys):
    common = CLI_CHAINS[chain] + ["--chunk-bytes", "1024", "--devices", "8"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert jcli.main(common + ["--workdir", str(ref_dir), *cli_files]) == 0
    stats_path = tmp_path / "plan.json"
    extra = ["--pipeline"] if chain == "grep-wc" else []
    rc = tcli.main(common + extra + [
        "--workdir", str(port_dir), "--check", "--device", "cpu",
        "--stats-json", str(stats_path), *cli_files])
    err = capsys.readouterr().err
    assert rc == 0 and "parity OK (chained vs staged)" in err
    want = _outputs(ref_dir)
    assert want and _outputs(port_dir) == want
    stats = json.loads(stats_path.read_text())
    assert stats["plan_handoff"] == "device"
    if chain == "grep-wc":
        assert stats["plan_intermediate_bytes"] == 0
        assert stats["plan_pipelined"] == 1


@pytest.mark.parametrize("flags,item", [
    (["--hosts"], "#5"),
    # Stage commits are ported: these two cases are the reference's own
    # refusals now.
    pytest.param(["--checkpoint-dir", "ck", "--hosts"], "#5",
                 id="flags1-#4"),
    pytest.param(["--resume"], "--resume requires --checkpoint-dir",
                 id="flags2-#4"),
    (["--trace-dir", "t"], "#5"), (["--aot"], "#7")])
def test_planrun_refuses_what_is_not_ported(flags, item, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--chain", "wc-topk", "--device", "cpu", *flags, "f"])
    assert e.value.code == 2
    assert item in capsys.readouterr().err
