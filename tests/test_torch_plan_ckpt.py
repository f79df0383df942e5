"""The port's plan stage commits against the JAX package's, on the CPU.

The shapes of ``tests/test_plan.py``: its grep→wordcount chain over
``corpus()`` (512-byte chunks) and its indexer chain over ``DOCS``, the
port on 8 virtual shards (``device="cpu"``), the reference on
``tests/conftest.py``'s 8-device mesh.  A fault is armed at a named point
in raise mode (``DSI_FAULT_MODE=raise``, so every case runs in one
process), the run dies there, and a resume from the stage stores must give
the reference's uninterrupted result: ``plan_resumed_stages`` is the
number of stages the reference resumes in the same scenario, and
``final`` (with the df top-k for the indexer) is equal.  Stores cross
between the packages both ways; each stage's newest manifest in the port's
store equals the reference's (meta, array names, dtypes, shapes and
bytes); ``planrun --checkpoint-dir`` crashed and then ``--resume``d writes
the reference CLI's ``mr-out-*`` bytes.  Every comparison is exact.  Each
reference result is computed once per module.
"""

from __future__ import annotations

import functools
import glob
import os

import numpy as np
import pytest
import torch

from dsi_tpu import plan as jp
from dsi_tpu.ckpt import CheckpointMismatch as JCheckpointMismatch
from dsi_tpu.ckpt import CheckpointStore as JCheckpointStore
from dsi_tpu.ckpt import FaultInjected as JFaultInjected
from dsi_tpu.ckpt import reset_faults as j_reset_faults
from dsi_tpu.cli import planrun as jcli
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch import plan as tp
from dsi_tpu_torch.ckpt import (
    CheckpointMismatch,
    CheckpointStore,
    FaultInjected,
    reset_faults,
)
from dsi_tpu_torch.cli import planrun as tcli
from dsi_tpu_torch.plan import driver as td

N_DEV = 8
FAULT_ENV = ("DSI_FAULT_MODE", "DSI_FAULT_POINT", "DSI_FAULT_STEP")


def corpus(n=420):
    """``tests/test_plan.py``'s corpus: matching lines carry 'the' plus a
    vocabulary; fillers do not."""
    lines = []
    for i in range(n):
        if i % 3 == 0:
            lines.append(f"the quick w{i % 29} fox likes the pond")
        else:
            lines.append(f"unrelated filler row{i} content")
    return ("\n".join(lines) + "\n").encode()


DOCS = [f"alpha beta w{i % 7} gamma shared doc{i % 3} tail".encode()
        for i in range(13)]


def gw_plan(pkg, data=None):
    return pkg.grep_wordcount_plan("the", data=corpus() if data is None
                                   else data, chunk_bytes=1 << 9)


def idx_plan(pkg):
    return pkg.indexer_join_plan(DOCS, topk=5, device_accumulate=True,
                                 u_cap=1 << 8)


PLANS = {"grep-wc": gw_plan, "indexer": idx_plan}


@pytest.fixture(autouse=True)
def _hermetic_env(monkeypatch):
    """Engine knobs another test file may have left set take no part."""
    for var in ("DSI_PLAN_SPILL_MB", "DSI_DEVICE_TABLE_CAP",
                "DSI_DEVICE_TOPK_CAP", "DSI_DEVICE_POSTINGS_CAP",
                "DSI_STREAM_MESH_SHARDS", "DSI_STREAM_SYNC_EVERY",
                "DSI_STREAM_PIPELINE_DEPTH", "DSI_STREAM_CKPT_COMPRESS",
                *FAULT_ENV):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain versions run torch ops above the intra-op grain.
    On a host busy with the other test workers, torch's thread pool
    oversubscribes the cores and a plan run takes tens of times longer;
    one thread keeps the file's cost that of its work.  The setting is
    restored for the worker's next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _mesh():
    return js.default_mesh(N_DEV)


def _arm(monkeypatch, point, step=1):
    reset_faults()
    j_reset_faults()
    monkeypatch.setenv("DSI_FAULT_MODE", "raise")
    monkeypatch.setenv("DSI_FAULT_POINT", point)
    monkeypatch.setenv("DSI_FAULT_STEP", str(step))


def _disarm(monkeypatch):
    for k in FAULT_ENV:
        monkeypatch.delenv(k, raising=False)
    reset_faults()
    j_reset_faults()


def _port(make, **kw):
    st: dict = {}
    res = tp.run_plan(make(tp), n_dev=N_DEV, device="cpu", stats=st, **kw)
    return res, st


def _ref(make, **kw):
    st: dict = {}
    res = jp.run_plan(make(jp), mesh=_mesh(), stats=st, **kw)
    return res, st


def _crash(run, make, monkeypatch, point, step, exc, **kw):
    """``run`` (:func:`_port` or :func:`_ref`) killed at ``point`` #step."""
    _arm(monkeypatch, point, step)
    with pytest.raises(exc):
        run(make, **kw)
    _disarm(monkeypatch)


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """The reference's uninterrupted checkpointed run of each plan: its
    result, and the store it left."""
    @functools.lru_cache(maxsize=None)
    def get(name):
        ck = str(tmp_path_factory.mktemp(f"ref-{name}"))
        return _ref(PLANS[name], checkpoint_dir=ck)[0], ck

    return get


# ── the fault points, the torn manifest, the refusals ───────────────────


@pytest.mark.parametrize("point,step,resumed", [
    ("plan-stage0-advance", 2, 0),   # inside the grep: nothing committed
    ("plan-stage1-advance", 1, 1),   # the word count's entry
    ("plan-stage1-advance", 3, 1),   # inside the word count
    ("post-stage-commit", 1, 1),     # right after the grep's manifest
])
def test_chain_crash_resume_every_fault_point(tmp_path, monkeypatch, ref_ckpt,
                                              point, step, resumed):
    want = ref_ckpt("grep-wc")[0]
    ck = str(tmp_path / "ck")
    _crash(_port, gw_plan, monkeypatch, point, step, FaultInjected,
           checkpoint_dir=ck)
    res, st = _port(gw_plan, checkpoint_dir=ck, resume=True)
    assert st["plan_resumed_stages"] == resumed
    assert res.final == want.final and len(res.final) > 0
    assert res.results["grep"] == want.results["grep"]
    assert st["plan_commit_bytes"] > 0 and st["stage_commit_s"] > 0


def test_torn_stage_manifest_falls_back(tmp_path, ref_ckpt):
    ck = str(tmp_path / "ck")
    _port(gw_plan, checkpoint_dir=ck)
    # Tear the last stage's manifest: the resume falls back to the grep's
    # commit and runs only the word count again.
    m = sorted(glob.glob(os.path.join(ck, "stage01-wc",
                                      "manifest-*.json")))[-1]
    with open(m, "r+b") as f:
        f.write(b"GARBAGE")
    res, st = _port(gw_plan, checkpoint_dir=ck, resume=True)
    assert st["plan_resumed_stages"] == 1
    assert res.final == ref_ckpt("grep-wc")[0].final


@pytest.mark.parametrize("store", ["other_plan", "staged_store"])
def test_resume_refuses_another_job(tmp_path, store):
    ck = str(tmp_path / "ck")
    if store == "other_plan":
        _port(gw_plan, checkpoint_dir=ck)
        with pytest.raises(CheckpointMismatch):
            _port(lambda pkg: gw_plan(pkg, corpus(n=99)), checkpoint_dir=ck,
                  resume=True)
        return
    # A store written staged, resumed chained: both packages refuse it.
    _port(gw_plan, checkpoint_dir=ck, staged=True)
    with pytest.raises(CheckpointMismatch):
        _port(gw_plan, checkpoint_dir=ck, resume=True)
    with pytest.raises(JCheckpointMismatch):
        _ref(gw_plan, checkpoint_dir=ck, resume=True)


def test_indexer_chain_crash_resume(tmp_path, monkeypatch, ref_ckpt):
    want = ref_ckpt("indexer")[0]
    ck = str(tmp_path / "ck")
    _crash(_port, idx_plan, monkeypatch, "plan-stage1-advance", 1,
           FaultInjected, checkpoint_dir=ck)
    res, st = _port(idx_plan, checkpoint_dir=ck, resume=True)
    assert st["plan_resumed_stages"] == 1
    assert res.results["dftopk"] == want.results["dftopk"]
    assert res.final == want.final and len(res.final) == 5


@pytest.mark.parametrize("chain", ["grep-grep", "wc-topk"])
def test_other_chains_crash_resume(tmp_path, monkeypatch, chain):
    """The cascade reads a restored relay through ``host_blocks``; the
    top-k reads the word count's decoded counts."""
    def make(pkg):
        if chain == "grep-grep":
            return pkg.grep_cascade_plan("the", "pond", data=corpus(),
                                         chunk_bytes=512)
        return pkg.wordcount_topk_plan(7, data=corpus(), chunk_bytes=512)

    want, _ = _ref(make)
    ck = str(tmp_path / "ck")
    _crash(_port, make, monkeypatch, "post-stage-commit", 1, FaultInjected,
           checkpoint_dir=ck)
    res, st = _port(make, checkpoint_dir=ck, resume=True)
    assert st["plan_resumed_stages"] == 1
    assert res.results == want.results


# ── the pipelined pair (the spent-relay rule) and staged mode ───────────


@pytest.mark.parametrize("step,resumed", [(1, 0), (2, 2)])
def test_pipelined_crash_resume_matches_reference(tmp_path, monkeypatch,
                                                  ref_ckpt, step, resumed):
    """``post-stage-commit`` #1 lands after the spent grep's manifest: its
    consumer has none, so both stages run again; #2 after both."""
    want = ref_ckpt("grep-wc")[0]
    got = {}
    for name, run, exc in (("port", _port, FaultInjected),
                           ("ref", _ref, JFaultInjected)):
        ck = str(tmp_path / name)
        _crash(run, gw_plan, monkeypatch, "post-stage-commit", step, exc,
               checkpoint_dir=ck, pipelined=True)
        got[name] = run(gw_plan, checkpoint_dir=ck, resume=True,
                        pipelined=True)
    (res, st), (ref_res, ref_st) = got["port"], got["ref"]
    assert st["plan_resumed_stages"] == ref_st["plan_resumed_stages"] \
        == resumed
    assert res.final == ref_res.final == want.final


def test_staged_crash_resume(tmp_path, monkeypatch, ref_ckpt):
    ck = str(tmp_path / "ck")
    _crash(_port, gw_plan, monkeypatch, "post-stage-commit", 1,
           FaultInjected, checkpoint_dir=ck, staged=True)
    res, st = _port(gw_plan, checkpoint_dir=ck, resume=True, staged=True)
    assert st["plan_resumed_stages"] == 1
    assert res.final == ref_ckpt("grep-wc")[0].final


# ── across the packages ─────────────────────────────────────────────────


@pytest.mark.parametrize("chain,writer", [
    ("grep-wc", "ref"), ("grep-wc", "port"), ("indexer", "port")])
def test_stores_cross_between_packages(tmp_path, monkeypatch, ref_ckpt,
                                       chain, writer):
    """A store left by one package's crashed run (after the first stage's
    commit) is resumed by the other."""
    make = PLANS[chain]
    ck = str(tmp_path / "ck")
    if writer == "ref":
        _crash(_ref, make, monkeypatch, "post-stage-commit", 1,
               JFaultInjected, checkpoint_dir=ck)
        res, st = _port(make, checkpoint_dir=ck, resume=True)
    else:
        _crash(_port, make, monkeypatch, "post-stage-commit", 1,
               FaultInjected, checkpoint_dir=ck)
        res, st = _ref(make, checkpoint_dir=ck, resume=True)
    want = ref_ckpt(chain)[0]
    assert st["plan_resumed_stages"] == 1
    assert res.final == want.final
    if chain == "indexer":
        assert res.results["dftopk"] == want.results["dftopk"]


@pytest.mark.parametrize("chain", sorted(PLANS))
def test_stage_manifests_match_reference(tmp_path, ref_ckpt, chain):
    """Each stage's newest manifest in the port's store, read back through
    both packages' ``load_latest``, equals the reference's: meta, array
    names, dtypes, shapes and bytes."""
    want, ref_dir = ref_ckpt(chain)
    ck = str(tmp_path / "ck")
    res, st = _port(PLANS[chain], checkpoint_dir=ck)
    assert res.final == want.final
    plan = PLANS[chain](tp)
    sig = plan.signature()
    dirs = sorted(os.listdir(ck))
    assert dirs == sorted(os.listdir(ref_dir)) and len(dirs) == len(plan)
    for i, stage in enumerate(plan.ordered()):
        job = {"plan": sig, "stage": stage.name, "staged": False}
        name = f"stage{i:02d}-{stage.name}"
        ref_meta, ref_arrays = JCheckpointStore(
            os.path.join(ref_dir, name), f"plan-{stage.kind}",
            job).load_latest()
        for store_cls in (CheckpointStore, JCheckpointStore):
            meta, arrays = store_cls(os.path.join(ck, name),
                                     f"plan-{stage.kind}", job).load_latest()
            assert meta == ref_meta, name
            assert sorted(arrays) == sorted(ref_arrays), name
            for key, a in arrays.items():
                b = ref_arrays[key]
                assert (a.dtype, a.shape) == (b.dtype, b.shape), (name, key)
                assert np.array_equal(a, b), (name, key)
    assert st["plan_commit_bytes"] > 0


@pytest.mark.parametrize("chain,kw", [
    ("grep-wc", {}), ("grep-wc", {"pipelined": True}), ("indexer", {})])
def test_fault_point_counts_match_reference(tmp_path, monkeypatch, chain,
                                            kw):
    """Each named point fires as often in the port as in the reference,
    so ``DSI_FAULT_STEP`` kills both at the same place."""
    from dsi_tpu.plan import driver as jd

    counts = {}
    for name, mod, run in (("port", td, _port), ("ref", jd, _ref)):
        seen: dict = {}
        monkeypatch.setattr(mod, "fault_point",
                            lambda p, seen=seen: seen.update(
                                {p: seen.get(p, 0) + 1}))
        run(PLANS[chain], checkpoint_dir=str(tmp_path / name), **kw)
        counts[name] = seen
    assert counts["port"] == counts["ref"]
    assert counts["port"]["post-stage-commit"] == len(PLANS[chain](tp))


def test_codecs_round_trip():
    counts = {"a": (3, 1), "the": (7, 4)}
    assert td._decode_counts(td._encode_counts(counts)) == counts
    assert td._decode_counts(td._encode_counts({})) == {}
    top = ((7, "the"), (3, "a"))
    assert td._decode_top(td._encode_top(top)) == top
    join = {"a": (2, 1, (0, 3)), "b": (1, 5, (2,))}
    assert td._decode_join(td._encode_join(join)) == join


# ── planrun ─────────────────────────────────────────────────────────────


def _mr_out(d) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "mr-out-*"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def test_planrun_crash_then_resume_matches_reference_cli(
        tmp_path, monkeypatch, capsys):
    files = []
    for i in range(2):
        p = tmp_path / f"pg-{i}.txt"
        p.write_bytes(corpus(n=200 + 40 * i))
        files.append(str(p))
    common = ["--chain", "grep-wc", "--pattern", "the", "--chunk-bytes",
              "1024", "--devices", str(N_DEV)]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert jcli.main(common + ["--workdir", str(ref_dir), *files]) == 0
    port = common + ["--device", "cpu", "--workdir", str(port_dir),
                     "--checkpoint-dir", str(tmp_path / "ck")]
    _arm(monkeypatch, "post-stage-commit", 1)
    with pytest.raises(FaultInjected):
        tcli.main(port + files)
    _disarm(monkeypatch)
    assert not _mr_out(port_dir)
    capsys.readouterr()
    assert tcli.main(port + ["--resume", *files]) == 0
    err = capsys.readouterr().err
    assert "planrun: resumed past 1 committed stage(s)" in err
    assert "commit_bytes=" in err
    want = _mr_out(ref_dir)
    assert want and _mr_out(port_dir) == want
