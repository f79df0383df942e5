"""The port's compressed chunk uploads against the JAX package, on the CPU.

``wordcount_streaming(wire_upload=True)`` encodes each batch on the host
and decodes it where the step runs (kernel N's plain version here).  On
the seeded stream of ``tests/test_wire_ingest.py`` and in its four
``(device_accumulate, depth, mesh_shards)`` cases, the port's result must
equal the reference's wire run (on the 4-device virtual CPU mesh) and the
port's own raw run, with the same ``wire_steps``, ``wire_raw_steps``,
``wire_packed_bytes`` and ``wire_ratio``.  Also: the ``DSI_STREAM_WIRE``
switch, an input that ships raw in every step, and the ``wcstream
--wire-upload --check`` command.  Tolerance: exact.
"""

from __future__ import annotations

import ast
import os

import pytest

from dsi_tpu.parallel import shuffle as js
from dsi_tpu.parallel import streaming as jst
from dsi_tpu_torch.apps import wc
from dsi_tpu_torch.mr.sequential import run_sequential
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.parallel import streaming as tst
from dsi_tpu_torch.utils.corpus import ensure_corpus

N_DEV = 4
_WIRE_STATS = ("wire_upload", "wire_steps", "wire_raw_steps",
               "wire_packed_bytes", "wire_ratio", "steps")


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


# ``tests/test_wire_ingest.py``'s stream: ~38 KB, ~10 steps of 4 x 1 KiB.
WC_TEXT = ((" ".join(_letters(i) for i in range(120)) + "\n") * 80).encode()
_KW = dict(n_reduce=10, chunk_bytes=1 << 10, u_cap=256)


def _port(blocks, stats=None, **kw):
    return tst.wordcount_streaming(blocks, n_dev=N_DEV, device="cpu",
                                   pipeline_stats=stats, **{**_KW, **kw})


def _ref(blocks, stats=None, **kw):
    return jst.wordcount_streaming(blocks, mesh=js.default_mesh(N_DEV),
                                   pipeline_stats=stats, **{**_KW, **kw})


@pytest.mark.parametrize("dacc,depth,shards", [
    (False, 1, None), (False, 2, None), (True, 2, None), (True, 2, 4),
])
def test_wire_stream_matches_reference(dacc, depth, shards):
    kw = dict(depth=depth, device_accumulate=dacc, mesh_shards=shards)
    got_stats, want_stats = {}, {}
    got = _port([WC_TEXT], got_stats, wire_upload=True, **kw)
    want = _ref([WC_TEXT], want_stats, wire_upload=True, **kw)
    assert got is not None and got == want
    assert got == _port([WC_TEXT], **kw)  # the port's raw run
    assert {k: got_stats[k] for k in _WIRE_STATS} == \
        {k: want_stats[k] for k in _WIRE_STATS}
    assert got_stats["wire_steps"] > 0 and got_stats["wire_ratio"] > 1.0
    assert got_stats["wire_steps"] + got_stats["wire_raw_steps"] == \
        got_stats["steps"]
    assert sum(got_stats["wire_modes"].values()) == got_stats["wire_steps"]
    assert got_stats["decode_s"] >= 0.0


def test_wire_switch_from_environment(monkeypatch):
    monkeypatch.setenv("DSI_STREAM_WIRE", "1")
    got_stats, want_stats = {}, {}
    got = _port([WC_TEXT], got_stats)
    assert got == _ref([WC_TEXT], want_stats)
    assert got_stats["wire_upload"] is True
    assert {k: got_stats[k] for k in _WIRE_STATS} == \
        {k: want_stats[k] for k in _WIRE_STATS}
    monkeypatch.setenv("DSI_STREAM_WIRE", "0")
    off: dict = {}
    assert _port([WC_TEXT], off) == got
    assert "wire_upload" not in off


def test_wire_stream_all_raw():
    """A chunk width that is not a multiple of 8: the codec refuses every
    batch, and each step uploads raw."""
    kw = dict(chunk_bytes=1020, wire_upload=True)
    got_stats, want_stats = {}, {}
    got = _port([WC_TEXT], got_stats, **kw)
    assert got == _ref([WC_TEXT], want_stats, **kw)
    assert got == _port([WC_TEXT], chunk_bytes=1020)
    assert got_stats["wire_steps"] == 0
    assert got_stats["wire_raw_steps"] == got_stats["steps"] > 0
    assert "wire_ratio" not in got_stats and "wire_ratio" not in want_stats
    for k in ("wire_steps", "wire_raw_steps", "wire_packed_bytes"):
        assert got_stats[k] == want_stats[k]


def test_wire_stream_launches_no_kernel_on_the_cpu():
    tw.reset_launches()
    _port([WC_TEXT], wire_upload=True)
    assert all(v == 0 for v in tw.launch_counts().values())


def test_wcstream_cli_wire_upload_matches_oracle(tmp_path, capsys):
    from dsi_tpu_torch.cli import wcstream

    files = ensure_corpus(str(tmp_path / "inputs"), n_files=2,
                          file_size=20_000)
    out = str(tmp_path / "out")
    rc = wcstream.main(["--device", "cpu", "--devices", "2",
                        "--wire-upload", "--check", "--stats",
                        "--chunk-bytes", "4096", "--workdir", out] + files)
    assert rc == 0
    err = capsys.readouterr().err
    assert "parity OK" in err
    stats = ast.literal_eval(err.split("pipeline_stats=", 1)[1]
                             .splitlines()[0])
    assert stats["wire_upload"] is True and stats["wire_steps"] > 0
    got = []
    for r in range(10):
        with open(os.path.join(out, f"mr-out-{r}"), encoding="utf-8") as f:
            got.extend(ln for ln in f if ln.strip())
    oracle = run_sequential(wc.Map, wc.Reduce, files,
                            str(tmp_path / "mr-correct.txt"))
    with open(oracle, encoding="utf-8") as f:
        assert sorted(got) == sorted(ln for ln in f if ln.strip())
