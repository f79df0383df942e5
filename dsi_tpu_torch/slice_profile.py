"""Where the time of the port's word-count slice goes, on the card.

    python -m dsi_tpu_torch.slice_profile [--baseline-csrc DIR [--ab A,B]]
        [--stream]
    python -m dsi_tpu_torch.slice_profile --grep
    python -m dsi_tpu_torch.slice_profile --tfidf
    python -m dsi_tpu_torch.slice_profile --indexer
    python -m dsi_tpu_torch.slice_profile --wire
    python -m dsi_tpu_torch.slice_profile --crashcheck
    python -m dsi_tpu_torch.slice_profile --plan
    python -m dsi_tpu_torch.slice_profile --host-profile [--baseline-csrc DIR]

On the bench corpus (8 files x (2 MiB - 64), seed 1234) it prints JSON
lines:

* ``corpus_profile``: one warm ``corpus_wordcount`` call under
  ``torch.profiler``: wall seconds, the sum of device kernel time, and
  the busiest device kernels by total time; ``corpus_hash_profile`` and
  ``corpus_pack6_profile`` the same with the hash grouper and with the
  6-bit transport;
* ``sort_profile``: the same for one ``radix_sort`` of the corpus keys,
  split by sub-kernel (histogram, passes, final gather);
* with ``--baseline-csrc``: kernels B, A and C built from that directory
  (for example the parent commit's ``dsi_tpu_torch/csrc``, unpacked with
  ``git archive``) timed in turns with this tree's (baseline, change,
  change, baseline), each checked against the plain version: B on the
  corpus keys and at the stream step's reduce shape (``sort_ab``); A on
  the corpus (16 MiB, with poslen) and at the stream step's 2 MiB chunk
  (``tokenize_ab``), each version's scalars as its wrapper leaves them
  (the older interface had the caller zero them); C at the corpus and
  reduce shapes (``group_ab``); A and C each with one call of each
  version profiled, its device time by launch; and, through the
  wrappers of the tree that holds that directory and of this tree, each
  turn a process of its own with its tree first on the path, kernel O
  (``crash_ab``: ``simulate_batch`` at 1,000, 2^16 and 2^20 instances in
  the CLI's configuration) and kernel I (``nfa_ab``: ``nfa_kernel`` on the
  bench's first file padded to 2^21 bytes in each state bucket), kernel
  L (``compact_ab``: ``compact_rows`` on the TF-IDF wave's received rows,
  every shard the bench's first file, at 1 and 8 shards) and kernel M
  (``append_ab``: ``postings_append`` of that wave's compacted rows at one
  shard, and ``mesh_postings_append`` of the 8-shard wave, whose L and M
  work this tree fuses), kernel P (``relay_ab``: a ``DeviceRelay`` at [1,
  2^20] and [8, 2^20] adopting a quarter-full buffer, then packing 8
  appends) and kernel N (``wire_ab``: ``decode_chunk_device`` on the
  bench's text at [1, 2 MiB], 7-bit, and on low-entropy text at [1, 2
  MiB] and [8, 2 MiB], nibble) and kernel H (``grep_ab``: ``grep_kernel``
  for ``the`` and ``function``, ``classgrep_kernel``, the whole ``altgrep_host_result`` call for
  ``the|and`` and ``nfa_kernel`` at S = 16, on the bench's first file
  padded to 2^21 bytes), each version's outputs checked against this
  tree's plain version; ``--ab`` names the A/Bs to run (``sort``,
  ``tokenize``, ``group``, ``crash``, ``nfa``, ``compact``, ``append``,
  ``relay``, ``wire``, ``grep``; all by default) and skips the profiles
  without a baseline;
* with ``--host-profile``: ``host_profile``, where the host time of the
  ``relay_ab``, ``wire_ab`` and ``grep_ab`` workloads' calls goes (those
  ``--ab`` names), in this tree and, with ``--baseline-csrc``, in the
  tree that holds that directory, each a process of its own: every
  shape's call 1,000 times under ``cProfile`` (a call's wall and its
  heaviest functions);
* with ``--stream``: ``stream_profile``, the bench's stream row (the
  corpus cycled to 64 MB, 2 MiB chunks, u_cap 2^15, depth 2) with the
  device table off and on at one shard, with the table on and the hash
  grouper, and at 8 virtual shards with the table mesh-sharded 8 ways,
  each run once warm and once under ``torch.profiler``: wall seconds,
  device seconds (kernels and copies), the device's idle share (1 -
  device / wall) and the busiest kernels;
* with ``--grep`` (and nothing else): ``grep_profile``, the bench's grep
  row (``bench.py run_grep_row``: the corpus once, 16,776,704 bytes,
  pattern ``the``, 2 MiB chunks, one shard) through ``grep_streaming``
  with ``device_accumulate`` off and on, and ``cuda_map`` on one file
  (tiers 1, 2 and 4), each the same way;
* with ``--tfidf`` (and nothing else): ``tfidf_profile``, the bench's
  TF-IDF row (``bench.py run_tfidf_row``: the 8 files as 8 documents,
  u_cap 2^15, packed) through ``tfidf_sharded`` at one shard with the
  postings buffer off and on, and at 8 virtual shards (one wave), each
  the same way;
* with ``--indexer`` (and nothing else): ``indexer_profile``, the same
  documents through ``indexer_streaming`` (u_cap 2^15, depth 2) at one
  shard with the services off and on, at 8 virtual shards, and at 8 with
  ``mesh_shards`` 8; and ``tfidf_sharded`` at 8 with ``mesh_shards`` 8;
  each the same way;
* with ``--wire`` (and nothing else): ``wire_profile``, the bench's wire
  A/B row (the corpus cycled to 16 MB, 2 MiB chunks, u_cap 2^15, depth
  2) through ``wordcount_streaming`` raw and with ``wire_upload``, with
  the device table off and on, and 16 MB of low-entropy text (the nibble
  mode) raw and wired, each the same way, with the pipeline's phases
  (``decode_s`` holds the host encoder) and the encoder's share of the
  wall;
* with ``--crashcheck`` (and nothing else): ``crash_profile``,
  ``run_crash_model_check`` at 1,000 instances and ``simulate_batch`` at
  2^20 in the CLI's configuration (kernel O), each the same way;
* with ``--plan`` (and nothing else): ``plan_profile``, the bench's plan
  row (``bench.py run_plan_row``: 8 MB of its corpus, ``grep-wc``,
  ``dsi``, 1 MiB chunks, one shard) through ``run_plan`` chained, staged
  and pipelined, and the corpus cycled to 64 MB grepped for ``th`` in 2
  MiB chunks (the relay seals buffers) chained, each the same way, with
  the stage walls and the relay's counters.

Needs one CUDA card; the card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dsi_tpu_torch.kernels import build
from dsi_tpu_torch.ops import wordcount as w
from dsi_tpu_torch.ops.corpus_wc import _resolve_pieces, corpus_wordcount
from dsi_tpu_torch.utils.corpus import ensure_corpus


def _ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)))


def _profile(fn, top: int = 12) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    return {"wall_s": wall,
            "device_s": sum(_device_us(e) for e in kernels) / 1e6,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": _device_us(e) / 1e3} for e in kernels[:top]]}


def _stream_profile(files, total_bytes: int) -> dict:
    from dsi_tpu_torch.parallel.streaming import (cycle_files,
                                                  wordcount_streaming)

    cycles = max(1, round(64e6 / total_bytes))
    out = {"cycles": cycles}
    for tag, acc, grouper, n_dev, mesh in (
            ("stream", False, None, 1, 0), ("stream_acc", True, None, 1, 0),
            ("stream_hash", True, "hash", 1, 0),
            ("stream_mesh", True, None, 8, 8)):
        stats: dict = {}

        def run():
            stats.clear()
            wordcount_streaming(cycle_files(files, cycles), n_dev=n_dev,
                                n_reduce=10, chunk_bytes=1 << 21,
                                u_cap=1 << 15, device_accumulate=acc,
                                mesh_shards=mesh, pipeline_stats=stats,
                                device="cuda")

        with pinned_grouper(grouper):
            prof = _profile(run)
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        prof["steps"] = stats["steps"]
        out[tag] = prof
    return out


def _grep_profile(files, raw0: bytes) -> dict:
    from dsi_tpu_torch.apps.cuda_grep import cuda_map
    from dsi_tpu_torch.parallel.grepstream import (GREP_CHUNK_BYTES,
                                                   grep_streaming)
    from dsi_tpu_torch.parallel.streaming import stream_files

    out = {}
    for tag, acc in (("grep_stream", False), ("grep_stream_acc", True)):
        stats: dict = {}

        def run():
            stats.clear()
            grep_streaming(stream_files(files), "the",
                           chunk_bytes=GREP_CHUNK_BYTES,
                           device_accumulate=acc, pipeline_stats=stats,
                           device="cuda")

        prof = _profile(run)
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        prof["steps"] = stats["steps"]
        out[tag] = prof
    for pattern in ("the", "[Tt]he", "th[a-z]*e"):
        with env_set(DSI_GREP_PATTERN=pattern, DSI_NFA_DISPATCH="device"):
            prof = _profile(lambda: cuda_map("pg-00.txt", raw0,
                                             device="cuda"))
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        out[f"cuda_map {pattern}"] = prof
    return out


def _tfidf_profile(files) -> dict:
    from dsi_tpu_torch.parallel.tfidf import FileDocs, tfidf_sharded

    out = {}
    for tag, acc, n_dev in (("tfidf", False, 1), ("tfidf_acc", True, 1),
                            ("tfidf_n8", False, 8)):
        stats: dict = {}

        def run():
            stats.clear()
            tfidf_sharded(FileDocs(files), n_dev=n_dev, n_reduce=10,
                          u_cap=1 << 15, packed=True, device_accumulate=acc,
                          wave_stats=stats, device="cuda")

        prof = _profile(run)
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        prof["waves"] = stats["waves"]
        out[tag] = prof
    return out


def _indexer_profile(files) -> dict:
    from dsi_tpu_torch.parallel.grepstream import indexer_streaming
    from dsi_tpu_torch.parallel.tfidf import FileDocs, tfidf_sharded

    out = {}
    for tag, kw in (("indexer", {}),
                    ("indexer_acc", {"device_accumulate": True}),
                    ("indexer_n8", {"n_dev": 8}),
                    ("indexer_mesh", {"n_dev": 8, "mesh_shards": 8}),
                    ("tfidf_mesh", {"n_dev": 8, "mesh_shards": 8})):
        stats: dict = {}

        def run():
            stats.clear()
            if tag == "tfidf_mesh":
                tfidf_sharded(FileDocs(files), n_reduce=10, u_cap=1 << 15,
                              packed=True, wave_stats=stats, device="cuda",
                              **kw)
            else:
                indexer_streaming(FileDocs(files), n_reduce=10,
                                  u_cap=1 << 15, depth=2, stats=stats,
                                  device="cuda", **kw)

        prof = _profile(run)
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        prof["waves"] = stats["waves"]
        out[tag] = prof
    return out


def lowent_unit() -> bytes:
    """The low-entropy text of ``tests/test_wire_ingest.py`` (``WC_TEXT``'s
    line): 120 three-letter words and a newline, 480 bytes.  Repeated, it
    takes the wire codec's nibble mode at its first literal rung."""
    words = ["".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))
             for i in range(120)]
    return (" ".join(words) + "\n").encode()


def _wire_profile(files, total_bytes: int) -> dict:
    from dsi_tpu_torch.parallel.streaming import (cycle_files,
                                                  wordcount_streaming)

    cycles = max(1, round(16e6 / total_bytes))
    unit = lowent_unit()
    reps = 16_000_000 // len(unit)
    out = {"cycles": cycles}
    for tag, acc, wire, lowent in (
            ("raw", False, False, False), ("wire", False, True, False),
            ("raw_acc", True, False, False), ("wire_acc", True, True, False),
            ("raw_lowent", True, False, True),
            ("wire_lowent", True, True, True)):
        stats: dict = {}

        def run():
            stats.clear()
            blocks = ([unit * (reps // 4)] * 4 if lowent
                      else cycle_files(files, cycles))
            wordcount_streaming(blocks, n_dev=1, n_reduce=10,
                                chunk_bytes=1 << 21, u_cap=1 << 15,
                                device_accumulate=acc, wire_upload=wire,
                                pipeline_stats=stats, device="cuda")

        prof = _profile(run)
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        prof["stats"] = {k: v for k, v in stats.items()
                         if k.endswith("_s") or k.startswith("wire")
                         or k == "steps"}
        if wire:
            prof["encoder_share"] = stats["decode_s"] / prof["wall_s"]
        out[tag] = prof
    return out


def _crash_profile() -> dict:
    from dsi_tpu_torch.parallel.simulate import (run_crash_model_check,
                                                 simulate_batch)

    cfg = dict(exit_prob=0.25, stall_prob=0.2, timeout=10, horizon=800)
    out = {}
    for tag, fn in (
            ("check_1000", lambda: run_crash_model_check(
                1000, device="cuda", **cfg)),
            ("fleet_2^20", lambda: simulate_batch(0, 1 << 20,
                                                  device="cuda", **cfg))):
        prof = _profile(fn)
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        out[tag] = prof
    return out


def _plan_profile(work: str, files) -> dict:
    from dsi_tpu_torch.plan import grep_wordcount_plan, run_plan
    from dsi_tpu_torch.utils.corpus import plan_corpus

    corpus = plan_corpus(os.path.join(work, "plan.txt"), 8.0)
    total = sum(os.path.getsize(p) for p in files) + len(files) - 1
    pg = list(files) * max(1, round(64e6 / total))
    out = {}
    for tag, make, kw in (
            ("plan_chained", lambda: grep_wordcount_plan(
                "dsi", paths=[corpus], chunk_bytes=1 << 20), {}),
            ("plan_staged", lambda: grep_wordcount_plan(
                "dsi", paths=[corpus], chunk_bytes=1 << 20),
             {"staged": True}),
            ("plan_pipelined", lambda: grep_wordcount_plan(
                "dsi", paths=[corpus], chunk_bytes=1 << 20),
             {"pipelined": True}),
            ("plan_pg_th", lambda: grep_wordcount_plan(
                "th", paths=pg, chunk_bytes=1 << 21, u_cap=1 << 15), {})):
        stats: dict = {}

        def run():
            stats.clear()
            run_plan(make(), device="cuda", stats=stats, **kw)

        prof = _profile(run)
        prof["idle_share"] = 1.0 - prof["device_s"] / prof["wall_s"]
        prof.update({k: stats.get(k, 0) for k in (
            "plan_s", "plan_stage_walls", "plan_relay_buffers",
            "plan_intermediate_bytes", "plan_overlap_s")})
        out[tag] = prof
    return out


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set for the duration; the old values come
    back after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def pinned_grouper(grouper):
    """``DSI_WC_GROUPER`` pinned to ``grouper`` (None: unset, the
    device's default) for the duration; the previous value comes back
    after."""
    old = os.environ.pop("DSI_WC_GROUPER", None)
    if grouper is not None:
        os.environ["DSI_WC_GROUPER"] = grouper
    try:
        yield
    finally:
        os.environ.pop("DSI_WC_GROUPER", None)
        if old is not None:
            os.environ["DSI_WC_GROUPER"] = old


def _reduce_operands(raw: bytes):
    """(key words, counts int64, lengths int32) of the stream step's
    reduce half (K9) in received order, what B sorts and C groups: one
    shard, one 2 MiB chunk holding ``raw``, u_cap 2^15, routed by E."""
    from dsi_tpu_torch.parallel.shuffle import map_prologue

    buf = np.zeros(1 << 21, np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    packed_u, len_u, cnt_u, part, dest, _ = map_prologue(
        torch.from_numpy(buf).cuda(), n_dev=1, n_reduce=10, max_word_len=16,
        u_cap=1 << 15, t_cap_frac=4)
    rows = torch.cat([packed_u, len_u[:, None], cnt_u[:, None],
                      part[:, None]], dim=1)[None].contiguous()
    recv = w.shuffle_rows(rows, dest[None].contiguous(), n_dev=1, k=4)[0]
    return (torch.stack(w.pack_key_lanes(tuple(recv[:, j]
                                               for j in range(4)))),
            w._u32_value(recv[:, 5]), recv[:, 4].contiguous())


def _tokenize_with(lib, chunk: torch.Tensor, t_cap: int, poslen: bool,
                   zeroed: bool):
    """Kernel A from ``lib`` (same C interface as the package's) as its
    wrapper calls it: ``zeroed`` for the older version, whose caller
    zeroes the scalars."""
    n = chunk.shape[0]
    dev = {"device": chunk.device}
    keys = torch.empty((2, t_cap), dtype=torch.int64, **dev)
    lengths = torch.empty(t_cap, dtype=torch.int32, **dev)
    pl = torch.empty(t_cap, dtype=torch.int32, **dev) if poslen else None
    scalars = (torch.zeros if zeroed else torch.empty)(4, dtype=torch.int32,
                                                       **dev)
    scratch = torch.empty(lib.dsi_tokenize_scratch_bytes(n),
                          dtype=torch.uint8, **dev)
    rc = lib.dsi_tokenize(chunk.data_ptr(), n, 4, t_cap, keys.data_ptr(),
                          lengths.data_ptr(),
                          pl.data_ptr() if poslen else None,
                          scalars.data_ptr(), scratch.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tokenize launch failed: CUDA error {rc}")
    return keys, lengths, pl, scalars


def _group_with(lib, skeys, counts, u_cap: int, payload, perm):
    """Kernel C from ``lib`` (same C interface as the package's)."""
    k64, t = skeys.shape
    dev = {"device": skeys.device}
    keys_u = torch.empty((k64, u_cap), dtype=torch.int64, **dev)
    totals = torch.empty(u_cap, dtype=torch.int64, **dev)
    upos = torch.empty(u_cap, dtype=torch.int32, **dev)
    payload_u = torch.empty(u_cap, dtype=torch.int32, **dev)
    n_unique = torch.empty(1, dtype=torch.int32, **dev)
    scratch = torch.empty(lib.dsi_group_scratch_bytes(t, u_cap),
                          dtype=torch.uint8, **dev)
    rc = lib.dsi_group(skeys.data_ptr(), k64, t, counts.data_ptr(),
                       payload.data_ptr(), perm.data_ptr(), u_cap,
                       keys_u.data_ptr(), totals.data_ptr(), upos.data_ptr(),
                       payload_u.data_ptr(), n_unique.data_ptr(),
                       scratch.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group launch failed: CUDA error {rc}")
    return keys_u, totals, upos, payload_u, n_unique[0]


def _ab(tag: str, at: str, shape, calls: dict, want) -> None:
    """One kernel from two libraries in turns (baseline, change, change,
    baseline), each checked against the plain version's outputs, with one
    call of each under ``torch.profiler`` (its device time by launch)."""
    same = {name: all(torch.equal(g, x) for g, x in zip(fn(), want)
                      if x is not None)
            for name, fn in calls.items()}
    turns = [[name, _ms(calls[name], 20)]
             for name in ("baseline", "change", "change", "baseline")]
    launches = {name: [[e["name"][:40], e["device_ms"]]
                       for e in _profile(fn, top=8)["top"]]
                for name, fn in calls.items()}
    print(json.dumps({tag: {"at": at, "equal_to_plain": same,
                            "ms_in_turns": turns,
                            "device_ms_by_launch": launches,
                            "shape": shape}}),
          flush=True)


def _sort_with(lib, keys: torch.Tensor):
    """Kernel B from ``lib`` (same C interface as the package's)."""
    k64, t = keys.shape
    out = torch.empty_like(keys)
    perm = torch.empty(t, dtype=torch.int32, device=keys.device)
    scratch = torch.empty(lib.dsi_radix_sort_scratch_bytes(t),
                          dtype=torch.uint8, device=keys.device)
    rc = lib.dsi_radix_sort(keys.data_ptr(), k64, t, out.data_ptr(),
                            perm.data_ptr(), scratch.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"radix_sort launch failed: CUDA error {rc}")
    return out, perm


# A wrapper-level A/B runs each turn in a process of its own, with the
# tree under test first on the path, so each version runs through its own
# wrappers and kernels built from its own csrc.  The process loads this
# file and calls _turn; the workloads use only entry points whose
# signatures both trees share.
_TURN = ("import importlib.util, sys\n"
         "spec = importlib.util.spec_from_file_location('_ab_turn', "
         "sys.argv[1])\n"
         "m = importlib.util.module_from_spec(spec)\n"
         "spec.loader.exec_module(m)\n"
         "getattr(m, sys.argv[2])(*sys.argv[3:])\n")
_ROOT = Path(__file__).resolve().parents[1]
_CRASH_CLI = dict(exit_prob=0.25, stall_prob=0.2, timeout=10, horizon=800)


def _crash_workload(raw0: bytes):
    """Kernel O through ``simulate_batch`` at 1,000, 2^16 and 2^20
    instances in the CLI's configuration: (at, shape, call, plain)."""
    from dsi_tpu_torch.parallel import simulate as sim

    def outputs(d):
        return tuple(d[k] for k in sim.OUTPUTS)

    return [(f"n={n}", [n],
             lambda n=n: outputs(sim.simulate_batch(0, n, device="cuda",
                                                    **_CRASH_CLI)),
             lambda n=n: outputs(sim.simulate_batch_plain(
                 0, n, device="cuda", **_CRASH_CLI)))
            for n in (1000, 1 << 16, 1 << 20)]


def _nfa_workload(raw0: bytes):
    """Kernel I through ``nfa_kernel`` on ``raw0`` padded to a power of
    two, one pattern a state bucket: (at, shape, call, plain)."""
    from dsi_tpu_torch.ops import grepk, nfak

    chunk = torch.from_numpy(w._pad_pow2(raw0)).cuda()
    n = chunk.shape[0]
    l_cap = grepk.line_cap_rungs(n)[0]
    out = []
    for s, pat in ((16, "th[a-z]*e"), (32, "a{5,20}b"), (48, "a{20,40}b")):
        table, v0 = (torch.from_numpy(x).cuda() for x in nfak._build_table(
            *nfak.parse_nfa_pattern(pat)))
        out.append((f"S={s} {pat}", [n, s, l_cap],
                    lambda t=table, v=v0: nfak.nfa_kernel(chunk, t, v,
                                                          l_cap=l_cap),
                    lambda t=table, v=v0: nfak.nfa_kernel_plain(
                        chunk, t, v, l_cap=l_cap)))
    return out


def _wave_inputs(raw0: bytes, n_dev: int):
    """The TF-IDF row's wave at ``n_dev`` shards, every shard the document
    ``raw0`` (2 MiB chunks, u_cap the rung-0 capacity of 2^15, 16-byte
    words): its received rows [n_dev, n_dev * 32,768, 8] and its
    compacted rows and scalars, each through the tree's own kernels."""
    from dsi_tpu_torch.parallel.tfidf import (_wave_chunk, tfidf_wave_step,
                                              wave_received)

    size = 1 << max(8, len(raw0).bit_length())
    chunks = torch.from_numpy(_wave_chunk([raw0] * n_dev, range(n_dev),
                                          n_dev, size)).cuda()
    ids = torch.arange(n_dev, dtype=torch.int32, device="cuda")
    kw = dict(n_dev=n_dev, n_reduce=10, max_word_len=16,
              u_cap=w.rung0_cap(size, 1 << 15))
    recv, _ = wave_received(chunks, ids, **kw)
    return recv, tfidf_wave_step(chunks, ids, **kw)


def _compact_workload(raw0: bytes):
    """Kernel L through ``compact_rows`` on the TF-IDF wave's received
    rows at 1 and 8 shards: (at, shape, call, plain)."""
    from dsi_tpu_torch.ops.meshroute import compact_rows, compact_rows_plain

    out = []
    for n_dev in (1, 8):
        recv = _wave_inputs(raw0, n_dev)[0]
        out.append((f"n_dev={n_dev}", list(recv.shape),
                    lambda x=recv: compact_rows(x, pad_lanes=2),
                    lambda x=recv: compact_rows_plain(x, pad_lanes=2)))
    return out


def _append_workload(raw0: bytes):
    """Kernel M through ``postings_append`` (the wave's compacted rows at
    one shard into a buffer of its capacity) and through
    ``mesh_postings_append`` (the 8-shard wave re-routed, exchanged and
    appended into eight times the rung-0 capacity): (at, shape, call,
    plain); the plain chain runs on CPU copies.  Each call appends at
    offset 0 of the same buffer, so every call writes the same bytes."""
    from dsi_tpu_torch.device.postings import (mesh_postings_append,
                                               postings_append)

    def mesh(buf, n, dirty, rows, scal):
        return mesh_postings_append(buf, n, dirty, rows, scal, kk=4,
                                    n_shards=8)

    out = []
    for n_dev, at, fn in ((1, "postings_append", postings_append),
                          (8, "mesh_postings_append", mesh)):
        rows, scal = _wave_inputs(raw0, n_dev)[1]
        cap = rows.shape[1]  # n_dev x the rung-0 capacity
        args = (torch.zeros((n_dev, cap, rows.shape[2]), dtype=torch.int32,
                            device="cuda"),
                torch.zeros(n_dev, dtype=torch.int32, device="cuda"))
        args = args + args[1:] + (rows, scal)
        out.append((f"{at} n_dev={n_dev}",
                    [list(rows.shape), cap, int(scal[:, 0].sum())],
                    lambda fn=fn, a=args: (a[0],) + tuple(fn(*a)),
                    lambda fn=fn, a=args: (lambda c: (c[0],) + tuple(fn(*c)))(
                        [t.cpu() for t in a])))
    return out


RELAY_CAP, RELAY_PACKS = 1 << 20, 8


def _relay_rows(rng, n_dev: int, hi: int):
    """[n_dev, RELAY_CAP] uint8 with kept[r] < hi nonzero bytes in row r
    and a zero tail (a step's compacted grep output), and kept."""
    kept = rng.integers(hi // 2, hi, n_dev)
    buf = np.zeros((n_dev, RELAY_CAP), np.uint8)
    for r in range(n_dev):
        buf[r, :kept[r]] = rng.integers(1, 256, kept[r])
    return buf, kept


def _relay_workload(raw0: bytes):
    """Kernel P through ``DeviceRelay.append``: a relay at [1, 2^20] and
    [8, 2^20] adopts a quarter-full buffer, then packs RELAY_PACKS appends
    of up to 1/16 of a row each after its fill point (no seal); the call
    returns the open buffer, the plain version the rows' concatenation:
    (at, shape, call, plain)."""
    from dsi_tpu_torch.device.relay import DeviceRelay

    out = []
    for n_dev in (1, 8):
        rng = np.random.default_rng(1234 + n_dev)
        steps = [_relay_rows(rng, n_dev, RELAY_CAP // 4)] + [
            _relay_rows(rng, n_dev, RELAY_CAP // 16)
            for _ in range(RELAY_PACKS)]
        want = np.zeros((n_dev, RELAY_CAP), np.uint8)
        for r in range(n_dev):
            row = np.concatenate([b[r, :k[r]] for b, k in steps])
            want[r, :row.size] = row
        dev = [(torch.from_numpy(b).cuda(), k) for b, k in steps]

        def call(dev=dev, n_dev=n_dev):
            relay = DeviceRelay(n_dev, cap=RELAY_CAP, device="cuda")
            relay.append(dev[0][0].clone(), dev[0][1])
            for buf, kept in dev[1:]:
                relay.append(buf, kept)
            return list(relay.batches())

        out.append((f"n_dev={n_dev}", [n_dev, RELAY_CAP, RELAY_PACKS], call,
                    lambda want=want: [torch.from_numpy(want)]))
    return out


def _wire_batches(raw0: bytes):
    """(at, batch) for kernel N: the bench's text at [1, 2 MiB] (the 7-bit
    mode), the low-entropy text at [1, 2 MiB] (nibble, rung 8) and at [8,
    2 MiB]."""
    n = 1 << 21
    text = raw0 + b"\n"
    bench = np.frombuffer(text * (n // len(text) + 1), np.uint8)[:n]
    unit = lowent_unit()
    low = np.frombuffer(unit * (8 * n // len(unit) + 1), np.uint8)
    return [("b7 [1, 2 MiB]", bench.reshape(1, n)),
            ("nib [1, 2 MiB]", low[:n].reshape(1, n)),
            ("nib [8, 2 MiB]", low[:8 * n].reshape(8, n))]


def _wire_workload(raw0: bytes):
    """Kernel N through ``decode_chunk_device`` on :func:`_wire_batches`,
    each encoded by ``encode_chunk``: (at, shape, call, plain)."""
    from dsi_tpu_torch.ops.wirecodec import (decode_chunk_device,
                                             decode_chunk_plain, encode_chunk)

    out = []
    for at, batch in _wire_batches(raw0):
        mode, packed, cap = encode_chunk(batch)
        if mode != at[:len(mode)]:
            raise RuntimeError(f"wire workload {at} encoded as {mode}")
        pk = torch.from_numpy(packed).cuda()
        kw = dict(n=batch.shape[1], lit_cap=cap, mode=mode)
        out.append((f"{at} lit_cap {cap}", list(pk.shape),
                    lambda pk=pk, kw=kw: [decode_chunk_device(pk, **kw)],
                    lambda pk=pk, kw=kw: [decode_chunk_plain(pk, **kw)]))
    return out


def _grep_workload(raw0: bytes):
    """Kernel H through the grep tiers' public entry points on ``raw0``
    padded to a power of two, at the first rung: ``grep_kernel`` (``the``,
    and ``function``, a literal past H's 4-byte warm-up),
    ``classgrep_kernel`` (``[Tt]he``), ``altgrep_host_result`` (``the|and``,
    the whole tier call: upload, rungs and lines; one H call here, two in a
    tree that runs one a branch) and ``nfa_kernel`` (S = 16, whose line
    flags are H's pass over I's mask): (at, shape, call, plain)."""
    from dsi_tpu_torch.ops import altk, grepk, nfak, regexk

    chunk = torch.from_numpy(w._pad_pow2(raw0)).cuda()
    n = chunk.shape[0]
    l_cap = grepk.line_cap_rungs(n)[0]
    ranges, a_s, a_e = regexk.parse_class_pattern("[Tt]he")
    kw = dict(ranges=ranges, anchor_start=a_s, anchor_end=a_e, l_cap=l_cap)
    table, v0 = (torch.from_numpy(x).cuda() for x in nfak._build_table(
        *nfak.parse_nfa_pattern("th[a-z]*e")))

    def lines(device):
        got = altk.altgrep_host_result(raw0, "the|and", device=device)
        text = np.frombuffer("\n".join(got).encode(), np.uint8).copy()
        return [torch.tensor(len(got)), torch.from_numpy(text)]

    return [("grep_kernel the", [n, l_cap],
             lambda: grepk.grep_kernel(chunk, b"the", l_cap=l_cap),
             lambda: grepk.grep_kernel_plain(chunk, b"the", l_cap=l_cap)),
            ("grep_kernel function", [n, l_cap],
             lambda: grepk.grep_kernel(chunk, b"function", l_cap=l_cap),
             lambda: grepk.grep_kernel_plain(chunk, b"function",
                                             l_cap=l_cap)),
            ("classgrep_kernel [Tt]he", [n, l_cap],
             lambda: regexk.classgrep_kernel(chunk, **kw),
             lambda: regexk.classgrep_kernel_plain(chunk, **kw)),
            ("altgrep_host_result the|and", [len(raw0)],
             lambda: lines("cuda"), lambda: lines("cpu")),
            ("nfa_kernel S=16 th[a-z]*e", [n, 16, l_cap],
             lambda: nfak.nfa_kernel(chunk, table, v0, l_cap=l_cap),
             lambda: nfak.nfa_kernel_plain(chunk, table, v0, l_cap=l_cap))]


_WORKLOADS = {"crash": _crash_workload, "nfa": _nfa_workload,
              "compact": _compact_workload, "append": _append_workload,
              "relay": _relay_workload, "wire": _wire_workload,
              "grep": _grep_workload}
HOST_CALLS = 1000


def _bench_raw0(work: str) -> bytes:
    return Path(ensure_corpus(os.path.join(work, "c"), 8, (2 << 20) - 64,
                              1234)[0]).read_bytes()


def _turn(name: str, out: str) -> None:
    """One turn of a wrapper-level A/B, in its own process: every shape
    of workload ``name`` once (its outputs saved to ``out``), timed over
    50 calls and profiled over one; prints the times as one JSON line."""
    w.resolve_device("cuda")
    with tempfile.TemporaryDirectory() as work:
        raw0 = _bench_raw0(work)
    saved, times = {}, {}
    for at, _, call, _ in _WORKLOADS[name](raw0):
        saved[at] = [torch.as_tensor(x).cpu() for x in call()]
        times[at] = {"ms": _ms(call, 50),
                     "device_ms_by_launch": [
                         [e["name"][:40], e["device_ms"]]
                         for e in _profile(call, top=8)["top"]]}
    torch.save(saved, out)
    print(json.dumps({"package": str(Path(w.__file__).resolve().parents[2]),
                      "times": times}), flush=True)


def _host_turn(name: str) -> None:
    """Where the host time of workload ``name``'s wrappers goes, in this
    process's tree: each shape's call HOST_CALLS times under ``cProfile``
    after a warm-up; prints, a call, the wall and the heaviest functions
    by their own time (microseconds) as one JSON line."""
    import cProfile
    import pstats

    w.resolve_device("cuda")
    with tempfile.TemporaryDirectory() as work:
        raw0 = _bench_raw0(work)
    result = {}
    for at, _, call, _ in _WORKLOADS[name](raw0):
        call()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(HOST_CALLS):
            call()
        prof.disable()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        rows = sorted(pstats.Stats(prof).stats.items(),
                      key=lambda kv: kv[1][2], reverse=True)
        result[at] = {"us_a_call": wall / HOST_CALLS * 1e6, "top": [
            [f"{Path(f).name}:{ln} {fn}", nc // HOST_CALLS,
             tt / HOST_CALLS * 1e6, ct / HOST_CALLS * 1e6]
            for (f, ln, fn), (_, nc, tt, ct, _) in rows[:14]]}
    print(json.dumps({"package": str(Path(w.__file__).resolve().parents[2]),
                      "host_profile": result}), flush=True)


def _run_tree(root: Path, *argv: str) -> dict:
    """``_TURN`` in a process of its own with the tree at ``root`` first on
    the path, calling this file's function ``argv[0]`` with the rest;
    returns its last output line, checked to come from that tree."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    run = subprocess.run([sys.executable, "-c", _TURN, __file__, *argv],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=1200)
    if run.returncode != 0:
        raise RuntimeError(f"{argv} in {root} exited {run.returncode}: "
                           f"{run.stderr[-2000:]}")
    got = json.loads(run.stdout.strip().splitlines()[-1])
    if Path(got["package"]) != root.resolve():
        raise RuntimeError(f"{argv} ran the package of {got['package']}, "
                           f"not {root}")
    return got


def _tree_ab(name: str, base_root: Path, raw0: bytes) -> None:
    """``{name}_ab``: workload ``name`` through the wrappers of the tree
    at ``base_root`` (for example the parent commit unpacked with ``git
    archive``) and of this tree, in turns (baseline, change, change,
    baseline), each a process of its own; every version's outputs checked
    against this tree's plain version."""
    roots = {"baseline": base_root, "change": _ROOT}
    turns, outputs = [], {}
    with tempfile.TemporaryDirectory() as work:
        for k, who in enumerate(("baseline", "change", "change",
                                 "baseline")):
            out = os.path.join(work, f"{k}.pt")
            got = _run_tree(roots[who], "_turn", name, out)
            turns.append((who, got["times"]))
            outputs.setdefault(who, torch.load(out))
    for at, shape, _, plain in _WORKLOADS[name](raw0):
        want = [torch.as_tensor(x).cpu() for x in plain()]
        print(json.dumps({f"{name}_ab": {
            "at": at, "shape": shape,
            "equal_to_plain": {
                who: all(torch.equal(g, x)
                         for g, x in zip(got[at], want))
                for who, got in outputs.items()},
            "ms_in_turns": [[who, t[at]["ms"]] for who, t in turns],
            "device_ms_by_launch": {who: t[at]["device_ms_by_launch"]
                                    for who, t in turns[:2]}}}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-csrc", type=Path, default=None,
                    help="csrc directory of the kernel version to compare")
    ap.add_argument("--ab", default=None,
                    help="with --baseline-csrc, the A/Bs to run (comma "
                         "list of sort, tokenize, group, crash, nfa, "
                         "compact, append, relay, wire, grep; default all), "
                         "without the profiles")
    ap.add_argument("--host-profile", action="store_true",
                    help="cProfile 1,000 calls of the relay, wire and grep "
                         "workloads (host_profile; --ab names others), in "
                         "this tree and, with --baseline-csrc, in the tree "
                         "that holds it")
    ap.add_argument("--stream", action="store_true",
                    help="also profile the stream row (stream_profile)")
    ap.add_argument("--grep", action="store_true",
                    help="profile the grep row and cuda_map alone "
                         "(grep_profile)")
    ap.add_argument("--tfidf", action="store_true",
                    help="profile the TF-IDF row alone (tfidf_profile)")
    ap.add_argument("--indexer", action="store_true",
                    help="profile the indexer and the mesh-sharded TF-IDF "
                         "alone (indexer_profile)")
    ap.add_argument("--wire", action="store_true",
                    help="profile the wire A/B row alone (wire_profile)")
    ap.add_argument("--crashcheck", action="store_true",
                    help="profile the crash model checker alone "
                         "(crash_profile)")
    ap.add_argument("--plan", action="store_true",
                    help="profile the plan row alone (plan_profile)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("slice_profile: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    w.resolve_device("cuda")
    build.library()
    if args.crashcheck:
        print(json.dumps({"crash_profile": _crash_profile()}), flush=True)
        return 0
    if args.host_profile:
        roots = {"change": _ROOT}
        if args.baseline_csrc is not None:
            roots = {"baseline": args.baseline_csrc.resolve().parents[1],
                     **roots}
        names = (("relay", "wire", "grep") if args.ab is None
                 else args.ab.split(","))
        for who, root in roots.items():
            for name in names:
                got = _run_tree(root, "_host_turn", name)
                print(json.dumps({"host_profile": {
                    "tree": who, "workload": name, **got["host_profile"]}}),
                    flush=True)
        return 0
    with tempfile.TemporaryDirectory() as work:
        files = ensure_corpus(os.path.join(work, "c"), 8, (2 << 20) - 64,
                              1234)
        raws = [Path(p).read_bytes() for p in files]
        if args.plan:
            print(json.dumps({"plan_profile": _plan_profile(work, files)}),
                  flush=True)
            return 0
        if args.tfidf:
            print(json.dumps({"tfidf_profile": _tfidf_profile(files)}),
                  flush=True)
            return 0
        if args.indexer:
            print(json.dumps({"indexer_profile": _indexer_profile(files)}),
                  flush=True)
            return 0
        if args.wire:
            print(json.dumps({"wire_profile": _wire_profile(
                files, sum(len(r) for r in raws) + len(raws) - 1)}),
                flush=True)
            return 0
        if args.grep:
            print(json.dumps({"grep_profile": _grep_profile(files,
                                                            raws[0])}),
                  flush=True)
            return 0
        if args.stream:
            print(json.dumps({"stream_profile": _stream_profile(
                files, sum(len(r) for r in raws) + len(raws) - 1)}),
                flush=True)
    abs_ = set(("sort tokenize group crash nfa compact append relay wire grep"
                if args.ab is None
                else args.ab.replace(",", " ")).split())
    buf, _, _ = _resolve_pieces(raws, None)
    for tag, kw in (("corpus_profile", {}),
                    ("corpus_hash_profile", {"grouper": "hash"}),
                    ("corpus_pack6_profile", {"pack6": True})):
        if args.ab is None:
            print(json.dumps({tag: _profile(
                lambda: corpus_wordcount(raws, device="cuda", **kw))}),
                flush=True)

    chunk = torch.from_numpy(buf).cuda()
    keys = w.tokenize(chunk, max_word_len=16, t_cap=len(buf) // 4 + 1)[0]
    if args.ab is None:
        print(json.dumps({"sort_profile": _profile(
            lambda: w.radix_sort(keys), top=8)}), flush=True)
    if args.baseline_csrc is not None and abs_ & {"sort", "tokenize",
                                                  "group"}:
        base = build.load(build.build(
            args.baseline_csrc, build.BUILD_DIR / "baseline"),
            names=("dsi_radix_sort_scratch_bytes", "dsi_radix_sort",
                   "dsi_tokenize_scratch_bytes", "dsi_tokenize",
                   "dsi_group_scratch_bytes", "dsi_group"))
        new = build.library()
        step = np.zeros(1 << 21, np.uint8)
        step[:len(raws[0])] = np.frombuffer(raws[0], np.uint8)
        for at, c, pl in (("corpus", chunk, True),
                          ("stream_step", torch.from_numpy(step).cuda(),
                           False)):
            if "tokenize" not in abs_:
                break
            t_cap = c.shape[0] // 4 + 1
            _ab("tokenize_ab", at, [c.shape[0], t_cap], {
                "baseline": lambda c=c, t=t_cap, pl=pl: _tokenize_with(
                    base, c, t, pl, True),
                "change": lambda c=c, t=t_cap, pl=pl: _tokenize_with(
                    new, c, t, pl, False)},
                w.tokenize_plain(c, max_word_len=16, t_cap=t_cap,
                                 with_poslen=pl))
        tok = w.tokenize(chunk, max_word_len=16, t_cap=len(buf) // 4 + 1,
                         with_poslen=True)
        r_keys, r_counts, r_lens = _reduce_operands(raws[0])
        for at, k, cnt, pay, u_cap in (
                ("corpus", keys, torch.ones_like(tok[1], dtype=torch.int64),
                 tok[2], w.rung0_cap(len(buf), 1 << 18)),
                ("reduce", r_keys, r_counts, r_lens, r_keys.shape[1])):
            if "group" not in abs_:
                break
            sk, perm = w.radix_sort(k)
            sc = cnt[perm.long()]
            _ab("group_ab", at, [*sk.shape, u_cap], {
                name: lambda lib=lib, sk=sk, sc=sc, u=u_cap, pay=pay,
                perm=perm: _group_with(lib, sk, sc, u, pay, perm)
                for name, lib in (("baseline", base), ("change", new))},
                w.group_sorted_plain(sk, sc, u_cap, pay, perm))
        for at, k in (("corpus", keys), ("reduce", r_keys)):
            if "sort" not in abs_:
                break
            _ab("sort_ab", at, list(k.shape), {
                name: lambda lib=lib, k=k: _sort_with(lib, k)
                for name, lib in (("baseline", base), ("change", new))},
                w.radix_sort_plain(k))
    if args.baseline_csrc is not None:
        base_root = args.baseline_csrc.resolve().parents[1]
        for name in _WORKLOADS:
            if name in abs_:
                _tree_ab(name, base_root, raws[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
