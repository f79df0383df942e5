"""Where the time of the port's word-count slice goes, on the card.

    python -m dsi_tpu_torch.slice_profile [--baseline-csrc DIR] [--stream]
    python -m dsi_tpu_torch.slice_profile --grep
    python -m dsi_tpu_torch.slice_profile --tfidf
    python -m dsi_tpu_torch.slice_profile --indexer
    python -m dsi_tpu_torch.slice_profile --wire
    python -m dsi_tpu_torch.slice_profile --crashcheck
    python -m dsi_tpu_torch.slice_profile --plan

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
  version profiled, its device time by launch; and kernel J with and
  without its emit epilogue (``grep_ab``: the older version through its
  two C entry points and its wrapper's allocations as that tree made them,
  this tree's through ``grep_step``) on the bench corpus cut into 2 MiB
  rows at 1 and 8 shards, pattern ``the``, ``l_cap`` 262,144, each call
  checked against ``grep_step_plain`` and one of each profiled; and
  kernels E and D (``route_ab``: the older versions through their older
  C interface and wrappers, this tree's through ``shuffle_rows``,
  ``fnv1a32_route`` and ``route_dest``): E at the stream step, the mesh
  fold, the mesh append and ``tfidf_n8``'s wave, D as ``map_prologue``
  (the hash, then eight torch ops before; one launch now) and
  ``route_dest`` (the lanes packed, the hash, five torch ops before; one
  launch now) run it, each checked against the plain versions;
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
import ctypes
import json
import os
import subprocess
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


# The C interface of kernel J before it took one C call a step: the step
# and its emit epilogue, each with its own scratch.
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_GREP_TWO_ENTRIES = {
    "dsi_grep_step_scratch_bytes": (_I64, [_INT, _I64, _I64, _INT]),
    "dsi_grep_step": (_INT, [_P, _INT, _I64, _P, _INT, _P, _P, _I64, _INT,
                             _INT, _P, _P, _P, _P, _P]),
    "dsi_grep_emit_scratch_bytes": (_I64, [_INT, _I64]),
    "dsi_grep_emit": (_INT, [_P, _INT, _I64, _P, _I64, _INT, _P, _P, _P,
                             _P, _P]),
}


def _declare(lib, signatures: dict) -> None:
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _grep_two_entries(lib, chunks, pats, dlen, bases, *, l_cap: int,
                      bins: int, k: int, emit: bool):
    """Kernel J from ``lib`` through its older two-entry interface, with
    the allocations its wrapper made (seven tensors, two C calls)."""
    n_dev, n = chunks.shape
    dev = {"device": chunks.device}
    stream = torch.cuda.current_stream().cuda_stream
    hist_ext = torch.empty((n_dev, bins + 3), dtype=torch.int32, **dev)
    cand = torch.empty((n_dev, k, 5), dtype=torch.int32, **dev)
    scal = torch.empty((n_dev, 5), dtype=torch.int32, **dev)
    scratch = torch.empty(lib.dsi_grep_step_scratch_bytes(n_dev, n, l_cap, k),
                          dtype=torch.uint8, **dev)
    rc = lib.dsi_grep_step(chunks.data_ptr(), n_dev, n, pats.data_ptr(),
                           pats.shape[1], dlen.data_ptr(), bases.data_ptr(),
                           l_cap, bins, k, hist_ext.data_ptr(),
                           cand.data_ptr(), scal.data_ptr(),
                           scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"grep_step launch failed: CUDA error {rc}")
    if not emit:
        return hist_ext, cand, scal
    comp = torch.empty((n_dev, n), dtype=torch.uint8, **dev)
    kept = torch.empty(n_dev, dtype=torch.int32, **dev)
    emit_scratch = torch.empty(lib.dsi_grep_emit_scratch_bytes(n_dev, n),
                               dtype=torch.uint8, **dev)
    rc = lib.dsi_grep_emit(chunks.data_ptr(), n_dev, n, dlen.data_ptr(),
                           l_cap, k, scratch.data_ptr(),
                           emit_scratch.data_ptr(), comp.data_ptr(),
                           kept.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"grep_emit launch failed: CUDA error {rc}")
    return hist_ext, cand, scal, comp, kept


def _grep_ab(base, raws) -> None:
    """``grep_ab``: J with and without emit from ``base`` (the older
    interface) and from this tree, in turns, at 1 and 8 shards."""
    from dsi_tpu_torch.parallel.grepstream import grep_step, grep_step_plain

    text = b"".join(raws)
    for n_dev in (1, 8):
        batch = np.zeros((n_dev, 1 << 21), np.uint8)
        lens = np.zeros(n_dev, np.int32)
        rest = text
        for r in range(n_dev):
            cut = rest.rfind(b"\n", 0, 1 << 21) + 1
            batch[r, :cut] = np.frombuffer(rest[:cut], np.uint8)
            lens[r] = cut
            rest = rest[cut:]
        args = (torch.from_numpy(batch).cuda(),
                torch.from_numpy(np.tile(np.frombuffer(b"the", np.uint8),
                                         (n_dev, 1))).cuda(),
                torch.from_numpy(lens).cuda(),
                torch.zeros(n_dev, dtype=torch.int64, device="cuda"))
        for emit in (False, True):
            kw = dict(l_cap=1 << 18, bins=8, k=16, emit=emit)
            _ab("grep_ab", f"n_dev={n_dev} emit={emit}",
                [n_dev, 1 << 21, kw["l_cap"]], {
                    "baseline": lambda kw=kw, args=args: _grep_two_entries(
                        base, *args, **kw),
                    "change": lambda kw=kw, args=args: grep_step(*args,
                                                                 **kw)},
                grep_step_plain(*args, **kw))


# The C interface of kernels D and E before D took both layouts and its
# epilogue, and before E's scratch depended on the row width.
_ROUTE_OLDER = {
    "dsi_fnv": (_INT, [_P, _I64, _P, _INT, _P, _P]),
    "dsi_route_scratch_bytes": (_I64, [_INT, _I64]),
    "dsi_route": (_INT, [_P, _P, _INT, _I64, _INT, _INT, _P, _P, _P]),
}


def _route_older(lib, rows, dest, n_dev: int, k: int):
    """Kernel E from ``lib`` through its older interface, with the two
    allocations its wrapper made."""
    _, r, w_ = rows.shape
    recv = torch.empty((n_dev, n_dev * r, w_), dtype=torch.int32,
                       device=rows.device)
    scratch = torch.empty(lib.dsi_route_scratch_bytes(n_dev, r),
                          dtype=torch.uint8, device=rows.device)
    rc = lib.dsi_route(rows.data_ptr(), dest.data_ptr(), n_dev, r, w_, k,
                       recv.data_ptr(), scratch.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"route launch failed: CUDA error {rc}")
    return (recv,)


def _fnv_older(lib, keys64, lens, mwl: int):
    """Kernel D from ``lib`` through its older interface (u64 words)."""
    out = torch.empty(lens.shape[0], dtype=torch.int32, device=lens.device)
    rc = lib.dsi_fnv(keys64.data_ptr(), lens.shape[0], lens.data_ptr(), mwl,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fnv launch failed: CUDA error {rc}")
    return out


def _route_dest_older(lib, keys, lens, valid, n_shards: int, park: int):
    """``route_dest`` as the older tree ran it: the lanes packed into u64
    words, D, then five torch ops."""
    kk = keys.shape[1]
    keys64 = torch.stack(w.pack_key_lanes(tuple(keys[:, j]
                                                for j in range(kk))))
    h = _fnv_older(lib, keys64, lens, 4 * kk)
    dest = ((w._u32_value(h) & 0x7FFFFFFF) % n_shards).to(torch.int32)
    return (torch.where(valid, dest, park).to(torch.int32),)


def _map_rule_older(lib, keys_u, len_u, n_unique, n_reduce: int,
                    n_dev: int):
    """``map_prologue``'s hash and partition rule as the older tree ran
    them: D, then eight torch ops."""
    fnv_u = _fnv_older(lib, keys_u, len_u, 16)
    uvalid = torch.arange(len_u.shape[0], device=len_u.device) < n_unique
    part = (fnv_u & 0x7FFFFFFF) % n_reduce
    dest = torch.where(uvalid, part % n_dev, n_dev).to(torch.int32)
    return fnv_u, part.to(torch.int32), dest


def _route_ab(base, raws) -> None:
    """``route_ab``: kernel E from ``base`` (the older interface and
    wrapper) and from this tree in turns at the stream step, the mesh
    fold, the mesh append and ``tfidf_n8``'s wave; kernel D as
    ``route_dest`` (mesh fold) and ``map_prologue`` (stream step) ran it
    before and run it now, each checked against the plain versions."""
    from dsi_tpu_torch.device import table as dt
    from dsi_tpu_torch.ops.meshroute import route_dest
    from dsi_tpu_torch.parallel.shuffle import (_slice_pack, map_prologue,
                                                mapreduce_step)
    from dsi_tpu_torch.parallel.tfidf import (_wave_chunk, tfidf_wave_step,
                                              wave_rows)

    step = np.zeros(1 << 21, np.uint8)
    step[:len(raws[0])] = np.frombuffer(raws[0], np.uint8)
    chunk = torch.from_numpy(step).cuda()
    keys_u, _, len_u, _, n_unique, *_ = w.group_chunk(
        chunk, max_word_len=16, u_cap=1 << 15, t_cap_frac=4, grouper="sort")
    ep = dict(n_part=10, n_dest=1, park=1, n_valid=n_unique)
    _ab("route_ab", "D stream step (map_prologue)", list(keys_u.shape), {
        "baseline": lambda: _map_rule_older(base, keys_u, len_u, n_unique,
                                            10, 1),
        "change": lambda: w.fnv1a32_route(keys_u, len_u, 16, **ep)},
        w.fnv1a32_route_plain(keys_u, len_u, 16, **ep))
    packed_u, len_u, cnt_u, part, dest, _ = map_prologue(
        chunk, n_dev=1, n_reduce=10, max_word_len=16, u_cap=1 << 15,
        t_cap_frac=4)
    rows1 = torch.cat([packed_u, len_u[:, None], cnt_u[:, None],
                       part[:, None]], dim=1)[None].contiguous()
    shapes = {"stream step": (rows1, dest[None].contiguous(), 1, 4)}

    n_dev = 8
    buf = np.zeros((n_dev, 1 << 21), np.uint8)
    for i, raw in enumerate(raws[:n_dev]):
        buf[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    out = mapreduce_step(torch.from_numpy(buf).cuda(), n_dev=n_dev,
                         n_reduce=10, max_word_len=16, u_cap=1 << 15)
    packed = _slice_pack(*out[:4], mp=out[0].shape[1])
    operands = dt._route_operands(packed, out[4])
    rkw = dict(n_shards=n_dev, park=n_dev)
    _ab("route_ab", "D mesh fold (route_dest)", list(operands[0].shape), {
        "baseline": lambda: _route_dest_older(base, *operands, **rkw),
        "change": lambda: (route_dest(*operands, **rkw),)},
        w.fnv1a32_route_plain(operands[0], operands[1], 16, n_part=n_dev,
                              n_dest=n_dev, park=n_dev,
                              valid=operands[2])[2:])
    shapes["mesh fold"] = (packed, route_dest(*operands, **rkw).view(
        n_dev, -1), n_dev, 4)

    size = 1 << max(8, max(len(r) for r in raws).bit_length())
    cap = w.rung0_cap(size, 1 << 15)
    chunks = torch.from_numpy(_wave_chunk(raws, range(n_dev), n_dev,
                                          size)).cuda()
    ids = torch.arange(n_dev, dtype=torch.int32, device="cuda")
    rows, scal = tfidf_wave_step(chunks, ids, n_dev=n_dev, n_reduce=10,
                                 max_word_len=16, u_cap=cap)
    r = rows.shape[1]
    valid = torch.arange(r, device="cuda")[None, :] < scal[:, :1]
    keys = torch.where(valid[..., None], rows[..., :4], -1).reshape(-1, 4)
    lens = torch.where(valid, rows[..., 4], 0).reshape(-1)
    shapes["mesh append"] = (rows, route_dest(
        keys, lens, valid.reshape(-1), **rkw).view(n_dev, r), n_dev, 4)
    wrows, wdests, _ = wave_rows(chunks, ids, n_dev=n_dev, n_reduce=10,
                                 max_word_len=16, u_cap=cap)
    shapes["tfidf_n8 wave"] = (wrows, wdests, n_dev, 4)
    for at, (rows_, dest_, nd, k) in shapes.items():
        _ab("route_ab", f"E {at}", list(rows_.shape), {
            "baseline": lambda a=(rows_, dest_, nd, k): _route_older(base,
                                                                     *a),
            "change": lambda a=(rows_, dest_, nd, k): (w.shuffle_rows(
                a[0], a[1], n_dev=a[2], k=a[3]),)},
            (w.shuffle_rows_plain(rows_, dest_, n_dev=nd, k=k),))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-csrc", type=Path, default=None,
                    help="csrc directory of the kernel version to compare")
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
    buf, _, _ = _resolve_pieces(raws, None)
    for tag, kw in (("corpus_profile", {}),
                    ("corpus_hash_profile", {"grouper": "hash"}),
                    ("corpus_pack6_profile", {"pack6": True})):
        print(json.dumps({tag: _profile(
            lambda: corpus_wordcount(raws, device="cuda", **kw))}),
            flush=True)

    chunk = torch.from_numpy(buf).cuda()
    keys = w.tokenize(chunk, max_word_len=16, t_cap=len(buf) // 4 + 1)[0]
    print(json.dumps({"sort_profile": _profile(lambda: w.radix_sort(keys),
                                               top=8)}), flush=True)
    if args.baseline_csrc is not None:
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
            sk, perm = w.radix_sort(k)
            sc = cnt[perm.long()]
            _ab("group_ab", at, [*sk.shape, u_cap], {
                name: lambda lib=lib, sk=sk, sc=sc, u=u_cap, pay=pay,
                perm=perm: _group_with(lib, sk, sc, u, pay, perm)
                for name, lib in (("baseline", base), ("change", new))},
                w.group_sorted_plain(sk, sc, u_cap, pay, perm))
        for at, k in (("corpus", keys), ("reduce", r_keys)):
            _ab("sort_ab", at, list(k.shape), {
                name: lambda lib=lib, k=k: _sort_with(lib, k)
                for name, lib in (("baseline", base), ("change", new))},
                w.radix_sort_plain(k))
        # Each A/B is written for the interface its kernels had before
        # their redesign; a baseline that already has the newer one skips it.
        if hasattr(base, "dsi_grep_emit"):
            _declare(base, _GREP_TWO_ENTRIES)
            _grep_ab(base, raws)
        else:
            print(json.dumps({"grep_ab": "skipped: the baseline's J has "
                                         "the one-call interface"}))
        if not hasattr(base, "dsi_route_tile_rows"):
            _declare(base, _ROUTE_OLDER)
            _route_ab(base, raws)
        else:
            print(json.dumps({"route_ab": "skipped: the baseline's D and "
                                          "E have the newer interface"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
