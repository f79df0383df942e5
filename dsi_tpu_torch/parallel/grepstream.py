"""Streaming grep and the streaming indexer on the card: port of
``dsi_tpu/parallel/grepstream.py``.

The grep engine on the port's shared pipeline core (``pipeline.py``): a
background batcher slices a byte-block stream into ``[n_dev,
chunk_bytes]`` batches cut only at newlines (``batch_lines``); every
batch runs ONE launch of kernel J (``grep_step``, ``csrc/grep_step.cu``,
K16) — match, per-line occurrence counts, the histogram, the totals and
the per-row top-k candidates; ``depth`` steps stay in flight and each
step's scalars are read only when it leaves the window.  A step whose
line count overflows the optimistic ``l_cap`` rung replays alone at the
``n + 1`` rung, which sticks.  With ``device_accumulate`` the histogram
folds into a :class:`~dsi_tpu_torch.device.topk.DeviceHistogram` and the
candidates into a :class:`~dsi_tpu_torch.device.topk.DeviceTopK` on the
card, pulled every ``sync_every`` folds under ``SyncPolicy``;
``mesh_shards`` mesh-shards both.

Grep semantics, exactly the reference's (and ``grep_host_oracle``'s): the
stream is '\\n'-delimited byte lines (a trailing newline opens no final
empty line); a line's match count is the number of positions where the
literal pattern starts (overlapping occurrences count); the result is
total / matched lines, occurrences, a ``bins``-bucket histogram of
``min(occ, bins-1)`` and the top-k lines by (occurrences desc, line asc).
Per-(step, shard) top-k pruning is exact: a line in the global top-k is in
the top-k of its own step and shard under the same order.

The engine returns None only when the stream needs the host path (a
non-literal pattern, or a line wider than the chunk).

The indexer (``indexer_streaming``) is the TF-IDF wave walk
(``parallel/tfidf.py``) with one posting row per distinct word per
document: a wave (K19, :func:`indexer_wave_step`) is the TF-IDF wave
with the tf lane 1, plus the df rows in the device table's layout.
Confirmed waves go to the host's ``PostingsTable``, or with
``device_accumulate`` append into ``DevicePostings`` (kernel M; with
``mesh_shards`` the re-routed append, D, E, L, M) while their df rows
fold into a ``DeviceTopK``.  The result is the postings (per-word doc
order = wave order) and the df top-k (df descending, word ascending);
``write_indexer_output`` writes the host indexer app's ``mr-out-*``.

The plan layer's handoffs are here: ``GrepStep(line_sink=)`` emits each
confirmed step's matching lines into a relay (kernel J's emit epilogue,
K16e), and ``IndexerStep(keep_services=True)`` ends its walk with the
device services live in ``step.exported``.

With ``checkpoint_dir`` both engines are crash-resumable (``ckpt/``),
bit-identical to an uninterrupted run: grep saves its accumulators (or
the services' images), the line counter, the sticky ``l_cap`` rung and
the byte cursor; the indexer saves, per word-window rung, the postings
table, the postings buffer's and the df top-k's images and the
confirmed-wave cursor.  Chains are the reference's, so either package
resumes the other's.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``aot`` and ``input_range``.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ckpt import (
    CheckpointPolicy,
    CheckpointStore,
    CheckpointWriter,
    DeltaSteps,
    checkpoint_async_default,
    checkpoint_delta_default,
    drain_packed_steps,
    fault_point,
    skip_stream,
)
from dsi_tpu_torch.device.policy import SyncPolicy, mesh_shards_default
from dsi_tpu_torch.device.table import DeviceTable, _pow2
from dsi_tpu_torch.device.topk import DeviceHistogram, DeviceTopK, KeyCounts
from dsi_tpu_torch.obs import span as _span
from dsi_tpu_torch.ops.grepk import is_literal_pattern, line_cap_rungs
from dsi_tpu_torch.ops.meshroute import compact_rows
from dsi_tpu_torch.ops.wordcount import (
    HostCopy,
    _launch,
    _lib,
    _on_cuda,
    _on_device,
    _ptr,
    _require,
    _u32_bits,
    grouper_ladder,
    resolve_device,
    rung0_cap,
    to_device,
)
from dsi_tpu_torch.parallel.merge import PackedCounts, PostingsTable
from dsi_tpu_torch.parallel.pipeline import (
    BufferPool,
    StepPipeline,
    fold_source_stats,
    pipeline_depth,
    timed,
)
from dsi_tpu_torch.parallel.shuffle import occupied_prefix
from dsi_tpu_torch.parallel.stepobj import EngineStep
from dsi_tpu_torch.parallel.streaming import _not_ported
from dsi_tpu_torch.parallel.tfidf import (
    WaveWalkStep,
    _WaveCkpt,
    _check_rung,
    _lens_crc,
    _postings_buffer,
    _replay_ladder,
    _wave_items,
    plan_waves,
    wave_received,
)

#: Histogram buckets for per-line match counts: bucket b < bins-1 holds
#: lines with exactly b occurrences, the last bucket everything wider.
GREP_BINS = 8

#: The bench grep row's chunk shape (``bench.py run_grep_row``).
GREP_CHUNK_BYTES = 1 << 21

#: Default top-k candidate rows kept per stream.
DEFAULT_TOPK = 16

_BIG = 0x7FFFFFFF


class _LineTooLong(Exception):
    """A line wider than one chunk row: the stream needs the host path."""


def _topk_cap_env() -> int:
    """The ``DSI_DEVICE_TOPK_CAP`` override (0 = unset/malformed): the
    candidate table's starting rung, and the test hook that forces the
    widen path mid-stream."""
    try:
        return max(0, int(os.environ.get("DSI_DEVICE_TOPK_CAP", "0")))
    except ValueError:
        return 0


def _default_topk_cap(n_dev: int, k: int) -> int:
    """Rung-0 capacity of the candidate table, overridable by
    ``DSI_DEVICE_TOPK_CAP``."""
    return _topk_cap_env() or _pow2(max(1 << 14, n_dev * k))


# ── line batching ──────────────────────────────────────────────────────


def batch_lines(blocks: Iterable[bytes], n_dev: int, chunk_bytes: int,
                pool: Optional[BufferPool] = None,
                offsets: Optional[list] = None):
    """Slice a byte-block stream into zero-padded ``[n_dev, chunk_bytes]``
    batches, cutting rows only at newline boundaries so no line straddles
    a row.  Yields ``(batch, lens, row_lines)`` — per-row valid byte
    counts and per-row line counts (newlines plus an unterminated tail
    line).  With ``pool`` batches come from the engine's rotating buffer
    set.  A line wider than ``chunk_bytes`` raises :class:`_LineTooLong`.

    With ``offsets`` (the checkpoint cursor hook, as ``batch_stream``'s)
    the stream offset just past each batch's content is appended before
    the batch is yielded.
    """
    carry = bytearray()
    consumed = 0

    def new_batch() -> np.ndarray:
        if pool is not None:
            return pool.take()
        return np.zeros((n_dev, chunk_bytes), dtype=np.uint8)

    batch = new_batch()
    lens = np.zeros(n_dev, dtype=np.int32)
    row_lines = np.zeros(n_dev, dtype=np.int64)
    row = 0

    def fill_rows(final: bool):
        nonlocal batch, lens, row_lines, row, consumed
        while carry and (len(carry) > chunk_bytes or final):
            if len(carry) <= chunk_bytes:
                cut = len(carry)  # final tail: whole remainder fits
            else:
                win = np.frombuffer(memoryview(carry)[:chunk_bytes],
                                    dtype=np.uint8)
                hits = np.flatnonzero(win == 10)
                del win  # release the export before the carry resize
                if hits.size == 0:
                    raise _LineTooLong
                cut = int(hits[-1]) + 1  # cut AFTER the last newline
            view = np.frombuffer(carry, dtype=np.uint8, count=cut)
            batch[row, :cut] = view
            n_nl = int(np.count_nonzero(view == 10))
            del view
            del carry[:cut]
            consumed += cut
            batch[row, cut:] = 0
            lens[row] = cut
            row_lines[row] = n_nl + (1 if batch[row, cut - 1] != 10 else 0)
            row += 1
            if row == n_dev:
                if offsets is not None:
                    offsets.append(consumed)
                yield batch, lens, row_lines
                batch = new_batch()
                lens = np.zeros(n_dev, dtype=np.int32)
                row_lines = np.zeros(n_dev, dtype=np.int64)
                row = 0

    for block in blocks:
        carry.extend(block)
        yield from fill_rows(final=False)
    yield from fill_rows(final=True)
    if row:
        batch[row:] = 0  # recycled buffer: stale tail rows must not count
        if offsets is not None:
            offsets.append(consumed)
        yield batch, lens, row_lines
    elif pool is not None:
        pool.give(batch)


# ── J: the grep step ───────────────────────────────────────────────────


def grep_step_plain(chunks: torch.Tensor, pats: torch.Tensor,
                    dlen: torch.Tensor, bases: torch.Tensor, *, l_cap: int,
                    bins: int, k: int, emit: bool = False):
    """Plain version of kernel J, the reference's ``_grep_step_device``
    per row of the ``[n_dev, N]`` batch.  ``pats`` [n_dev, m] uint8,
    ``dlen`` [n_dev] int32 valid bytes, ``bases`` [n_dev] int64 (u64
    global line number of each row's first line).  Returns (hist_ext
    [n_dev, bins+3] int32 holding u32: the histogram then n_lines,
    matched, occurrences; cand [n_dev, k, 5] int32 holding u32: rows [hi,
    lo, 8, occ, 0] of the top-k lines, zero past n_cand; scal [n_dev, 5]
    int32: n_cand, n_lines, overflow, matched, occurrences).

    ``emit=True`` (K16e, the plan layer's stage handoff) also returns comp
    [n_dev, N] uint8, the bytes of the matching lines (each with its
    newline) moved, stable, to the front of the row with a zero tail, and
    kept [n_dev] int32, their count.  A byte past line ``l_cap - 1`` takes
    that line's count, as the reference's; such a step overflows and is
    replayed wider before anything reads its bytes."""
    n_dev, n = chunks.shape
    dev = chunks.device
    c = chunks.to(torch.int64)
    padded = torch.cat([c, torch.zeros((n_dev, pats.shape[1]),
                                       dtype=torch.int64, device=dev)], 1)
    match = torch.ones((n_dev, n), dtype=torch.bool, device=dev)
    for j in range(pats.shape[1]):
        match &= padded[:, j:j + n] == pats[:, j:j + 1].to(torch.int64)
    dl = dlen.to(torch.int64).clamp(0, n)
    valid = torch.arange(n, device=dev)[None, :] < dl[:, None]
    nl = ((c == 10) & valid).to(torch.int64)
    line_id = torch.cumsum(nl, 1) - nl  # valid newlines strictly before i
    last = c.gather(1, (dl - 1).clamp(min=0)[:, None])[:, 0]
    n_lines = nl.sum(1) + ((dl > 0) & (last != 10)).to(torch.int64)
    occ = torch.zeros((n_dev, l_cap + 1), dtype=torch.int64, device=dev)
    occ.scatter_add_(1, line_id.clamp(max=l_cap), match.to(torch.int64))
    occ = occ[:, :l_cap]
    lrange = torch.arange(l_cap, device=dev)
    line_valid = lrange[None, :] < n_lines[:, None]
    occv = torch.where(line_valid, occ, 0)
    matched = (occv > 0).sum(1)
    occurrences = occv.sum(1)
    bucket = torch.where(line_valid, occv.clamp(max=bins - 1), bins)
    hist = torch.zeros((n_dev, bins + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, bucket, torch.ones_like(bucket))
    hist_ext = torch.cat([hist[:, :bins],
                          torch.stack([n_lines, matched, occurrences], 1)], 1)
    # (occ desc, line asc) as one ascending key; non-candidates sort last.
    is_cand = line_valid & (occ > 0)
    key = ((_BIG - torch.where(is_cand, occv, 0)) << 32) | lrange[None, :]
    top = torch.sort(key, dim=1).values[:, :k]
    n_cand = matched.clamp(max=k)
    cvalid = torch.arange(k, device=dev)[None, :] < n_cand[:, None]
    gline = bases.to(torch.int64)[:, None] + (top & 0xFFFFFFFF)
    cols = (((gline >> 32) & 0xFFFFFFFF), gline & 0xFFFFFFFF,
            torch.full_like(top, 8), _BIG - (top >> 32),
            torch.zeros_like(top))
    cand = torch.stack([torch.where(cvalid, x, 0) for x in cols], 2)
    scal = torch.stack([n_cand, n_lines, (n_lines > l_cap).to(torch.int64),
                        matched, occurrences], 1)
    out = (_u32_bits(hist_ext), _u32_bits(cand), scal.to(torch.int32))
    if not emit:
        return out
    keep = valid & (occv.gather(1, line_id.clamp(max=l_cap - 1)) > 0)
    rank = torch.cumsum(keep, 1) - keep.to(torch.int64)
    comp = torch.zeros((n_dev, n + 1), dtype=torch.uint8, device=dev)
    comp.scatter_(1, torch.where(keep, rank, n), chunks)
    return out + (comp[:, :n].contiguous(), keep.sum(1).to(torch.int32))


def grep_step(chunks: torch.Tensor, pats: torch.Tensor, dlen: torch.Tensor,
              bases: torch.Tensor, *, l_cap: int, bins: int, k: int,
              emit: bool = False):
    """Kernel J (``csrc/grep_step.cu``); see :func:`grep_step_plain`.
    One C call a step; with ``emit`` it also runs J's emit epilogue (K16e,
    counted as ``grep_emit``) into a ``comp`` allocated for this call.
    hist_ext, cand, scal and kept are views of one int32 allocation."""
    _require(chunks, torch.uint8, 2, "grep_step chunks")
    _require(pats, torch.uint8, 2, "grep_step patterns")
    _require(dlen, torch.int32, 1, "grep_step dlen")
    _require(bases, torch.int64, 1, "grep_step bases")
    n_dev, n = chunks.shape
    if (n < 1 or pats.shape[0] != n_dev or pats.shape[1] < 1
            or dlen.shape[0] != n_dev or bases.shape[0] != n_dev
            or not 1 <= k <= l_cap or not 1 <= bins <= 64):
        raise ValueError(f"grep_step: bad shapes chunks={tuple(chunks.shape)}"
                         f" pats={tuple(pats.shape)} l_cap={l_cap} k={k} "
                         f"bins={bins}")
    if not _on_cuda(chunks):
        return grep_step_plain(chunks, pats, dlen, bases, l_cap=l_cap,
                               bins=bins, k=k, emit=emit)
    lib = _lib()
    dev = chunks.device
    # One int32 allocation for the small outputs; views cut by as_strided
    # (the cheapest on the host, which sets this call's time).
    h, c, sc = n_dev * (bins + 3), n_dev * k * 5, n_dev * 5
    out = torch.empty(h + c + sc + n_dev, dtype=torch.int32, device=dev)
    hist_ext = out.as_strided((n_dev, bins + 3), (bins + 3, 1), 0)
    cand = out.as_strided((n_dev, k, 5), (k * 5, 5, 1), h)
    scal = out.as_strided((n_dev, 5), (5, 1), h + c)
    kept = out.as_strided((n_dev,), (1,), h + c + sc) if emit else None
    # comp is fresh every call: a relay adopts it as its buffer.
    comp = (torch.empty((n_dev, n), dtype=torch.uint8, device=dev) if emit
            else None)
    scratch = torch.empty(_step_scratch_bytes(n_dev, n, l_cap, bins, k),
                          dtype=torch.uint8, device=dev)
    with _on_device(dev):
        rc = lib.dsi_grep_step(
            _ptr(chunks), n_dev, n, _ptr(pats), pats.shape[1], _ptr(dlen),
            _ptr(bases), l_cap, bins, k, _ptr(hist_ext), _ptr(cand),
            _ptr(scal), _ptr(comp), _ptr(kept), _ptr(scratch),
            torch._C._cuda_getCurrentRawStream(dev.index))
    _launch("grep_step", rc)
    if not emit:
        return hist_ext, cand, scal
    _launch("grep_emit", rc)
    return hist_ext, cand, scal, comp, kept


@functools.lru_cache(maxsize=64)
def _step_scratch_bytes(n_dev: int, n: int, l_cap: int, bins: int,
                        k: int) -> int:
    """J's scratch for a step shape, asked of the library once a shape."""
    return _lib().dsi_grep_step_scratch_bytes(n_dev, n, l_cap, bins, k)


# ── results and the host oracle ────────────────────────────────────────


class GrepStreamResult(NamedTuple):
    """Whole-stream grep statistics.  ``hist[b]`` is the number of lines
    with ``min(occurrences, bins-1) == b``; ``topk`` is ``((line_no,
    occ), ...)`` count desc, line asc — exact, not approximate."""

    lines: int
    matched: int
    occurrences: int
    hist: Tuple[int, ...]
    topk: Tuple[Tuple[int, int], ...]


def _count_occurrences(line: bytes, pat: bytes) -> int:
    """Overlapping occurrence count — the engine counts every position
    where the pattern starts (``bytes.count`` is non-overlapping)."""
    n = 0
    i = line.find(pat)
    while i >= 0:
        n += 1
        i = line.find(pat, i + 1)
    return n


def grep_host_oracle(blocks: Iterable[bytes], pattern: str, *,
                     bins: int = GREP_BINS,
                     topk: int = DEFAULT_TOPK) -> GrepStreamResult:
    """Single-pass host oracle with the engine's exact semantics — the
    parity ground truth for the CLI ``--check``, ``chip_smoke.py`` and the
    tests."""
    pat = pattern.encode("ascii")
    hist = [0] * bins
    matched = occurrences = line_no = 0
    cands: List[Tuple[int, int]] = []
    carry = b""

    def take(line: bytes) -> None:
        nonlocal matched, occurrences, line_no
        occ = _count_occurrences(line, pat)
        hist[min(occ, bins - 1)] += 1
        if occ:
            matched += 1
            occurrences += occ
            cands.append((line_no, occ))
        line_no += 1

    for block in blocks:
        parts = (carry + bytes(block)).split(b"\n")
        carry = parts.pop()  # the unterminated tail stays pending
        for line in parts:
            take(line)
    if carry:
        take(carry)  # a final line without a trailing newline
    top = tuple(sorted(cands, key=lambda r: (-r[1], r[0]))[:topk])
    return GrepStreamResult(line_no, matched, occurrences, tuple(hist), top)


def merge_topk(cands: Iterable[Tuple[int, int]],
               k: int) -> Tuple[Tuple[int, int], ...]:
    """Exact global top-k from a union of per-step top-k candidate lists
    (``(line_no, occurrences)`` pairs, line numbers disjoint across
    steps)."""
    return tuple(sorted(cands, key=lambda r: (-r[1], r[0]))[:k])


# ── the engine ─────────────────────────────────────────────────────────


class GrepStep(EngineStep):
    """Step object over the streaming grep (``parallel/stepobj.py``
    lifecycle); parameters as :func:`grep_streaming`.  A non-literal
    pattern routes to the host path at construction (already terminal,
    ``close()`` -> None).

    ``line_sink`` (the plan layer's stage handoff, ``dsi_tpu_torch/plan``)
    is a relay, :class:`~dsi_tpu_torch.device.relay.DeviceRelay` or
    :class:`~dsi_tpu_torch.device.relay.HostRelay`, that receives every
    confirmed step's matching-line bytes through ``append(comp, kept)``:
    each step also runs J's emit epilogue (K16e), and only the confirmed
    attempt of a replayed step reaches the sink."""

    def __init__(self, blocks: Iterable[bytes], pattern: str, n_dev: int = 1,
                 chunk_bytes: int = 1 << 20, depth: Optional[int] = None,
                 aot: bool = False, device_accumulate: bool = False,
                 sync_every: Optional[int] = None,
                 mesh_shards: Optional[int] = None,
                 topk: int = DEFAULT_TOPK, bins: int = GREP_BINS,
                 pipeline_stats: Optional[dict] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_async: Optional[bool] = None,
                 checkpoint_delta: Optional[bool] = None,
                 resume: bool = False, line_sink=None,
                 input_range: Optional[Tuple[int, int]] = None,
                 device=None):
        super().__init__()
        if line_sink is not None and checkpoint_dir:
            # The relay's content is not part of an engine checkpoint, so
            # a mid-stage resume would drop lines already emitted; chains
            # commit at stage boundaries instead.
            raise ValueError("line_sink and checkpoint_dir are exclusive: "
                             "chained stages commit at stage boundaries")
        if aot:
            raise _not_ported("aot", "the kernel build/warm cache")
        if input_range is not None:
            raise _not_ported("input_range", "the plan and serving layers")
        _grep_setup(self, blocks, pattern, n_dev, chunk_bytes, depth,
                    device_accumulate, sync_every, mesh_shards, topk, bins,
                    pipeline_stats, checkpoint_dir, checkpoint_every,
                    checkpoint_async, checkpoint_delta, resume,
                    resolve_device(device), line_sink)


def grep_streaming(
        blocks: Iterable[bytes], pattern: str, n_dev: int = 1,
        chunk_bytes: int = 1 << 20, depth: Optional[int] = None,
        aot: bool = False, device_accumulate: bool = False,
        sync_every: Optional[int] = None,
        mesh_shards: Optional[int] = None, topk: int = DEFAULT_TOPK,
        bins: int = GREP_BINS, pipeline_stats: Optional[dict] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_async: Optional[bool] = None,
        checkpoint_delta: Optional[bool] = None, resume: bool = False,
        device=None) -> Optional[GrepStreamResult]:
    """Whole-stream literal grep with bounded memory, pipelined, over
    ``n_dev`` virtual shards on ``device`` (None = the card).

    Returns a :class:`GrepStreamResult`, or None when the stream needs
    the host path (non-literal pattern, or a line wider than
    ``chunk_bytes``).  A step whose line count overflows the optimistic
    rung (average line >= 8 bytes) is detected ``depth - 1`` steps late
    and replays exactly that step at the ``n + 1`` rung, which then
    sticks.  Results are bit-identical to ``depth=1``.

    ``device_accumulate=True`` folds each confirmed step's histogram into
    a :class:`DeviceHistogram` and its candidate rows into a
    :class:`DeviceTopK` (lag = depth - 1), pulling a top-k snapshot and
    the histogram every ``sync_every`` folds (``DSI_STREAM_SYNC_EVERY``,
    8) plus the close drain: ``step_pulls`` drops to 0, ``sync_pulls``
    counts the windows (+1 close), ``widens`` the candidate table's
    recoveries.  ``mesh_shards`` (default ``DSI_STREAM_MESH_SHARDS``, 0 =
    off; implies ``device_accumulate``) mesh-shards both services.

    ``pipeline_stats`` receives the reference's keys (``batch_s``,
    ``batch_wait_s``, ``upload_s``, ``kernel_s``, ``pull_s``, ``merge_s``,
    ``replay_s``, ``steps``, ``replays``, ``step_pulls``, ``sync_pulls``,
    ``l_cap`` and the services' counters) plus ``dispatch_s``, the
    seconds launching the steps.

    ``checkpoint_dir`` enables crash-resume (``ckpt/``): every
    ``checkpoint_every`` confirmed steps (default
    ``DSI_STREAM_CKPT_EVERY``, 32) a snapshot of the host accumulators
    (or the services' images), the line counter, the sticky ``l_cap``
    rung and the byte cursor; ``resume=True`` restores the newest chain
    and seeks past the cursor, bit-identical to an uninterrupted run.
    ``checkpoint_async`` (``DSI_STREAM_CKPT_ASYNC``) commits in the
    background writer; ``checkpoint_delta`` (``DSI_STREAM_CKPT_DELTA``)
    saves only the candidate rows since the previous save plus the
    cumulative histogram.  ``pipeline_stats`` then also receives the
    ``ckpt_*`` counters and, on resume, ``resume_gap_s`` and
    ``resume_cursor``.  ``aot`` keeps the reference's signature and
    raises ``NotImplementedError``.
    """
    return GrepStep(
        blocks, pattern, n_dev=n_dev, chunk_bytes=chunk_bytes, depth=depth,
        aot=aot, device_accumulate=device_accumulate, sync_every=sync_every,
        mesh_shards=mesh_shards, topk=topk, bins=bins,
        pipeline_stats=pipeline_stats, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, checkpoint_async=checkpoint_async,
        checkpoint_delta=checkpoint_delta, resume=resume,
        device=device).close()


def _grep_setup(step, blocks, pattern, n_dev, chunk_bytes, depth,
                device_accumulate, sync_every, mesh_shards, topk, bins,
                pipeline_stats, checkpoint_dir, checkpoint_every,
                checkpoint_async, checkpoint_delta, resume,
                dev: torch.device, line_sink=None):
    """The engine body behind :class:`GrepStep`: setup (the resume's
    restore included) ending with the pipeline armed and the lifecycle
    hooks attached to ``step``.  With ``line_sink`` every step also runs
    J's emit epilogue, and each confirmed step's matching-line bytes go to
    ``line_sink.append``."""
    emit = line_sink is not None
    if not is_literal_pattern(pattern):
        step._phase = "hostpath"  # terminal before any device work
        return
    depth = pipeline_depth(depth)
    rungs = line_cap_rungs(chunk_bytes)
    state = {"l_cap": rungs[0]}
    stats = {"depth": depth, "steps": 0, "replays": 0, "step_pulls": 0,
             "sync_pulls": 0, "device_accumulate": device_accumulate,
             "l_cap": rungs[0], "batch_s": 0.0, "batch_wait_s": 0.0,
             "upload_s": 0.0, "dispatch_s": 0.0, "kernel_s": 0.0,
             "pull_s": 0.0, "merge_s": 0.0, "replay_s": 0.0}
    on_card = dev.type == "cuda"
    pat_np = np.tile(np.frombuffer(pattern.encode("ascii"), np.uint8),
                     (n_dev, 1))
    pat_dev = torch.from_numpy(pat_np).to(dev)  # once per stream
    next_line = [0]

    # Host-merge accumulators (the depth=1-equivalent path).
    hist_h = np.zeros(bins, dtype=np.int64)
    totals = np.zeros(3, dtype=np.int64)  # lines, matched, occurrences
    cand_h: List[Tuple[int, int]] = []

    mesh_shards = mesh_shards_default(mesh_shards)
    if mesh_shards:
        device_accumulate = True
        stats["device_accumulate"] = True
    acc = KeyCounts()
    hist_svc: Optional[DeviceHistogram] = None
    topk_svc: Optional[DeviceTopK] = None
    policy: Optional[SyncPolicy] = None
    if device_accumulate:
        policy = SyncPolicy(sync_every)
        stats["sync_every"] = policy.sync_every
        stats["mesh_shards"] = mesh_shards
        hist_svc = DeviceHistogram(n_dev, slots=bins + 3, device=dev,
                                   stats=stats, mesh_shards=mesh_shards)
        topk_svc = DeviceTopK(n_dev, kk=2, cap=_default_topk_cap(n_dev, topk),
                              k=topk, acc=acc, device=dev,
                              lag=max(0, depth - 1), stats=stats,
                              mesh_shards=mesh_shards)

    # ── checkpoint/restore (ckpt/) ──
    ck_store: Optional[CheckpointStore] = None
    ck_policy: Optional[CheckpointPolicy] = None
    ck_writer: Optional[CheckpointWriter] = None
    ck_cursor = {"offset": 0, "lines": 0}  # last CONFIRMED step's end
    offsets: Optional[list] = None
    dispatch_idx = [0]
    start_offset = 0
    ck_async = checkpoint_async_default(checkpoint_async)
    ck_delta = checkpoint_delta_default(checkpoint_delta)
    cand_mark = [0]  # the host path's delta watermark into cand_h
    if checkpoint_dir:
        ck_store = CheckpointStore(
            checkpoint_dir, "grep",
            {"n_dev": n_dev, "chunk_bytes": chunk_bytes, "pattern": pattern,
             "bins": bins, "topk": topk,
             "device_accumulate": bool(device_accumulate)})
        ck_policy = CheckpointPolicy(checkpoint_every)
        offsets = []
        stats.update({"ckpt_saves": 0, "ckpt_s": 0.0,
                      "ckpt_every": ck_policy.every, "ckpt_capture_s": 0.0,
                      "ckpt_async": ck_async, "ckpt_delta": ck_delta})
        ck_writer = CheckpointWriter(ck_store, stats, async_=ck_async,
                                     delta=ck_delta)
        if ck_delta and topk_svc is not None:
            topk_svc.enable_delta()
        if resume:
            t_res = time.perf_counter()
            loaded = ck_store.load_latest_chain()
            if loaded is not None:
                meta, arrays, deltas = loaded
                # Cursor and rung are newest-wins: the last delta's meta
                # is the restore point; the base meta names the images.
                eff = deltas[-1][0] if deltas else meta
                start_offset = int(eff["cursor"])
                ck_cursor.update(offset=start_offset,
                                 lines=int(eff["lines"]))
                next_line[0] = int(eff["lines"])
                state["l_cap"] = int(eff["l_cap"])
                stats["l_cap"] = state["l_cap"]
                if device_accumulate:
                    acc.restore({k[3:]: v for k, v in arrays.items()
                                 if k.startswith("kc_")})
                    # The histogram is cumulative and rides every delta
                    # whole: the newest copy wins.
                    hist_img = arrays.get("hist")
                    for _, darr in deltas:
                        if "hist" in darr:
                            hist_img = darr["hist"]
                    if hist_img is not None:
                        hist_svc.restore_state({"hist": hist_img})
                    if meta.get("table_cap"):
                        img = {k[6:]: v for k, v in arrays.items()
                               if k.startswith("table_")}
                        same_degree = (int(meta.get("mesh_shards", 0))
                                       == mesh_shards)
                        if deltas or not same_degree:
                            # A chain (or a change of sharding degree)
                            # re-enters through the drain: the image's
                            # rows go to the KeyCounts, the table starts
                            # empty and the resumed folds rebuild it.
                            DeviceTable.drain_image(acc, img)
                            if not same_degree:
                                stats["resharded_resume"] = int(
                                    meta.get("mesh_shards", 0))
                        else:
                            topk_svc.restore_state(img)
                            if ck_delta:
                                topk_svc.enable_delta()
                    policy.restore(eff.get("sync_since", 0))
                    for _, darr in deltas:
                        # Each delta's candidate steps re-enter the
                        # accumulator in save order, the drain argument.
                        drain_packed_steps(acc, darr)
                else:
                    if "gs_hist" in arrays:
                        hist_h[:] = arrays["gs_hist"]
                        totals[:] = arrays["gs_totals"]
                    if "gs_cands" in arrays:
                        cand_h.extend((int(a), int(b)) for a, b
                                      in arrays["gs_cands"].tolist())
                    for _, darr in deltas:
                        # Cumulative counters newest-wins; candidate rows
                        # are the append-only log's increments.
                        hist_h[:] = darr["gs_hist"]
                        totals[:] = darr["gs_totals"]
                        if "gs_cands" in darr:
                            cand_h.extend((int(a), int(b)) for a, b
                                          in darr["gs_cands"].tolist())
                    cand_mark[0] = len(cand_h)
            stats["resume_gap_s"] = time.perf_counter() - t_res
            stats["resume_cursor"] = start_offset
        else:
            ck_store.reset()  # a fresh lineage: no stale chain may resume

    def save_ckpt() -> None:
        """One consistent snapshot at a confirmed-step boundary: capture
        here, commit inline or in the background writer.  The device
        images first (flushing the top-k's lag can widen, and that drain
        lands in the KeyCounts), the host residue second.  A delta save
        ships the candidate rows appended since the previous save and the
        cumulative histogram (KBs, newest wins on restore); every
        ``DSI_STREAM_CKPT_REBASE``-th save, and any save after a window
        that overflowed its log, is full."""
        with _span("ckpt", stats=stats, key="ckpt_s",
                   lines=ck_cursor["lines"]):
            meta = {"cursor": ck_cursor["offset"],
                    "lines": ck_cursor["lines"], "l_cap": state["l_cap"]}
            kind = "full"
            parts = None
            with _span("ckpt_capture", lane="ckpt", stats=stats,
                       key="ckpt_capture_s"):
                if ck_writer.want_delta():
                    if device_accumulate:
                        entries = topk_svc.take_delta()
                        if entries is not None:
                            parts = [("", DeltaSteps(entries)),
                                     ("", hist_svc.checkpoint_capture())]
                            meta["sync_since"] = policy.snapshot()
                            kind = "delta"
                    else:
                        new_cands = cand_h[cand_mark[0]:]
                        cand_mark[0] = len(cand_h)
                        d_arrays = {"gs_hist": hist_h.copy(),
                                    "gs_totals": totals.copy()}
                        if new_cands:
                            d_arrays["gs_cands"] = np.array(new_cands,
                                                            dtype=np.int64)
                        parts = [("", d_arrays)]
                        kind = "delta"
                if parts is None:
                    # A full image, and a fresh delta window: payloads
                    # recorded before this base are inside it.
                    parts = []
                    if device_accumulate:
                        parts.append(("table_",
                                      topk_svc.checkpoint_capture()))
                        meta["table_cap"] = topk_svc.cap
                        meta["table_kk"] = topk_svc.kk
                        meta["mesh_shards"] = topk_svc.mesh_shards
                        parts.append(("", hist_svc.checkpoint_capture()))
                        parts.append(("kc_", acc.snapshot()))
                        meta["sync_since"] = policy.snapshot()
                        if ck_delta:
                            topk_svc.take_delta()
                    else:
                        arrays = {"gs_hist": hist_h.copy(),
                                  "gs_totals": totals.copy()}
                        if cand_h:
                            arrays["gs_cands"] = np.array(cand_h,
                                                          dtype=np.int64)
                        parts.append(("", arrays))
                    cand_mark[0] = len(cand_h)
            fault_point("mid-capture")
            ck_writer.commit(parts, meta, kind=kind)

    def pinned_batch() -> np.ndarray:
        # The numpy view keeps the pinned tensor alive.
        return torch.zeros((n_dev, chunk_bytes), dtype=torch.uint8,
                           pin_memory=True).numpy()

    pool = BufferPool((n_dev, chunk_bytes), retain=2 * depth + 3,
                      alloc=pinned_batch if on_card else None)

    def give_back(buf: np.ndarray, uploaded) -> None:
        if uploaded is not None:
            uploaded.synchronize()  # the copy out of buf has completed
        pool.give(buf)

    def step_call(buf, lens_np, bases_np, l_cap):
        """Upload one batch (a ``non_blocking`` copy from the pinned pool
        buffer plus the event that guards its reuse) and launch J, with
        its emit epilogue when there is a line sink: ``emitted`` is then
        (comp, kept in flight to the host), else None.  kept (n_dev
        int32s) comes back with its own event, so a confirmed step's pull
        waits for that step alone."""
        with timed(stats, "upload_s"):
            if on_card:
                chunks = torch.from_numpy(buf).to(dev, non_blocking=True)
                uploaded = torch.cuda.Event()
                uploaded.record(torch.cuda.current_stream(dev))
            else:
                chunks, uploaded = torch.from_numpy(buf.copy()), None
            lens = torch.from_numpy(lens_np.copy()).to(dev)
            bases = torch.from_numpy(bases_np.copy()).to(dev)
        with timed(stats, "dispatch_s"):
            outs = grep_step(chunks, pat_dev, lens, bases, l_cap=l_cap,
                             bins=bins, k=topk, emit=emit)
            emitted = (outs[3], HostCopy(outs[4])) if emit else None
        return outs[0], outs[1], outs[2], emitted, uploaded

    def dispatch(item):
        buf, lens_np, row_lines = item
        bases = np.zeros(n_dev, dtype=np.int64)
        bases[0] = next_line[0]
        np.cumsum(row_lines[:-1], out=bases[1:])
        bases[1:] += next_line[0]
        next_line[0] += int(row_lines.sum())
        hist_d, cand_d, scal, emitted, uploaded = step_call(
            buf, lens_np, bases, state["l_cap"])
        stats["steps"] += 1
        rec_offset = 0
        if offsets is not None:
            # This step's cursor: the absolute stream offset just past its
            # batch (appended before the batch was queued).
            rec_offset = start_offset + offsets[dispatch_idx[0]]
            dispatch_idx[0] += 1
        fault_point("post-dispatch")
        return (buf, uploaded, lens_np, row_lines, bases, state["l_cap"],
                hist_d, cand_d, scal, HostCopy(scal), emitted, rec_offset,
                next_line[0])

    def replay_step(buf, lens_np, bases_np, used_l_cap):
        """Late-detected line-capacity overflow: replay just this step at
        the wider sticky rung.  Exactly once — the optimistic attempt's
        tensors are dropped unmerged, its emitted bytes included
        (occurrence counts and kept bytes do not depend on the rung, so
        the replay reproduces them exactly)."""
        stats["replays"] += 1
        with timed(stats, "replay_s"):
            for l_cap in rungs:
                if l_cap <= used_l_cap:
                    continue
                hist_d, cand_d, scal, emitted, _ = step_call(
                    buf, lens_np, bases_np, l_cap)
                scal_np = scal.cpu().numpy()  # waits for the launch
                if not scal_np[:, 2].any():
                    state["l_cap"] = max(state["l_cap"], l_cap)
                    stats["l_cap"] = state["l_cap"]
                    return hist_d, cand_d, scal, scal_np, emitted
        raise RuntimeError("grep l_cap ladder exhausted (n+1 must fit)")

    def finish_one(record) -> None:
        buf, uploaded, lens_np, row_lines, bases_np, l_cap_used, hist_d, \
            cand_d, scal, scal_host, emitted, rec_offset, rec_lines = record
        with timed(stats, "kernel_s"):
            scal_np = scal_host.wait()  # blocks until the step lands
        if scal_np[:, 2].any():  # l_cap overflow: replay wider, sticky
            hist_d, cand_d, scal, scal_np, emitted = replay_step(
                buf, lens_np, bases_np, l_cap_used)
        if not np.array_equal(scal_np[:, 1].astype(np.int64), row_lines):
            # The global line numbering depends on host/device agreeing
            # on per-row line counts; a disagreement is an engine bug and
            # must fail loudly, never skew the keys silently.
            give_back(buf, uploaded)
            raise RuntimeError(
                f"host/device line-count disagreement: "
                f"{row_lines.tolist()} vs {scal_np[:, 1].tolist()}")
        if device_accumulate:
            hist_svc.fold(hist_d)
            if int(scal_np[:, 0].max()) > 0:
                topk_svc.fold(cand_d, scal, scal_np)
            policy.note_fold()
            if policy.due():
                fault_point("pre-sync")
                topk_svc.sync()
                hist_svc.pull()
                stats["sync_pulls"] += 1
                policy.reset()
        else:
            with timed(stats, "pull_s"):
                hist_np = hist_d.cpu().numpy().view(np.uint32)
                cand_np = cand_d.cpu().numpy().view(np.uint32)
                stats["step_pulls"] += 1
            with timed(stats, "merge_s"):
                hist_h[:] += hist_np[:, :bins].astype(np.int64).sum(axis=0)
                totals[:] += hist_np[:, bins:].astype(np.int64).sum(axis=0)
                for d in range(n_dev):
                    for i in range(int(scal_np[d, 0])):
                        line = (int(cand_np[d, i, 0]) << 32) | int(
                            cand_np[d, i, 1])
                        cand_h.append((line, int(cand_np[d, i, 3])))
        if emitted is not None:
            # The stage handoff: this confirmed step's matching-line bytes
            # go to the relay, resident (DeviceRelay) or pulled
            # (HostRelay); the kept counts are the only host metadata.
            comp_d, kept_host = emitted
            line_sink.append(comp_d, kept_host.wait().astype(np.int64))
        # The step is confirmed: merged or folded, and nothing after it.
        # The fault point sits before the cursor moves, the torn-update
        # instant.
        fault_point("mid-fold")
        if ck_store is not None:
            ck_cursor["offset"] = rec_offset
            ck_cursor["lines"] = rec_lines
            ck_policy.note_step()
            if ck_policy.due():
                save_ckpt()
                ck_policy.reset()
        give_back(buf, uploaded)

    pipe = StepPipeline(depth=depth, dispatch=dispatch, finish=finish_one,
                        stats=stats, produce_key="batch_s",
                        wait_key="batch_wait_s",
                        inflight_key="max_inflight_chunks",
                        thread_name="dsi-grep-batcher")
    step._pipe = pipe
    step._cursor_ref = ck_cursor
    feed = skip_stream(blocks, start_offset) if start_offset else blocks
    pipe.begin(lambda: batch_lines(feed, n_dev, chunk_bytes, pool=pool,
                                   offsets=offsets))
    step._host_excs = (_LineTooLong,)
    step._save = save_ckpt if ck_store is not None else None
    step._writer = ck_writer
    if resume:
        step._restore_info = {
            "resume_cursor": stats.get("resume_cursor", 0),
            "resume_gap_s": stats.get("resume_gap_s", 0.0)}

    def on_complete():
        h, t, cands = hist_h, totals, cand_h
        if device_accumulate:
            fault_point("pre-sync")
            topk_svc.close()  # the exact final drain into the KeyCounts
            final = hist_svc.close()
            h = final[:bins]
            t = final[bins:]
            cands = list(acc.finalize().items())
        if ck_writer is not None:
            ck_writer.drain()  # commit errors surface; counters settle
        top = tuple(sorted(cands, key=lambda r: (-r[1], r[0]))[:topk])
        step.result = GrepStreamResult(int(t[0]), int(t[1]), int(t[2]),
                                       tuple(int(x) for x in h), top)

    released = []

    def release():
        if released:  # idempotent: close() after a failure re-runs it
            return
        released.append(True)
        if ck_writer is not None:
            ck_writer.shutdown()
        fold_source_stats(stats, blocks)
        if pipeline_stats is not None:
            stats["batch_allocs"] = pool.allocs
            pipeline_stats.update(stats)

    step._on_complete = on_complete
    step._release = release


# ── the streaming indexer ──────────────────────────────────────────────


def indexer_wave_step(chunks: torch.Tensor, doc_ids: torch.Tensor, *,
                      n_dev: int, n_reduce: int, max_word_len: int,
                      u_cap: int, t_cap_frac: int = 4,
                      grouper: str = "sort"):
    """One indexer wave (K19, reference ``_idx_device_step`` :1101 under
    ``_idx_wave_step_impl`` :1148): the TF-IDF wave (kernels A-E, then
    L) with the tf lane 1 on every row, one posting row per distinct word
    per document.  ``chunks`` [n_dev, L] uint8, one zero-padded document
    a shard; ``doc_ids`` [n_dev] int32.  Runs where the tensors lie and
    never waits on the card.

    Returns per-shard posting rows [n_dev, n_dev*u_cap, K+4] int32 (u32
    bits: key lanes, len, 1, doc, part), valid rows first in received
    order, then the pad rows; the df rows [n_dev, n_dev*u_cap, K+3], the
    same rows without the doc lane (``DeviceTable``'s (keys, len, count,
    part) layout, count 1); and [n_dev, 5] int32 scalars (n_rows,
    n_unique, max_len, has_high, token_overflow)."""
    k = max_word_len // 4
    recv, map_scal = wave_received(
        chunks, doc_ids, n_dev=n_dev, n_reduce=n_reduce,
        max_word_len=max_word_len, u_cap=u_cap, t_cap_frac=t_cap_frac,
        grouper=grouper, tf_ones=True)
    srecv, n_rows = compact_rows(recv, pad_lanes=2)
    df = torch.cat([srecv[..., :k + 2], srecv[..., k + 3:k + 4]], dim=2)
    return srecv, df, torch.cat([n_rows[:, None], map_scal], dim=1)


class IndexerStep(WaveWalkStep):
    """Step object over the streaming indexer's wave walk
    (``parallel/stepobj.py`` lifecycle, the word-window ladder of
    ``parallel/tfidf.py WaveWalkStep``); parameters as
    :func:`indexer_streaming`.

    ``keep_services=True`` (the plan layer's stage handoff) ends the walk
    without draining the device services: ``exported`` then holds the live
    :class:`DeviceTopK` df table (``topk_svc``), the
    :class:`~dsi_tpu_torch.device.postings.DevicePostings` buffer
    (``postings_svc``) and the host accumulators (``df_acc``, ``table``),
    so a downstream stage can take a k-row df snapshot and a selective
    postings join instead of the full result; ``result`` is then a
    handoff marker, not the (postings, topk) tuple."""

    def __init__(self, docs: Sequence[bytes], n_dev: int = 1,
                 n_reduce: int = 10, max_word_len: int = 16,
                 u_cap: int = 1 << 15, depth: Optional[int] = None,
                 device_accumulate: bool = False,
                 sync_every: Optional[int] = None,
                 mesh_shards: Optional[int] = None,
                 topk: int = DEFAULT_TOPK, stats: Optional[dict] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_async: Optional[bool] = None,
                 checkpoint_delta: Optional[bool] = None,
                 resume: bool = False, keep_services: bool = False,
                 input_range: Optional[Tuple[int, int]] = None,
                 device=None):
        super().__init__()
        if input_range is not None:
            raise _not_ported("input_range", "the plan and serving layers")
        self.exported: Optional[dict] = None
        _indexer_setup(self, docs, n_dev, n_reduce, max_word_len, u_cap,
                       depth, device_accumulate, sync_every, mesh_shards,
                       topk, stats, checkpoint_dir, checkpoint_every,
                       checkpoint_async, checkpoint_delta, resume,
                       resolve_device(device), keep_services)


def indexer_streaming(
        docs: Sequence[bytes], n_dev: int = 1, n_reduce: int = 10,
        max_word_len: int = 16, u_cap: int = 1 << 15,
        depth: Optional[int] = None, device_accumulate: bool = False,
        sync_every: Optional[int] = None,
        mesh_shards: Optional[int] = None, topk: int = DEFAULT_TOPK,
        stats: Optional[dict] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_async: Optional[bool] = None,
        checkpoint_delta: Optional[bool] = None, resume: bool = False,
        device=None):
    """Whole-corpus inverted index in waves of ``n_dev`` documents over
    ``n_dev`` virtual shards on ``device`` (None = the card), ``depth``
    waves in flight (default ``DSI_STREAM_PIPELINE_DEPTH``, 2).

    Returns ``(postings, topk)``: ``postings`` is ``{word: (part, [doc
    indices in wave order])}`` and ``topk`` ``((df, word), ...)``, the
    ``topk`` words of highest document frequency, df descending, word
    ascending; or None when a document needs the host path (non-ASCII
    bytes, a word longer than 64).  The exactness discipline is
    ``tfidf_sharded``'s: waves dispatch at a sticky (capacity, grouper,
    frac) rung, a wave's scalars are checked when it leaves the window, a
    failed check replays exactly that wave, and a word wider than the
    packed window restarts the walk at the 64-byte rung.

    ``device_accumulate=True`` appends each confirmed wave's posting rows
    into the card's :class:`~dsi_tpu_torch.device.postings.DevicePostings`
    and folds its df rows into a
    :class:`~dsi_tpu_torch.device.topk.DeviceTopK` on the same
    confirmation; both are pulled every ``sync_every`` waves (default
    ``DSI_STREAM_SYNC_EVERY``, 8; the top-k as a k-row snapshot) and
    drained at the end.  ``DSI_DEVICE_POSTINGS_CAP`` and
    ``DSI_DEVICE_TOPK_CAP`` set their starting capacities.
    ``mesh_shards`` (default ``DSI_STREAM_MESH_SHARDS``, 0 = off; implies
    ``device_accumulate``) re-routes both services by ``ihash(word) %
    mesh_shards``.  Postings (per-word order included) and the top-k are
    the same in every mode.

    ``stats`` receives ``tfidf_sharded``'s wave counters and seconds,
    ``finalize_s`` (building the result on the host) and the services'
    counters (``folds``, ``widens``, ``topk_snapshots``, ...).

    ``checkpoint_dir``/``checkpoint_every``/``checkpoint_async``/
    ``checkpoint_delta``/``resume`` follow ``grep_streaming``'s
    crash-resume contract with a wave cursor: the cursor is the
    confirmed-wave ordinal (``plan_waves`` is a function of the document
    lengths, whose CRC is part of the chain's identity), and a snapshot
    holds the postings table, the postings buffer's and the df top-k's
    images, the df accumulator and the sticky rung, tagged with its
    word-window rung.  Resumed postings (per-word order included) and
    the top-k equal an uninterrupted run's; ``stats`` then also receives
    ``resume_gap_s`` and ``resume_wave``.
    """
    return IndexerStep(
        docs, n_dev=n_dev, n_reduce=n_reduce, max_word_len=max_word_len,
        u_cap=u_cap, depth=depth, device_accumulate=device_accumulate,
        sync_every=sync_every, mesh_shards=mesh_shards, topk=topk,
        stats=stats, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, checkpoint_async=checkpoint_async,
        checkpoint_delta=checkpoint_delta, resume=resume,
        device=device).close()


def _indexer_setup(step, docs, n_dev, n_reduce, max_word_len, u_cap,
                   depth, device_accumulate, sync_every, mesh_shards, topk,
                   stats, checkpoint_dir, checkpoint_every, checkpoint_async,
                   checkpoint_delta, resume, dev: torch.device,
                   keep_services: bool = False):
    """The engine body behind :class:`IndexerStep`: corpus-wide setup
    (the chain to resume loaded), then ``begin_rung`` arms the pipeline
    and attaches the lifecycle hooks."""
    depth = pipeline_depth(depth)
    # ``mesh_shards`` re-routes the postings buffer AND the df top-k by
    # ``ihash(word) % n_shards``: word state shards by key.
    mesh_shards = mesh_shards_default(mesh_shards)
    if mesh_shards:
        device_accumulate = True
    doc_lens = getattr(docs, "lengths", None)
    if doc_lens is None:
        doc_lens = [len(d) for d in docs]
    waves = plan_waves(doc_lens, n_dev)
    longest = max(doc_lens, default=1)
    size_max = 1 << max(8, int(longest).bit_length())
    n_real = len(docs)
    st = {"waves": len(waves), "step_pulls": 0, "depth": depth,
          "replays": 0, "device_accumulate": device_accumulate,
          "upload_s": 0.0, "dispatch_s": 0.0, "kernel_s": 0.0,
          "pull_s": 0.0, "merge_s": 0.0, "replay_s": 0.0,
          "finalize_s": 0.0, "sync_pulls": 0}
    groupers = grouper_ladder(dev)
    chain = _WaveCkpt(
        checkpoint_dir, checkpoint_every, checkpoint_async, checkpoint_delta,
        resume, "indexer",
        {"n_dev": n_dev, "n_reduce": n_reduce, "u_cap": u_cap,
         "n_docs": n_real, "doc_lens_crc32": _lens_crc(doc_lens),
         "topk": topk, "device_accumulate": bool(device_accumulate)})

    def begin_rung(mwl: int):
        kk = mwl // 4
        table = PostingsTable()
        # Sticky dispatch rung: only ever moves toward more headroom.
        state = {"cap": rung0_cap(size_max, u_cap),
                 "grouper": groupers[0], "frac": 4}
        outcome = {"high": False}

        def buffer_rows(r: np.ndarray) -> None:
            """One shard's pulled posting rows into the host table, the
            short last wave's padding documents filtered first."""
            r = r[r[:, kk + 2] < n_real]
            if len(r):
                table.add(r, kk)

        df_acc = PackedCounts()
        buf_dev = policy = None
        if device_accumulate:
            buf_dev, policy = _postings_buffer(
                n_dev, kk, n_dev * state["cap"], buffer_rows, dev, depth, st,
                mesh_shards, sync_every)

        def make_topk(kk_: int, cap: int) -> DeviceTopK:
            return DeviceTopK(n_dev, kk=kk_, cap=cap, k=topk, acc=df_acc,
                              device=dev, lag=max(0, depth - 1), stats=st,
                              mesh_shards=mesh_shards)

        # Checkpoints: a fresh writer per rung, and the loaded chain
        # applied only at its own rung.  The df table (``ck.topk``) is
        # made at the first confirmed wave, sized by it, unless a
        # same-degree full image restores it.
        ck = chain.rung(mwl, st, state, table, buf_dev, policy, buffer_rows,
                        mesh_shards, df_acc=df_acc, make_topk=make_topk)

        def wave_call(chunk_np, ids_np, cap, frac, g):
            """Upload and launch one wave at one rung; no waiting."""
            with timed(st, "upload_s"):
                chunks = to_device(chunk_np.reshape(-1), dev).view(n_dev, -1)
                ids = torch.as_tensor(ids_np, device=dev)
            with timed(st, "dispatch_s"):
                return indexer_wave_step(chunks, ids, n_dev=n_dev,
                                         n_reduce=n_reduce, max_word_len=mwl,
                                         u_cap=cap, t_cap_frac=frac,
                                         grouper=g)

        def dispatch(item):
            chunk_np, ids_np = item
            rows, df, scal = wave_call(chunk_np, ids_np, state["cap"],
                                       state["frac"], state["grouper"])
            out = (chunk_np, ids_np, rows, df, scal, HostCopy(scal),
                   state["cap"])
            fault_point("post-dispatch")
            return out

        def replay_wave(chunk_np, ids_np):
            """The exactness ladder for ONE wave; the rung that cleared
            sticks."""
            st["replays"] += 1
            with timed(st, "replay_s"):
                (rows, df, scal), scal_np, rung = _replay_ladder(
                    lambda cap, frac, g: wave_call(chunk_np, ids_np, cap,
                                                   frac, g),
                    groupers, state["cap"], mwl, outcome)
            state["cap"], state["grouper"], state["frac"] = rung
            return rows, df, scal, scal_np

        def commit(rows, df, scal, scal_np):
            m = int(scal_np[:, 0].max())
            if m == 0:
                return
            if buf_dev is not None:
                # The df fold rides the SAME confirmation: only waves the
                # postings path accepted fold their frequency rows.
                # Rung-0 capacity: the wave's row count (one fold never
                # overflows it) unless DSI_DEVICE_TOPK_CAP asks for less.
                topk_svc = ck.df_topk(kk, _topk_cap_env() or int(df.shape[1]))
                pulls_before = st["sync_pulls"]
                buf_dev.append(rows, scal,
                               nvalid=scal_np[:, 0].astype(np.int64))
                topk_svc.fold(df, scal, scal_np)
                policy.note_fold()
                if st["sync_pulls"] != pulls_before:
                    policy.reset()  # an overflow recovery just drained:
                    # that was this window's pull
                elif policy.due():
                    fault_point("pre-sync")
                    buf_dev.sync()
                    topk_svc.sync()
                    policy.reset()
                return
            # Pull only the occupied prefix (pow2-rounded): the copy
            # tracks this wave's postings, not the capacity.
            with timed(st, "pull_s"):
                mp = occupied_prefix(m, rows.shape[1])
                rows_np = rows[:, :mp].cpu().numpy().view(np.uint32)
                st["step_pulls"] += 1
            with timed(st, "merge_s"):
                for d in range(n_dev):
                    nr = int(scal_np[d, 0])
                    if nr:
                        buffer_rows(rows_np[d, :nr])
                ck.note_pulled(rows_np, scal_np[:, 0])

        def finish(rec):
            """Retire the oldest in-flight wave: deferred scalar check,
            then commit (clean) or replay at a wider rung (overflow)."""
            chunk_np, ids_np, rows, df, scal, scal_host, cap = rec
            with timed(st, "kernel_s"):
                scal_np = scal_host.wait()  # blocks until the wave lands
            _check_rung(scal_np, mwl, outcome)
            if scal_np[:, 4].any() or int(scal_np[:, 1].max()) > cap:
                # Late-found overflow: replay just this wave, exactly once.
                rows, df, scal, scal_np = replay_wave(chunk_np, ids_np)
            commit(rows, df, scal, scal_np)
            ck.after_wave()

        pipe = StepPipeline(depth=depth, dispatch=dispatch, finish=finish,
                            stats=st, produce_key="materialize_s",
                            wait_key="materialize_wait_s",
                            inflight_key="max_inflight_waves",
                            thread_name="dsi-idx-materializer")
        step._pipe = pipe
        step._mwl = mwl
        step._outcome = outcome
        step._save = ck.save if ck.policy is not None else None
        step._writer = ck.writer
        pipe.begin(lambda: _wave_items(docs, waves[ck.start_wave:], n_dev))

        def end_ok():
            if keep_services:
                # The plan handoff: the walk is done, the device services
                # stay resident; the downstream stages take a k-row df
                # snapshot and close the postings buffer themselves.
                ck.end(close_services=False)
                step.exported = {
                    "kk": kk, "n_real": n_real, "topk": topk,
                    "device_accumulate": device_accumulate,
                    "topk_svc": ck.topk, "postings_svc": buf_dev,
                    "df_acc": df_acc, "table": table,
                    "buffer_rows": buffer_rows}
                step.result = ("plan-handoff",)
                return
            ck.end()  # the end-of-walk drain, then the writer's
            with timed(st, "finalize_s"):
                postings = {w: (part, [d for d, _ in pairs])
                            for w, (part, pairs) in table.finalize().items()}
                if ck.topk is not None:
                    df_map = {w: c for w, (c, _) in df_acc.finalize().items()}
                else:
                    df_map = {w: len(ds) for w, (_, ds) in postings.items()}
                top = tuple(sorted(((c, w) for w, c in df_map.items()),
                                   key=lambda r: (-r[0], r[1]))[:topk])
            step.result = (postings, top)

        step._on_complete = end_ok

    # The word-window ladder: a word wider than the packed window re-keys
    # every row, so that overflow class restarts the walk at 64.
    step._rungs = chain.rungs((max_word_len, 64) if max_word_len < 64
                              else (max_word_len,))
    step._begin_rung = begin_rung

    released = []

    def release():
        if released:
            return
        released.append(True)
        if step._writer is not None:  # the current rung's writer
            step._writer.shutdown()
        fold_source_stats(st, docs)  # a doc source may pool-read too
        if stats is not None:
            stats.update(st)

    step._release = release
    begin_rung(step._rungs[0])


def write_indexer_output(result, doc_names: Sequence[str], n_reduce: int,
                         workdir: str = ".") -> List[str]:
    """``mr-out-<r>`` files byte-identical to the host indexer app's
    reduce output (``"<count> <doc1>,<doc2>,..."``, documents sorted and
    deduplicated), through the shared partitioned writer."""
    from dsi_tpu_torch.parallel.shuffle import write_partitioned_output

    postings, _ = result if isinstance(result, tuple) else (result, ())
    formatted = {}
    for w, (part, doc_ids) in postings.items():
        names = sorted({doc_names[d] for d in doc_ids})
        formatted[w] = (f"{len(names)} {','.join(names)}", part)
    return write_partitioned_output(formatted, n_reduce, workdir)
