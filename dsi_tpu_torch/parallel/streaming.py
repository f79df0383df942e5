"""Streaming SPMD word count: corpus size decoupled from device memory.

Port of ``dsi_tpu/parallel/streaming.py`` (``batch_stream``,
``stream_files``, ``WordcountStep``, ``wordcount_streaming``).  The
corpus arrives as an iterator of byte blocks; a carry buffer slices it
into fixed ``[n_dev, chunk_bytes]`` batches cut only at non-letter
boundaries; every batch runs ``parallel/shuffle.py mapreduce_step``
(kernels A-E); per-step grouped counts merge into a host accumulator
(``PackedCounts``) or, with ``device_accumulate``, fold into a table on
the card (``device/table.py``) that the host pulls every ``sync_every``
folds; with ``mesh_shards`` that table is mesh-sharded (its fold routes
every key to shard ``ihash % mesh_shards``).  Every step walks the
device's grouper ladder (``ops/wordcount.py grouper_ladder``).

The stream is a pipeline: ``depth`` steps stay in flight (default 2).
A background batcher thread slices blocks into a bounded queue of
pinned host buffers; the main thread uploads (one ``non_blocking`` copy
per step, guarded by a CUDA event) and launches step k+1 while step k's
kernels run.  Each step's scalars go to the host as a ``non_blocking``
copy into pinned memory with an event, and are read only when the step
leaves the window; a step that overflowed its rung replays alone through
the shared exactness ladder at a wider one, disturbing nothing merged
before it, and the rung that cleared (capacity, word window, grouper and
token buffer) sticks for later steps.  A batch buffer goes back to the
pool only once its step is confirmed and its upload has completed.
Nothing on the dispatch side waits on the card.

With ``wire_upload`` the host encodes each batch (``ops/wirecodec.py``
``encode_chunk``), uploads the packed tensor and decodes it on the card
(kernel N) into the chunk the step reads; a batch the codec cannot shrink
uploads raw.

With ``device_batches`` (the plan layer's stage handoff) the engine reads
ready ``[n_dev, chunk_bytes]`` batches instead of a block stream: device
tensors (an upstream relay's buffers) are consumed in place, host arrays
(spilled or restored buffers) are uploaded.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``aot``, checkpoints and ``input_range``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from dsi_tpu_torch.device.policy import SyncPolicy, mesh_shards_default
from dsi_tpu_torch.device.table import DeviceTable
from dsi_tpu_torch.ops.wirecodec import (
    decode_chunk_device,
    encode_chunk,
    wire_upload_default,
)
from dsi_tpu_torch.ops.wordcount import (
    HostCopy,
    exactness_retry,
    grouper_ladder,
    resolve_device,
    rung0_cap,
    to_device,
)
from dsi_tpu_torch.parallel.merge import PackedCounts
from dsi_tpu_torch.parallel.pipeline import (
    BufferPool,
    StepPipeline,
    fold_source_stats,
    pipeline_depth,
    timed,
)
from dsi_tpu_torch.parallel.shuffle import (
    _is_letter_byte,
    _slice_pack,
    mapreduce_step,
    occupied_prefix,
)
from dsi_tpu_torch.parallel.stepobj import EngineStep

# A cut never needs to back off further than the longest word the kernels
# can represent (64 bytes) — if it does, the word needs the host path.
_MAX_BACKOFF = 96


class _TokenTooLong(Exception):
    """A letter run longer than the device word limit spans a cut point."""


class _NeedsHostPath(Exception):
    """A step proved the stream needs the host path (non-ASCII, >64-byte
    word): unwind the pipeline and return None to the caller."""


def _cut_at_boundary(buf, size: int) -> int:
    """Largest c <= size with no letter run crossing buf[c-1]/buf[c]."""
    if len(buf) <= size:
        return len(buf)
    if not (_is_letter_byte(buf[size - 1]) and _is_letter_byte(buf[size])):
        return size  # common case: the natural cut already sits on a gap
    lo = max(0, size - _MAX_BACKOFF - 1)
    win = np.frombuffer(memoryview(buf)[lo:size + 1], dtype=np.uint8)
    letter = ((win >= 65) & (win <= 90)) | ((win >= 97) & (win <= 122))
    ok = ~(letter[:-1] & letter[1:])  # ok[p] ⇔ cut c = lo+p+1 splits no run
    hits = np.flatnonzero(ok)
    if hits.size:
        return lo + 1 + int(hits[-1])
    if size <= _MAX_BACKOFF:
        return 0  # the whole prefix is one (representable) letter run
    raise _TokenTooLong


def batch_stream(blocks: Iterable[bytes], n_dev: int, chunk_bytes: int,
                 pool: Optional[BufferPool] = None) -> Iterator[np.ndarray]:
    """Slice a byte-block stream into zero-padded [n_dev, chunk_bytes]
    batches, cutting rows only at non-letter boundaries.

    With ``pool`` batches come from a small rotating buffer set; the
    consumer hands each yielded batch back via ``pool.give`` once nothing
    reads it.  Rows are always written in full — data then zero tail — so
    a recycled buffer never leaks stale bytes."""
    carry = bytearray()

    def new_batch() -> np.ndarray:
        if pool is not None:
            return pool.take()
        return np.zeros((n_dev, chunk_bytes), dtype=np.uint8)

    batch = new_batch()
    row = 0

    def fill_rows(final: bool):
        nonlocal row, carry, batch
        while carry and (len(carry) >= chunk_bytes + 1 or final):
            cut = _cut_at_boundary(carry, chunk_bytes)
            if cut == 0:
                # A letter run as wide as the whole row: no cut can make
                # progress at this chunk size, so the word needs the host.
                raise _TokenTooLong
            view = np.frombuffer(carry, dtype=np.uint8, count=cut)
            batch[row, :cut] = view
            del view           # release the bytearray export before the
            del carry[:cut]    # resize (a live view blocks it)
            batch[row, cut:] = 0
            row += 1
            if row == n_dev:
                yield batch
                batch = new_batch()
                row = 0

    for block in blocks:
        carry.extend(block)
        yield from fill_rows(final=False)
    yield from fill_rows(final=True)
    if row:
        batch[row:] = 0  # recycled buffer: stale tail rows must not count
        yield batch      # tail batch; remaining rows are empty chunks
    elif pool is not None:
        pool.give(batch)  # taken but never filled: straight back


def stream_files(paths: Sequence[str],
                 block_bytes: int = 4 << 20) -> Iterator[bytes]:
    """File contents as a block stream, separated by newlines so the last
    word of one file and the first of the next never merge."""
    for i, p in enumerate(paths):
        if i:
            yield b"\n"
        with open(p, "rb") as f:
            while True:
                b = f.read(block_bytes)
                if not b:
                    break
                yield b


def cycle_files(paths: Sequence[str], cycles: int,
                block_bytes: int = 4 << 20) -> Iterator[bytes]:
    """``stream_files`` over ``paths`` ``cycles`` times, newline-separated:
    the input of the bench's stream row (``bench.py run_stream_row``), a
    corpus cycled to a target size."""
    for c in range(cycles):
        if c:
            yield b"\n"
        yield from stream_files(paths, block_bytes)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, "
                               f"{item})")


class WordcountStep(EngineStep):
    """Step object over the streaming word count (``parallel/stepobj.py``
    lifecycle); parameters as :func:`wordcount_streaming`.

    ``device_batches`` (the plan layer's stage handoff,
    ``dsi_tpu_torch/plan``) replaces the block stream with an iterable of
    ready ``[n_dev, chunk_bytes]`` uint8 batches: tensors on the engine's
    device are consumed in place (the upstream stage's resident output is
    this stage's upload; no host bytes move, and a replay re-runs from
    the same buffer), np.ndarrays (spilled or restored buffers) are
    uploaded.  Batch rows must keep the engine's cut contract (no token
    crosses a row's fill point; the zero tail ends the last token).  No
    batch goes back to a pool, and there is no wire upload in this
    mode."""

    def __init__(self, blocks: Iterable[bytes], n_dev: int = 1,
                 n_reduce: int = 10, chunk_bytes: int = 1 << 20,
                 max_word_len: int = 16, u_cap: int = 1 << 12,
                 aot: bool = False, on_attempt=None,
                 depth: Optional[int] = None,
                 pipeline_stats: Optional[dict] = None,
                 device_accumulate: bool = False,
                 sync_every: Optional[int] = None,
                 mesh_shards: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_async: Optional[bool] = None,
                 checkpoint_delta: Optional[bool] = None,
                 resume: bool = False,
                 wire_upload: Optional[bool] = None,
                 device_batches=None,
                 input_range: Optional[Tuple[int, int]] = None,
                 device=None):
        super().__init__()
        if device_batches is not None and checkpoint_dir:
            raise ValueError("device_batches and checkpoint_dir are "
                             "exclusive: chained stages commit at stage "
                             "boundaries (dsi_tpu_torch/plan), not byte "
                             "cursors")
        if aot:
            raise _not_ported("aot", "the kernel build/warm cache")
        if (checkpoint_dir or checkpoint_every or checkpoint_async
                or checkpoint_delta or resume):
            raise _not_ported("checkpointing", "checkpoints")
        if input_range is not None:
            raise _not_ported("input_range", "the plan and serving layers")
        _wordcount_setup(self, blocks, n_dev, n_reduce, chunk_bytes,
                         max_word_len, u_cap, on_attempt, depth,
                         pipeline_stats, device_accumulate, sync_every,
                         mesh_shards, wire_upload, resolve_device(device),
                         device_batches)


def wordcount_streaming(
        blocks: Iterable[bytes], n_dev: int = 1,
        n_reduce: int = 10, chunk_bytes: int = 1 << 20,
        max_word_len: int = 16, u_cap: int = 1 << 12,
        aot: bool = False, on_attempt=None,
        depth: Optional[int] = None,
        pipeline_stats: Optional[dict] = None,
        device_accumulate: bool = False,
        sync_every: Optional[int] = None,
        mesh_shards: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_async: Optional[bool] = None,
        checkpoint_delta: Optional[bool] = None,
        resume: bool = False,
        wire_upload: Optional[bool] = None,
        input_range: Optional[Tuple[int, int]] = None,
        device=None,
) -> Optional[Dict[str, Tuple[int, int]]]:
    """Exact whole-stream word counts with bounded memory, pipelined, over
    ``n_dev`` virtual shards on ``device`` (None = the card).

    Returns ``{word: (count, reduce_partition)}``, or None when the stream
    needs the host path (non-ASCII bytes, or a word longer than 64).  A
    step whose uniques overflow retries itself wider without disturbing
    the accumulator, and the widened capacity (or word window) sticks.

    ``depth`` (default ``DSI_STREAM_PIPELINE_DEPTH``, 2) is the in-flight
    window; results are bit-identical to ``depth=1``.

    ``pipeline_stats``, if given, receives per-phase wall seconds
    (``batch_s``, ``batch_wait_s``, ``upload_s``, ``kernel_s`` blocked on
    step scalars, ``pull_s``, ``merge_s``, ``replay_s``, and two the
    reference does not report: ``dispatch_s`` launching the steps and
    ``finalize_s`` decoding the merged table) plus ``depth``,
    ``steps``, ``replays``, ``step_pulls``, ``max_inflight_chunks`` and
    ``batch_allocs``.

    ``device_accumulate=True`` folds each confirmed step into the device
    table and pulls it every ``sync_every`` folds (default
    ``DSI_STREAM_SYNC_EVERY``, 8) and at stream end; ``pipeline_stats``
    gains ``folds``/``fold_overflows``/``sync_pulls``/``widens``/
    ``table_cap`` and ``fold_s``/``sync_s``/``widen_s``.
    ``DSI_DEVICE_TABLE_CAP`` starts the table below the step's row count
    (the widen protocol recovers).

    ``mesh_shards`` (default ``DSI_STREAM_MESH_SHARDS``, 0 = off; at most
    ``n_dev``) mesh-shards the device table and implies
    ``device_accumulate``; ``pipeline_stats`` then gains
    ``mesh_shards``, ``shard_widens``, ``shard_imbalance`` and
    ``pull_bytes``.  Results are the same either way.

    ``wire_upload`` (default ``DSI_STREAM_WIRE``, off) compresses each
    chunk upload on the host (``ops/wirecodec.py encode_chunk``) and
    decodes it on the card (kernel N); a batch the codec cannot shrink
    uploads raw (``wire_raw_steps``).  Results are the same either way.
    ``pipeline_stats`` gains ``wire_upload``, ``wire_steps``,
    ``wire_raw_steps``, ``wire_packed_bytes``, ``wire_ratio`` (raw bytes
    over packed bytes of the packed steps, 3 places), ``decode_s`` (the
    encode and the decode launch) and, beyond the reference's keys,
    ``wire_modes`` (packed steps by mode and literal rung).

    ``on_attempt(max_word_len, u_cap)`` is called before every step
    attempt.  The remaining parameters keep the reference's signature and
    raise ``NotImplementedError`` when set.
    """
    return WordcountStep(
        blocks, n_dev=n_dev, n_reduce=n_reduce, chunk_bytes=chunk_bytes,
        max_word_len=max_word_len, u_cap=u_cap, aot=aot,
        on_attempt=on_attempt, depth=depth, pipeline_stats=pipeline_stats,
        device_accumulate=device_accumulate, sync_every=sync_every,
        mesh_shards=mesh_shards, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        checkpoint_async=checkpoint_async,
        checkpoint_delta=checkpoint_delta, resume=resume,
        wire_upload=wire_upload, input_range=input_range,
        device=device).close()


def _wordcount_setup(step, blocks, n_dev, n_reduce, chunk_bytes,
                     max_word_len, u_cap, on_attempt, depth, pipeline_stats,
                     device_accumulate, sync_every, mesh_shards,
                     wire_upload, dev: torch.device, device_batches=None):
    """The engine body behind :class:`WordcountStep`: setup ending with
    the pipeline armed and the lifecycle hooks attached to ``step``."""
    depth = pipeline_depth(depth)
    acc = PackedCounts()
    groupers = grouper_ladder(dev)
    # Sticky dispatch rung: starts where the ladder would and only ever
    # moves toward more headroom (run_step_sync records the rung that
    # cleared) — cap and word window widen, and grouper and frac follow
    # the last cleared combination, so a stream that needs the sort
    # grouper or the exact token buffer does not replay every step.
    state = {"cap": rung0_cap(chunk_bytes, u_cap), "mwl": max_word_len,
             "grouper": groupers[0], "frac": 4}
    mesh_shards = mesh_shards_default(mesh_shards)
    if mesh_shards:
        device_accumulate = True  # the mesh-sharded table is the state
    stats = {"depth": depth, "steps": 0, "replays": 0,
             "max_inflight_chunks": 0, "step_pulls": 0,
             "device_accumulate": device_accumulate, "batch_s": 0.0,
             "batch_wait_s": 0.0, "upload_s": 0.0, "kernel_s": 0.0,
             "pull_s": 0.0, "merge_s": 0.0, "replay_s": 0.0,
             "dispatch_s": 0.0, "finalize_s": 0.0}
    # Compressed chunk uploads: the knob changes only what crosses the
    # link, never the chunk the step reads, so results are the same.
    # Device batches have no upload to compress.
    wire = (wire_upload_default(wire_upload) if device_batches is None
            else False)
    wire_raw_total = 0  # raw-equivalent bytes of the packed uploads
    if wire:
        stats.update({"wire_upload": True, "wire_steps": 0,
                      "wire_raw_steps": 0, "wire_packed_bytes": 0,
                      "decode_s": 0.0, "wire_modes": {}})
    # The table allocates lazily at the first fold (its key width and
    # capacity come from that step's shapes); the fold-flag lag is the
    # pipeline window, so confirming a fold never waits on kernels the
    # window still wants in flight.
    table_svc: Optional[DeviceTable] = None
    policy: Optional[SyncPolicy] = None
    if device_accumulate:
        policy = SyncPolicy(sync_every)
        stats["sync_every"] = policy.sync_every
        stats["mesh_shards"] = mesh_shards
    on_card = dev.type == "cuda"

    def fold_confirmed(packed_dev, scal_dev, scal_np) -> None:
        nonlocal table_svc
        if int(scal_np[:, 0].max()) == 0:
            return  # empty step: nothing to fold, nothing to sync for
        if table_svc is None:
            # Rung-0 capacity: the step's row count (one fold can never
            # overflow it), unless DSI_DEVICE_TABLE_CAP asks for a smaller
            # start (the widen protocol recovers if the guess is wrong).
            try:
                cap = int(os.environ.get("DSI_DEVICE_TABLE_CAP", "0"))
            except ValueError:
                cap = 0
            table_svc = DeviceTable(
                n_dev, kk=int(packed_dev.shape[2]) - 3,
                cap=cap if cap > 0 else int(packed_dev.shape[1]),
                acc=acc, device=dev, lag=max(0, depth - 1), stats=stats,
                mesh_shards=mesh_shards)
        table_svc.fold(packed_dev, scal_dev, scal_np)
        policy.note_fold()
        if policy.due():
            table_svc.sync()
            policy.reset()

    # Live host buffers = out queue (≤ depth+1) + in-flight window
    # (≤ depth) + one being filled + one being finished.
    def pinned_batch() -> np.ndarray:
        # The numpy view keeps the pinned tensor alive.
        return torch.zeros((n_dev, chunk_bytes), dtype=torch.uint8,
                           pin_memory=True).numpy()

    pool = BufferPool((n_dev, chunk_bytes), retain=2 * depth + 3,
                      alloc=pinned_batch if on_card else None)

    def upload(buf):
        """One batch to the device: on the card a ``non_blocking`` copy
        from the pinned pool buffer plus the event that guards the
        buffer's reuse; on the CPU a copy.  A device batch is already
        there and is read in place."""
        if isinstance(buf, torch.Tensor):
            if buf.device.type != dev.type or tuple(buf.shape[:1]) != (
                    n_dev,) or buf.dtype != torch.uint8:
                raise ValueError(f"device batch: want [{n_dev}, L] uint8 on "
                                 f"{dev}, got {buf.dtype} "
                                 f"{tuple(buf.shape)} on {buf.device}")
            return buf, None
        if not on_card:
            return torch.from_numpy(buf.copy()), None
        chunks = torch.from_numpy(buf).to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return chunks, done

    def give_back(buf, uploaded) -> None:
        if uploaded is not None:
            uploaded.synchronize()  # the copy out of buf has completed
        if device_batches is None:  # a handed-over batch is never pooled
            pool.give(buf)

    def step_call(chunks, mwl, cap, frac, g):
        return mapreduce_step(chunks, n_dev=n_dev, n_reduce=n_reduce,
                              max_word_len=mwl, u_cap=cap, t_cap_frac=frac,
                              grouper=g)

    def pull_packed(keys, lens, cnts, parts, scal_np):
        """One packed host array per step (the single-pull shape,
        shuffle._slice_pack) + per-shard occupied counts + key width."""
        m = int(scal_np[:, 0].max())
        if m == 0:
            return None, None, 0
        mp = occupied_prefix(m, keys.shape[1])
        packed = _slice_pack(keys, lens, cnts, parts, mp=mp).cpu().numpy()
        return packed.view(np.uint32), scal_np[:, 0], keys.shape[2]

    def run_step_sync(chunks_np, device_payload: bool = False):
        """The full exactness ladder for ONE batch — the replay path of a
        deferred-check failure, and what ``depth=1`` reduces to.  With
        ``device_payload`` the payload returns the cleared attempt's
        device tensors (full-capacity packed tensor + scalars) instead of
        pulling, so a replayed step folds like any confirmed step."""

        def run(mwl: int, cap: int):
            state["cap"] = cap    # last attempt = the one that succeeded
            state["mwl"] = mwl    # (sticky for later optimistic dispatches)
            if on_attempt is not None:
                on_attempt(mwl, cap)
            for g in groupers:
                for frac in (4, 2):
                    chunks, uploaded = upload(chunks_np)
                    keys, lens, cnts, parts, scal = step_call(
                        chunks, mwl, cap, frac, g)
                    scal_np = scal.cpu().numpy()
                    if not scal_np[:, 4].any():
                        break
                if not scal_np[:, 4].any():
                    break
            state["grouper"], state["frac"] = g, frac  # the rung sticks

            def payload():
                if device_payload:
                    packed_dev = _slice_pack(keys, lens, cnts, parts,
                                             mp=keys.shape[1])
                    return packed_dev, scal, scal_np
                return pull_packed(keys, lens, cnts, parts, scal_np)

            return (bool(scal_np[:, 3].any()), int(scal_np[:, 1].max()),
                    int(scal_np[:, 2].max()), payload)

        return exactness_retry(run, chunk_bytes, state["mwl"], state["cap"])

    def wire_upload_batch(buf: np.ndarray):
        """The batch encoded on the host, its packed tensor uploaded and
        decoded on the card (kernel N); None when the codec cannot shrink
        it (the caller uploads it raw)."""
        nonlocal wire_raw_total
        with timed(stats, "decode_s"):
            enc = encode_chunk(buf)
        if enc is None:
            stats["wire_raw_steps"] += 1
            return None
        mode, packed_np, lit_cap = enc
        with timed(stats, "upload_s"):
            packed = to_device(packed_np.reshape(-1), dev).view(
                packed_np.shape)
        with timed(stats, "decode_s"):
            chunks = decode_chunk_device(packed, n=chunk_bytes,
                                         lit_cap=lit_cap, mode=mode)
        stats["wire_steps"] += 1
        stats["wire_packed_bytes"] += int(packed_np.nbytes)
        wire_raw_total += n_dev * chunk_bytes
        stats["wire_ratio"] = round(wire_raw_total
                                    / stats["wire_packed_bytes"], 3)
        tag = mode if mode == "b7" else f"{mode}_l{lit_cap}"
        stats["wire_modes"][tag] = stats["wire_modes"].get(tag, 0) + 1
        return chunks

    def dispatch(buf: np.ndarray):
        """Optimistically launch one step at the sticky rung — upload and
        kernel launches, no waiting.  With device accumulation the pack
        runs here too (its full-capacity shape needs no flags)."""
        mwl, cap = state["mwl"], state["cap"]
        if on_attempt is not None:
            on_attempt(mwl, cap)
        chunks = wire_upload_batch(buf) if wire else None
        uploaded = None  # a packed upload leaves buf free at once
        if chunks is None:
            with timed(stats, "upload_s"):
                chunks, uploaded = upload(buf)
        with timed(stats, "dispatch_s"):
            keys, lens, cnts, parts, scal = step_call(
                chunks, mwl, cap, state["frac"], state["grouper"])
            if device_accumulate:
                # Only scal + the packed tensor stay referenced: an
                # in-flight step holds one packed copy, not four tables.
                packed_dev = _slice_pack(keys, lens, cnts, parts,
                                         mp=keys.shape[1])
                handles = (scal, packed_dev, keys.shape[2], None)
            else:
                handles = (scal, None, keys.shape[2],
                           (keys, lens, cnts, parts))
            scal_host = HostCopy(scal)
        stats["steps"] += 1
        return (buf, uploaded, scal_host, mwl, cap, handles)

    def finish_one(record) -> None:
        """Retire the oldest in-flight step: deferred exactness check,
        then merge (clean) or replay at a wider shape (overflow)."""
        buf, uploaded, scal_host, mwl, cap, handles = record
        scal, packed_dev, kk, tables = handles
        with timed(stats, "kernel_s"):
            scal_np = scal_host.wait()  # blocks until the step lands
        if scal_np[:, 3].any():  # non-ASCII: the whole stream is host's
            give_back(buf, uploaded)
            raise _NeedsHostPath
        exact = (not scal_np[:, 4].any()
                 and int(scal_np[:, 1].max()) <= cap
                 and int(scal_np[:, 2].max()) <= mwl)
        if exact:
            if device_accumulate:
                # A fold happens only here, after its step's exactness
                # flags cleared: the lagged-confirmation invariant.
                fold_confirmed(packed_dev, scal, scal_np)
            else:
                with timed(stats, "pull_s"):
                    packed, nus, kk = pull_packed(*tables, scal_np)
                    if packed is not None:
                        stats["step_pulls"] += 1
                with timed(stats, "merge_s"):
                    if packed is not None:
                        acc.add_packed_step(packed, nus, kk)
        else:
            # Late-detected overflow: replay just this step through the
            # ladder.  Exactly once by construction — the optimistic
            # attempt's tables are dropped unmerged.
            stats["replays"] += 1
            with timed(stats, "replay_s"):
                payload = run_step_sync(buf,
                                        device_payload=device_accumulate)
                if payload is None:
                    give_back(buf, uploaded)
                    raise _NeedsHostPath
                if device_accumulate:
                    fold_confirmed(*payload())
                else:
                    packed, nus, kk = payload()
                    if packed is not None:
                        stats["step_pulls"] += 1
                        acc.add_packed_step(packed, nus, kk)
        give_back(buf, uploaded)

    pipe = StepPipeline(depth=depth, dispatch=dispatch, finish=finish_one,
                        stats=stats, produce_key="batch_s",
                        wait_key="batch_wait_s",
                        inflight_key="max_inflight_chunks",
                        thread_name="dsi-stream-batcher")
    step._pipe = pipe
    if device_batches is not None:
        pipe.begin(lambda: iter(device_batches))
    else:
        pipe.begin(lambda: batch_stream(blocks, n_dev, chunk_bytes,
                                        pool=pool))
    step._host_excs = (_TokenTooLong, _NeedsHostPath)

    def on_complete():
        if table_svc is not None:
            table_svc.close()  # the "or at stream end" pull
        with timed(stats, "finalize_s"):
            step.result = acc.finalize()

    released = []

    def release():
        if released:  # idempotent: close() after a failure re-runs it
            return
        released.append(True)
        fold_source_stats(stats, blocks)
        if pipeline_stats is not None:
            stats["batch_allocs"] = pool.allocs
            pipeline_stats.update(stats)

    step._on_complete = on_complete
    step._release = release
