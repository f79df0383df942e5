"""The capture/commit split: overlapped checkpoint commits.

Copy of ``dsi_tpu/ckpt/writer.py``.

A save done in one piece is synchronous end to end: pull complete device
images, serialize, CRC, fsync — all on the engine thread, stalling the
pipeline window for the whole durable write.  This module splits it:

* **capture** (engine thread, at the confirmed-step boundary): the
  device services dispatch their snapshot pulls without blocking
  (the occupied prefix packed, then a ``non_blocking`` copy into pinned
  host memory with a CUDA event behind it — enqueued before any later
  fold, sync or clear on the same stream, so none of them can change
  the capture; on the CPU a copy made at once), the host accumulators
  are snapshotted by reference (their merge tables are append-only:
  later adds create new buffers, never mutate captured ones) with small
  scalars copied — and the capture is
  handed to the writer.  Cost: flag flushes + dispatches, not wire.
* **commit** (writer thread): materialize the deferred pulls (the D2H
  has been draining under the next pipeline window), serialize, and run
  the existing ``CheckpointStore`` durable path.  Commits are strictly
  ordered (one worker — ``parallel/pipeline.CommitWorker``), so seq
  numbering and newest-valid-wins semantics are untouched.

The barrier rule: the engine blocks only when the NEXT save (or the
stream end) finds the previous commit still draining —
``submit``'s bounded queue — accounted in ``ckpt_barrier_s``.  With
async off the same capture/commit code runs inline on the engine
thread: the synchronous behavior, one code path.

Fault points: ``mid-commit`` fires in the writer after materialize and
before the store write (a crash there must leave the previous chain
winning), and ``post-ckpt`` moves INTO the commit — it means "right
after a checkpoint manifest commits" and keeps meaning that when the
commit is asynchronous.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from dsi_tpu_torch.ckpt.delta import materialize_part
from dsi_tpu_torch.ckpt.fault import fault_point
from dsi_tpu_torch.ckpt.policy import checkpoint_rebase_default
from dsi_tpu_torch.ckpt.store import CheckpointStore
from dsi_tpu_torch.obs import span as _span
from dsi_tpu_torch.parallel.pipeline import CommitWorker

#: A capture: ordered (prefix, part) pairs — part a ready dict or a
#: Deferred — exactly the arrays dict the engine used to build inline,
#: split so device pulls can finish in the writer.
CaptureParts = List[Tuple[str, object]]


class CheckpointWriter:
    """Commit captured snapshots through one ``CheckpointStore`` —
    inline when ``async_`` is off (the synchronous path),
    through a :class:`~dsi_tpu_torch.parallel.pipeline.CommitWorker`
    otherwise.  Also owns the delta-window state machine the engines
    share: :meth:`want_delta` says whether the next save may be
    incremental (a base exists, the re-base window isn't due), and
    every commit advances the window — one implementation instead of
    four per-engine copies.  ``stats`` receives
    ``ckpt_saves``/``ckpt_deltas``, ``ckpt_commit_s``/
    ``ckpt_barrier_s``, the ``ckpt_full_bytes``/``ckpt_delta_bytes``
    payload totals, and the compression
    attribution (``ckpt_compress`` mode, ``ckpt_delta_raw_bytes``
    uncompressed denominator, ``ckpt_compress_s`` zlib wall — on the
    worker thread under async, exactly like ``ckpt_commit_s``)."""

    def __init__(self, store: CheckpointStore, stats: dict,
                 async_: bool = False, delta: bool = False,
                 rebase: Optional[int] = None):
        self.store = store
        self.stats = stats
        self.async_ = bool(async_)
        self.delta = bool(delta)
        #: Re-base window: every ``rebase``-th save is a full image
        #: (``DSI_STREAM_CKPT_REBASE``, default 8; 1 = every save full,
        #: deltas effectively disabled).
        self.rebase = (checkpoint_rebase_default() if rebase is None
                       else max(1, int(rebase)))
        self._since_full = -1  # saves since the last full; -1 = no base
        self._worker: Optional[CommitWorker] = None
        if self.async_:
            self._worker = CommitWorker(name="dsi-ckpt-writer")
        for key in ("ckpt_saves", "ckpt_deltas", "ckpt_full_bytes",
                    "ckpt_delta_bytes", "ckpt_delta_raw_bytes"):
            self.stats.setdefault(key, 0)
        for key in ("ckpt_commit_s", "ckpt_barrier_s",
                    "ckpt_compress_s"):
            self.stats.setdefault(key, 0.0)
        self.stats.setdefault("ckpt_compress", store.compress)

    def want_delta(self) -> bool:
        """True when the NEXT save may be incremental: delta mode is
        on, this run has already committed a base, and the chain has
        not reached the re-base window (``rebase - 1`` deltas per
        full — so ``rebase=1`` really is every-save-full).  The engine
        still falls back to a full save when its delta window is
        invalid (``take_delta()`` returned None)."""
        return self.delta and 0 <= self._since_full < self.rebase - 1

    def commit(self, parts: CaptureParts, meta: Dict,
               kind: str = "full") -> None:
        """Hand one capture to the commit path.  Async: returns as soon
        as a writer slot is free (blocking time → ``ckpt_barrier_s``);
        a previous commit's error re-raises HERE, on the engine
        thread.  Sync: commits before returning."""
        def do_commit():
            with _span("ckpt_commit", lane="ckpt", stats=self.stats,
                       key="ckpt_commit_s", kind=kind):
                arrays: Dict = {}
                for prefix, part in parts:
                    for k, v in materialize_part(part).items():
                        arrays[prefix + k] = v
                fault_point("mid-commit")
                if kind == "delta":
                    self.store.save_delta(arrays, meta)
                    self.stats["ckpt_deltas"] += 1
                    self.stats["ckpt_delta_bytes"] += \
                        self.store.last_payload_bytes
                    # The compression A/B's denominator: what this
                    # delta's arrays would have cost raw.
                    self.stats["ckpt_delta_raw_bytes"] += \
                        self.store.last_payload_raw_bytes
                else:
                    self.store.save(arrays, meta)
                    self.stats["ckpt_full_bytes"] += \
                        self.store.last_payload_bytes
                self.stats["ckpt_compress_s"] += self.store.last_compress_s
                self.stats["ckpt_saves"] += 1
            fault_point("post-ckpt")

        self._since_full = 0 if kind == "full" else self._since_full + 1
        if self._worker is None:
            do_commit()
        else:
            self.stats["ckpt_barrier_s"] += self._worker.submit(do_commit)

    def drain(self) -> None:
        """Block until every submitted commit is durable; re-raise the
        first commit error.  Engines call this before finalizing their
        result (and before reading save counters)."""
        if self._worker is not None:
            self.stats["ckpt_barrier_s"] += self._worker.drain()

    def shutdown(self) -> None:
        """Silent join for ``finally`` blocks (never masks an engine
        exception already unwinding; a stored commit error is simply
        dropped with the run)."""
        if self._worker is not None:
            self._worker.shutdown()
