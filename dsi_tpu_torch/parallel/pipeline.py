"""Dispatch/finish pipeline core for the streaming engine.

Copy of ``dsi_tpu/parallel/pipeline.py`` (``pipeline_depth``,
``BufferPool``, ``StepPipeline``, ``fold_source_stats``) without the
tracing spans, histograms and stall watchdog of ``dsi_tpu/obs``, which
the port has not copied yet; the phase seconds they fed still land in
the ``stats`` dict under the same keys.

Four mechanics: a background producer thread feeding a bounded queue, a
``depth``-deep in-flight window (dispatch step k+1 before step k is
checked), deferred per-step checks (a step's flags are read only when it
leaves the window) and a small rotating host buffer pool (O(depth)
allocations however long the stream).  ``dispatch`` launches one item's
asynchronous work and returns an opaque record; ``finish`` retires the
OLDEST record.  Records finish in dispatch order, exactly once, and at
most ``depth`` are ever in flight.  ``depth=1`` is the synchronous loop —
no thread, no queue, dispatch then finish.

Exceptions propagate both ways: a producer error re-raises in the
consumer thread, and a consumer exception unwinds with the producer
thread stopped and its queue drained.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def pipeline_depth(depth: Optional[int] = None) -> int:
    """Resolve the in-flight window: an explicit ``depth`` wins, else
    ``DSI_STREAM_PIPELINE_DEPTH`` (default 2), floored at 1."""
    if depth is None:
        try:
            depth = int(os.environ.get("DSI_STREAM_PIPELINE_DEPTH", "2"))
        except ValueError:
            depth = 2
    return max(1, depth)


@contextlib.contextmanager
def timed(stats: dict, key: str):
    """Add the wall seconds of the block to ``stats[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0


def fold_source_stats(stats: dict, source) -> None:
    """Fold a block source's ingest counters (``utils/ioread.py
    ParallelBlocks.ingest_stats``) into the engine's stats at release;
    plain iterables have nothing to report."""
    fn = getattr(source, "ingest_stats", None)
    if callable(fn):
        stats.update(fn())


class BufferPool:
    """Small rotating pool of reusable fixed-shape host buffers.

    ``take`` hands out a free buffer, allocating only when the pool is
    dry; ``give`` returns one for reuse.  Never blocks — the pipeline's
    bounded queue provides the backpressure.  ``allocs`` counts real
    allocations.  ``alloc()`` makes a buffer (default ``np.zeros``); the
    streaming engine passes one that returns pinned host memory on the
    card, so an upload is one asynchronous copy.
    """

    def __init__(self, shape: Sequence[int], retain: int,
                 dtype=np.uint8, alloc: Optional[Callable] = None):
        self._shape = tuple(shape)
        self._dtype = dtype
        self._alloc = alloc or (lambda: np.zeros(self._shape, self._dtype))
        self._free: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._retain = retain
        self.allocs = 0

    def take(self) -> np.ndarray:
        with self._lock:
            if self._free:
                return self._free.popleft()
            self.allocs += 1
        return self._alloc()

    def give(self, buf: Optional[np.ndarray]) -> None:
        if not isinstance(buf, np.ndarray) or buf.shape != self._shape:
            return
        with self._lock:
            if len(self._free) < self._retain:
                self._free.append(buf)


class StepPipeline:
    """``depth``-deep dispatch/finish window over a produced item stream.

    ``stats`` receives ``produce_key`` (seconds building items — in the
    producer thread at depth > 1, inline at depth 1), ``wait_key``
    (consumer starvation on the queue) and ``inflight_key`` (peak window
    occupancy, bounded by ``depth``).  The loop is ``begin``, ``pump``
    (dispatch the next item, retiring the oldest record when the window
    is full), ``drain`` (retire everything in flight) and ``end`` (tear
    the producer down, idempotent).
    """

    def __init__(self, *, depth: int, dispatch: Callable, finish: Callable,
                 stats: dict, produce_key: str = "batch_s",
                 wait_key: str = "batch_wait_s",
                 inflight_key: str = "max_inflight_chunks",
                 thread_name: str = "dsi-pipeline-producer"):
        self.depth = max(1, int(depth))
        self._dispatch = dispatch
        self._finish = finish
        self._stats = stats
        self._produce_key = produce_key
        self._wait_key = wait_key
        self._inflight_key = inflight_key
        self._thread_name = thread_name
        stats.setdefault(produce_key, 0.0)
        stats.setdefault(wait_key, 0.0)
        stats.setdefault(inflight_key, 0)
        self.finished = 0

    def _timed_next(self, gen, key: str):
        t0 = time.perf_counter()
        try:
            return next(gen)
        finally:
            self._stats[key] += time.perf_counter() - t0

    # ── item feed: inline at depth=1, background thread otherwise ──

    def _producer(self, make_items: Callable[[], Iterator],
                  out_q: queue.Queue, stop: threading.Event) -> None:
        gen = make_items()
        try:
            while True:
                try:
                    item = self._timed_next(gen, self._produce_key)
                except StopIteration:
                    break
                while not stop.is_set():
                    try:
                        out_q.put(("item", item), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            out_q.put(("done", None))
        except BaseException as e:  # surfaced to the consumer thread
            # Stop-aware retry, like the item put above: a fixed timeout
            # could drop the error while the consumer sits in a long
            # replay, leaving it blocked on a queue with no sentinel.
            while not stop.is_set():
                try:
                    out_q.put(("err", e), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def _feed(self, make_items, out_q, stop, started: list) -> Iterator:
        if self.depth == 1:
            gen = make_items()
            while True:
                try:
                    item = self._timed_next(gen, self._produce_key)
                except StopIteration:
                    return
                yield item
        thread = threading.Thread(
            target=self._producer, args=(make_items, out_q, stop),
            daemon=True, name=self._thread_name)
        started.append(thread)
        thread.start()
        while True:
            t0 = time.perf_counter()
            kind, item = out_q.get()
            self._stats[self._wait_key] += time.perf_counter() - t0
            if kind == "done":
                return
            if kind == "err":
                raise item
            yield item

    # ── the window ──

    def begin(self, make_items: Callable[[], Iterator]) -> None:
        """Arm the pipeline over ``make_items()``'s items.  Must be
        balanced by :meth:`end`."""
        self._pending: collections.deque = collections.deque()
        self._stop_evt = threading.Event()
        self._out_q: queue.Queue = queue.Queue(maxsize=self.depth + 1)
        self._started: list = []
        self._ended = False
        self._feed_iter: Optional[Iterator] = self._feed(
            make_items, self._out_q, self._stop_evt, self._started)

    def _finish_oldest(self) -> None:
        self._finish(self._pending.popleft())
        self.finished += 1

    def pump(self) -> bool:
        """Dispatch the next produced item, retiring the oldest in-flight
        record first when the window is full.  False when the item stream
        is exhausted (records may still be in flight — ``drain``)."""
        try:
            item = next(self._feed_iter)
        except StopIteration:
            return False
        rec = self._dispatch(item)
        if rec is None:
            return True
        self._pending.append(rec)
        if len(self._pending) > self._stats[self._inflight_key]:
            self._stats[self._inflight_key] = len(self._pending)
        if len(self._pending) >= self.depth:
            self._finish_oldest()
        return True

    def drain(self) -> None:
        """Retire every in-flight record (FIFO): afterwards everything
        dispatched has passed its deferred checks and merged."""
        while self._pending:
            self._finish_oldest()

    def end(self) -> None:
        """Tear down the producer thread.  Idempotent, and safe
        mid-stream."""
        if getattr(self, "_ended", True):
            return
        self._ended = True
        if self._started:
            self._stop_evt.set()
            thread = self._started[0]
            # Unblock a producer stuck on a full queue; bounded — a
            # producer mid-build exits at its next stop check.
            deadline = time.monotonic() + 5.0
            while thread.is_alive() and time.monotonic() < deadline:
                try:
                    self._out_q.get_nowait()
                except queue.Empty:
                    thread.join(0.05)
        self._feed_iter = None
