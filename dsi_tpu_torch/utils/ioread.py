"""Parallel mmap'd file ingest with readahead.

Copy of ``dsi_tpu/utils/ioread.py``.  A small pool of reader threads
mmaps the input files and copies fixed-size segments out ahead of the
consumer (a bounded readahead window keeps memory O(readahead x block)),
so the streaming engine's batcher finds its bytes already host-resident.

The yielded byte stream is exactly ``parallel/streaming.py
stream_files``' — per-file bytes in order, a single ``b"\\n"`` separator
between files — whatever the reader count or block boundaries; only
segment scheduling is parallel, delivery order is total.  Read-only by
construction (mmap ``ACCESS_READ`` with a seek/read fallback).

Stats (``ParallelBlocks.ingest_stats()``, folded into the engine's
``pipeline_stats`` at release): ``ingest_readers``, ``ingest_blocks``,
``readahead_hit_pct`` (blocks already resident when the consumer asked)
and ``ingest_wait_s`` (consumer wall blocked on a block not yet read).
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

_READERS_ENV = "DSI_INGEST_READERS"
#: Default block size — matches ``stream_files``' 4 MiB.
DEFAULT_BLOCK_BYTES = 4 << 20


def ingest_readers_default(readers: Optional[int] = None) -> int:
    """Resolve the reader-pool width: an explicit value wins, else
    ``DSI_INGEST_READERS`` (default 0 = no pool, inline reads — the
    historical ``stream_files`` path, bit-identical by construction)."""
    if readers is None:
        try:
            readers = int(os.environ.get(_READERS_ENV, "0"))
        except ValueError:
            readers = 0
    return max(0, int(readers))


def serial_blocks(paths: Sequence[str],
                  block_bytes: int = DEFAULT_BLOCK_BYTES) -> Iterator[bytes]:
    """File contents as an in-order block stream with ``b"\\n"`` file
    separators — byte-identical to ``parallel/streaming.stream_files``,
    without importing the engine."""
    for i, p in enumerate(paths):
        if i:
            yield b"\n"
        with open(p, "rb") as f:
            while True:
                b = f.read(block_bytes)
                if not b:
                    break
                yield b


#: Segment plan entries: (path_index, offset, length) for file bytes,
#: or (-1, 0, 0) for the inter-file separator block.
_SEP = (-1, 0, 0)


def _plan_segments(paths: Sequence[str],
                   block_bytes: int) -> List[Tuple[int, int, int]]:
    segs: List[Tuple[int, int, int]] = []
    for i, p in enumerate(paths):
        if i:
            segs.append(_SEP)
        size = os.path.getsize(p)
        off = 0
        while off < size:
            n = min(block_bytes, size - off)
            segs.append((i, off, n))
            off += n
    return segs


class ParallelBlocks:
    """In-order block stream over ``paths`` read by ``readers`` threads
    with a bounded readahead window.

    Iterable (single pass).  Reader threads claim segment ordinals up to
    ``consumed + readahead`` and fill per-segment slots; the consumer
    yields slot *i* strictly in order, blocking only when the pool has
    not reached it yet (counted as a readahead miss).  Abandoning the
    iterator mid-stream (a tenant eviction, an engine unwinding on an
    error) tears the pool down via the generator's ``finally`` —
    threads are daemons and stop at their next claim check either way.
    """

    def __init__(self, paths: Sequence[str],
                 block_bytes: int = DEFAULT_BLOCK_BYTES,
                 readers: Optional[int] = None,
                 readahead: Optional[int] = None):
        self.paths = [str(p) for p in paths]
        self.block_bytes = max(1, int(block_bytes))
        self.readers = max(1, ingest_readers_default(readers))
        #: In-flight + ready-but-unconsumed segments the pool may hold:
        #: the memory bound (readahead × block_bytes) and the distance
        #: the pool can run ahead of the consumer.
        self.readahead = (max(2, 2 * self.readers) if readahead is None
                          else max(1, int(readahead)))
        self._segs = _plan_segments(self.paths, self.block_bytes)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._slots: dict = {}
        self._next_claim = 0
        self._consumed = 0
        self._closed = False
        self._err: Optional[BaseException] = None
        self._threads: List[threading.Thread] = []
        self._mmaps: dict = {}
        self._hits = 0
        self._misses = 0
        self._wait_s = 0.0

    # ── reading (reader threads) ──

    def _read_segment(self, seg: Tuple[int, int, int]) -> bytes:
        pi, off, n = seg
        if pi < 0:
            return b"\n"
        mm = self._file_map(pi)
        if mm is not None:
            return bytes(mm[off:off + n])
        with open(self.paths[pi], "rb") as f:  # mmap-refusing file
            f.seek(off)
            return f.read(n)

    def _file_map(self, pi: int):
        """One shared read-only mmap per file, opened lazily (None for
        files mmap refuses — zero-length, special files — which fall
        back to seek/read)."""
        with self._lock:
            if pi in self._mmaps:
                return self._mmaps[pi]
        try:
            with open(self.paths[pi], "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            mm = None
        with self._lock:
            # First opener wins; a racing duplicate closes itself.
            cur = self._mmaps.setdefault(pi, mm)
            if cur is not mm and mm is not None:
                mm.close()
            return cur

    def _reader_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._closed
                       and (self._next_claim >= len(self._segs)
                            or self._next_claim
                            >= self._consumed + self.readahead)):
                    if self._next_claim >= len(self._segs):
                        return
                    self._cond.wait(0.2)
                if self._closed:
                    return
                i = self._next_claim
                self._next_claim += 1
            try:
                data = self._read_segment(self._segs[i])
            except BaseException as e:
                with self._cond:
                    self._err = self._err or e
                    self._cond.notify_all()
                return
            with self._cond:
                self._slots[i] = data
                self._cond.notify_all()

    def _start(self) -> None:
        if self._threads:
            return
        n = min(self.readers, max(1, len(self._segs)))
        for r in range(n):
            t = threading.Thread(target=self._reader_loop, daemon=True,
                                 name=f"dsi-ingest-reader-{r}")
            self._threads.append(t)
            t.start()

    # ── consuming ──

    def __iter__(self) -> Iterator[bytes]:
        if self._closed:
            # Single-pass source: after exhaustion/abandonment no reader
            # will ever fill another slot — a second pass would wait
            # forever on slot 0.  Fail loudly instead of hanging.
            raise RuntimeError("ParallelBlocks is single-pass and was "
                               "already consumed/closed; construct a "
                               "fresh pool to re-read")
        self._start()
        try:
            for i in range(len(self._segs)):
                with self._cond:
                    if i in self._slots:
                        self._hits += 1
                    else:
                        self._misses += 1
                        t0 = time.perf_counter()
                        while i not in self._slots and self._err is None:
                            self._cond.wait(0.2)
                        self._wait_s += time.perf_counter() - t0
                    if self._err is not None and i not in self._slots:
                        raise self._err
                    data = self._slots.pop(i)
                    self._consumed = i + 1
                    self._cond.notify_all()
                yield data
        finally:
            self.close()

    def close(self) -> None:
        """Stop the pool and release the file maps.  Idempotent; called
        by the iterator's own ``finally`` (stream end OR mid-stream
        abandonment)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            maps, self._mmaps = self._mmaps, {}
        for t in self._threads:
            t.join(timeout=5.0)
        for mm in maps.values():
            if mm is not None:
                try:
                    mm.close()
                except (ValueError, OSError):
                    pass

    def ingest_stats(self) -> dict:
        """The engine's release-time fold (``fold_source_stats``)."""
        asked = self._hits + self._misses
        return {"ingest_readers": self.readers,
                "ingest_blocks": asked,
                "readahead_hit_pct": round(100.0 * self._hits / asked, 1)
                if asked else 0.0,
                "ingest_wait_s": round(self._wait_s, 4)}


def open_blocks(paths: Sequence[str],
                readers: Optional[int] = None,
                block_bytes: int = DEFAULT_BLOCK_BYTES,
                readahead: Optional[int] = None):
    """The one ingest entry point the CLI uses: a
    :class:`ParallelBlocks` pool when the resolved reader count
    (``--ingest-readers`` / ``DSI_INGEST_READERS``) is >= 1, else the
    plain in-order generator — byte-identical streams either way."""
    n = ingest_readers_default(readers)
    if n >= 1:
        return ParallelBlocks(paths, block_bytes=block_bytes,
                              readers=n, readahead=readahead)
    return serial_blocks(paths, block_bytes=block_bytes)
