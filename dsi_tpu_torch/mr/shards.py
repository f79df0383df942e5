"""Streaming-shard geometry: cursor ranges over the engines' byte stream.

Copy of the geometry half of ``dsi_tpu/mr/shards.py`` (``ShardSpec``,
``plan_shards``, ``read_stream_range`` and the helpers they call), what
the plan driver's ``stage_shards`` needs.  A shard is one cursor range
``[start, end)`` of the concatenated ``stream_files(files)`` stream
(files joined by single ``\\n`` separators), cut just after a newline:
no token and no line straddles a cut, so per-shard engine results merge
to the whole stream's.  The attempt markers, chain adoption, re-splits
and shard codecs go with the control plane (ROADMAP Queue 1, #5).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple


@dataclass(frozen=True)
class ShardSpec:
    """One cursor-range task: ``[start, end)`` over the concatenated
    ``stream_files(files)`` byte stream."""

    sid: int
    start: int
    end: int

    @property
    def size(self) -> int:
        return self.end - self.start


def stream_total_bytes(files: Sequence[str]) -> int:
    """Length of ``stream_files(files)``' byte stream: file bytes plus
    one ``\\n`` separator between adjacent files."""
    if not files:
        return 0
    return sum(os.path.getsize(f) for f in files) + (len(files) - 1)


def _file_segments(files: Sequence[str]) -> List[Tuple[int, int, str]]:
    """``(global_start, global_end, path)`` per file; separators live in
    the 1-byte gaps between consecutive segments."""
    segs = []
    pos = 0
    for i, p in enumerate(files):
        if i:
            pos += 1  # the separator byte
        size = os.path.getsize(p)
        segs.append((pos, pos + size, p))
        pos += size
    return segs


def read_stream_range(files: Sequence[str], start: int, end: int,
                      block_bytes: int = 4 << 20) -> Iterator[bytes]:
    """The byte-exact slice ``[start, end)`` of ``stream_files(files)``'
    stream, seeking to ``start`` instead of reading the prefix."""
    if end <= start:
        return
    for seg_start, seg_end, path in _file_segments(files):
        # The separator just before this file, if in range — checked
        # before the end-of-range break: a range ending exactly at a file
        # boundary still owns the separator at seg_start - 1.
        if seg_start > 0 and start <= seg_start - 1 < end:
            yield b"\n"
        if seg_start >= end:
            break
        if seg_end <= start:
            continue
        lo = max(start, seg_start) - seg_start
        hi = min(end, seg_end) - seg_start
        if hi <= lo:
            continue
        with open(path, "rb") as f:
            f.seek(lo)
            remaining = hi - lo
            while remaining:
                b = f.read(min(block_bytes, remaining))
                if not b:
                    break
                remaining -= len(b)
                yield b


def _align_to_newline(files: Sequence[str], pos: int, total: int,
                      window: int = 1 << 16) -> int:
    """Smallest cut ``c >= pos`` with ``stream[c-1] == \\n`` (or ``total``
    when no newline follows)."""
    if pos <= 0:
        return 0
    if pos >= total:
        return total
    scan = pos - 1
    while scan < total:
        chunk = b"".join(read_stream_range(files, scan,
                                           min(scan + window, total)))
        nl = chunk.find(b"\n")
        if nl >= 0:
            return scan + nl + 1
        scan += len(chunk)
        if not chunk:
            break
    return total


def plan_shards(files: Sequence[str], n_shards: int) -> List[ShardSpec]:
    """Split the stream into up to ``n_shards`` newline-aligned cursor
    ranges covering ``[0, total)`` exactly.  Nominal equal-size cuts move
    forward to the next newline; cuts that collapse together (a huge
    single line) merge their shards, so no shard is empty."""
    total = stream_total_bytes(files)
    if total <= 0 or n_shards <= 0:
        return []
    cuts = [0]
    for i in range(1, n_shards):
        c = _align_to_newline(files, i * total // n_shards, total)
        if c > cuts[-1] and c < total:
            cuts.append(c)
    cuts.append(total)
    return [ShardSpec(sid, s, e)
            for sid, (s, e) in enumerate(zip(cuts, cuts[1:]))]
