"""Capture-side deferreds and the delta payload format.

Copy of ``dsi_tpu/ckpt/delta.py``.

The async capture/commit split (``ckpt/writer.py``) needs snapshot
pieces that are CHEAP to take at the confirmed-step boundary and
materialize later in the commit writer: a device service dispatches its
snapshot pulls (``non_blocking`` copies into pinned host memory, each
with a CUDA event) and hands back a :class:`Deferred` whose
``materialize()`` blocks only on transfers that have been draining while
the pipeline kept stepping.

The delta payload format is shared by every engine: a delta checkpoint
is the ordered list of confirmed per-step device payloads retained
since the previous save — the rows APPENDED to the services, trimmed to
their occupied prefix — serialized as ``<prefix>d<i>_rows`` /
``<prefix>d<i>_nus`` array pairs (``rows[d, :nus[d]]`` are device
``d``'s valid rows; the key width is recoverable from the row shape, so
mixed-width chains survive a mid-stream re-key).  Restore re-ingests
each step through the engine's host drain path — ``PackedCounts``/
``KeyCounts`` merges are order-insensitive sums and the postings sink
preserves wave order, which is the same argument the cross-degree
resume (``DeviceTable.drain_image``) already rests on — so
``base + ordered deltas`` reproduces the uninterrupted accumulator
content exactly.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

_DELTA_KEY_RE = re.compile(r"^(.*)d(\d+)_rows$")


class Deferred:
    """A snapshot piece whose arrays materialize later (in the commit
    writer): wraps a zero-argument callable returning the final
    ``{name: np.ndarray}`` dict.  A plain dict is also accepted
    anywhere a Deferred is — ``materialize_part`` normalizes."""

    def __init__(self, fn: Callable[[], Dict[str, np.ndarray]]):
        self._fn = fn

    def materialize(self) -> Dict[str, np.ndarray]:
        return self._fn()


def materialize_part(part) -> Dict[str, np.ndarray]:
    """A capture part is either a ready dict (host accumulators —
    references to append-only tables, copied-on-capture scalars) or a
    :class:`Deferred` (device images with in-flight pulls)."""
    if hasattr(part, "materialize"):
        return part.materialize()
    return dict(part)


class HostDeltaLog:
    """Host-merge-path twin of the device services' delta log
    (``DeviceTable.enable_delta``): bounded retained window, overflow
    invalidates THIS window only — ``take()`` then returns None and the
    engine falls back to a full save, exactly the device rule.  Entries
    are ``(rows, nus)`` pairs; ``append`` trims ``rows`` to the
    occupied prefix AND copies (an AOT-shaped pull is full capacity,
    and a slice view would pin the whole buffer) so the retained bytes
    track the step's payload, not its capacity rung."""

    def __init__(self, max_steps: int = 64):
        self.max_steps = max(1, int(max_steps))
        self._log: List[Tuple[np.ndarray, np.ndarray]] = []
        self._invalid = False

    def append(self, rows, nus) -> None:
        if self._invalid:
            return  # dead window: nothing retained, no pointless copy
        if len(self._log) >= self.max_steps:
            self._invalid = True
            self._log.clear()
            return
        rows = np.asarray(rows)
        nus = np.asarray(nus, dtype=np.int64)
        mp = max(1, min(int(nus.max(initial=0)), int(rows.shape[1])))
        self._log.append((rows[:, :mp].copy(), nus.copy()))

    def take(self):
        """The retained steps since the last save — or None when this
        window overflowed (the full-save fallback signal); always
        re-arms the log."""
        if self._invalid:
            self._invalid = False
            self._log.clear()
            return None
        out = self._log[:]
        self._log.clear()
        return out

    def reset(self) -> None:
        """A full save landed: everything recorded so far is inside its
        image, so the window starts clean and valid."""
        self._log.clear()
        self._invalid = False


class DeltaSteps:
    """Deferred serializer for one delta's retained step payloads.

    ``entries`` is the ordered list of ``(rows, nus)`` pairs a service's
    ``take_delta()`` (or an engine-side host log) produced — ``rows``
    either a numpy array or an in-flight host copy (an object with
    ``wait()``, ``ops/wordcount.py HostCopy``) whose D2H was already
    enqueued; ``materialize`` turns them into the shared
    ``d<i>_rows``/``d<i>_nus`` payload arrays."""

    def __init__(self, entries: List[Tuple]):
        self.entries = list(entries)

    def materialize(self) -> Dict[str, np.ndarray]:
        arrays: Dict[str, np.ndarray] = {}
        for i, (rows, nus) in enumerate(self.entries):
            arrays[f"d{i:03d}_rows"] = (rows.wait() if hasattr(rows, "wait")
                                        else np.asarray(rows))
            arrays[f"d{i:03d}_nus"] = np.asarray(nus, dtype=np.int64)
        return arrays


def iter_delta_steps(arrays: Dict[str, np.ndarray],
                     prefix: str = "") -> Iterator[Tuple[np.ndarray,
                                                         np.ndarray]]:
    """The ``(rows, nus)`` pairs of one delta payload under ``prefix``,
    in step order — the restore-side inverse of :class:`DeltaSteps`."""
    idxs = []
    for k in arrays:
        m = _DELTA_KEY_RE.match(k)
        if m and m.group(1) == prefix:
            idxs.append(int(m.group(2)))
    for i in sorted(idxs):
        yield (arrays[f"{prefix}d{i:03d}_rows"],
               arrays[f"{prefix}d{i:03d}_nus"])


def drain_packed_steps(acc, arrays: Dict[str, np.ndarray],
                       prefix: str = "") -> int:
    """Re-ingest a delta's packed table steps (``shuffle._slice_pack``
    layout: kk key lanes + len/count/part columns) into a host
    accumulator — the same per-device ``acc.add`` walk
    ``DeviceTable._pull_merge`` and ``drain_image`` perform.  Returns
    the number of steps applied."""
    n = 0
    for rows, nus in iter_delta_steps(arrays, prefix):
        kk = int(rows.shape[2]) - 3
        for d in range(rows.shape[0]):
            nu = int(nus[d])
            if nu:
                r = rows[d, :nu]
                acc.add(r[:, :kk], r[:, kk],
                        r[:, kk + 1].astype(np.int64), r[:, kk + 2])
        n += 1
    return n


def drain_posting_steps(sink, arrays: Dict[str, np.ndarray],
                        prefix: str = "") -> int:
    """Re-ingest a delta's posting-row steps through the engine's sink
    (one ``[n, width]`` block per device, device order within a step,
    steps oldest-first) — per-word posting order is preserved because a
    word's rows within one wave come from exactly one source device,
    the invariant ``DevicePostings.drain_image`` documents."""
    n = 0
    for rows, nus in iter_delta_steps(arrays, prefix):
        for d in range(rows.shape[0]):
            nu = int(nus[d])
            if nu:
                sink(rows[d, :nu])
        n += 1
    return n
