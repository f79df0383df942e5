"""Vectorized host-side merge table for the SPMD paths' per-step outputs.

Copy of ``dsi_tpu/parallel/merge.py`` (``PackedCounts`` and
``PostingsTable`` with their checkpoint ``snapshot``/``restore``, their
helpers, and ``PackedPostings``).
Per-step tables of packed word keys (big-endian u32 lanes) plus length /
count / partition columns accumulate as raw numpy arrays; merging is one ``np.lexsort``
over the key lanes, run-boundary detection and ``np.add.reduceat`` per
compaction window; spellings are decoded once, from the final merged
table.

Zero-padded key lanes make width harmonisation trivial: a word packed
into K lanes and the same word packed into K' > K lanes agree on the
first K lanes and are zero beyond, so narrower tables are right-padded
with zero columns before concatenation.

TF-IDF's postings accumulate rather than merge: ``PostingsTable`` keeps
every wave's (word, len, tf, doc, part) rows raw and groups them once,
at ``finalize``, with one stable lexsort, so a word's postings keep the
order they were added in.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from dsi_tpu_torch.ops.wordcount import decode_packed


def _pad_width(keys: np.ndarray, k: int) -> np.ndarray:
    """Right-pad packed-key lanes with zero columns to width ``k``."""
    if keys.shape[1] == k:
        return keys
    out = np.zeros((keys.shape[0], k), dtype=np.uint32)
    out[:, :keys.shape[1]] = keys
    return out


def _group_starts(sorted_keys: np.ndarray) -> np.ndarray:
    """Start indices of equal-key runs in a lexsorted [n, k] table."""
    n = len(sorted_keys)
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.any(sorted_keys[1:] != sorted_keys[:-1], axis=1, out=boundary[1:])
    return np.flatnonzero(boundary)


def _lexsort_rows(keys: np.ndarray) -> np.ndarray:
    """Row order sorting a [n, k] table lexicographically (lane 0
    primary).  ``np.lexsort`` treats its LAST key as primary, so lanes are
    passed in reverse."""
    return np.lexsort(tuple(keys[:, j] for j in range(keys.shape[1] - 1,
                                                      -1, -1)))


class PackedCounts:
    """Word-count accumulator over packed-key row batches.

    ``add`` ingests per-shard step outputs (keys [n, K] uint32, byte
    lengths, counts, reduce partitions); batches are compacted into one
    merged table whenever the buffered row count crosses
    ``compact_rows`` — so host memory is O(vocabulary + window), never
    O(corpus).  ``finalize`` decodes spellings once and returns
    ``{word: (count, reduce_partition)}``.
    """

    def __init__(self, compact_rows: int = 1 << 21):
        self._bufs: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]] = []
        self._pending = 0
        self._compact_rows = max(1, compact_rows)

    def add(self, keys: np.ndarray, lens: np.ndarray, cnts: np.ndarray,
            parts: np.ndarray) -> None:
        if len(keys) == 0:
            return
        # Copies detach the rows from the step's transfer buffer; counts
        # widen to int64 so multi-step sums can't wrap.
        self._bufs.append((
            np.array(keys, dtype=np.uint32),
            np.array(lens, dtype=np.int32),
            np.array(cnts, dtype=np.int64),
            np.array(parts, dtype=np.int32)))
        self._pending += len(keys)
        if self._pending >= self._compact_rows:
            self._compact()

    def add_packed_step(self, packed: np.ndarray, n_uniques,
                        kk: int) -> None:
        """Ingest one pulled step tensor ``[n_dev, mp, kk+3]`` uint32
        (the ``shuffle._slice_pack`` layout: kk key lanes + len / count /
        partition columns), taking the first ``n_uniques[d]`` rows of each
        shard's table."""
        for d in range(packed.shape[0]):
            nu = int(n_uniques[d])
            r = packed[d, :nu]
            self.add(r[:, :kk], r[:, kk], r[:, kk + 1], r[:, kk + 2])

    def _compact(self) -> None:
        if len(self._bufs) <= 1:
            return
        k = max(b[0].shape[1] for b in self._bufs)
        keys = np.concatenate([_pad_width(b[0], k) for b in self._bufs])
        lens = np.concatenate([b[1] for b in self._bufs])
        cnts = np.concatenate([b[2] for b in self._bufs])
        parts = np.concatenate([b[3] for b in self._bufs])
        order = _lexsort_rows(keys)
        skeys = keys[order]
        starts = _group_starts(skeys)
        # len and partition are functions of the word, so first-of-run is
        # exact; only counts need the segmented sum.
        self._bufs = [(skeys[starts], lens[order][starts],
                       np.add.reduceat(cnts[order], starts),
                       parts[order][starts])]
        self._pending = len(starts)

    def finalize(self) -> Dict[str, Tuple[int, int]]:
        self._compact()
        if not self._bufs:
            return {}
        keys, lens, cnts, parts = self._bufs[0]
        words = decode_packed(keys, lens, len(keys))
        return {w: (int(c), int(p))
                for w, c, p in zip(words, cnts.tolist(), parts.tolist())}

    def snapshot(self) -> Dict[str, np.ndarray]:
        """The merged table as four arrays (``keys``, ``lens``, ``cnts``,
        ``parts``), compacted first so the image is bounded by the
        vocabulary; an empty accumulator gives an empty dict."""
        self._compact()
        if not self._bufs:
            return {}
        keys, lens, cnts, parts = self._bufs[0]
        return {"keys": keys, "lens": lens, "cnts": cnts, "parts": parts}

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        """Load a :meth:`snapshot` image, replacing any current state.
        Final results do not depend on how the same (word, count)
        contributions were buffered, so a restored accumulator finalizes
        bit-identically to the uninterrupted one."""
        if not arrays or "keys" not in arrays or len(arrays["keys"]) == 0:
            self._bufs, self._pending = [], 0
            return
        self._bufs = [(np.array(arrays["keys"], dtype=np.uint32),
                       np.array(arrays["lens"], dtype=np.int32),
                       np.array(arrays["cnts"], dtype=np.int64),
                       np.array(arrays["parts"], dtype=np.int32))]
        self._pending = len(self._bufs[0][0])


class PostingsTable:
    """TF-IDF accumulator over packed (word, tf, doc, part) row batches.

    Rows are kept raw (uint32) and grouped once at ``finalize``: one
    lexsort over the key lanes, run-boundary detection, one bulk spelling
    decode.  ``finalize`` returns ``{word: (reduce_partition, [(doc_index,
    tf), ...])}``, postings in the order they were added."""

    def __init__(self):
        self._bufs: List[np.ndarray] = []
        self._kk: Optional[int] = None

    def add(self, rows: np.ndarray, kk: int) -> None:
        """Ingest [n, kk+4] rows: kk key lanes + (len, tf, doc, part)."""
        if len(rows) == 0:
            return
        if self._kk is None:
            self._kk = kk
        elif kk != self._kk:  # one word-window rung per table
            raise ValueError(f"mixed key widths: {self._kk} vs {kk}")
        self._bufs.append(np.array(rows, dtype=np.uint32))

    # ── checkpoint image (ckpt/) ──

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Every buffered row, concatenated in insertion order: per-word
        doc order is part of the postings, and the stable ``finalize``
        lexsort keeps it, so a restored table groups the same."""
        if not self._bufs:
            return {}
        rows = (np.concatenate(self._bufs) if len(self._bufs) > 1
                else self._bufs[0])
        return {"rows": rows, "kk": np.array(self._kk, dtype=np.int64)}

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        if not arrays or "rows" not in arrays or len(arrays["rows"]) == 0:
            self._bufs, self._kk = [], None
            return
        self._kk = int(arrays["kk"])
        self._bufs = [np.array(arrays["rows"], dtype=np.uint32)]

    def finalize(self) -> Dict[str, Tuple[int, List[Tuple[int, int]]]]:
        return self.finalize_packed().to_dict()

    def finalize_packed(self) -> "PackedPostings":
        """Group without building Python objects: the postings stay numpy
        arrays (``to_dict`` or ``lookup_many`` make the dict form)."""
        if not self._bufs:
            return PackedPostings(0)
        kk = self._kk
        rows = (np.concatenate(self._bufs) if len(self._bufs) > 1
                else self._bufs[0])
        keys = rows[:, :kk]
        order = _lexsort_rows(keys)
        skeys = keys[order]
        starts = _group_starts(skeys)
        out = PackedPostings(kk)
        out.skeys = np.ascontiguousarray(skeys[starts])
        out.starts = starts
        out.ends = np.append(starts[1:], len(rows))
        out.lens = rows[order[starts], kk]
        out.parts = rows[order[starts], kk + 3]
        out.tfs = np.ascontiguousarray(rows[order, kk + 1])
        out.docs = np.ascontiguousarray(rows[order, kk + 2])
        return out


class PackedPostings:
    """Grouped TF-IDF postings as numpy tables, words in lexicographic
    order.  ``skeys/lens/parts/starts/ends`` are per unique word;
    ``tfs/docs`` are every posting, ``starts[i]:ends[i]`` word i's."""

    __slots__ = ("kk", "skeys", "lens", "parts", "starts", "ends",
                 "tfs", "docs", "_be")

    def __init__(self, kk: int):
        self.kk = kk
        self._be = None  # big-endian key view, made by lookup_many
        self.skeys = np.zeros((0, max(kk, 1)), np.uint32)
        self.lens = np.zeros(0, np.uint32)
        self.parts = np.zeros(0, np.uint32)
        self.starts = np.zeros(0, np.int64)
        self.ends = np.zeros(0, np.int64)
        self.tfs = np.zeros(0, np.uint32)
        self.docs = np.zeros(0, np.uint32)

    def __len__(self) -> int:
        return len(self.skeys)

    @property
    def n_postings(self) -> int:
        return len(self.tfs)

    def postings_per_word(self) -> np.ndarray:
        return self.ends - self.starts

    def lookup_many(self, words) -> Dict[str, Tuple[int, List[Tuple[int,
                                                                    int]]]]:
        """``{word: (part, [(doc, tf), ...])}`` for just these words
        (absent words omitted): a binary search per word over the
        lexsorted big-endian key bytes, whose byte order is lane order."""
        n = len(self.skeys)
        if n == 0:
            return {}
        if self._be is None:  # the table is immutable after finalize
            self._be = np.ascontiguousarray(self.skeys.astype(">u4"))
        be = self._be
        width = 4 * self.kk
        out: Dict[str, Tuple[int, List[Tuple[int, int]]]] = {}
        for w in words:
            try:
                raw = w.encode("ascii")
            except UnicodeEncodeError:
                continue  # a non-ASCII word cannot be in the table
            if not raw or len(raw) > width:
                continue
            q = raw.ljust(width, b"\x00")
            lo, hi = 0, n
            while lo < hi:
                mid = (lo + hi) // 2
                if be[mid].tobytes() < q:
                    lo = mid + 1
                else:
                    hi = mid
            if lo >= n or be[lo].tobytes() != q \
                    or int(self.lens[lo]) != len(raw):
                continue
            s, e = int(self.starts[lo]), int(self.ends[lo])
            out[w] = (int(self.parts[lo]),
                      list(zip(self.docs[s:e].tolist(),
                               self.tfs[s:e].tolist())))
        return out

    def to_dict(self) -> Dict[str, Tuple[int, List[Tuple[int, int]]]]:
        if len(self.skeys) == 0:
            return {}
        words = decode_packed(self.skeys, self.lens, len(self.skeys))
        tfs = self.tfs.tolist()
        docs = self.docs.tolist()
        out: Dict[str, Tuple[int, List[Tuple[int, int]]]] = {}
        for i, w in enumerate(words):
            s, e = int(self.starts[i]), int(self.ends[i])
            out[w] = (int(self.parts[i]), list(zip(docs[s:e], tfs[s:e])))
        return out
