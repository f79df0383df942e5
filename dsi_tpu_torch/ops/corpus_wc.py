"""Whole-corpus word count: one device pass, position-coded results.

Port of ``dsi_tpu/ops/corpus_wc.py``.  Every input file is laid out in
fixed-size zero-padded pieces (zero padding separates files, so no token
straddles a boundary); the pieces are uploaded through ``ops/xfer.py``,
raw or, with ``pack6=True``, 6 bits per byte (kernel G decodes them on
the card), and tokenize + group run over all of them through kernel A and
either the stable sort grouper (kernels B and C) or the hash grouper
(kernels D and F, with B and C for the dirty repair).  Each unique word
comes back as ``(first_occurrence_position << 7 | byte_length, count)``
in ONE device-to-host pull of a u32 vector that also carries the
overflow scalars; the host slices the spelling out of its own copy of the
corpus.

Tokens are maximal ASCII-letter runs; any byte >= 0x80 or word longer than
64 letters returns None so the caller takes the host path (the contract of
``count_words_host_result``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ops import xfer
from dsi_tpu_torch.ops.wordcount import (
    exactness_retry,
    fnv1a32_packed,
    group_sorted,
    grouper_ladder,
    hash_group,
    pack6_decode,
    radix_sort,
    resolve_device,
    tokenize,
)
from dsi_tpu_torch.utils.atomicio import atomic_write

# pos<<7|len packing needs pos < 2**25: cap the padded corpus at 32 MiB.
_POS_BITS = 25
_LEN_MASK = 0x7F

_FNV_OFFSET = np.uint32(0x811C9DC5)
_FNV_PRIME = np.uint32(0x01000193)


def _is_letter_byte(b: int) -> bool:
    """[A-Za-z] on one byte (copy of ``dsi_tpu/parallel/shuffle.py``)."""
    return (65 <= b <= 90) or (97 <= b <= 122)


def corpus_kernel(*pieces: torch.Tensor, max_word_len: int = 16,
                  u_cap: int = 1 << 18, t_cap_frac: int = 4,
                  grouper: str = "sort") -> torch.Tensor:
    """Count every word of the concatenated pieces; emit position-coded rows.

    Returns ONE 1-D int32 tensor (u32 bits) of length ``2*u_cap + 4``:
    ``rows[u_cap, 2]`` flattened (``pos << 7 | len``, ``count``; with the
    sort grouper rows are in lexicographic word order, with the hash
    grouper in bucket order — the output writer sorts on the host either
    way; pad rows zero) followed by the scalars ``[n_unique, max_len,
    has_high, token_overflow]``.
    """
    chunk = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    return _corpus_core(chunk, max_word_len, u_cap, t_cap_frac, grouper)


def corpus_kernel_packed(*pieces_and_table: torch.Tensor,
                         max_word_len: int = 16, u_cap: int = 1 << 18,
                         t_cap_frac: int = 4,
                         grouper: str = "sort") -> torch.Tensor:
    """``corpus_kernel`` over the 6-bit transport encoding of the corpus:
    packed pieces (each ``3/4 * piece_size`` bytes) plus the 64-entry
    code-to-byte table (``pack6_encode``).  Kernel G inverts the encoding
    first, so everything after it sees the raw path's bytes."""
    *pieces, table = pieces_and_table
    pk = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    return _corpus_core(pack6_decode(pk, table), max_word_len, u_cap,
                        t_cap_frac, grouper)


def _corpus_core(chunk: torch.Tensor, max_word_len: int, u_cap: int,
                 t_cap_frac: int, grouper: str = "sort") -> torch.Tensor:
    if grouper not in ("sort", "hash"):
        raise ValueError(f"unknown grouper {grouper!r}")
    n = chunk.shape[0]
    if n > 1 << _POS_BITS:
        raise ValueError(f"corpus_kernel caps at {1 << _POS_BITS} bytes")
    t_cap = n // t_cap_frac + 1
    keys, lengths, poslen, sc = tokenize(chunk, max_word_len=max_word_len,
                                         t_cap=t_cap, with_poslen=True)
    token_overflow = sc[0] > t_cap
    if grouper == "hash":
        # The first occurrence is the group's unsigned MIN of pos << 7 |
        # len (the length is the same across a group); it needs the
        # unsigned order, since the value reaches 2^32 - 1.
        fnv_t = fnv1a32_packed(keys, lengths, max_word_len)
        _, _, totals, poslen_u, n_unique, group_of = hash_group(
            keys, lengths, fnv_t, sc[:1], u_cap, extra=poslen)
        token_overflow = token_overflow | group_of
    else:
        # Stable sort: within a run of equal words the tokens keep
        # ascending position, so each run's FIRST row carries the first
        # occurrence.
        skeys, perm = radix_sort(keys)
        ones = torch.ones(t_cap, dtype=torch.int64, device=chunk.device)
        _, totals, _, poslen_u, n_unique = group_sorted(
            skeys, ones, u_cap, payload=poslen, perm=perm)
    rows = torch.stack([poslen_u, totals.to(torch.int32)], dim=1)
    scalars = torch.stack([n_unique, sc[1], sc[2],
                           token_overflow.to(torch.int32)])
    return torch.cat([rows.reshape(-1), scalars])


def pack6_encode(buf: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """6-bit transport encoding (copy of the reference's): (packed bytes
    [3n/4], code-to-byte table [64]), or None when the corpus uses more
    than 64 distinct byte values.  ``len(buf)`` must be a multiple of 4
    (piece sizes are powers of two)."""
    used = np.flatnonzero(np.bincount(buf, minlength=256))
    if len(used) > 64:
        return None
    table = np.zeros(64, dtype=np.uint8)
    table[:len(used)] = used.astype(np.uint8)
    lut = np.zeros(256, dtype=np.uint8)
    lut[used] = np.arange(len(used), dtype=np.uint8)
    c = lut[buf].astype(np.uint32).reshape(-1, 4)
    v = (c[:, 0] << 18) | (c[:, 1] << 12) | (c[:, 2] << 6) | c[:, 3]
    packed = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                      axis=1).astype(np.uint8).reshape(-1)
    return packed, table


def pack_pieces(raws: Sequence[bytes],
                piece_size: int = 1 << 21) -> Tuple[np.ndarray, int]:
    """Lay the files out as fixed-size zero-padded pieces.

    Returns (buf [n_pieces * piece_size] uint8, n_pieces).  A file larger
    than one piece is split at non-letter boundaries; zero padding at each
    piece tail separates files.  Reported positions index this buffer.
    """
    spans: List[bytes] = []
    for raw in raws:
        off = 0
        while len(raw) - off > piece_size - 1:
            cut = off + piece_size - 1
            while cut > off and _is_letter_byte(raw[cut - 1]) \
                    and _is_letter_byte(raw[cut]):
                cut -= 1
            if cut == off:  # one >piece letter run: host path handles it
                cut = off + piece_size - 1
            spans.append(raw[off:cut])
            off = cut
        spans.append(raw[off:])
    n_pieces = len(spans)
    buf = np.zeros(n_pieces * piece_size, dtype=np.uint8)
    for i, s in enumerate(spans):
        buf[i * piece_size:i * piece_size + len(s)] = np.frombuffer(
            s, dtype=np.uint8)
    return buf, n_pieces


def _resolve_pieces(raws: Sequence[bytes], piece_size: int | None):
    """Default piece size: smallest power of two holding the largest file
    plus its separator byte, floored at 4 KiB and capped at 2 MiB."""
    if piece_size is None:
        longest = max((len(r) for r in raws), default=1)
        piece_size = min(1 << 21, 1 << max(12, (longest + 1).bit_length()))
    buf, n_pieces = pack_pieces(raws, piece_size)
    return buf, n_pieces, piece_size


class CorpusResult:
    """Position-coded result + the corpus buffer the positions index."""

    __slots__ = ("buf", "pos", "lens", "cnt")

    def __init__(self, buf: np.ndarray, pos: np.ndarray, lens: np.ndarray,
                 cnt: np.ndarray) -> None:
        self.buf = buf      # [N] uint8, W zero bytes of tail padding
        self.pos = pos      # [nu] int64 first-occurrence byte offsets
        self.lens = lens    # [nu] int64 word byte lengths
        self.cnt = cnt      # [nu] int64 counts, in the kernel's row order

    def words(self) -> List[str]:
        b = self.buf.tobytes()
        return [b[p:p + l].decode("ascii")
                for p, l in zip(self.pos.tolist(), self.lens.tolist())]

    def to_dict(self, n_reduce: int = 10) -> Dict[str, Tuple[int, int]]:
        """{word: (count, reduce_partition)}."""
        parts = (self.ihashes() % np.uint32(n_reduce)).tolist()
        cnts = self.cnt.tolist()
        return {w: (cnts[i], parts[i])
                for i, w in enumerate(self.words())}

    def byte_matrix(self, width: int) -> np.ndarray:
        """[nu, width] uint8 word-byte matrix, zero past each length."""
        mat = self.buf[self.pos[:, None] + np.arange(width)]
        return np.where(np.arange(width) < self.lens[:, None], mat, 0)

    def ihashes(self, mat: np.ndarray | None = None) -> np.ndarray:
        """Vectorized reference ihash (fnv1a32 & 0x7fffffff,
        mr/worker.go:33-37) over all unique words at once."""
        if mat is None:
            mat = self.byte_matrix(int(self.lens.max(initial=1)))
        h = np.full(len(self.pos), _FNV_OFFSET, np.uint32)
        for j in range(mat.shape[1]):
            upd = (h ^ mat[:, j]) * _FNV_PRIME
            h = np.where(j < self.lens, upd, h)
        return h & np.uint32(0x7FFFFFFF)


def corpus_wordcount(raws: Sequence[bytes], *, piece_size: int | None = None,
                     max_word_len: int = 16, u_cap: int = 1 << 18,
                     pack6: bool = False, grouper: str | None = None,
                     device=None) -> Optional[CorpusResult]:
    """Exact whole-corpus counts, or None when the host path is needed
    (non-ASCII bytes or a word longer than 64).  Retries wider shapes on
    overflow.  ``device=None`` means ``cuda``.

    ``pack6=True`` ships the corpus 6 bits per byte when its alphabet fits
    in 64 symbols, and raw bytes when it does not.  ``grouper`` (default:
    the device's ``grouper_ladder``) picks the grouping stage; a hash
    grouper that cannot prove exactness retries through the sort grouper,
    the always-exact last rung."""
    dev = resolve_device(device)
    buf, n_pieces, piece_size = _resolve_pieces(raws, piece_size)
    if n_pieces == 0:
        return CorpusResult(np.zeros(64, np.uint8), *(np.zeros(0, np.int64)
                                                      for _ in range(3)))
    if len(buf) > 1 << _POS_BITS:
        return None  # position coding needs pos < 2^25: caller chunks
    table = None
    if pack6:
        enc = pack6_encode(buf)
        if enc is None:
            pack6 = False
        else:
            wire, table = enc
    if pack6:
        wire_piece = piece_size * 3 // 4
    else:
        wire, wire_piece = buf, piece_size
    views = [wire[i * wire_piece:(i + 1) * wire_piece]
             for i in range(n_pieces)]
    if table is not None:
        views.append(table)
    kernel = corpus_kernel_packed if pack6 else corpus_kernel
    if grouper is None:
        groupers = grouper_ladder(dev)
    else:
        groupers = (grouper, "sort") if grouper != "sort" else ("sort",)
    dev_args = xfer.put_views(views, dev)  # one upload serves every rung

    def run(mwl: int, cap: int):
        for g in groupers:
            for frac in (4, 2):  # exact token bound is n//2+1
                out = kernel(*dev_args, max_word_len=mwl, u_cap=cap,
                             t_cap_frac=frac, grouper=g)
                out = out.cpu().numpy().view(np.uint32)  # the ONE D2H pull
                nu, max_len, has_high, tok_of = (int(x) for x in out[-4:])
                if not tok_of:
                    break
            if not tok_of:
                break

        def payload():
            rows = out[:-4].reshape(-1, 2)[:nu].astype(np.int64)
            return CorpusResult(np.concatenate([buf, np.zeros(64, np.uint8)]),
                                rows[:, 0] >> 7, rows[:, 0] & _LEN_MASK,
                                rows[:, 1])

        return bool(has_high), nu, max_len, payload

    payload = exactness_retry(run, len(buf), max_word_len, u_cap)
    return None if payload is None else payload()


def render_lines(mat: np.ndarray, lens: np.ndarray,
                 cnt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Render ``"<word> <count>\\n"`` lines for every row, vectorized.

    Returns (buf [total_bytes] uint8, ends [nu] int64 — exclusive end
    offset of each row's line in ``buf``)."""
    nu, width = mat.shape
    if nu == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    c = np.maximum(cnt, 1).astype(np.int64)
    dlen = np.full(nu, 1, np.int64)
    p = np.int64(10)
    while True:  # digits(count): bounded by the corpus' total token count
        more = c >= p
        if not more.any():
            break
        dlen += more
        p *= 10
    max_d = int(dlen.max())

    total = lens + 1 + dlen + 1  # word, space, digits, newline
    ends = np.cumsum(total)
    starts = ends - total
    buf = np.zeros(int(ends[-1]), np.uint8)

    col = np.arange(width)
    wmask = col < lens[:, None]
    buf[(starts[:, None] + col)[wmask]] = mat[wmask]
    buf[starts + lens] = 32  # space

    dcol = np.arange(max_d)
    dmask = dcol < dlen[:, None]
    # Most-significant digit first: digit j = cnt // 10^(dlen-1-j) % 10.
    pow10 = np.power(np.int64(10), np.maximum(dlen[:, None] - 1 - dcol, 0))
    digits = (cnt.astype(np.int64)[:, None] // pow10) % 10
    buf[(starts[:, None] + 1 + lens[:, None] + dcol)[dmask]] = \
        (48 + digits[dmask]).astype(np.uint8)
    buf[ends - 1] = 10  # newline
    return buf, ends


def write_corpus_output(res: CorpusResult, n_reduce: int,
                        workdir: str = ".") -> List[str]:
    """Materialise mr-out-<r> files straight from the position-coded table.

    Rows go into lexicographic word order host-side, then a stable sort by
    partition leaves each partition's lines in the reference's within-file
    order (``mr/worker.go:124-146``).  Vectorized numpy throughout."""
    width = int(res.lens.max(initial=1))
    mat = res.byte_matrix(width)  # built once: hashes + spellings below
    part = res.ihashes(mat) % np.uint32(n_reduce)

    worder = np.lexsort(tuple(mat[:, j] for j in range(width - 1, -1, -1)))
    mat = mat[worder]
    part = part[worder]
    res = CorpusResult(res.buf, res.pos[worder], res.lens[worder],
                       res.cnt[worder])

    order = np.argsort(part, kind="stable")
    buf, ends = render_lines(mat[order], res.lens[order], res.cnt[order])
    starts = np.concatenate([[0], ends[:-1]]) if len(ends) else ends
    counts = np.bincount(part, minlength=n_reduce)
    row_bounds = np.concatenate([[0], np.cumsum(counts)])

    paths = []
    for r in range(n_reduce):
        lo, hi = int(row_bounds[r]), int(row_bounds[r + 1])
        lo_b = int(starts[lo]) if lo < hi else 0
        hi_b = int(ends[hi - 1]) if lo < hi else 0
        path = os.path.join(workdir, f"mr-out-{r}")
        with atomic_write(path, mode="wb") as f:
            f.write(buf[lo_b:hi_b].tobytes())
        paths.append(path)
    return paths
