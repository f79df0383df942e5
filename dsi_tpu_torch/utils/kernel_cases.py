"""Edge cases for kernels A (tokenize), C (group runs), H (grep line
flags), J (the grep step) and E (the shuffle) at tile edges, for kernel
D (FNV-1a with its partition epilogue), kernel O (the crash model
checker), kernel I (the NFA scan) at its group edges, kernel P (the
relay pack) at every offset residue mod 16 and past the row, and kernel
N (the wire decode) with escapes across its tile edges.

One set of inputs serves two checks: the CPU tests hold the port's plain
versions against ``dsi_tpu`` on them at a small tile, and ``chip_smoke.py``
holds each kernel against its plain version on the card with ``tile`` set
to the kernel's own (``dsi_tokenize_tile_bytes``, ``dsi_group_tile_rows``,
``dsi_grep_tile_bytes``, ``dsi_grep_step_tile_bytes``,
``dsi_grep_step_line_tile`` and ``dsi_route_tile_rows``).  Every case is
made with numpy from a seed; every case of one call has the same shape,
apart from A's ``odd_length``, J's pattern lengths and E's and D's
shapes, so a compiled reference serves most of them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from dsi_tpu_torch.ops.grepk import literal_branch as lit

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                         b"ABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)
_SEPS = np.frombuffer(b" \n\t.,;:!?0123456789_-", np.uint8)
_PAD64 = np.iinfo(np.uint64).max

# (name, chunk u8 [n], max_word_len, t_cap)
TokenizeCase = Tuple[str, np.ndarray, int, int]
# (name, sorted keys u64 [k64, t], counts i64 [t], u_cap, payload i32 [t],
#  perm i32 [t])
GroupCase = Tuple[str, np.ndarray, np.ndarray, int, np.ndarray, np.ndarray]
# (name, chunks u8 [8, n], pats u8 [8, m], dlen i32 [8], bases i64 [8],
#  l_cap); every case has bins GREP_BINS and k GREP_K
GrepCase = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]
GREP_BINS, GREP_K = 8, 16
# (name, chunk u8 [n], branches, l_cap): kernel H's call, each branch a
# (positions, anchor_start, anchor_end) with each position a tuple of
# (lo, hi) byte ranges (ops/grepk.py Branch); several branches are an
# alternation, whose flags are the OR of its branches'
HGrepCase = Tuple[str, np.ndarray, tuple, int]
# (name, chunk u8 [n], mask u8 [n], l_cap): H's mask entry (kernel I's)
LineFlagCase = Tuple[str, np.ndarray, np.ndarray, int]
# (name, rows u32 [n_dev, r, w], dest i32 [n_dev, r], n_dev, k)
RouteCase = Tuple[str, np.ndarray, np.ndarray, int, int]
# (name, lanes u32 [u, kk], lens i32 [u], max_word_len, epilogue): the
# epilogue is None (the hash alone) or a dict of fnv1a32_route's keywords
# n_part, n_dest, park and one of valid (bool [u]) or n_valid (an int)
FnvCase = Tuple[str, np.ndarray, np.ndarray, int, Optional[dict]]
# (name, n_instances, first, simulate_batch's keywords); every case has
# seed CRASH_SEED
CrashCase = Tuple[str, int, int, dict]
CRASH_SEED = 3
# (name, chunk u8 [n], pattern, state bucket, l_cap)
NfaCase = Tuple[str, np.ndarray, str, int, int]
# Kernel I's group (csrc/nfa.cu kGroup blocks of 256 bytes), the bytes one
# CUDA block scans and publishes one aggregate for.
NFA_GROUP_BYTES = 64 * 256
# (name, acc u8 [n_dev, cap], off i64 [n_dev], new u8 [n_dev, cap])
RelayCase = Tuple[str, np.ndarray, np.ndarray, np.ndarray]
# (name, packed u8 [n_dev, width], lit_cap, the encoder's input u8
#  [n_dev, n] or None for a hand-made packed tensor); every case's n is
#  the call's
WireCase = Tuple[str, np.ndarray, int, Optional[np.ndarray]]


def _text(rng, n: int, max_len: int = 14) -> np.ndarray:
    """n bytes of words of 1..max_len letters between 1..3 separators."""
    out = np.empty(n, np.uint8)
    i = 0
    while i < n:
        ln = int(rng.integers(1, max_len + 1))
        out[i:i + ln] = rng.choice(_LETTERS, ln)[:n - i]
        i += ln
        gap = int(rng.integers(1, 4))
        out[i:i + gap] = rng.choice(_SEPS, gap)[:max(0, n - i)]
        i += gap
    return out


def _put(buf: np.ndarray, at: int, word: bytes) -> None:
    """Write ``word`` at ``at`` with a separator on each side."""
    if at > 0:
        buf[at - 1] = ord(" ")
    end = min(len(buf), at + len(word))
    buf[at:end] = np.frombuffer(word, np.uint8)[:end - at]
    if end < len(buf):
        buf[end] = ord(" ")


def _tokens(rng, n: int, extra: int) -> np.ndarray:
    """n bytes holding exactly n // 4 + extra tokens (n % 4 == 0): one token
    a 4-byte unit, and two in each of the last ``extra`` units."""
    units = n // 4
    out = np.empty(n, np.uint8)
    for u in range(units):
        a, b = rng.choice(_LETTERS, 2)
        out[4 * u:4 * u + 4] = ((a, ord("."), b, ord(" "))
                                if u >= units - extra else
                                (a, b, ord("."), ord(" ")))
    return out


# (start relative to a tile edge, length) of the word put at each edge.
_EDGE_WORDS = ((-1, 5),     # its first byte is the tile's last
               (-40, 40),   # its last byte is the tile's last
               (0, 7),      # starts on the next tile's first byte
               (-10, 100),  # runs past the next tile's halo
               (-16, 64),   # at max_word_len 64 its key bytes fill the halo
               (-5, 69),    # ends on the halo's last byte
               (-5, 70))    # ends on the first byte past the halo


def tokenize_cases(tile: int, n: int, seed: int = 1234) -> List[TokenizeCase]:
    """Kernel A's edges for a tile of ``tile`` bytes in a chunk of ``n``
    bytes (``n`` a multiple of 4 and at least 8 tiles): a word at each
    tile edge (first, last and halo byte; the halo is 64 bytes), a word
    ending on the chunk's last byte, letters only, a 200-letter word
    across an edge (past any halo and past 127, so ``poslen``'s OR shows),
    ``n_tokens`` equal to ``t_cap`` and one above, high bytes, odd k
    (max_word_len 12) and a chunk whose length is no multiple of 16.
    ``t_cap`` is ``n // 4 + 1``, the word count's at ``t_cap_frac`` 4."""
    if n % 4 or n < 8 * tile:
        raise ValueError(f"tokenize_cases: n={n} for tile {tile}")
    rng = np.random.default_rng(seed)
    t_cap = n // 4 + 1
    cases = []

    end_word = _text(rng, n)
    end_word[-9:] = rng.choice(_LETTERS, 9)
    end_word[-10] = ord(" ")
    cases.append(("word_at_chunk_end", end_word, 16, t_cap))
    cases.append(("letters_only", rng.choice(_LETTERS, n), 16, t_cap))

    edges = _text(rng, n)
    for i, e in enumerate(range(tile, n, tile)):
        at, ln = _EDGE_WORDS[i % len(_EDGE_WORDS)]
        _put(edges, e + at, bytes(rng.choice(_LETTERS, ln)))
    cases += [("tile_edges", edges, 16, t_cap),
              ("tile_edges_mwl64", edges, 64, t_cap)]

    long_word = _text(rng, n)
    _put(long_word, tile - 100, bytes(rng.choice(_LETTERS, 200)))
    cases.append(("word_200", long_word, 16, t_cap))
    cases.append(("n_tokens_eq_t_cap", _tokens(rng, n, 1), 16, t_cap))
    cases.append(("n_tokens_t_cap_plus_1", _tokens(rng, n, 2), 16, t_cap))

    high = _text(rng, n)
    high[rng.integers(0, n, 40)] = rng.integers(128, 256, 40)
    high[tile - 1] = 0xC3
    high[tile] = 0xA9
    cases.append(("high_bytes", high, 16, t_cap))
    cases.append(("odd_k_mwl12", _text(rng, n, 20), 12, t_cap))
    odd = _text(rng, n - 5)
    odd[-3:] = rng.choice(_LETTERS, 3)
    cases.append(("odd_length", odd, 16, (n - 5) // 4 + 1))
    return cases


def _sorted_rows(rng, t: int, k64: int, n_pad: int, n_words: int,
                 hi: int = 1 << 62) -> np.ndarray:
    """[k64, t] lexicographically sorted u64 key words: t - n_pad rows drawn
    from n_words distinct rows, then n_pad pad rows."""
    vocab = rng.integers(0, hi, size=(max(1, n_words), k64), dtype=np.uint64)
    rows = vocab[rng.integers(0, len(vocab), t - n_pad)]
    rows = rows[np.lexsort(rows.T[::-1])]
    pad = np.full((n_pad, k64), _PAD64, np.uint64)
    return np.ascontiguousarray(np.concatenate([rows, pad]).T)


def _n_unique(keys: np.ndarray) -> int:
    valid = keys[0] != _PAD64
    prev = np.concatenate([np.full((keys.shape[0], 1), _PAD64, np.uint64),
                           keys[:, :-1]], axis=1)
    return int(((keys != prev).any(axis=0) & valid).sum())


def group_cases(tile: int, t: int, seed: int = 1234) -> List[GroupCase]:
    """Kernel C's edges for a tile of ``tile`` rows and ``t`` rows (at
    least 4 tiles): one run of all rows, all pad rows, no pad row,
    ``n_unique`` equal to ``u_cap`` and one above, ``u_cap`` 1, counts
    above 2^32, k64 1, 2 and 8, pad rows whose later words differ (a row
    is a pad row by its first word), and runs whose heads fall on tile
    and warp edges, with one run longer than a tile."""
    if t < 4 * tile:
        raise ValueError(f"group_cases: t={t} for tile {tile}")
    rng = np.random.default_rng(seed)

    def case(name, keys, u_cap, counts=None):
        if counts is None:
            counts = rng.integers(1, 9, t).astype(np.int64)
        payload = rng.integers(-(1 << 31), 1 << 31, t).astype(np.int32)
        perm = rng.permutation(t).astype(np.int32)
        return (name, keys, counts, u_cap, payload, perm)

    cases = []
    cases.append(case("one_run", np.tile(
        rng.integers(0, 1 << 62, (2, 1), dtype=np.uint64), (1, t)), 16))
    cases.append(case("all_pad", np.full((2, t), _PAD64, np.uint64), 16))
    no_pad = _sorted_rows(rng, t, 2, 0, t // 3)
    cases.append(case("no_pad", no_pad, t))
    mixed = _sorted_rows(rng, t, 2, 37, t // 5)
    nu = _n_unique(mixed)
    cases += [case("n_unique_eq_u_cap", mixed, nu),
              case("n_unique_u_cap_plus_1", mixed, nu - 1),
              case("u_cap_1", mixed, 1),
              case("counts_above_2_32", mixed, nu,
                   rng.integers(1 << 32, 1 << 40, t).astype(np.int64))]
    for k64 in (1, 2, 8):
        cases.append(case(f"k64_{k64}", _sorted_rows(
            rng, t, k64, int(rng.integers(1, 200)), t // 4, hi=1 << 3),
            t // 2))
    real_pad = _sorted_rows(rng, t, 2, 300, t // 5)
    real_pad[1, t - 300:] = np.sort(rng.integers(0, 1 << 62, 300,
                                                 dtype=np.uint64))
    cases.append(case("pad_first_word", real_pad, t))

    # Heads at tile and warp edges: run boundaries at e - 1, e, e + 1 and
    # e + 32 for every tile edge e, one run over the whole second tile, and
    # a boundary in the last key word alone.
    cuts = {0}
    for e in range(tile, t, tile):
        cuts |= {e - 1, e, e + 1, e + 32, e + 33}
    cuts -= set(range(tile + 2, 3 * tile + 1))  # no head in tile 2
    cuts = sorted(c for c in cuts if 0 <= c < t)
    rid = np.zeros(t, np.int64)
    rid[cuts] = 1
    rid = np.cumsum(rid)
    edges = np.stack([rid.astype(np.uint64) // 2 * 5 + 1,
                      rid.astype(np.uint64) % 2])
    cases.append(case("tile_edges", np.ascontiguousarray(edges),
                      _n_unique(edges)))
    return cases


_NO_T = np.frombuffer(b"abcdefghijklmnopqrsuvwxyz", np.uint8)  # no 't'


def _line_text(rng, n: int, lo: int, hi: int,
               alphabet: np.ndarray = _LETTERS[:26]) -> np.ndarray:
    """n bytes of lines of lo..hi bytes (the newline included, the last
    line cut at n): words of ``alphabet`` between single spaces."""
    ends = np.cumsum(rng.integers(lo, hi + 1, n // lo + 1))
    out = rng.choice(alphabet, n)
    out[rng.random(n) < 0.18] = ord(" ")
    out[ends[ends <= n] - 1] = ord("\n")
    return out


def _at(buf: np.ndarray, at: int, data: bytes) -> None:
    end = min(len(buf), at + len(data))
    if 0 <= at < end:
        buf[at:end] = np.frombuffer(data, np.uint8)[:end - at]


def grep_cases(tile: int, line_tile: int, seed: int = 1234) -> List[GrepCase]:
    """Kernel J's edges for byte tiles of ``tile`` bytes and line tiles of
    ``line_tile`` lines, each case 8 rows of 8 tiles (``l_cap`` an eighth
    of a row and at least 4 line tiles, lines 2 to 40 bytes long, pattern
    ``the`` unless named): a match across every tile edge (and across the
    pattern's halo of 64 bytes), a newline on a tile's first and last
    byte, a line over three tiles whose only match is in the middle one,
    every line matching (matched > k, ties in occ by line), a line with
    12 or more occurrences (>= bins - 1), n_lines > l_cap, dlen 0 and
    dlen no multiple of 16, the pattern past dlen of an unterminated row
    (and across dlen), m = 1 with lines of 256 or more matches, m = 80
    (past the halo) with near misses, a different pattern on each row
    (one with overlapping occurrences), and bases whose lines cross
    2^32."""
    rng = np.random.default_rng(seed)
    n = 8 * tile
    l_cap = max(4 * line_tile, n // 8)
    edges = range(tile, n, tile)
    the = np.frombuffer(b"the", np.uint8)
    cases = []

    def case(name, rows, pats=None, dlen=None, bases=None):
        chunks = np.stack(rows).astype(np.uint8)
        if pats is None:
            pats = np.tile(the, (8, 1))
        if dlen is None:  # each row cut after its last newline
            dlen = np.array([int(np.flatnonzero(r == 10)[-1]) + 1
                             if (r == 10).any() else 0 for r in chunks])
        if bases is None:
            bases = np.arange(8, dtype=np.int64) * 100_003
        cases.append((name, chunks, np.ascontiguousarray(pats, np.uint8),
                      np.asarray(dlen, np.int32), np.asarray(bases, np.int64),
                      l_cap))

    def text(lo=2, hi=40, alphabet=_LETTERS[:26]):
        return _line_text(rng, n, lo, hi, alphabet)

    rows = []
    for r in range(8):
        t = text(8, 40)
        for e in edges:  # starts 1 or 2 bytes before the edge
            _at(t, e - 1 - r % 2, b"the")
            _at(t, e + 62 - r % 3, b"the")  # across the halo's end
        rows.append(t)
    case("match_across_tiles", rows)

    rows = []
    for r in range(8):
        t = text(3, 30)
        for e in edges:
            t[e] = t[e - 1] = ord("\n")
            _at(t, e + 1, b"the")
            _at(t, e - 4, b"the")
        rows.append(t)
    case("newline_on_tile_edges", rows)

    rows = []
    for r in range(8):
        t = text(4, 40, _NO_T)
        a = tile // 2 + 7 * r  # no newline in [a, a + 3 tiles)
        t[a:a + 3 * tile] = rng.choice(_NO_T, 3 * tile)
        t[a - 1] = t[a + 3 * tile] = ord("\n")
        _at(t, a + tile + tile // 2 + r, b"the")
        rows.append(t)
    case("line_over_three_tiles", rows)

    rows = []
    for r in range(8):  # 1 or 2 matches a line: many ties
        lines = (b"the xyz\n" if one else b"the a the\n"
                 for one in rng.random(n // 8 + 1) < 0.7)
        rows.append(np.frombuffer(b"".join(lines), np.uint8)[:n].copy())
    case("every_line_matches", rows)

    rows = []
    for r in range(8):
        t = text(8, 40)
        at = int(rng.integers(0, n - 200))
        _at(t, at, b"\n" + b"the" * (12 + r) + b"\n")
        _at(t, at + 100, b"\nthethe thehe the\n")
        rows.append(t)
    case("many_occurrences", rows)

    rows = [np.resize(np.frombuffer(b"the\nx\n" if r % 2 else b"x\nthe\n",
                                    np.uint8), n) for r in range(8)]
    case("n_lines_over_l_cap", rows)

    rows = [text() for _ in range(8)]
    case("dlen_edges", rows, dlen=[0, 1, 17, 37, tile + 5, n - 3, n, 2 * tile])

    rows, dlen = [], []
    for r in range(8):
        t = text(5, 30)
        d = n - 6 - 9 * r
        t[d - 1] = ord("x")  # unterminated
        _at(t, d + 2, b"the")
        if r % 2:
            _at(t, d - 2, b"the")  # across dlen
        rows.append(t)
        dlen.append(d)
    case("pattern_past_dlen", rows, dlen=dlen)

    rows = []
    for r in range(8):  # lines of 256 or more matches: a select on 2 bytes
        t = text()
        for i in range(2 + r % 4):
            _at(t, i * 350 + 40,
                b"\n" + b"e" * (256 + 13 * r + 5 * (i % 2)) + b"\n")
        rows.append(t)
    case("pattern_length_1", rows, pats=np.full((8, 1), ord("e"), np.uint8))

    long_pat = rng.choice(_LETTERS[:26], 80)
    long_pat[[9, 30, 61]] = ord(" ")
    rows = []
    for r in range(8):
        t = text(100, 300)
        for i, e in enumerate(edges):
            at = e - [1, 10, 64, 70, 79, 0, 33][i % 7]
            miss = long_pat.copy()
            miss[[79, 64, 40][i % 3]] ^= 1  # near misses on the halo edge
            _at(t, at - 200, miss.tobytes())
            _at(t, at, long_pat.tobytes())
        rows.append(t)
    case("pattern_length_80", rows, pats=np.tile(long_pat, (8, 1)))

    pats = np.stack([np.frombuffer(p, np.uint8) for p in (
        b"the", b"and", b"e e", b"aaa", b"x\nx", b"  t", b"zzz", b"hea")])
    rows = []
    for r in range(8):
        t = text(4, 20, _LETTERS[:26] if r != 3 else
                 np.frombuffer(b"aab", np.uint8))
        rows.append(t)
    case("pattern_per_row", rows, pats=pats)

    rows = []
    for r in range(8):
        t = text(4, 20)
        for at in rng.integers(0, n - 3, n // 64):
            _at(t, int(at), b"the")
        rows.append(t)
    case("bases_across_2_32", rows,
         bases=(1 << 32) - 5 - np.arange(8, dtype=np.int64) * 7)
    return cases


def cls(positions, anchor_start: bool = False,
        anchor_end: bool = False) -> tuple:
    """A class branch of kernel H (``ops/grepk.py Branch``) from a string
    per position (its bytes, each a one-byte range) or a list of (lo, hi)
    ranges."""
    return (tuple(tuple((b, b) for b in p.encode()) if isinstance(p, str)
                  else tuple(p) for p in positions),
            anchor_start, anchor_end)


def hgrep_cases(tile: int, seed: int = 1234) -> List[HGrepCase]:
    """Kernel H's edges for tiles of ``tile`` bytes (a thread holds 32 of
    them), on lines of 20-120 bytes in 6 tiles, ``l_cap`` the first rung
    (n // 8) unless named: a match across every tile edge and across
    thread edges, a line over one tile edge and a line over three tiles
    whose only match is in the middle one, a chunk that ends in '\n'
    (its last line has no position: INT32_MIN), ^ and $ at tile edges and
    at n (the zero fill past n ends a line for $), a class position that
    accepts byte 0 at the chunk's end, literals of 40 bytes (past the
    word: near misses in the word and in the tail) and of 2,100 bytes
    (its tail past the launch's 2 KiB), alternations of 2 and 8 branches
    (8 of 5 positions overflow the 32-bit word into a second call, and a
    40-byte literal takes its own), every line shorter than 8 bytes
    (overflow at the first rung, then the n + 1 rung), bytes 0 and '\n'
    inside patterns, literals of 8 and 24 bytes and a class of 20
    positions with ^ and $ (the word's 32-byte warm-up, without and with
    anchors), and a chunk far under one tile with ^ and $ at both its
    ends."""
    rng = np.random.default_rng(seed)
    n = 6 * tile
    edges = range(tile, n, tile)
    the = lit(b"the")
    cases = []

    def text(size=n, alphabet=_LETTERS[:26]):
        return _line_text(rng, size, 20, 120, alphabet)

    def case(name, buf, branches, l_cap=None):
        cases.append((name, np.ascontiguousarray(buf, np.uint8),
                      tuple(branches),
                      max(len(buf) // 8, 1) if l_cap is None else l_cap))

    t = text(alphabet=_NO_T)
    for e in edges:
        _at(t, e - 1, b"the")          # across the tile edge
        _at(t, e - 34, b"the")         # across a thread edge
    for q in range(32, n, 32 * 37):    # at thread edges
        _at(t, q - 2, b"the")
    case("match_across_edges", t, [the])

    t = text(alphabet=_NO_T)
    t[tile - 50:tile + 50] = ord("x")  # one line over the first edge
    _at(t, tile - 3, b"the")
    t[tile + 100:4 * tile + 100] = ord("y")  # one line over three tiles
    _at(t, 2 * tile + 777, b" the ")
    t[5 * tile:5 * tile + 2 * 32] = ord("z")  # a line with no match
    case("lines_over_tiles", t, [the])

    t = text(alphabet=_NO_T)
    _at(t, n - 40, b" the ")
    t[-1] = 10
    case("ends_in_newline", t, [the])
    case("ends_in_newline_class", t,
         [cls(["Tt", "h", "e"]), cls([[(97, 122)]], anchor_end=True)])

    t = text()
    for e in edges:
        t[e - 1] = 10                  # a line starts at the edge
        _at(t, e, b"ab")
        _at(t, e + 2 * 32 - 3, b"s\n")  # a line ends at a thread edge
        _at(t, e - 3, b"xs\n")          # ... and at the tile edge
    t[-2:] = np.frombuffer(b"ss", np.uint8)  # $ at n (no newline)
    case("anchors_at_edges", t, [cls(["a"], anchor_start=True),
                                 cls(["s"], anchor_end=True)])
    case("anchored_both", t, [cls(["a", "b"], True, True),
                              cls(["x", "s"], True, True)])

    t = text()
    t[-1] = ord("q")
    t[n // 2] = 0                      # a zero inside the chunk too
    t[n // 2 - 1] = ord("q")
    case("class_accepts_zero_at_n", t,
         [cls(["q", [(0, 0), (10, 10)]])])

    long = bytes(rng.choice(_LETTERS[:26], 40))
    t = text(alphabet=_LETTERS[26:])   # upper case: no stray match
    _at(t, tile - 20, long)            # across an edge, tail past it
    _at(t, 2 * tile + 5, long[:39] + b"!")   # misses in the tail
    _at(t, 3 * tile + 5, b"!" + long[1:])    # misses in the word
    _at(t, n - 30, long)               # runs past n: no match
    _at(t, 4 * tile - 1, long)
    case("literal_40", t, [lit(long)])

    huge = bytes(rng.choice(_LETTERS[:26], 2100))
    # 8,400 bytes, under torch's parallel grain: the plain version's 2,100
    # shifted compares then run on one thread (on a busy host, each of
    # them parallel took seconds).
    t = text(max(n, 4 * len(huge)), alphabet=_LETTERS[26:])[:4 * len(huge)]
    t[100:100 + 4000] = ord("Q")       # one line, so the match can run
    _at(t, 200, huge)
    _at(t, 100 + 2200, huge[:2099] + b"!")   # a miss at its last byte
    case("literal_2100", t, [lit(huge)])

    t = text()
    for e in edges:
        _at(t, e - 2, b" and the ")
    case("alternation_2", t, [the, lit(b"and")])

    eight = [lit(b"quick"), cls(["Tt", "h", "e", "r", "e"]),
             cls(["a", "b", "c", "d", "e"], anchor_start=True),
             cls(["v", "w", "x", "y", "z"], anchor_end=True),
             cls(["l", "m", "no", "p", [(97, 122)]]), lit(b"jumps"),
             cls(["o", "v", "e", "r", "s"], True, True), lit(b"lazyd")]
    t = text()
    for k, e in enumerate(edges):
        t[e - 1] = 10
        _at(t, e, b"abcde" if k % 2 else b"overs\n")
        _at(t, e + 40 - k, b" quick There vwxyz\n")
        _at(t, e + 300, b" lmnpq jumps lazyd ")
    case("alternation_8", t, eight)
    case("alternation_8_and_literal_40", t, eight[:3] + [lit(long)])

    short = np.frombuffer(b"a\nthe\nb\n" * (n // 8 + 1), np.uint8)[:n].copy()
    case("overflow_rung0", short, [the])
    case("overflow_rung0_at_n_plus_1", short, [the], l_cap=n + 1)

    t = text()
    _at(t, tile - 2, b"x\ny")            # a pattern holding '\n'
    t[n // 3] = 0
    case("newline_and_zero_in_pattern", t,
         [lit(b"x\ny"), cls([[(0, 0)], [(0, 255)]])])

    for m in (8, 24):                    # the word's 32-byte warm-up
        word = bytes(rng.choice(_LETTERS[:26], m))
        t = text(alphabet=_LETTERS[26:])
        for e in edges:
            _at(t, e - 2, word)      # across the tile edge, from bit 30
            _at(t, e - 32 - m // 2, word[:-1] + b"!")  # a miss at its end
            _at(t, e + 100, b"!" + word[1:])          # a miss at its start
        _at(t, n - m, word)              # ends at n
        _at(t, n - m // 2, word)         # runs past n: no match
        case(f"literal_{m}", t, [lit(word)])

    up = [[(97 + k, 98 + k)] for k in range(20)]   # "ab", "bc", ...
    a20 = bytes(range(97, 117))
    t = text(alphabet=_LETTERS[26:])
    for e in edges:
        _at(t, e - 11, b"\n" + a20 + b"\n")   # a whole line over the edge
        _at(t, e + 200, b"\n" + a20 + b"X")   # not at a line end
        _at(t, e + 400, b"X" + a20 + b"\n")   # not at a line start
    _at(t, n - 21, b"\n" + a20)         # $ at n
    case("anchored_class_20", t, [cls(up, True, True)])

    size = 3 * tile // 16                # far under one tile
    t = text(size)
    t[0], t[-1] = ord("a"), ord("s")
    _at(t, size // 2, b"s\na")
    case("short_chunk_anchors", t, [cls(["a"], anchor_start=True),
                                    cls(["s"], anchor_end=True)])
    return cases


def line_flag_cases(tile: int, seed: int = 1234) -> List[LineFlagCase]:
    """H's mask entry (kernel I's line flags) at tiles of ``tile`` bytes:
    sparse and dense masks on lines of 20-120 bytes in 6 tiles, a line
    over three tiles marked only in the middle one, a chunk that ends in
    '\n', and every line shorter than 8 bytes (overflow at n // 8)."""
    rng = np.random.default_rng(seed)
    n = 6 * tile
    cases = []
    t = _line_text(rng, n, 20, 120)
    cases.append(("sparse", t, (rng.random(n) < 0.01).astype(np.uint8),
                  n // 8))
    t = _line_text(rng, n, 20, 120)
    t[100:3 * tile + 100] = ord("y")
    mask = np.zeros(n, np.uint8)
    mask[2 * tile - 1] = 7             # any nonzero byte marks
    t[-1] = 10
    cases.append(("line_over_tiles_ends_in_newline", t, mask, n // 8))
    short = np.frombuffer(b"a\nb\n" * n, np.uint8)[:n].copy()
    cases.append(("overflow", short, (rng.random(n) < 0.5).astype(
        np.uint8), n // 8))
    return cases


def route_cases(tile: Union[int, Callable[[int], int]],
                seed: int = 1234) -> List[RouteCase]:
    """Kernel E's edges for tiles of ``tile`` rows (an int, or the tile
    for a row width ``w``, ``dsi_route_tile_rows``): dests set on each
    tile's first and last rows, one destination's run crossing tile
    edges, r = 1 and r = tile - 1 and tile + 1, every row parked, every
    row to one destination, dests below 0 and above n_dev (dropped like
    n_dev), n_dev 1, 3, 8 and 1024 (the contract's largest; the kernel's
    write pass asks for more than 48 KB of shared memory there), widths
    1, 7, 8, 19 and 20 with k = 0 and k = w, and real rows equal to the
    pad row."""
    rng = np.random.default_rng(seed)
    tile_of = tile if callable(tile) else (lambda w: tile)
    cases = []

    def rows(n_dev, r, w):
        return rng.integers(0, 1 << 32, (n_dev, r, w),
                            dtype=np.uint64).astype(np.uint32)

    def case(name, n_dev, r, w, k, dest):
        cases.append((name, rows(n_dev, r, w),
                      np.asarray(dest, np.int32).reshape(n_dev, r),
                      n_dev, k))

    t7 = tile_of(7)
    r = 3 * t7 + 5
    dest = rng.integers(0, 9, (8, r))
    for e in range(t7, r, t7):  # the rows on each side of a tile edge
        dest[:, e - 1] = rng.integers(0, 8, 8)
        dest[:, e] = dest[:, e - 1]
    dest[:, 0] = 0
    dest[:, -1] = 7
    case("tile_edges_n8", 8, r, 7, 4, dest)
    # Long runs of one destination, each across one or two tile edges.
    runs = (np.arange(r)[None, :] // (t7 + t7 // 3 + 1)
            + np.arange(8)[:, None]) % 8
    case("runs_across_tiles_n8", 8, r, 7, 4, runs)
    case("all_parked_n8", 8, r, 7, 4, np.full((8, r), 8))
    case("one_dest_n8", 8, r, 7, 4, np.full((8, r), 5))
    pad_like = rng.integers(0, 9, (8, r))
    case("pad_rows_in_payload_n8", 8, r, 7, 4, pad_like)
    name, prow, pdest, _, _ = cases[-1]
    prow[:, ::3, :4] = 0xFFFFFFFF  # real rows that look like pad rows
    prow[:, ::3, 4:] = 0
    prow[:, 1::5, :] = 0
    case("r1_n8", 8, 1, 7, 4, rng.integers(0, 9, (8, 1)))
    case("r_tile_plus_1_n8", 8, t7 + 1, 7, 4,
         rng.integers(0, 9, (8, t7 + 1)))
    case("r_tile_minus_1_n1", 1, t7 - 1, 7, 4,
         rng.integers(0, 2, (1, t7 - 1)))
    case("random_n1", 1, 2 * t7 + 3, 7, 4,
         rng.integers(0, 2, (1, 2 * t7 + 3)))
    case("out_of_range_n3", 3, 2 * t7 + 1, 7, 4,
         rng.choice(np.array([-(1 << 31), -7, -1, 0, 1, 2, 3, 4, 1 << 30]),
                    (3, 2 * t7 + 1)))
    case("random_n3", 3, t7 + 7, 8, 4, rng.integers(0, 4, (3, t7 + 7)))
    case("n1024", 1024, 3, 3, 2, rng.integers(0, 1025, (1024, 3)))
    for w in (1, 7, 8, 19, 20):
        tw = tile_of(w)
        for k in (0, w):
            case(f"w{w}_k{k}_n3", 3, tw + 3, w, k,
                 rng.integers(0, 4, (3, tw + 3)))
    return cases


def lanes_to_words(lanes: np.ndarray) -> np.ndarray:
    """[u, kk] big-endian u32 lanes as u64 key words, word-major [k64, u]
    (lane 2j the high half of word j; an odd last lane's low half all
    ones, as ``pack_key_lanes`` pads it)."""
    u, kk = lanes.shape
    if kk % 2:
        lanes = np.concatenate([lanes, np.full((u, 1), 0xFFFFFFFF,
                                               np.uint32)], axis=1)
    hi = lanes[:, 0::2].astype(np.uint64)
    lo = lanes[:, 1::2].astype(np.uint64)
    return np.ascontiguousarray(((hi << np.uint64(32)) | lo).T)


def fnv_cases(u: int = 600, seed: int = 1234) -> List[FnvCase]:
    """Kernel D's edges over ``u`` rows (past a few of its 256-row
    blocks), each to be run in both of its layouts (``lanes_to_words``):
    lengths 0, max_word_len and past it, bytes 0x80-0xFF, widths 1, 2, 4
    (its 16-byte loads), 5 and 16, a window narrower than the lanes, and
    the epilogue with a bool mask, with ``n_valid`` 0, inside and past
    ``u``, and without it."""
    rng = np.random.default_rng(seed)
    cases = []

    def lanes(kk, lo=0, hi=256):
        return rng.integers(lo, hi, (u, 4 * kk), dtype=np.uint64) \
            .astype(np.uint8).view(">u4").astype(np.uint32)

    def lens(mwl, extra=6):
        ln = rng.integers(0, mwl + extra, u).astype(np.int32)
        ln[::7] = 0
        ln[1::7] = mwl
        return ln

    cases.append(("lens_0_mwl_and_past_kk4", lanes(4), lens(16), 16, None))
    cases.append(("high_bytes_map_rule", lanes(4, 0x80), lens(16), 16,
                  {"n_part": 10, "n_dest": 8, "park": 8,
                   "n_valid": u // 2 + 3}))
    cases.append(("kk5_mwl20_route_rule", lanes(5), lens(20), 20,
                  {"n_part": 8, "n_dest": 8, "park": 8,
                   "valid": rng.random(u) < 0.7}))
    cases.append(("kk16_mwl64_none_valid", lanes(16), lens(64, 10), 64,
                  {"n_part": 10, "n_dest": 3, "park": 3, "n_valid": 0}))
    cases.append(("kk2_mwl8_keys", lanes(2), np.full(u, 8, np.int32), 8,
                  {"n_part": 3, "n_dest": 3, "park": 3,
                   "valid": np.ones(u, bool)}))
    cases.append(("mwl12_under_kk4", lanes(4), lens(12, 8), 12,
                  {"n_part": 1 << 20, "n_dest": 1, "park": 7,
                   "n_valid": u + 5}))
    cases.append(("kk1_mwl4", lanes(1), lens(4), 4, None))
    return cases


def crash_cases() -> List[CrashCase]:
    """Kernel O's cases: the reference tests' three configurations
    (tests/test_simulate.py; the second is the CLI's), logs past one
    32-bit mask word (n_map 33, n_reduce 65) with timeout 1 (worker state
    in memory), no worker with a horizon of 1, one worker that always
    exits, a run that starts at instance 37, and logs whose state does not
    fit one warp's shared memory (n_map 1,800: the deadlines move to the
    device-memory spill) with two workers that always stall, cut at its
    horizon.  The counts are past one grid of 64 lanes where the refill
    matters, and small, since the CPU tests compile the reference once a
    configuration and model every lane."""
    cli = dict(exit_prob=0.25, stall_prob=0.2, horizon=800)
    return [
        ("no_faults", 64, 0, dict(exit_prob=0.0, stall_prob=0.0,
                                  horizon=200)),
        ("cli", 80, 0, cli),
        ("stalls", 64, 0, dict(exit_prob=0.0, stall_prob=0.5, timeout=5,
                               horizon=800)),
        ("wide_logs_timeout_1", 48, 0, dict(n_map=33, n_reduce=65,
                                            timeout=1, horizon=800)),
        ("no_workers_horizon_1", 64, 0, dict(n_workers=0, horizon=1)),
        ("one_worker_exits", 48, 0, dict(n_workers=1, exit_prob=1.0,
                                         stall_prob=0.0, horizon=60)),
        ("cli_first_37", 48, 37, cli),
        ("spill_deadlines_all_stall", 40, 0, dict(
            n_map=1800, n_reduce=40, n_workers=2, exit_prob=0.0,
            stall_prob=1.0, horizon=60)),
    ]


def _line_bytes(rng, n: int) -> np.ndarray:
    """n bytes of lowercase words and spaces in lines of 20-120 bytes."""
    out = np.frombuffer(rng.choice(np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyz      ", np.uint8), n).tobytes(),
        np.uint8).copy()
    at = 0
    while True:
        at += int(rng.integers(20, 121))
        if at >= n:
            return out
        out[at] = 10


def nfa_cases(group: int = NFA_GROUP_BYTES,
              seed: int = 1234) -> List[NfaCase]:
    """Kernel I's cases at a group of ``group`` bytes: every state bucket,
    n below 256, n = 256, n one group less and more one block, matches
    across a block edge and a group edge, a line spanning two groups, a $
    match whose line end is a group's last byte, a chunk of newlines only
    (its lines overflow ``l_cap``), and enough groups (34) that a
    look-back reads past one window of 32 predecessors.  Cases of one
    size and bucket share an ``l_cap``, so a compiled reference serves
    them."""
    rng = np.random.default_rng(seed)
    cases = []
    l_cap = 1 << 13

    def text(n):
        buf = _line_bytes(rng, n)
        buf[-1] = 0  # a pad byte, as _pad_pow2 leaves one
        return buf

    def put(buf, at, word: bytes):
        buf[at:at + len(word)] = np.frombuffer(word, np.uint8)

    small = text(200)
    put(small, 10, b"the quick theme")
    cases.append(("n200_s16", small, "th[a-z]*e", 16, l_cap))
    b256 = text(256)
    put(b256, 100, b"aaaaaab")
    cases.append(("n256_s32", b256, "a{5,20}b", 32, l_cap))
    for delta, tag in ((-256, "minus"), (256, "plus")):
        buf = text(group + delta)
        put(buf, 250, b" thxxxe ")
        put(buf, len(buf) - 300, b" thaaaaae ")
        cases.append((f"group_{tag}_one_block_s16", buf, "th[a-z]*e", 16,
                      l_cap))
    edge = text(2 * group)
    put(edge, 250, b" thhhhhhe ")             # across the first block edge
    put(edge, group - 3, b"\nth" + b"z" * 10 + b"e")  # over the group edge
    cases.append(("block_and_group_edges_s16", edge, "th[a-z]*e", 16, l_cap))
    dollar = text(2 * group)
    put(dollar, group - 6, b" dogs\n")  # the \n is the group's last byte
    put(dollar, group + 40, b" dog\n")
    cases.append(("dollar_at_group_end_s16", dollar, "dogs?$", 16, l_cap))
    cases.append(("only_newlines_s16", np.full(2 * group, 10, np.uint8),
                  "^ab*c$", 16, l_cap))
    runs = text(2 * group)
    put(runs, group - 12, b"\n" + b"a" * 30 + b"b\n")  # a{20,40}b over it
    cases.append(("group_edge_run_s48", runs, "a{20,40}b", 48, l_cap))
    span = text(2 * group)
    span[group // 2:group + group // 2] = ord("x")  # one line, two groups
    put(span, group // 2 + 7, b"qu")
    put(span, group + 50, b"ick")
    cases.append(("line_spans_groups_s16", span, "qu+ick|x{3}z", 16, l_cap))
    many = text(34 * group)
    for g in range(0, 34, 5):
        put(many, g * group - 2 if g else 5, b"the")
    cases.append(("34_groups_s16", many, "th[a-z]*e", 16, l_cap))
    return cases


def relay_cases(n_dev: int, cap: int, seed: int = 1234) -> List[RelayCase]:
    """Kernel P's cases at [n_dev, cap] (any cap, also one that is not a
    multiple of 16): random acc and new rows, and offsets 0, ``cap -
    kept``, sixteen consecutive ones around mid-row (every residue mod 16,
    ``n_dev`` a case), one below 0 (new shifted left, its tail clamped to
    its last byte), one below ``-cap`` (every byte that last one), ``cap``
    and past it (nothing written), and at more than one row all of them
    mixed in one call."""
    rng = np.random.default_rng(seed + 7 * n_dev + cap % 97)

    def rows():
        return rng.integers(0, 256, (n_dev, cap), dtype=np.uint8)

    def case(name, off):
        return (name, rows(), np.asarray(off, np.int64).reshape(n_dev),
                rows())

    mid = cap // 2
    kept = rng.integers(1, cap, n_dev)
    cases = [case("zero", np.zeros(n_dev)), case("cap_kept", cap - kept)]
    for j in range(0, 16, n_dev):
        cases.append(case(f"mid_res{j}",
                          mid - 8 + j + np.arange(n_dev) % 16))
    for name, o in (("negative", -5), ("below_minus_cap", -cap - 3),
                    ("at_cap", cap), ("past_cap", cap + 7)):
        cases.append(case(name, np.full(n_dev, o)))
    if n_dev > 1:
        mixed = np.array([-5, -cap - 3, cap, cap + 7, 0, 1, mid + 3,
                          cap - 1])
        cases.append(case("mixed", np.resize(mixed, n_dev)))
    return cases


_WIRE_COMMON = np.frombuffer(b"etaoinshrdlu \n", np.uint8)
_WIRE_RARE = np.frombuffer(b"vwxyzqjkVWXYZQJK", np.uint8)


def wire_cases(n_dev: int, n: int, tile_bytes: int,
               seed: int = 1234) -> List[WireCase]:
    """Kernel N's nibble-mode cases at [n_dev, n] (n % 8 == 0), with
    ``tile_bytes`` packed bytes a tile: escapes on both sides of every
    tile edge (encoded), rows with no escape (encoded), rows of
    escapes only and rows whose escapes overrun the literal region (the
    clamp), both hand-made, and a hand-made row of odd width (every row's
    nibbles off the 16-byte grid)."""
    from dsi_tpu_torch.ops.wirecodec import encode_chunk, packed_width

    rng = np.random.default_rng(seed + n_dev)
    half = n // 2

    def common():
        return rng.choice(_WIRE_COMMON, (n_dev, n)).astype(np.uint8)

    def encoded(name, batch):
        mode, packed, cap = encode_chunk(batch)
        if mode != "nib":
            raise ValueError(f"wire case {name} encoded as {mode}")
        return (name, packed, cap, batch)

    edges = common()
    for t in range(0, half, tile_bytes):
        for d in (-3, -2, -1, 0, 1, 2):
            i = 2 * t + d
            if 0 <= i < n:
                edges[:, i] = rng.choice(_WIRE_RARE, n_dev)
    cases = [encoded("tile_edges", edges), encoded("no_escape", common())]
    lit_cap = max(1, n // 4)
    every = rng.integers(0, 256, (n_dev, packed_width(n, lit_cap)),
                        dtype=np.uint8)
    every[:, 16:16 + half] = 0xFF
    cases.append(("all_escapes", every, lit_cap, None))
    lit_cap = max(1, n // 8)
    clamp = rng.integers(0, 256, (n_dev, packed_width(n, lit_cap)),
                         dtype=np.uint8)
    clamp[:, 16:16 + half // 2] = 0xFF  # n / 2 escapes, 4x the region
    cases.append(("clamp", clamp, lit_cap, None))
    lit_cap = max(1, n // 8) + 3
    odd = rng.integers(0, 256, (n_dev, packed_width(n, lit_cap)),
                       dtype=np.uint8)
    cases.append(("odd_width", odd, lit_cap, None))
    return cases


def load16_any_model(mem: np.ndarray, base: int, p: np.ndarray, lo: int,
                     hi: int, warp: int = 32) -> np.ndarray:
    """A numpy model of ``csrc/common.cuh load16_any`` for the CPU tests
    of kernels N and P: the 16 bytes at each address of ``p`` (int64
    [threads], a warp every ``warp`` (32 on the card; fewer where a test's
    small tile has fewer threads), lane l + 1 asking for lane l's address
    + 16) of the bytes ``mem`` placed at address ``base``.  Each lane
    loads the aligned vector at or below its address, takes the next from
    lane l + 1 (the warp's last lane loads it), and shifts the pair into
    place word by word, as the kernel's selects and funnel shifts do.  A
    vector that does not overlap [lo, hi) is not read and holds 0xCD; a
    read byte outside ``mem`` is 0xEE (the memory around an
    allocation)."""
    sh = int(p[0]) & 15
    assert p.size % warp == 0 and np.all((p & 15) == sh)
    assert np.all(np.diff(p.reshape(-1, warp), axis=1) == 16)

    def load(a):
        idx = a[:, None] + np.arange(16) - base
        got = np.where((idx >= 0) & (idx < mem.size),
                       mem[np.clip(idx, 0, mem.size - 1)], 0xEE)
        read = (a + 16 > lo) & (a < hi)
        return np.where(read[:, None], got, 0xCD).astype(np.uint8)

    a = p - sh
    x = load(a)
    if sh == 0:
        return x
    y = np.roll(x.reshape(-1, warp, 16), -1, axis=1).reshape(-1, 16)
    last = np.arange(p.size) % warp == warp - 1
    y[last] = load(a[last] + 16)
    w = np.concatenate([x, y], 1).view("<u4").astype(np.uint64)  # [m, 8]
    q, bits = sh >> 2, 8 * (sh & 3)
    s = w[:, q:q + 5]
    v = ((s[:, :4] >> np.uint64(bits)) | (s[:, 1:] << np.uint64(32 - bits)))
    return (v & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8)
