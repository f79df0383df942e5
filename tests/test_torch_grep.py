"""The port's grep tiers 1-3 (kernel H) against the JAX package, on the CPU.

The same seeded bytes go through ``dsi_tpu.ops.grepk.grep_kernel`` /
``regexk.classgrep_kernel`` (jitted on the CPU) and the port's
``grep_kernel`` / ``classgrep_kernel`` (their plain versions: the tensors
lie on the CPU).  The flags, ``n_lines`` and ``overflow`` must be equal bit
for bit, the empty-line value included.  The tier entry points and the
``cuda_map`` tier walk are held against the reference's and against
``re`` over the text's lines.
"""

from __future__ import annotations

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.apps import tpu_grep as jtpu_grep
from dsi_tpu.ops import altk as jaltk
from dsi_tpu.ops import grepk as jgrepk
from dsi_tpu.ops import regexk as jregexk
from dsi_tpu_torch.apps import cuda_grep
from dsi_tpu_torch.apps import grep as tgrep
from dsi_tpu_torch.interop import to_numpy
from dsi_tpu_torch.ops import altk, grepk, regexk
from dsi_tpu_torch.ops.wordcount import _pad_pow2


def _letters(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(3))


VOCAB = [_letters(i) for i in range(600)] + ["The", "the", "and", "42",
                                             "a_b", "x9"]


def _text(seed: int, n_words: int = 3000) -> bytes:
    rng = np.random.default_rng(seed)
    out, cur = [], []
    for j in rng.integers(0, len(VOCAB), n_words):
        cur.append(VOCAB[j])
        if rng.random() < 0.15:
            out.append(" ".join(cur))
            cur = []
    out.append(" ".join(cur))
    return "\n".join(out).encode()


TEXTS = {
    "random": _text(3),
    "trailing_newline": _text(5, 800) + b"\n",
    "empty_lines": b"the\n\n\nand the\n\nxx\n\n",
    "no_newline": b"the end",
    # Every byte a newline: the last line has no position (INT32_MIN).
    "all_newlines": b"\n" * 255,
    # Lines averaging under 8 bytes: rung 0 (n/8) overflows.
    "short_lines": b"a\nthe\nb\n" * 300,
}


@functools.lru_cache(maxsize=None)
def _jgrep(l_cap: int):
    return jax.jit(functools.partial(jgrepk.grep_kernel, l_cap=l_cap))


def _same(got, want):
    lm, nl, of = got
    assert np.array_equal(to_numpy(lm), np.asarray(want[0]))
    assert int(nl) == int(want[1]) and bool(of) == bool(want[2])


@pytest.mark.parametrize("pattern", ["the", "a", "and the", "zzzz"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_grep_kernel_matches_reference(name, pattern):
    buf = _pad_pow2(TEXTS[name])
    for l_cap in grepk.line_cap_rungs(len(buf)):
        want = _jgrep(l_cap)(jnp.asarray(buf), jnp.asarray(
            np.frombuffer(pattern.encode(), np.uint8)))
        got = grepk.grep_kernel(torch.from_numpy(buf), pattern.encode(),
                                l_cap=l_cap)
        _same(got, want)


CLASS_PATTERNS = ["[Tt]he", "^a", "s$", "^the$", r"\d\d", r"\w_\w",
                  r"a\sb", "t.e", "[^a-z ]", "[a-c][^ ]x", r"\.", "^$x"]


@pytest.mark.parametrize("pattern", CLASS_PATTERNS)
@pytest.mark.parametrize("name", ["random", "empty_lines", "short_lines",
                                  "no_newline"])
def test_classgrep_kernel_matches_reference(name, pattern):
    parsed = jregexk.parse_class_pattern(pattern)
    assert parsed == regexk.parse_class_pattern(pattern)
    if parsed is None:
        return  # both decline ("^$x": a stray anchor)
    ranges, a_s, a_e = parsed
    buf = _pad_pow2(TEXTS[name])
    for l_cap in grepk.line_cap_rungs(len(buf)):
        want = jax.jit(functools.partial(
            jregexk.classgrep_kernel, ranges=ranges, anchor_start=a_s,
            anchor_end=a_e, l_cap=l_cap))(jnp.asarray(buf))
        got = regexk.classgrep_kernel(torch.from_numpy(buf), ranges=ranges,
                                      anchor_start=a_s, anchor_end=a_e,
                                      l_cap=l_cap)
        _same(got, want)


def _oracle(data: bytes, pattern: str):
    return [ln for ln in data.decode().split("\n") if re.search(pattern, ln)]


TIER_CASES = [
    # (tier, pattern)
    ("grep", "the"), ("grep", "and the"), ("grep", "a"),
    ("class", "[Tt]he"), ("class", "^a"), ("class", "s$"), ("class", r"\d"),
    ("class", r"\w\s\w"), ("class", "[^a-z]"),
    ("alt", "the|and"), ("alt", "[Tt]he|^a|x9"), ("alt", "^the$|s$"),
]
TIERS = {"grep": (grepk.grep_host_result, jgrepk.grep_host_result),
         "class": (regexk.classgrep_host_result,
                   jregexk.classgrep_host_result),
         "alt": (altk.altgrep_host_result, jaltk.altgrep_host_result)}


@pytest.mark.parametrize("tier,pattern", TIER_CASES)
@pytest.mark.parametrize("name", ["random", "empty_lines", "short_lines",
                                  "no_newline"])
def test_tiers_match_reference_and_re(name, tier, pattern):
    data = TEXTS[name]
    mine, ref = TIERS[tier]
    got = mine(data, pattern, device="cpu")
    assert got == ref(data, pattern)
    assert got == _oracle(data, pattern)


@pytest.mark.parametrize("tier,pattern,data", [
    ("grep", "the", "café the\n".encode()),    # non-ASCII data
    ("grep", "th.e", b"the\n"),                     # a metacharacter
    ("grep", "\x01", b"a\x01b\n"),                  # a control byte
    ("class", "[Tt]he", b"the\x00x\n"),             # NUL in the data
    ("class", "a*", b"a\n"),                        # variable length
    ("class", "(ab)", b"ab\n"),                     # a group
    ("alt", "a|(b)", b"a\nb\n"),                    # an ineligible branch
    ("alt", "a|", b"a\n"),                          # an empty branch
    ("alt", "[Tt]he|x", b"the\x00\n"),              # NUL with a class branch
])
def test_tiers_decline_where_the_reference_does(tier, pattern, data):
    mine, ref = TIERS[tier]
    assert ref(data, pattern) is None
    assert mine(data, pattern, device="cpu") is None


@pytest.mark.parametrize("pattern", ["and|" + "q" * 40, "q" * 40 + "|[Tt]he",
                                     "q" * 40 + "|r" * 40])
@pytest.mark.parametrize("name", ["empty_lines", "no_newline"])
def test_alternation_dead_branch_longer_than_the_data(name, pattern):
    data = TEXTS[name]
    got = altk.altgrep_host_result(data, pattern, device="cpu")
    assert got == jaltk.altgrep_host_result(data, pattern)
    assert got == _oracle(data, pattern)


def test_pattern_longer_than_data():
    assert grepk.grep_host_result(b"ab", "abc", device="cpu") == []
    assert jgrepk.grep_host_result(b"ab", "abc") == []


def test_short_lines_take_the_second_rung():
    data = TEXTS["short_lines"]
    buf = _pad_pow2(data)
    l0, l1 = grepk.line_cap_rungs(len(buf))
    _, n_lines, overflow = grepk.grep_kernel(torch.from_numpy(buf), b"the",
                                             l_cap=l0)
    assert bool(overflow) and int(n_lines) > l0
    assert grepk.grep_host_result(data, "the", device="cpu") == \
        _oracle(data, "the")


def test_literal_detection_matches_reference():
    for pat in ("the", "th.e", "a b", "", "\x7f", "x|y", "é"):
        assert grepk.is_literal_pattern(pat) == jgrepk.is_literal_pattern(pat)
    assert grepk.line_cap_rungs(4096) == jgrepk.line_cap_rungs(4096)


@pytest.mark.parametrize("pattern", ["the", "[Tt]he", "the|and", "th[a-z]*e",
                                     "(?!x)x", "(ab)+"])
def test_cuda_map_walks_the_tiers_like_tpu_map(pattern, monkeypatch):
    monkeypatch.setenv("DSI_GREP_PATTERN", pattern)
    monkeypatch.setenv("DSI_NFA_DISPATCH", "device")
    data = TEXTS["random"]
    got = cuda_grep.cuda_map("f", data, device="cpu")
    assert got == jtpu_grep.tpu_map("f", data)
    if got is not None:
        assert got == tgrep.Map("f", data.decode())


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA; without it the call raises rather than
    falling back to the CPU."""
    from dsi_tpu_torch.ops import nfak
    from dsi_tpu_torch.parallel import grepstream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DSI_GREP_PATTERN", "the")
    for fn in (grepk.grep_host_result, regexk.classgrep_host_result,
               altk.altgrep_host_result, nfak.nfagrep_host_result,
               grepstream.grep_streaming):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn([b"the\n"] if fn is grepstream.grep_streaming else b"the\n",
               "the")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_grep.cuda_map("f", b"the\n")


# ── kernel H's design as a numpy model ──────────────────────────────────
#
# csrc/grep.cu in numpy: the Shift-And word of grepk.grep_spec run
# backwards over each thread's 32 positions and its warm-up bytes, the
# thread pairs (newlines, open-line hit) scanned with seg_combine in each
# tile, a decoupled look-back over tiles under random published states,
# each line's flag stored once, and the INT_MIN tail shared out over the
# grid.  The same cases (kernel_cases.hgrep_cases / line_flag_cases) hold
# kernel H against its plain version on the card in chip_smoke.py.

from dsi_tpu_torch.utils.kernel_cases import (  # noqa: E402
    hgrep_cases,
    line_flag_cases,
)

H_TILE = 256 * 32    # csrc/grep.cu kTile
SMALL_THREADS = 8    # a 256-byte tile
_INT_MIN = np.iinfo(np.int32).min


def _seg_combine(a: int, b: int) -> int:
    nb = b >> 1
    return (((a >> 1) + nb) << 1) | ((b & 1) if nb else ((a | b) & 1))


def _warm(m_max: int) -> int:
    return 4 if m_max <= 5 else 32


def _word_hits(chunk, spec: bytes, tail: bytes, p: np.ndarray):
    """[threads, 32] bools: the word's hits at p + k, as word_hits (and
    the long literal's check) computes them."""
    vals = grepk._SPEC.unpack(spec)
    table = np.array(vals[:256], np.uint64)
    keep, inj, inj_eol, last, last_bol, m_max, tail_len = vals[256:]
    n = len(chunk)
    warm = 32 if tail_len else _warm(m_max)
    ext = np.zeros(p[-1] + 34 + warm + len(tail) + 1, np.uint8)
    ext[1:n + 1] = chunk   # ext[q + 1] is byte q, 0 outside [0, n)

    def byte(q):
        return ext[q + 1]

    d = np.zeros(len(p), np.uint64)
    nxt = byte(p + 32 + warm)
    hits = np.zeros((len(p), 32), bool)
    for k in range(32 + warm - 1, -1, -1):
        b = byte(p + k)
        eol = (nxt == 10) | (nxt == 0)
        d = (((d << np.uint64(1)) & np.uint64(keep))
             | np.where(eol, np.uint64(inj | inj_eol), np.uint64(inj))
             ) & table[b]
        d &= np.uint64(0xFFFFFFFF)
        if k < 32:
            bol = (p + k == 0) | (byte(p + k - 1) == 10)
            lst = np.where(bol, np.uint64(last | last_bol), np.uint64(last))
            hits[:, k] = (d & lst) != 0
        nxt = b
    if tail_len:
        want = np.frombuffer(tail, np.uint8)
        for t, k in zip(*np.nonzero(hits)):
            s = p[t] + k + 32
            if not np.array_equal(byte(np.arange(s, s + tail_len)), want):
                hits[t, k] = False
    return hits


def _look_back(values, tile: int, threads: int, state, inclusive):
    """Tile ``tile``'s exclusive prefix as lines_look_back walks it:
    windows of ``threads`` predecessors, each stopping at the nearest one
    in state 2 (its inclusive prefix), combined in tile order."""
    acc = 0
    j = tile - 1
    while j >= 0:
        window = list(range(j, max(j - threads, -1), -1))
        stop = next((q for q in window if state[q] == 2), None)
        win = 0
        for q in reversed(window if stop is None
                          else window[:window.index(stop) + 1]):
            win = _seg_combine(win, inclusive[q] if q == stop
                               else values[q])
        acc = _seg_combine(win, acc)
        if stop is not None:
            break
        j -= threads
    return acc


def h_model(chunk, l_cap: int, *, branches=None, mask=None,
            threads: int = 256, grid=None, seed: int = 0):
    """Kernel H (or its mask entry) by its design; returns (line_match,
    n_lines, overflow) and checks that every flag was stored once."""
    rng = np.random.default_rng(seed)
    n = len(chunk)
    tile = 32 * threads
    tiles = -(-n // tile)
    p = np.arange(tiles * threads, dtype=np.int64) * 32
    pos = p[:, None] + np.arange(32)
    valid = pos < n
    nl = valid & (np.where(valid, chunk[np.minimum(pos, n - 1)], 0) == 10)
    if mask is not None:
        h = valid & (np.where(valid, mask[np.minimum(pos, n - 1)], 0) != 0)
    else:
        h = np.zeros_like(valid)
        for call in grepk.pack_branches(branches):
            h |= _word_hits(chunk, *grepk.grep_spec(call), p)
        h &= valid
    # Thread pairs, then the in-tile scan and the tile aggregates.
    vals = []
    for t in range(len(p)):
        q = np.flatnonzero(nl[t])
        after = h[t, q[-1] + 1:] if len(q) else h[t]
        vals.append((len(q) << 1) | int(after.any()))
    in_tile, agg = [], []
    for b in range(tiles):
        run = 0
        for t in range(b * threads, (b + 1) * threads):
            in_tile.append(run)
            run = _seg_combine(run, vals[t])
        agg.append(run)
    inclusive, before = [], []
    for b in range(tiles):
        state = rng.integers(1, 3, b)  # 1 aggregate, 2 inclusive
        if b:
            state[0] = rng.integers(1, 3)
        ex = _look_back(agg, b, threads, state, inclusive) if b else 0
        inclusive.append(_seg_combine(ex, agg[b]))
        before.append(ex)
    # Each line's flag, stored once.
    out = np.full(l_cap, 12345, np.int64)
    stores = np.zeros(l_cap, np.int64)

    def store(i, v):
        if i < l_cap:
            out[i] = v
            stores[i] += 1

    n_lines = None
    for t in range(len(p)):
        bf = _seg_combine(before[t // threads], in_tile[t])
        lid, open_ = bf >> 1, bf & 1
        prev = -1
        for q in np.flatnonzero(nl[t]):
            store(lid, int(open_ or h[t, prev + 1:q + 1].any()))
            lid, open_, prev = lid + 1, 0, q
        k = n - 1 - p[t]
        if 0 <= k < 32:
            store(lid, _INT_MIN if nl[t, k]
                  else int(open_ or h[t, prev + 1:].any()))
            n_lines = lid + 1
    assert n_lines == (inclusive[-1] >> 1) + 1
    # The tail, shared out over the grid in 16-byte words.
    g = grid or tiles
    lo, hi = n_lines, l_cap
    if lo < hi:
        v0, v1 = (lo + 3) & ~3, hi & ~3
        if v0 > v1:
            v0 = v1 = hi
        for tid in range(g * 256):
            for i in range(v0 // 4 + tid, v1 // 4, g * 256):
                for j in range(4 * i, 4 * i + 4):
                    store(j, _INT_MIN)
            for i in list(range(lo + tid, v0, g * 256)) + list(
                    range(v1 + tid, hi, g * 256)):
                store(i, _INT_MIN)
    assert (stores == 1).all(), "a flag stored twice or never"
    return out.astype(np.int32), n_lines, n_lines > l_cap


def _ref_branch(chunk, branch, l_cap):
    positions, a_s, a_e = branch
    if not (a_s or a_e) and all(len(r) == 1 and r[0][0] == r[0][1]
                                for r in positions):
        pat = np.array([r[0][0] for r in positions], np.uint8)
        return _jgrep(l_cap)(jnp.asarray(chunk), jnp.asarray(pat))
    return jregexk.classgrep_kernel(jnp.asarray(chunk), ranges=positions,
                                    anchor_start=a_s, anchor_end=a_e,
                                    l_cap=l_cap)


def _reference(chunk, branches, l_cap):
    """The reference's flags: each branch through K13 or K14, OR-ed by
    jnp.maximum as dsi_tpu/ops/altk.py does."""
    total = nl = of = None
    for b in branches:
        lm, nl, of = _ref_branch(chunk, b, l_cap)
        total = lm if total is None else jnp.maximum(total, lm)
    return np.asarray(total), int(nl), bool(of)


def _equal(got, want):
    assert np.array_equal(np.asarray(got[0]), want[0])
    assert int(got[1]) == want[1] and bool(got[2]) == want[2]


def _cases_at(threads):
    return [(threads, c) for c in hgrep_cases(32 * threads)]


@pytest.mark.parametrize(
    "threads,case", _cases_at(256) + _cases_at(SMALL_THREADS),
    ids=lambda x: x if isinstance(x, int) else x[0])
def test_h_model_matches_reference(threads, case):
    """The model of the new H, at H's tile and at a 256-byte one, equals
    the reference's K13 / K14 (OR-ed over an alternation's branches) on
    the shared edge cases; so do the port's plain versions."""
    name, buf, branches, l_cap = case
    chunk = torch.from_numpy(buf)
    got = altk.altgrep_kernel(chunk, branches, l_cap=l_cap)
    if max(len(b[0]) for b in branches) > 64:
        # The reference unrolls a shift a byte (minutes for 2,100 bytes):
        # the plain version, held to it on literal_40, stands in.
        want = (got[0].numpy(), int(got[1]), bool(got[2]))
    else:
        want = _reference(buf, branches, l_cap)
        _equal(got, want)
    grid = max(1, -(-len(buf) // (32 * threads)) // 3)
    _equal(h_model(buf, l_cap, branches=branches, threads=threads,
                   grid=grid, seed=len(name)), want)
    if len(branches) == 1:
        positions, a_s, a_e = branches[0]
        _equal(regexk.classgrep_kernel(chunk, ranges=positions,
                                       anchor_start=a_s, anchor_end=a_e,
                                       l_cap=l_cap), want)


@pytest.mark.parametrize("threads", [256, SMALL_THREADS])
def test_h_mask_entry_model_matches_reference(threads):
    """I's mask entry (mask_lines) by the model equals the reference's
    line_flags_from_match."""
    for name, buf, mask, l_cap in line_flag_cases(32 * threads):
        want = jgrepk.line_flags_from_match(
            jnp.asarray(buf), jnp.asarray(mask != 0), l_cap)
        want = (np.asarray(want[0]), int(want[1]), bool(want[2]))
        _equal(h_model(buf, l_cap, mask=mask, threads=threads), want)
        _equal(grepk.line_flags_from_match(
            torch.from_numpy(buf), torch.from_numpy(mask != 0), l_cap), want)


def test_seg_combine_is_associative():
    """The look-back and the block scan regroup seg_combine freely."""
    rng = np.random.default_rng(7)
    vals = [0, 1, 2, 3] + [int(v) for v in rng.integers(0, 1 << 12, 60)]
    for a in vals[:16]:
        assert _seg_combine(0, a) == a == _seg_combine(a, 0)
        for b in vals[:16]:
            for c in vals[::7]:
                assert (_seg_combine(_seg_combine(a, b), c)
                        == _seg_combine(a, _seg_combine(b, c)))


def test_grep_spec_packs_branches():
    """One call holds branches while their positions fit the 32-bit word;
    a literal longer than it goes alone, its bytes past the word in the
    tail; the table is the reversed positions."""
    the, andb = grepk.literal_branch(b"the"), grepk.literal_branch(b"and")
    assert grepk.pack_branches([the, andb]) == [(the, andb)]
    five = grepk.literal_branch(b"abcde")
    assert [len(c) for c in grepk.pack_branches([five] * 8)] == [6, 2]
    long = grepk.literal_branch(b"q" * 40)
    assert grepk.pack_branches([the, long, andb]) == [(the,), (long,),
                                                      (andb,)]
    spec, tail = grepk.grep_spec((the, andb))
    vals = grepk._SPEC.unpack(spec)
    assert len(spec) == 1052 and tail == b""
    assert vals[ord("t")] == 1 << 2 and vals[ord("e")] == 1 << 0
    assert vals[ord("a")] == 1 << 5 and vals[ord("d")] == 1 << 3
    assert vals[256:] == (0xFFFFFFFF & ~0b1001, 0b1001, 0, 0b100100, 0, 3,
                          0)
    assert grepk.grep_spec((long,))[1] == b"q" * 8
    with pytest.raises(ValueError):
        grepk.grep_spec((five,) * 7)


def test_grep_c_interface():
    """H's C entry points as kernels/build.py declares them: the pattern a
    host GrepSpec and a long literal's tail (host, or card past 2 KiB),
    one buffer for the flags, scalars and look-back state."""
    import ctypes

    from dsi_tpu_torch.kernels import build

    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert build.SIGNATURES["dsi_grep"] == (c_int, [p, i64, p, p, p, i64, p,
                                                    p])
    assert build.SIGNATURES["dsi_grep_bytes"] == (i64, [i64, i64])
    assert build.SIGNATURES["dsi_grep_scratch_bytes"] == (i64, [i64])
    assert build.SIGNATURES["dsi_grep_tile_bytes"] == (i64, [])
    assert build.SIGNATURES["dsi_line_flags_prezeroed"] == (
        c_int, [p, i64, p, i64, p, p, p, p])
    assert "dsi_line_flags" not in build.SIGNATURES
