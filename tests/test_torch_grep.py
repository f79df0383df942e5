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
