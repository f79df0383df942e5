"""The port's hash grouper (K5) against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through
``dsi_tpu.ops.wordcount._hash_group`` (jitted on the CPU, as the JAX
package's own tests run it) and ``dsi_tpu_torch.ops.wordcount.hash_group``
(its plain version: the tensors lie on the CPU).  The output order is
fixed — clean buckets in bucket-index order, then the dirty uniques in
sorted order — so every output must be equal bit for bit, row for row.
The hash branches of the per-split program and of the corpus program,
the grouper ladder and the entry points that walk it are held against the
reference the same way.
"""

from __future__ import annotations

import collections
import functools
import itertools
import re
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.ops import corpus_wc as jc
from dsi_tpu.ops import wordcount as jw
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.utils.jaxcompat import enable_x64, x64_scoped
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.mr.sequential import fnv32a
from dsi_tpu_torch.ops import corpus_wc as tc
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.parallel import shuffle as ts

WORDS = re.compile(r"[A-Za-z]+")


def _colliding_words(mask: int, count: int = 2):
    """Distinct lowercase words sharing their FNV-1a low bits (the search
    of ``tests/test_ops_wordcount.py``): one bucket at ``mask``."""
    seen: dict = {}
    for tup in itertools.product(string.ascii_lowercase, repeat=3):
        w = "".join(tup)
        b = fnv32a(w.encode()) & mask
        seen.setdefault(b, []).append(w)
        if len(seen[b]) >= count:
            return seen[b][:count]
    raise AssertionError("no collision found")


def _vocab_text(seed: int, n_words: int, max_len: int = 12) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(1, max_len)))
                   .astype(np.uint8)) for _ in range(300)]
    return b" ".join(vocab[i] for i in rng.integers(0, 300, n_words))


_W1, _W2 = _colliding_words(1023)  # one bucket at a 4 KiB chunk's shape

# name -> text (a 4 KiB chunk after _pad_pow2: t_cap 1025, 1024 buckets,
# d_cap 256)
TEXTS = {
    "random": _vocab_text(1, 500),
    "collisions": f"{_W1} {_W2} ".encode() * 50 + _vocab_text(2, 300),
    "dirty_overflow": f"{_W1} {_W2} ".encode() * 300,
    "empty": b"",
}


@functools.lru_cache(maxsize=None)
def _ref_hash_fn(mwl: int, u_cap: int, frac: int, with_extra: bool):
    """The reference's ``_hash_group`` on the token rows its programs
    build (``tokenize_group_core`` :350-383, ``_corpus_core`` :156-172)."""
    def body(chunk):
        n = chunk.shape[0]
        t_cap = n // frac + 1
        letter = jw.is_ascii_letter(chunk)
        prev = jnp.concatenate([jnp.zeros((1,), jnp.bool_), letter[:-1]])
        nxt = jnp.concatenate([letter[1:], jnp.zeros((1,), jnp.bool_)])
        starts, ends = letter & ~prev, letter & ~nxt
        n_tokens = jnp.sum(starts, dtype=jnp.int32)
        (sp,) = jnp.nonzero(starts, size=t_cap, fill_value=n - 1)
        (ep,) = jnp.nonzero(ends, size=t_cap, fill_value=n - 1)
        valid = jnp.arange(t_cap, dtype=jnp.int32) < n_tokens
        lengths = jnp.where(valid, ep - sp + 1, 0).astype(jnp.int32)
        c = chunk.astype(jnp.uint32)
        b32 = ((c << 24) | (jw._shift_left(c, 1) << 16)
               | (jw._shift_left(c, 2) << 8) | jw._shift_left(c, 3))
        cols = tuple(jnp.where(valid, b32[sp + 4 * j] & jw._byte_mask(
            jnp.clip(lengths - 4 * j, 0, 4)), jnp.uint32(jw._PAD_KEY))
            for j in range(mwl // 4))
        fnv_t = jw.fnv1a32_packed(jnp.stack(cols, axis=1), lengths, mwl)
        extra = None
        if with_extra:
            extra = jnp.where(valid, (sp.astype(jnp.uint32) << 7)
                              | lengths.astype(jnp.uint32), 0)
        return jw._hash_group(cols, lengths, valid, fnv_t, u_cap=u_cap,
                              max_word_len=mwl, extra=extra)

    return x64_scoped(jax.jit(body))


def _port_hash(chunk, mwl, u_cap, frac, with_extra):
    t_cap = len(chunk) // frac + 1
    keys, lengths, poslen, sc = tw.tokenize(
        to_tensor(chunk), max_word_len=mwl, t_cap=t_cap, with_poslen=True)
    fnv = tw.fnv1a32_packed(keys, lengths, mwl)
    return tw.hash_group(keys, lengths, fnv, sc[:1], u_cap,
                         extra=poslen if with_extra else None)


def _assert_same_groups(got, want):
    keys_u, len_u, cnt_u, ex_u, n_unique, group_of = got
    with enable_x64(True):
        w_keys = np.stack([np.asarray(c) for c in want[0]])
    np.testing.assert_array_equal(to_numpy(keys_u, np.uint64), w_keys,
                                  err_msg="keys")
    np.testing.assert_array_equal(to_numpy(len_u), np.asarray(want[1]),
                                  err_msg="lengths")
    np.testing.assert_array_equal(to_numpy(cnt_u),
                                  np.asarray(want[2]).astype(np.int64),
                                  err_msg="counts")
    assert (ex_u is None) == (want[3] is None)
    if ex_u is not None:
        np.testing.assert_array_equal(to_numpy(ex_u, np.uint32),
                                      np.asarray(want[3]), err_msg="extra")
    assert int(n_unique) == int(want[4])
    assert bool(group_of) == bool(want[5])


@pytest.mark.parametrize("with_extra", (False, True), ids=("plain", "extra"))
@pytest.mark.parametrize("mwl", (16, 64))
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_hash_group_matches_reference(name, mwl, with_extra):
    chunk = jw._pad_pow2(TEXTS[name])
    want = _ref_hash_fn(mwl, 256, 4, with_extra)(jnp.asarray(chunk))
    got = _port_hash(chunk, mwl, 256, 4, with_extra)
    _assert_same_groups(got, want)
    if name == "collisions":  # a dirty bucket, repaired exactly
        assert not bool(got[5])
    if name == "dirty_overflow":
        assert bool(got[5])


def test_hash_group_unsigned_min_and_cut_at_u_cap():
    """Synthetic token rows fed to both: ``extra`` values at and above
    2^31 (pos << 7 | len from pos 2^24 on) need the unsigned MIN, and more
    uniques than ``u_cap`` keep ``n_unique`` true."""
    rng = np.random.default_rng(9)
    t, n_valid, k = 2049, 1900, 4
    vocab = rng.integers(0, 1 << 31, (700, k), dtype=np.uint64) \
        .astype(np.uint32)
    lanes = vocab[rng.integers(0, len(vocab), t)]
    lanes[n_valid:] = jw._PAD_KEY
    lengths = np.where(np.arange(t) < n_valid, 16, 0).astype(np.int32)
    extra = rng.integers(0, 1 << 32, t, dtype=np.uint64).astype(np.uint32)
    extra[::3] |= np.uint32(1 << 31)
    fnv = np.asarray(jw.fnv1a32_packed(jnp.asarray(lanes),
                                       jnp.asarray(lengths), 16))
    valid = np.arange(t) < n_valid
    want = x64_scoped(jax.jit(functools.partial(
        jw._hash_group, u_cap=512, max_word_len=16)))(
        tuple(jnp.asarray(lanes[:, j]) for j in range(k)),
        jnp.asarray(lengths), jnp.asarray(valid), jnp.asarray(fnv),
        extra=jnp.asarray(extra))
    keys = torch.stack(tw.pack_key_lanes(
        tuple(to_tensor(lanes[:, j].copy()) for j in range(k))))
    got = tw.hash_group(keys, to_tensor(lengths), to_tensor(fnv),
                        torch.tensor([n_valid], dtype=torch.int32), 512,
                        extra=to_tensor(extra))
    _assert_same_groups(got, want)
    assert int(got[4]) > 512


def _forced_rows(name: str):
    """Token rows with forced hashes: (lanes [t, 4] u32, fnv [t] u32,
    n_valid).  ``one_bucket_two_words``: every token in one bucket, two
    distinct words; ``one_word_a_bucket``: every bucket clean;
    ``last_word_differs``: two words equal but in their last key word,
    sharing a bucket beside clean ones."""
    rng = np.random.default_rng(17)
    t, k = 2049, 4
    vocab = rng.integers(0x41414141, 0x5A5A5A5A, (700, k),
                         dtype=np.int64).astype(np.uint32)
    if name == "one_bucket_two_words":
        tok, n_valid = np.arange(t) % 2, 200
        bucket = np.full(t, 5)
    elif name == "one_word_a_bucket":
        tok, n_valid = rng.integers(0, 700, t), 1500
        bucket = tok
    else:
        tok, n_valid = rng.integers(2, 700, t), 1800
        tok[::31], tok[5::31] = 0, 1
        vocab[1, :k - 1] = vocab[0, :k - 1]
        bucket = np.where(tok < 2, 1, tok)
    lanes = vocab[tok]
    lanes[n_valid:] = jw._PAD_KEY
    return lanes, bucket.astype(np.uint32), n_valid


_REF_FORCED = x64_scoped(jax.jit(functools.partial(
    jw._hash_group, u_cap=1024, max_word_len=16)))


@pytest.mark.parametrize("with_extra", (False, True), ids=("plain", "extra"))
@pytest.mark.parametrize("name", ("one_bucket_two_words",
                                  "one_word_a_bucket", "last_word_differs"))
def test_hash_group_forced_buckets_match_reference(name, with_extra):
    lanes, fnv, n_valid = _forced_rows(name)
    t, k = lanes.shape
    lengths = np.where(np.arange(t) < n_valid, 16, 0).astype(np.int32)
    valid = np.arange(t) < n_valid
    extra = (np.random.default_rng(3).integers(0, 1 << 32, t,
                                               dtype=np.uint64)
             .astype(np.uint32) if with_extra else None)
    want = _REF_FORCED(
        tuple(jnp.asarray(lanes[:, j]) for j in range(k)),
        jnp.asarray(lengths), jnp.asarray(valid), jnp.asarray(fnv),
        extra=None if extra is None else jnp.asarray(extra))
    keys = torch.stack(tw.pack_key_lanes(
        tuple(to_tensor(lanes[:, j].copy()) for j in range(k))))
    got = tw.hash_group(keys, to_tensor(lengths), to_tensor(fnv),
                        torch.tensor([n_valid], dtype=torch.int32), 1024,
                        extra=None if extra is None else to_tensor(extra))
    _assert_same_groups(got, want)
    assert not bool(got[5])
    n_words = len({tuple(r) for r in lanes[:n_valid]})
    assert int(got[4]) == n_words


# ── the hash branches of the per-split and the corpus programs ──────────


@pytest.mark.parametrize("mwl,u_cap,frac", [
    (16, 1 << 10, 4), (64, 1 << 10, 4), (16, 64, 4), (16, 1 << 10, 2)])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_tokenize_group_core_hash_matches_reference(name, mwl, u_cap, frac):
    chunk = jw._pad_pow2(TEXTS[name])
    want = [np.asarray(x) for x in jw.count_words_kernel(
        jnp.asarray(chunk), max_word_len=mwl, u_cap=u_cap, t_cap_frac=frac,
        grouper="hash")]
    got = tw.tokenize_group_core(to_tensor(chunk), max_word_len=mwl,
                                 u_cap=u_cap, t_cap_frac=frac,
                                 grouper="hash")
    for i, (g, w) in enumerate(zip(got, want)):
        g = to_numpy(g, w.dtype if w.dtype == np.uint32 else None)
        if i == 2:
            # The reference's hash counts are int64 (an x64 segment sum of
            # Python ints); the port keeps the sort branch's int32.
            assert g.dtype == np.int32 and w.dtype == np.int64
            g = g.astype(np.int64)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


_corpus_kernel = x64_scoped(jax.jit(
    jc.corpus_kernel,
    static_argnames=("max_word_len", "u_cap", "t_cap_frac", "grouper")))


@pytest.mark.parametrize("mwl,u_cap", [(16, 1 << 12), (64, 1 << 12),
                                       (16, 64)])
def test_corpus_kernel_hash_matches_reference(mwl, u_cap):
    texts = [_vocab_text(s, 400, max_len=20)[:4000] for s in range(3)]
    texts[1] += b" " + b"Q" * 30  # wider than 16: the 64-byte window
    buf, n_pieces = tc.pack_pieces(texts, 4096)
    pieces = [buf[i * 4096:(i + 1) * 4096] for i in range(n_pieces)]
    want = np.asarray(_corpus_kernel(
        *(jnp.asarray(p) for p in pieces), max_word_len=mwl, u_cap=u_cap,
        t_cap_frac=4, grouper="hash"))
    got = tc.corpus_kernel(*(to_tensor(p) for p in pieces),
                           max_word_len=mwl, u_cap=u_cap, t_cap_frac=4,
                           grouper="hash")
    np.testing.assert_array_equal(to_numpy(got, np.uint32), want)


# ── the grouper ladder and the entry points that walk it ────────────────


def test_grouper_ladder_keys_on_the_device(monkeypatch):
    monkeypatch.delenv("DSI_WC_GROUPER", raising=False)
    assert tw.grouper_ladder("cpu") == ("hash", "sort")
    assert tw.grouper_ladder(torch.device("cuda")) == ("sort",)
    assert jw.grouper_ladder() == tw.grouper_ladder("cpu")  # CPU platform
    for pin, ladder in (("hash", ("hash", "sort")), ("sort", ("sort",))):
        monkeypatch.setenv("DSI_WC_GROUPER", pin)
        assert tw.grouper_ladder("cpu") == ladder
        assert tw.grouper_ladder("cuda") == ladder
        assert jw.grouper_ladder() == ladder
    monkeypatch.setenv("DSI_WC_GROUPER", "other")
    assert tw.default_grouper("cuda") == "sort"


@pytest.mark.parametrize("grouper", ("hash", "sort"))
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_count_words_host_result_matches_reference(name, grouper,
                                                   monkeypatch):
    monkeypatch.setenv("DSI_WC_GROUPER", grouper)
    text = TEXTS[name]
    got = tw.count_words_host_result(text, device="cpu")
    assert got == jw.count_words_host_result(text)
    counts = collections.Counter(WORDS.findall(text.decode()))
    assert {w: c for w, (c, _) in got.items()} == dict(counts)


@pytest.mark.parametrize("n_dev", (1, 8))
def test_wordcount_sharded_hash_matches_reference(n_dev, monkeypatch):
    monkeypatch.setenv("DSI_WC_GROUPER", "hash")
    data = TEXTS["collisions"] + b" " + _vocab_text(4, 1500)
    want = js.wordcount_sharded(data, mesh=js.default_mesh(n_dev),
                                u_cap=64)
    got = ts.wordcount_sharded(data, n_dev=n_dev, u_cap=64, device="cpu")
    assert got is not None and got == want


def test_corpus_wordcount_grouper_ladder_matches_reference(monkeypatch):
    """The dirty overflow clears through the sort rung, under both the
    explicit grouper and the device's ladder."""
    monkeypatch.delenv("DSI_WC_GROUPER", raising=False)
    raws = [TEXTS["dirty_overflow"], TEXTS["random"]]
    for grouper in (None, "hash", "sort"):
        got = tc.corpus_wordcount(raws, grouper=grouper, device="cpu")
        want = jc.corpus_wordcount(raws, grouper=grouper, use_aot=False)
        assert got.to_dict() == want.to_dict()
        np.testing.assert_array_equal(got.pos, want.pos)
        np.testing.assert_array_equal(got.cnt, want.cnt)


def test_hash_group_rejects_bad_shapes():
    keys = torch.zeros((2, 8), dtype=torch.int64)
    lens = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="hash_group"):
        tw.hash_group(keys, lens, lens[:4], torch.zeros(1, dtype=torch.int32),
                      16)
    with pytest.raises(ValueError, match="hash_group"):
        tw.hash_group(keys, lens, lens, torch.zeros(2, dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="unknown grouper"):
        tw.tokenize_group_core(torch.zeros(256, dtype=torch.uint8),
                               grouper="bucket")
