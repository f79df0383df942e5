"""The port's per-split word count against the JAX package, on the CPU.

The same inputs, made from a seed, go through
``dsi_tpu.ops.wordcount.count_words_kernel`` and
``dsi_tpu_torch.ops.wordcount.tokenize_group_core`` (plain versions: the
tensors lie on the CPU) at equal static shapes.  Every output is an
integer, so the tolerance is exact: all eight outputs must be equal bit for
bit.  The per-kernel plain versions are also held against the JAX helpers
they port.
"""

from __future__ import annotations

import collections
import random
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.ops import wordcount as jw
from dsi_tpu.utils.jaxcompat import enable_x64
from dsi_tpu_torch.apps.wc import tokenize
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.mr.sequential import ihash
from dsi_tpu_torch.ops import wordcount as tw


def _random_text(seed: int, n_words: int, alphabet: str = string.ascii_letters,
                 max_len: int = 14) -> bytes:
    rng = random.Random(seed)
    seps = " \n\t.,;:!?0123456789_"
    out = []
    for _ in range(n_words):
        out.append("".join(rng.choice(alphabet)
                           for _ in range(rng.randint(1, max_len))))
        out.append(rng.choice(seps) * rng.randint(1, 3))
    return "".join(out).encode()


def _padding_text(size: int) -> bytes:
    rng = random.Random(size)
    return "".join(rng.choice("ab c") for _ in range(size)).encode()


# name -> (text, max_word_len, u_cap, t_cap_frac); the cases of
# tests/test_ops_wordcount.py at fixed static shapes.
CASES = {
    "simple": (b"the quick brown fox jumps over the lazy dog the end",
               16, 1 << 10, 4),
    "empty": (b"", 16, 1 << 10, 4),
    "no_letters": (b"123 456 !!! \n\t 789", 16, 1 << 10, 4),
    "edges": (b"word a a b a b a end-of-buffer-word trailing Capital "
              b"capital CAPITAL cApItAl under_score split3split "
              b"digits123mixed", 16, 1 << 10, 4),
    "len16": (b"abcdefghijklmnop x abcdefghijklmnop", 16, 1 << 10, 4),
    "len17": (b"abcdefghijklmnopq x abcdefghijklmnop", 16, 1 << 10, 4),
    "len64_wide": (b"k" * 64 + b" short " + b"k" * 64, 64, 1 << 10, 4),
    "len65_wide": (b"k" * 65 + b" short " + b"k" * 64, 64, 1 << 10, 4),
    "non_ascii": ("héllo wörld plain".encode(), 16, 1 << 10, 4),
    "token_overflow_frac4": (b"a b " * 300, 16, 1 << 10, 4),
    "token_overflow_frac2": (b"a b " * 300, 16, 1 << 10, 2),
    "unique_overflow": (_random_text(3, 400), 16, 64, 4),
    "random_text": (_random_text(7, 1500), 16, 1 << 12, 4),
    "random_text_wide": (_random_text(8, 600, max_len=40), 64, 1 << 12, 4),
    **{f"padding_{n}": (_padding_text(n), 16, 1 << 10, 4)
       for n in (0, 1, 255, 256, 257, 4096)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tokenize_group_core_matches_jax(name):
    text, mwl, u_cap, frac = CASES[name]
    chunk = jw._pad_pow2(text)
    want = [np.asarray(x) for x in jw.count_words_kernel(
        jnp.asarray(chunk), max_word_len=mwl, u_cap=u_cap, t_cap_frac=frac,
        grouper="sort")]
    got = tw.tokenize_group_core(to_tensor(chunk), max_word_len=mwl,
                                 u_cap=u_cap, t_cap_frac=frac)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        g = to_numpy(g, w.dtype if w.dtype == np.uint32 else None)
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype)
        assert np.array_equal(g, w), f"output {i} differs"


HOST_RESULT_CASES = {
    "wide_retry": b"the quick fox supercalifragilisticexpialidocious the",
    "over_64_letters": b"x" * 100,
    "non_ascii": "h\u00e9llo world".encode(),
}


@pytest.mark.parametrize("name", sorted(HOST_RESULT_CASES))
def test_count_words_host_result_matches_jax(name):
    text = HOST_RESULT_CASES[name]
    assert (tw.count_words_host_result(text, device="cpu")
            == jw.count_words_host_result(text))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 16])
def test_pack_key_lanes_matches_jax(k):
    rng = np.random.default_rng(k)
    cols = rng.integers(0, 1 << 32, size=(k, 257), dtype=np.uint64)
    cols = cols.astype(np.uint32)
    cols[:, rng.choice(257, 16, replace=False)] = jw._PAD_KEY
    with enable_x64(True):
        want = [np.asarray(c) for c in jw.pack_key_lanes(
            tuple(jnp.asarray(c) for c in cols))]
    got = tw.pack_key_lanes(tuple(to_tensor(c) for c in cols))
    assert [to_numpy(g, np.uint64).tolist() for g in got] == \
        [w.tolist() for w in want]
    rows = torch.stack(got, dim=1)
    back = to_numpy(tw.unpack_key_rows(rows, k), np.uint32)
    assert np.array_equal(back, cols.T)


def _sorted_key_words(seed: int, t: int, k64: int, n_pad: int):
    """Lexicographically sorted u64 key rows with duplicate runs, PAD last."""
    rng = np.random.default_rng(seed)
    vocab = rng.integers(0, 1 << 62, size=(max(1, t // 5), k64),
                         dtype=np.uint64)
    rows = vocab[rng.integers(0, len(vocab), t - n_pad)]
    rows = rows[np.lexsort(rows.T[::-1])]
    pad = np.full((n_pad, k64), np.iinfo(np.uint64).max, np.uint64)
    return np.concatenate([rows, pad])


@pytest.mark.parametrize("k64,u_cap", [(1, 64), (2, 8), (2, 1024), (8, 300)])
def test_group_sorted_matches_jax(k64, u_cap):
    keys = _sorted_key_words(k64, 600, k64, 37)
    counts = np.random.default_rng(1).integers(1, 9, 600).astype(np.int32)
    with enable_x64(True):
        _, totals, upos, ovalid, n_unique = jw.group_sorted(
            tuple(jnp.asarray(keys[:, j]) for j in range(k64)),
            jnp.asarray(counts), u_cap)
        totals, upos, ovalid = (np.asarray(x) for x in (totals, upos, ovalid))
    payload = np.arange(600, dtype=np.int32) * 3
    perm = np.random.default_rng(2).permutation(600).astype(np.int32)
    keys_u, g_tot, g_upos, g_pay, g_nu = tw.group_sorted(
        to_tensor(keys.T.copy()), to_tensor(counts.astype(np.int64)), u_cap,
        to_tensor(payload), to_tensor(perm))
    assert int(g_nu) == int(n_unique)
    assert np.array_equal(to_numpy(g_tot), totals.astype(np.int64))
    assert np.array_equal(to_numpy(g_upos), upos)
    want_keys = np.where(ovalid[:, None], keys[upos], 0)
    assert np.array_equal(to_numpy(keys_u, np.uint64).T, want_keys)
    assert np.array_equal(to_numpy(g_pay),
                          np.where(ovalid, payload[perm[upos]], 0))


@pytest.mark.parametrize("mwl", [16, 64])
def test_fnv1a32_packed_matches_jax(mwl):
    rng = np.random.default_rng(mwl)
    k = mwl // 4
    lanes = rng.integers(0, 1 << 32, size=(500, k),
                         dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, mwl + 8, 500).astype(np.int32)
    lens[:20] = 0  # pad rows hash to the offset basis, not 0
    want = np.asarray(jw.fnv1a32_packed(jnp.asarray(lanes), jnp.asarray(lens),
                                        mwl))
    keys = torch.stack(tw.pack_key_lanes(
        tuple(to_tensor(lanes[:, j].copy()) for j in range(k))))
    got = to_numpy(tw.fnv1a32_packed(keys, to_tensor(lens), mwl), np.uint32)
    assert np.array_equal(got, want)
    assert (got[:20] == 0x811C9DC5).all()


@pytest.mark.parametrize("k64", [1, 2, 8])
def test_radix_sort_plain_is_stable_lexicographic(k64):
    rng = np.random.default_rng(k64)
    keys = rng.integers(0, 4, size=(k64, 999), dtype=np.uint64)
    keys[:, ::7] = np.iinfo(np.uint64).max  # PAD rows sort last
    keys[0, 1::7] = 1 << 63                 # high bit set sorts high
    sk, perm = tw.radix_sort(to_tensor(keys))
    want = np.lexsort(keys[::-1])           # np.lexsort is stable
    assert np.array_equal(to_numpy(perm), want)
    assert np.array_equal(to_numpy(sk, np.uint64), keys[:, want])


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.count_words_host_result(b"alpha beta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.resolve_device(None)
    assert tw.resolve_device("cpu").type == "cpu"


def test_wrappers_refuse_other_devices():
    chunk = torch.zeros(256, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tw.tokenize(chunk, max_word_len=16, t_cap=65)


def test_count_words_host_result_matches_oracle():
    text = _random_text(12, 3000) + b" a b c" * 400
    want = collections.Counter(tokenize(text.decode()))
    got = tw.count_words_host_result(text, device="cpu")
    assert got == {w: (c, ihash(w)) for w, c in want.items()}


def test_cpu_runs_launch_no_kernel():
    tw.reset_launches()
    tw.count_words_host_result(_random_text(5, 300) + b" " + b"q" * 30,
                               device="cpu")
    assert tw.LAUNCHES == {"tokenize": 0, "radix_sort": 0, "group": 0,
                           "fnv": 0, "route": 0, "hash_group": 0,
                           "pack6": 0, "grep": 0, "nfa": 0, "grep_step": 0}
