"""Kernel A's edge cases against the JAX package, on the CPU.

The cases of ``dsi_tpu_torch/utils/kernel_cases.py tokenize_cases`` (words
on tile edges and past the halo, a word ending on the chunk's last byte,
letters only, a 200-letter word, ``n_tokens`` equal to ``t_cap`` and one
above, high bytes, max_word_len 12, a length no multiple of 16) go through
``dsi_tpu.ops.wordcount.count_words_kernel`` and ``corpus_kernel`` and
through the port's ``tokenize_group_core`` and ``corpus_kernel`` (plain
versions: the tensors lie on the CPU).  ``chip_smoke.py`` runs the same
cases at kernel A's own tile on the card.  Every output is an integer: the
tolerance is exact.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsi_tpu.ops import corpus_wc as jc
from dsi_tpu.ops import wordcount as jw
from dsi_tpu.utils.jaxcompat import x64_scoped
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.kernels import build
from dsi_tpu_torch.ops import corpus_wc as tc
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.utils.kernel_cases import tokenize_cases

TILE = 256
U_CAP = 1 << 10
CASES = {c[0]: c[1:] for c in tokenize_cases(TILE, 8 * TILE)}
_jax_corpus_kernel = x64_scoped(jax.jit(
    jc.corpus_kernel,
    static_argnames=("max_word_len", "u_cap", "t_cap_frac", "grouper")))


def _frac(chunk, t_cap):
    assert t_cap == len(chunk) // 4 + 1
    return 4


@pytest.mark.parametrize("name", sorted(CASES))
def test_count_words_kernel_matches_jax(name):
    chunk, mwl, t_cap = CASES[name]
    frac = _frac(chunk, t_cap)
    want = [np.asarray(x) for x in jw.count_words_kernel(
        jnp.asarray(chunk), max_word_len=mwl, u_cap=U_CAP, t_cap_frac=frac,
        grouper="sort")]
    got = tw.tokenize_group_core(to_tensor(chunk), max_word_len=mwl,
                                 u_cap=U_CAP, t_cap_frac=frac)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        g = to_numpy(g, w.dtype if w.dtype == np.uint32 else None)
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype)
        assert np.array_equal(g, w), f"output {i} differs"


@pytest.mark.parametrize("name", sorted(CASES))
def test_corpus_kernel_matches_jax(name):
    chunk, mwl, t_cap = CASES[name]
    frac = _frac(chunk, t_cap)
    want = np.asarray(_jax_corpus_kernel(
        jnp.asarray(chunk), max_word_len=mwl, u_cap=U_CAP, t_cap_frac=frac,
        grouper="sort"))
    got = tc.corpus_kernel(to_tensor(chunk), max_word_len=mwl, u_cap=U_CAP,
                           t_cap_frac=frac)
    assert np.array_equal(to_numpy(got, np.uint32), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tokenize_scalars_and_rows_match_numpy(name):
    """n_tokens is the true count above t_cap; max_len counts the rows
    below t_cap; poslen is start << 7 | len with the length unmasked."""
    chunk, mwl, t_cap = CASES[name]
    letter = np.isin(chunk, np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8))
    padded = np.concatenate([[False], letter, [False]])
    starts = np.flatnonzero(padded[1:-1] & ~padded[:-2])
    ends = np.flatnonzero(padded[1:-1] & ~padded[2:])
    lens = (ends - starts + 1)[:t_cap]
    keys, lengths, poslen, sc = tw.tokenize(
        to_tensor(chunk), max_word_len=mwl, t_cap=t_cap, with_poslen=True)
    rows = len(lens)
    assert to_numpy(sc).tolist() == [len(starts), int(lens.max(initial=0)),
                                     int((chunk >= 128).any()), 0]
    assert to_numpy(lengths)[:rows].tolist() == lens.tolist()
    assert (to_numpy(lengths)[rows:] == 0).all()
    want = ((starts[:t_cap].astype(np.uint64) << np.uint64(7))
            | lens.astype(np.uint64))
    assert to_numpy(poslen, np.uint32)[:rows].tolist() == \
        (want & np.uint64(0xFFFFFFFF)).tolist()
    assert (to_numpy(keys, np.uint64)[:, rows:] == np.iinfo(np.uint64).max
            ).all()


def test_tokenize_c_interface_is_unchanged():
    """``slice_profile --baseline-csrc`` calls an older A through the first
    two; ``chip_smoke.py`` reads A's tile through the last."""
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert build.SIGNATURES["dsi_tokenize"] == (
        c_int, [p, i64, c_int, i64, p, p, p, p, p, p])
    assert build.SIGNATURES["dsi_tokenize_scratch_bytes"] == (i64, [i64])
    assert build.SIGNATURES["dsi_tokenize_tile_bytes"] == (i64, [])
