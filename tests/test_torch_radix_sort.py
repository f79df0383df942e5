"""Kernel B's plain version (``radix_sort``) against the JAX package, on
the CPU.

The same u64 key words, made from a seed with numpy, go through the
reference's sort (``lax.sort`` over the key words with ``num_keys=k64``
under x64, as ``dsi_tpu/ops/wordcount.py:401`` sorts, stable as
``dsi_tpu/ops/corpus_wc.py:187``, with the row index riding along as the
permutation) and through ``dsi_tpu_torch.ops.wordcount.radix_sort`` (its
plain version: the tensors lie on the CPU), and through ``np.lexsort``.
The sorted key words and the permutation must be equal bit for bit.  The
cases reach the branches of the CUDA kernel: a digit constant in every
row (a skipped pass), one row, one row either side of a tile of either
path, all rows equal (every pass skipped), real rows equal to the pad
value before pad rows, and 1, 2, 3 and 8 key words; then the prefix sort
(``n_sort``) and its precondition.
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dsi_tpu.utils.jaxcompat import enable_x64
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.kernels import build
from dsi_tpu_torch.ops import wordcount as tw

_ONES = np.iinfo(np.uint64).max


def _random_keys(seed: int, k64: int, t: int, hi: int = 4) -> np.ndarray:
    """[k64, t] u64 words with many ties, some high bits and pad rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, size=(k64, t), dtype=np.uint64)
    keys[0, 1::5] |= np.uint64(1 << 63)   # the high bit sorts high
    keys[:, 3::11] = _ONES                # pad rows sort last
    return keys


def _topk_words(cap: int, occupied: int) -> np.ndarray:
    """The top-k snapshot's three key words (``device/topk.py``): ~count,
    the packed word, its length; 7 of word 0's bytes and 7 of word 2's are
    the same in every row."""
    rng = np.random.default_rng(cap)
    counts = np.zeros(cap, np.int64)
    counts[:occupied] = rng.integers(1, 9, occupied)
    lanes = np.full((cap, 2), 0xFFFFFFFF, np.uint64)
    lanes[:occupied, 1] = rng.permutation(200_000)[:occupied]
    lanes[:occupied, 0] = 0
    return np.stack([(~counts).view(np.uint64),
                     (lanes[:, 0] << np.uint64(32)) | lanes[:, 1],
                     np.where(counts > 0, 8, 0).astype(np.uint64)])


def _pad_valued_rows() -> np.ndarray:
    keys = _random_keys(5, 2, 1000, hi=1 << 40)
    keys[:, [10, 500, 899]] = _ONES  # real rows equal to the pad value
    keys[:, 900:] = _ONES
    return keys


CASES = {
    "topk_constant_digits": lambda: _topk_words(1 << 10, 100),
    "one_row": lambda: _random_keys(1, 2, 1),
    **{f"tile_edge_{t}": (lambda t=t: _random_keys(t, 2, t))
       for t in (2047, 2048, 2049, 4095, 4096, 4097)},
    "all_equal": lambda: np.full((2, 3000), 0x0123456789ABCDEF, np.uint64),
    "pad_valued_rows": _pad_valued_rows,
    **{f"k64_{k}": (lambda k=k: _random_keys(10 + k, k, 999))
       for k in (1, 2, 3, 8)},
}


def _reference_sort(keys: np.ndarray):
    """``lax.sort`` over the key words (unsigned, x64), stable, with the
    row index carried as the permutation."""
    k64, t = keys.shape
    with enable_x64(True):
        out = lax.sort(tuple(jnp.asarray(w) for w in keys)
                       + (jnp.arange(t, dtype=jnp.int32),),
                       num_keys=k64, is_stable=True)
        return (np.stack([np.asarray(w) for w in out[:k64]]),
                np.asarray(out[k64]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_radix_sort_matches_reference(name):
    keys = CASES[name]()
    skeys, perm = tw.radix_sort(to_tensor(keys))
    want_keys, want_perm = _reference_sort(keys)
    np.testing.assert_array_equal(to_numpy(skeys, np.uint64), want_keys)
    np.testing.assert_array_equal(to_numpy(perm), want_perm)
    lex = np.lexsort(keys[::-1])  # stable, word 0 most significant
    np.testing.assert_array_equal(to_numpy(perm), lex)


def _prefix_case(t: int, n: int) -> np.ndarray:
    keys = _random_keys(n + 7, 3, t, hi=1 << 40)
    keys[:, n:] = _ONES
    keys[:, n // 2] = _ONES  # a real row equal to the tail, before it
    return keys


@pytest.mark.parametrize("t,n", [(600, 0), (600, 317), (600, 600),
                                 (4097, 2048)])
def test_radix_sort_prefix_equals_full_sort(t, n):
    keys = _prefix_case(t, n) if n else np.full((3, t), _ONES, np.uint64)
    n_sort = torch.tensor([n], dtype=torch.int32)
    got = tw.radix_sort(to_tensor(keys), n_sort)
    want = tw.radix_sort(to_tensor(keys))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # The prefix contract: the tail rows stay where they are.
    np.testing.assert_array_equal(to_numpy(got[1])[n:], np.arange(n, t))


@pytest.mark.parametrize("broken", ("unequal_tail", "tail_below_prefix"))
def test_radix_sort_prefix_refuses_a_broken_tail(broken):
    keys = _prefix_case(600, 300)
    if broken == "unequal_tail":
        keys[1, 450] = 7
    else:
        keys[:, 300:] = 1 << 41  # identical, but below some real rows
        keys[0, 10] = 1 << 50
    with pytest.raises(ValueError, match="n_sort"):
        tw.radix_sort(to_tensor(keys), torch.tensor([300],
                                                    dtype=torch.int32))


def test_radix_sort_refuses_a_bad_n_sort():
    keys = to_tensor(_random_keys(3, 2, 64))
    with pytest.raises(ValueError, match="n_sort"):
        tw.radix_sort(keys, torch.tensor([3], dtype=torch.int64))
    with pytest.raises(ValueError, match="n_sort"):
        tw.radix_sort(keys, torch.tensor([3, 4], dtype=torch.int32))


def test_radix_sort_c_interface_is_unchanged():
    """``slice_profile --baseline-csrc`` calls an older B through these."""
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert build.SIGNATURES["dsi_radix_sort"] == (
        c_int, [p, c_int, i64, p, p, p, p])
    assert build.SIGNATURES["dsi_radix_sort_scratch_bytes"] == (i64, [i64])


def test_radix_sort_pass_counts_and_switch_are_declared():
    """``chip_smoke.py`` reads B's own count of its skipped and run passes
    from the scratch, and the path switch, through these."""
    i64 = ctypes.c_int64
    assert build.SIGNATURES["dsi_radix_sort_passes_offset"] == (i64, [i64])
    assert build.SIGNATURES["dsi_radix_sort_small_max"] == (i64, [])
