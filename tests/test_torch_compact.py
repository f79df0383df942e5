"""Kernel L's contract (the stable valid-first compaction) against the JAX
package, on the CPU.

The same numpy rows go through the reference's two stable pad-bit
partitions and through ``dsi_tpu_torch.ops.meshroute.compact_rows``
(plain version: the tensors lie on the CPU):

* the TF-IDF wave step's one-key ``lax.sort`` over ``(is_pad,) + keys64 +
  pay64`` (``dsi_tpu/parallel/tfidf.py:124-134``, rebuilt here from the
  reference's own ``pack_key_lanes``/``unpack_key_lanes``), pad test on
  the first packed u64 word: ``pad_lanes=2``;
* ``compact_received`` (``dsi_tpu/ops/meshroute.py:83``), pad test on
  lane 0: ``pad_lanes=1``.

Rows, pad rows included, and counts equal bit for bit, order included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from dsi_tpu.ops import meshroute as jmr
from dsi_tpu.ops.wordcount import (_PAD_KEY64, pack_key_lanes,
                                   unpack_key_lanes)
from dsi_tpu.utils.jaxcompat import enable_x64
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.ops import meshroute as tmr

PAD = np.uint32(0xFFFFFFFF)


def _ref_wave_partition(recv: np.ndarray, k: int):
    """The reference wave step's partition of one shard's rows [r, k+4]."""
    with enable_x64(True):
        rv = jnp.asarray(recv)
        keys64 = pack_key_lanes(tuple(rv[:, j] for j in range(k)))
        pay64 = pack_key_lanes(tuple(rv[:, k + j] for j in range(4)))
        k64 = len(keys64)
        is_pad = (keys64[0] == jnp.array(_PAD_KEY64, jnp.uint64)) \
            .astype(jnp.uint8)
        cols = lax.sort((is_pad,) + keys64 + pay64, num_keys=1)
        srecv = jnp.stack(unpack_key_lanes(cols[1:1 + k64], k)
                          + unpack_key_lanes(cols[1 + k64:], 4), axis=1)
        n_rows = jnp.sum(cols[0] == 0, dtype=jnp.int32)
        return np.asarray(srecv), int(n_rows)


def _rows(kind: str, n_dev: int, r: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (n_dev, r, w), dtype=np.uint64) \
        .astype(np.uint32)
    if kind == "all_pad":
        pad = np.ones((n_dev, r), bool)
    elif kind == "no_pad":
        pad = np.zeros((n_dev, r), bool)
    elif kind == "alternating":
        pad = np.broadcast_to(np.arange(r) % 2 == 1, (n_dev, r))
    else:  # random, with a run of lane-0-only rows ("lane0_only")
        pad = rng.random((n_dev, r)) < 0.6
    rows[pad, :2] = PAD
    rows[pad, 2:] = 0
    if kind == "lane0_only":
        # Lane 0 all ones, lane 1 not: a pad row for compact_received, a
        # valid row for the wave step.
        sel = ~pad & (rng.random((n_dev, r)) < 0.3)
        rows[sel, 0] = PAD
        rows[sel, 1] = 7
    return rows


KINDS = ("all_pad", "no_pad", "alternating", "random", "lane0_only")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_dev,r,k", ((1, 700, 4), (3, 2500, 16)))
def test_compact_matches_wave_step_sort(kind, n_dev, r, k):
    rows = _rows(kind, n_dev, r, k + 4, seed=r + k)
    got, n_valid = tmr.compact_rows(to_tensor(rows), pad_lanes=2)
    got = to_numpy(got, np.uint32)
    for d in range(n_dev):
        want, want_n = _ref_wave_partition(rows[d], k)
        np.testing.assert_array_equal(got[d], want)
        assert int(n_valid[d]) == want_n


@pytest.mark.parametrize("kind", KINDS)
def test_compact_received_matches_reference(kind):
    n_dev, r, w = 4, 1100, 7
    rows = _rows(kind, n_dev, r, w, seed=11)
    ref = jax.jit(jmr.compact_received)
    got, n_valid = tmr.compact_received(to_tensor(rows))
    got = to_numpy(got, np.uint32)
    for d in range(n_dev):
        want, want_n = ref(jnp.asarray(rows[d]))
        np.testing.assert_array_equal(got[d], np.asarray(want))
        assert int(n_valid[d]) == int(want_n)
    if kind == "lane0_only":
        # The two pad tests really disagree on these rows.
        _, n2 = tmr.compact_rows(to_tensor(rows), pad_lanes=2)
        assert (to_numpy(n2) > to_numpy(n_valid)).all()


def test_compact_rejects_bad_shapes():
    import torch

    with pytest.raises(ValueError):
        tmr.compact_rows(torch.zeros((2, 0, 8), dtype=torch.int32),
                         pad_lanes=2)
    with pytest.raises(ValueError):
        tmr.compact_rows(torch.zeros((1, 4, 1), dtype=torch.int32),
                         pad_lanes=2)
    with pytest.raises(ValueError):
        tmr.compact_rows(torch.zeros((1, 4, 8), dtype=torch.int64),
                         pad_lanes=1)


def test_cpu_compaction_counts_no_launch():
    import torch
    from dsi_tpu_torch.device.postings import postings_append
    from dsi_tpu_torch.ops import wordcount as tw

    tw.reset_launches()
    rows = to_tensor(_rows("random", 2, 300, 8, seed=3))
    tmr.compact_rows(rows, pad_lanes=2)
    postings_append(torch.zeros((2, 64, 8), dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int32),
                    rows[:, :40].contiguous(),
                    torch.ones((2, 5), dtype=torch.int32))
    counts = tw.launch_counts()
    assert set(counts) == set(tw.KERNEL_NAMES)
    assert not any(counts.values())
