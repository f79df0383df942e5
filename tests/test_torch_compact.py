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
A numpy model of the kernel's two passes (``compact_model``: mask words
from ballots, tile counts, ranks from both) is held against the same
references at its tile edges: one row, one tile, one tile + 1, all rows
valid or none.
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


# ── kernel L's two passes as a numpy model ────────────────────────────────


def _tile_rows(n_dev: int, r: int, w: int) -> int:
    """``csrc/compact.cu tile_rows``: 32 rows at least, else at most 16 KB
    and 1,024 rows a tile, halved while the grid has fewer than 128
    blocks, down to 64 rows."""
    t = 32
    while 2 * t <= 1024 and 2 * t * w <= 4096:
        t *= 2
    while t > 64 and n_dev * -(-r // t) < 128:
        t //= 2
    return t


def _block_rows(n_dev: int, r: int, w: int) -> int:
    """``block_rows``: whole tiles, doubled while a shard has more than
    1,024 blocks."""
    b = _tile_rows(n_dev, r, w)
    while -(-r // b) > 1024:
        b *= 2
    return b


def compact_model(rows: np.ndarray, pad_lanes: int, tile: int, block: int):
    """Kernel L as ``csrc/compact.cu`` computes it: ``compact_count`` keeps
    one ballot a warp per 32 rows as a block's mask word and their
    popcounts as its count; ``compact_write`` takes its first valid slot
    and n_valid from the counts, then tile by tile ranks the rows from
    the mask words (valid first, then pad, each in row order) and writes
    the two runs."""
    n_dev, r, w = rows.shape
    blocks, mw = -(-r // block), block // 32
    valid = np.zeros((n_dev, blocks * block), bool)
    valid[:, :r] = ~(rows[..., :pad_lanes] == PAD).all(-1)
    lanes = np.arange(32, dtype=np.uint64)
    masks = (valid.reshape(n_dev, blocks, mw, 32).astype(np.uint64)
             << lanes).sum(-1).astype(np.uint32)
    counts = np.bitwise_count(masks).sum(-1, dtype=np.int64)
    out = np.empty_like(rows)
    for s in range(n_dev):
        total = int(counts[s].sum())
        for x in range(blocks):
            before = int(counts[s, :x].sum())
            row0 = x * block
            vrow, prow = before, total + row0 - before
            for a in range(0, min(r - row0, block), tile):
                n = min(r - row0 - a, tile)
                m = masks[s, x, a // 32:a // 32 + -(-n // 32)]
                pc = np.bitwise_count(m).astype(np.int64)
                wbefore = np.cumsum(pc) - pc
                i = np.arange(n)
                mi = m[i >> 5].astype(np.int64)
                bit = (mi >> (i & 31)) & 1
                vb = wbefore[i >> 5] + np.bitwise_count(
                    mi & ((1 << (i & 31)) - 1))
                nv = int(pc.sum())
                order = np.empty(n, np.int64)
                order[np.where(bit == 1, vb, nv + i - vb)] = i
                q = np.arange(n)
                dst = np.where(q < nv, vrow + q, prow + q - nv)
                out[s, dst] = rows[s, row0 + a + order]
                vrow += nv
                prow += n - nv
    return out, counts.sum(1)


_REF_RECEIVED = jax.jit(jmr.compact_received)


@pytest.mark.parametrize("kind", ("no_pad", "all_pad", "lane0_only"))
@pytest.mark.parametrize("n_dev,r,w", (
    (1, 1, 8),          # one row
    (3, 64, 8),         # one tile of the 64-row floor
    (3, 65, 8),         # one tile + 1
    (1, 65536, 8),      # 128 tiles of 512 rows
    (1, 65537, 8),      # ... + 1
    (1, 32769, 68),     # 1,024 32-row tiles + 1: two tiles a block
    (2, 513, 20),       # 64-row tiles of the 64-byte rung's rows
    (1, 33, 5000),      # 32-row tiles copied unstaged, one row over
))
def test_compact_model_matches_reference(n_dev, r, w, kind):
    tile, block = _tile_rows(n_dev, r, w), _block_rows(n_dev, r, w)
    assert (block > tile) == (r == 32769)
    rows = _rows(kind, n_dev, r, w, seed=r + w)
    for pad_lanes in (1, 2):
        got, n_valid = compact_model(rows, pad_lanes, tile, block)
        for d in range(n_dev):
            if pad_lanes == 1:
                want, want_n = _REF_RECEIVED(jnp.asarray(rows[d]))
            elif w <= 20:
                want, want_n = _ref_wave_partition(rows[d], w - 4)
            else:  # a wave's key lanes are at most 16
                continue
            np.testing.assert_array_equal(got[d], np.asarray(want))
            assert int(n_valid[d]) == int(want_n)


def test_compact_and_append_c_interface():
    """L's entry keeps its C signature; its scratch and tile depend on the
    row width; M gains its received entry (the mesh append's compaction
    fused in), and E hands out where its per-pair totals lie."""
    import ctypes

    from dsi_tpu_torch.kernels import build

    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sig = build.SIGNATURES
    assert sig["dsi_compact"] == (c_int, [p, c_int, i64, c_int, c_int, p, p,
                                          p, p])
    assert sig["dsi_compact_scratch_bytes"] == (i64, [c_int, i64, c_int])
    assert sig["dsi_compact_tile_rows"] == (i64, [c_int, i64, c_int])
    assert sig["dsi_postings_append"] == (c_int, [p, c_int, i64, c_int, p, p,
                                                  p, i64, p, c_int, p, p, p,
                                                  p])
    assert sig["dsi_postings_append_received"] == (
        c_int, [p, c_int, i64, c_int, p, p, p, i64, p, p, p, p, p, p])
    assert sig["dsi_postings_append_received_scratch_bytes"] == (
        i64, [c_int, i64])
    assert sig["dsi_route_totals_offset"] == (i64, [c_int, i64, c_int])
