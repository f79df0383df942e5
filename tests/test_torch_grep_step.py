"""Kernel J's edge cases against the JAX package, on the CPU.

The cases of ``dsi_tpu_torch/utils/kernel_cases.py grep_cases`` (matches
across tile edges and the pattern's halo, newlines on a tile's first and
last byte, a line over three tiles, every line matching, many
occurrences, ``n_lines > l_cap``, ``dlen`` 0 and no multiple of 16, the
pattern past ``dlen``, pattern lengths 1 and 80, a pattern a row, bases
across 2^32) go through the reference's step program (``_grep_fn`` with
``emit=True`` on the 8-device virtual CPU mesh) and through the port's
``grep_step_plain`` with and without emit, and the port's ``grep_step``
wrapper (the tensors lie on the CPU).  ``chip_smoke.py`` runs the same
cases at kernel J's own tiles on the card.  Every output is an integer:
the tolerance is exact.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dsi_tpu.device import table as jt
from dsi_tpu.parallel import grepstream as jgs
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.utils.jaxcompat import enable_x64
from dsi_tpu_torch.kernels import build
from dsi_tpu_torch.parallel import grepstream as tgs
from dsi_tpu_torch.utils.kernel_cases import GREP_BINS, GREP_K, grep_cases

TILE, LINE_TILE = 256, 64
CASES = {c[0]: c[1:] for c in grep_cases(TILE, LINE_TILE)}


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


def _ref_emit(chunks, pats, dlen, bases, l_cap):
    """The reference's (hist_ext, cand, scal, comp, kept) of one batch."""
    n_dev, n = chunks.shape
    mesh = _mesh(n_dev)
    sh2 = NamedSharding(mesh, P(js.AXIS, None))
    sh1 = NamedSharding(mesh, P(js.AXIS))
    args = [jax.device_put(chunks, sh2), jax.device_put(pats, sh2),
            jax.device_put(dlen, sh1)]
    with enable_x64(True):
        args.append(jax.device_put(bases.astype(np.uint64), sh1))
    fn = jgs._grep_fn(tuple(args), n_dev=n_dev, chunk_bytes=n,
                      m=pats.shape[1], l_cap=l_cap, bins=GREP_BINS, k=GREP_K,
                      mesh=mesh, emit=True)
    with jt._quiet_unusable_donation():
        return [np.asarray(x) for x in fn(*args)]


def _same(got, want) -> bool:
    g = got.numpy()
    if want.dtype.itemsize == g.dtype.itemsize:
        want = want.view(g.dtype)
    return g.shape == want.shape and np.array_equal(g, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grep_step_plain_matches_reference(name):
    chunks, pats, dlen, bases, l_cap = CASES[name]
    want = _ref_emit(chunks, pats, dlen, bases, l_cap)
    args = [torch.from_numpy(x) for x in (chunks, pats, dlen, bases)]
    kw = dict(l_cap=l_cap, bins=GREP_BINS, k=GREP_K)
    emitted = tgs.grep_step_plain(*args, emit=True, **kw)
    assert len(emitted) == 5
    for i, (g, w) in enumerate(zip(emitted, want)):
        assert _same(g, w), f"{name}: output {i} differs with emit"
    plain = tgs.grep_step_plain(*args, **kw)
    assert len(plain) == 3
    for i, (g, w) in enumerate(zip(plain, want)):
        assert _same(g, w), f"{name}: output {i} differs without emit"
    wrapped = tgs.grep_step(*args, emit=True, **kw)
    for i, (g, w) in enumerate(zip(wrapped, want)):
        assert _same(g, w), f"{name}: grep_step output {i} differs"


@pytest.mark.parametrize("tiles", [(TILE, LINE_TILE), (16384, 2048)])
def test_grep_cases_hold_their_edges(tiles):
    """Each case shows its edge at the CPU tests' tiles and at kernel J's
    own (16 KiB, 2,048 lines): only the overflow case overflows, matches
    sit across every tile edge, a line runs over three tiles, the top-k
    has more matched lines than k and occ of 256 or more, and the
    candidates' line numbers cross 2^32."""
    tile, line_tile = tiles
    cases = {c[0]: c[1:] for c in grep_cases(tile, line_tile)}
    for name, (chunks, pats, dlen, bases, l_cap) in cases.items():
        assert chunks.shape == (8, 8 * tile)
        assert l_cap == max(4 * line_tile, tile) >= 4 * line_tile
        n_lines = [int((r[:d] == 10).sum()) + int(d > 0 and r[d - 1] != 10)
                   for r, d in zip(chunks, dlen)]
        assert (max(n_lines) > l_cap) == (name == "n_lines_over_l_cap")
    out = {name: [x.numpy() for x in tgs.grep_step_plain(
        *(torch.from_numpy(x) for x in cases[name][:4]),
        l_cap=cases[name][4], bins=GREP_BINS, k=GREP_K)]
        for name in ("every_line_matches", "many_occurrences",
                     "pattern_length_1", "bases_across_2_32")}
    rows = cases["match_across_tiles"][0]
    for e in range(tile, 8 * tile, tile):
        assert all(bytes(r[e - 2:e + 2]).find(b"the") >= 0 for r in rows)
    rows = cases["newline_on_tile_edges"][0]
    assert (rows[:, tile::tile] == 10).all()
    assert (rows[:, tile - 1:-1:tile] == 10).all()
    for r in cases["line_over_three_tiles"][0]:
        gaps = np.diff(np.flatnonzero(r == 10))
        assert gaps.max() > 3 * tile
    assert (out["every_line_matches"][2][:, 3] > GREP_K).all()
    assert out["many_occurrences"][1][:, 0, 3].min() >= GREP_BINS - 1
    assert out["pattern_length_1"][1][:, 0, 3].min() >= 256
    assert cases["pattern_length_80"][1].shape[1] == 80
    dl = cases["dlen_edges"][2]
    assert 0 in dl and (dl % 16 != 0).any()
    assert (out["bases_across_2_32"][1][:, :, 0] == 1).any(axis=1).all()


def test_grep_step_c_interface():
    """One C entry point a step; the tiles chip_smoke.py places its cases
    at come from the library."""
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert build.SIGNATURES["dsi_grep_step"] == (
        c_int, [p, c_int, i64, p, c_int, p, p, i64, c_int, c_int,
                p, p, p, p, p, p, p])
    assert build.SIGNATURES["dsi_grep_step_scratch_bytes"] == (
        i64, [c_int, i64, i64, c_int, c_int])
    assert build.SIGNATURES["dsi_grep_step_tile_bytes"] == (i64, [])
    assert build.SIGNATURES["dsi_grep_step_line_tile"] == (i64, [])
    assert "dsi_grep_emit" not in build.SIGNATURES
