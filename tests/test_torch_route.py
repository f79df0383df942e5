"""Kernels E (the shuffle) and D (FNV-1a with its partition epilogue)
against the JAX package, on the CPU.

The cases of ``dsi_tpu_torch/utils/kernel_cases.py`` (``route_cases`` at a
256-row tile, ``fnv_cases``) go through the port's wrappers, which take the
plain versions here (the tensors lie on the CPU), and through
``dsi_tpu``'s ``shuffle_rows`` under ``shard_map`` on the virtual CPU mesh
(every case whose dests the reference's contract covers: ``n_dev`` parks,
nothing lies outside [0, n_dev]), ``fnv1a32_packed`` and ``route_dest``;
every route case also through a numpy model of the exchange.
``chip_smoke.py`` runs the same cases at the kernels' own tiles on the
card.  Every output is an integer: the tolerance is exact.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dsi_tpu.ops import meshroute as jmr
from dsi_tpu.ops import wordcount as jw
from dsi_tpu.parallel import shuffle as js
from dsi_tpu.utils.jaxcompat import shard_map, x64_scoped
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.kernels import build
from dsi_tpu_torch.ops import meshroute as tmr
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.parallel import shuffle as ts
from dsi_tpu_torch.utils.kernel_cases import (fnv_cases, lanes_to_words,
                                              route_cases)

TILE = 256
ROUTE = {c[0]: c[1:] for c in route_cases(TILE)}
FNV = {c[0]: c[1:] for c in fnv_cases()}


@functools.lru_cache(maxsize=None)
def _ref_shuffle_fn(n_dev: int, r: int, w: int, k: int):
    """The reference's ``shuffle_rows`` under ``shard_map``, one jit per
    shape (as ``tests/test_torch_shuffle.py`` runs it)."""
    def body(rows, dest):
        return js.shuffle_rows(rows.reshape(r, w), dest.reshape(r),
                               n_dev=n_dev, u_cap=r, k=k)[None]

    return jax.jit(shard_map(
        body, mesh=js.default_mesh(n_dev),
        in_specs=(P(js.AXIS, None, None), P(js.AXIS, None)),
        out_specs=P(js.AXIS, None, None)))


def _route_model(rows, dest, n_dev: int, k: int) -> np.ndarray:
    """recv[d, s*r + j] = the j-th row of source s bound for d; the rest
    pad rows; a dest outside [0, n_dev) dropped."""
    _, r, w = rows.shape
    recv = np.zeros((n_dev, n_dev * r, w), np.uint32)
    recv[..., :k] = 0xFFFFFFFF
    for s in range(n_dev):
        keep = (dest[s] >= 0) & (dest[s] < n_dev)
        d = dest[s][keep]
        order = np.argsort(d, kind="stable")
        d = d[order]
        first = np.searchsorted(d, d)  # each destination's first slot
        recv[d, s * r + np.arange(len(d)) - first] = rows[s][keep][order]
    return recv


@pytest.mark.parametrize("name", sorted(ROUTE))
def test_route_cases_plain_matches_reference(name):
    rows, dest, n_dev, k = ROUTE[name]
    got = to_numpy(ts.shuffle_rows(to_tensor(rows), to_tensor(dest),
                                   n_dev=n_dev, k=k), np.uint32)
    np.testing.assert_array_equal(got, _route_model(rows, dest, n_dev, k))
    if n_dev in (1, 8) and ((dest >= 0) & (dest <= n_dev)).all():
        _, r, w = rows.shape
        want = np.asarray(_ref_shuffle_fn(n_dev, r, w, k)(
            jnp.asarray(rows), jnp.asarray(dest)))
        np.testing.assert_array_equal(got, want)


def test_route_cases_hold_their_edges():
    for tile in (TILE, lambda w: 1024 if w < 9 else 256):
        cases = {c[0]: c[1:] for c in route_cases(tile)}
        t7 = tile(7) if callable(tile) else tile
        rows, dest, n_dev, k = cases["tile_edges_n8"]
        r = rows.shape[1]
        assert r == 3 * t7 + 5 and (dest[:, t7 - 1] == dest[:, t7]).all()
        assert set(np.unique(dest)) == set(range(9))
        # A destination's run crosses a tile edge on every source.
        runs = cases["runs_across_tiles_n8"][1]
        for e in range(t7, r, t7):
            assert (runs[:, e - 1] == runs[:, e]).any()
        assert (cases["all_parked_n8"][1] == 8).all()
        assert (cases["one_dest_n8"][1] == 5).all()
        assert {c[1].shape[1] for c in cases.values()} >= {1, t7 - 1,
                                                           t7 + 1}
        oob = cases["out_of_range_n3"][1]
        assert (oob < 0).any() and (oob > 3).any() and (oob == 3).any()
        assert {c[2] for c in cases.values()} == {1, 3, 8, 1024}
        widths = {(c[0].shape[2], c[3]) for c in cases.values()}
        assert {(w, k) for w in (1, 7, 8, 19, 20)
                for k in (0, w)} <= widths
        for w in (1, 19):
            r_w = cases[f"w{w}_k0_n3"][0].shape[1]
            assert r_w == (tile(w) if callable(tile) else tile) + 3
        prow = cases["pad_rows_in_payload_n8"][0]
        pad = (prow[..., :4] == 0xFFFFFFFF).all(-1) & (prow[..., 4:] == 0
                                                       ).all(-1)
        assert pad.sum() >= prow.shape[0] * prow.shape[1] // 4


def _ref_rule(h, n_part: int, n_dest: int, park: int, valid):
    part = (h & np.uint32(0x7FFFFFFF)) % np.uint32(n_part)
    return part, np.where(valid, part % np.uint32(n_dest), park)


@pytest.mark.parametrize("layout", ["lanes", "words"])
@pytest.mark.parametrize("name", sorted(FNV))
def test_fnv_route_plain_matches_reference(name, layout):
    lanes, lens, mwl, ep = FNV[name]
    want_h = np.asarray(jw.fnv1a32_packed(jnp.asarray(lanes),
                                          jnp.asarray(lens), mwl))
    keys = to_tensor(lanes if layout == "lanes" else lanes_to_words(lanes))
    got_h = to_numpy(tw.fnv1a32_packed(keys, to_tensor(lens), mwl),
                     np.uint32)
    np.testing.assert_array_equal(got_h, want_h)
    assert (got_h[lens <= 0] == 0x811C9DC5).all()
    if ep is None:
        return
    kw = dict(ep)
    u = len(lens)
    valid = kw.get("valid")
    if valid is None:
        valid = np.arange(u) < kw["n_valid"]
        kw["n_valid"] = torch.tensor(kw["n_valid"], dtype=torch.int32)
    else:
        kw["valid"] = torch.from_numpy(valid)
    h, part, dest = tw.fnv1a32_route(keys, to_tensor(lens), mwl, **kw)
    want_part, want_dest = _ref_rule(want_h, ep["n_part"], ep["n_dest"],
                                     ep["park"], valid)
    np.testing.assert_array_equal(to_numpy(h, np.uint32), want_h)
    np.testing.assert_array_equal(to_numpy(part), want_part)
    np.testing.assert_array_equal(to_numpy(dest), want_dest)
    if (ep["n_part"] == ep["n_dest"] and mwl == 4 * lanes.shape[1]
            and layout == "lanes"):
        ref = np.asarray(jax.jit(functools.partial(
            jmr.route_dest, n_shards=ep["n_dest"], park=ep["park"]))(
            jnp.asarray(lanes), jnp.asarray(lens), jnp.asarray(valid)))
        np.testing.assert_array_equal(to_numpy(dest), ref)
        np.testing.assert_array_equal(to_numpy(tmr.route_dest(
            keys, to_tensor(lens), torch.from_numpy(valid),
            n_shards=ep["n_dest"], park=ep["park"])), ref)


@functools.lru_cache(maxsize=None)
def _ref_map_prologue(grouper: str):
    return x64_scoped(jax.jit(functools.partial(
        js.map_prologue, n_dev=8, n_reduce=10, max_word_len=16, u_cap=128,
        t_cap_frac=4, grouper=grouper)))


@pytest.mark.parametrize("grouper", ["sort", "hash"])
def test_map_prologue_part_dest_match_reference(grouper):
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 123, int(rng.integers(1, 14)))
                   .astype(np.uint8)) for _ in range(60)]
    text = b" ".join(words[i] for i in rng.integers(0, 60, 150)) + b" "
    chunk = np.zeros(2048, np.uint8)
    chunk[:len(text)] = np.frombuffer(text, np.uint8)
    want = _ref_map_prologue(grouper)(jnp.asarray(chunk))
    got = ts.map_prologue(torch.from_numpy(chunk), n_dev=8, n_reduce=10,
                          max_word_len=16, u_cap=128, t_cap_frac=4,
                          grouper=grouper)
    for g, x in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(to_numpy(g, np.uint32),
                                      np.asarray(x).astype(np.uint32))
    assert [int(x) for x in got[5]] == [int(x) for x in want[5]]
    n_unique = int(want[5][0])
    assert 0 < n_unique < 128 and (to_numpy(got[4])[n_unique:] == 8).all()


def test_fnv_route_rejects_bad_operands():
    keys = torch.zeros((4, 4), dtype=torch.int32)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tw.fnv1a32_route(keys, lens, 16, n_part=2, n_dest=2, park=2,
                         valid=torch.ones(4, dtype=torch.bool),
                         n_valid=torch.tensor(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tw.fnv1a32_route(keys, lens, 16, n_part=2, n_dest=2, park=2,
                         n_valid=torch.tensor(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        tw.fnv1a32_route(keys, lens, 20, n_part=2, n_dest=2, park=2)
    with pytest.raises(ValueError):
        tw.fnv1a32_route(keys, lens, 16, n_part=2, n_dest=2, park=2,
                         n_valid=torch.tensor(1, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError):
        tw.fnv1a32_route(keys, lens, 16, n_part=0, n_dest=2, park=2)
    with pytest.raises(ValueError):
        tw.fnv1a32_packed(keys.to(torch.int16), lens, 8)
    with pytest.raises(ValueError):
        tw.shuffle_rows(torch.zeros((1, 2, 40000), dtype=torch.int32),
                        torch.zeros((1, 2), dtype=torch.int32), n_dev=1,
                        k=0)


def test_route_and_fnv_c_interface():
    """``dsi_route`` keeps its C signature; its scratch size now depends
    on the row width, whose tile ``chip_smoke.py`` reads through
    ``dsi_route_tile_rows``; ``dsi_fnv`` takes both layouts and the
    epilogue's operands (``slice_profile`` declares the older two for
    ``route_ab``)."""
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sig = build.SIGNATURES
    assert sig["dsi_route"] == (c_int, [p, p, c_int, i64, c_int, c_int, p,
                                        p, p])
    assert sig["dsi_route_scratch_bytes"] == (i64, [c_int, i64, c_int])
    assert sig["dsi_route_tile_rows"] == (i64, [c_int])
    assert sig["dsi_fnv"] == (c_int, [p, c_int, i64, c_int, p, c_int, p, p,
                                      p, c_int, c_int, c_int, p, p, p])
