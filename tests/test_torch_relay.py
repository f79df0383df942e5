"""The port's stage relay (kernel P's plain version, ``DeviceRelay``,
``HostRelay``) against the JAX package's, on the CPU.

``relay_pack_plain`` and the CPU path of ``relay_pack`` are held to the
reference's ``_pack_impl`` at offsets 0, mid-row, ``cap - kept`` and
random, at 1 and 8 rows.  A numpy model of kernel P's design (the row's
blocks from the fill point, one aligned 16-byte load a lane with the
neighbour lane's shifted in, 16-byte stores inside the row) is held to
``_pack_impl`` on ``kernel_cases.relay_cases``: every offset residue mod
16, offsets below 0, below ``-cap``, at and past ``cap``, caps off the
16-byte grid and rows at any address alignment.  The two packages'
relays take the same seeded appends (8 rows, the reference on its
8-device virtual mesh) and must hand over the same buffers, fill lengths
and stats through seals, a spill budget, ``take_sealed``/``finish`` and
``host_blocks``; a ``capture`` image from either package restores in the
other.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dsi_tpu.device import relay as jr
from dsi_tpu.parallel import shuffle as js
from dsi_tpu_torch.device import relay as tr
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.utils import kernel_cases as kc

N_DEV = 8


@functools.lru_cache(maxsize=None)
def _mesh(n_dev: int):
    return js.default_mesh(n_dev)


def _rows(seed: int, n_dev: int, cap: int, lo: int, hi: int):
    """One step's compacted output: [n_dev, cap] uint8 with kept[r] nonzero
    bytes in row r and a zero tail."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((n_dev, cap), np.uint8)
    kept = rng.integers(lo, hi, n_dev).astype(np.int64)
    for r in range(n_dev):
        buf[r, :kept[r]] = rng.integers(1, 256, kept[r])
    return buf, kept


def _ref_dev(buf: np.ndarray):
    return jax.device_put(buf, NamedSharding(_mesh(buf.shape[0]),
                                             P(js.AXIS, None)))


# ── P: the pack ──────────────────────────────────────────────────────────


@pytest.mark.parametrize("n_dev,cap,where", [
    (1, 64, "zero"), (1, 64, "mid"), (1, 64, "cap-kept"),
    (8, 256, "zero"), (8, 256, "mid"), (8, 256, "cap-kept"),
    (8, 250, "random"),
])
def test_pack_plain_matches_reference(n_dev, cap, where):
    acc, _ = _rows(1, n_dev, cap, 0, cap)
    new, kept = _rows(2, n_dev, cap, 1, cap // 2)
    rng = np.random.default_rng(3)
    off = {"zero": np.zeros(n_dev, np.int64),
           "mid": np.full(n_dev, cap // 2),
           "cap-kept": cap - kept,
           "random": rng.integers(0, cap + 1, n_dev)}[where].astype(np.int32)
    want = np.asarray(jr._pack_impl(acc, off, new))
    got = tr.relay_pack_plain(torch.from_numpy(acc), torch.from_numpy(off),
                              torch.from_numpy(new))
    assert np.array_equal(got.numpy(), want)
    # The wrapper on the CPU: the same function, written into acc.
    acc_t = torch.from_numpy(acc.copy())
    assert tr.relay_pack(acc_t, torch.from_numpy(off),
                         torch.from_numpy(new)) is acc_t
    assert np.array_equal(acc_t.numpy(), want)


def test_pack_refuses_alias_and_counts_no_launch():
    tw.reset_launches()
    acc = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="aliases"):
        tr.relay_pack(acc, torch.zeros(2, dtype=torch.int32), acc)
    base = torch.zeros((3, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="aliases"):  # overlapping rows
        tr.relay_pack(base[:2], torch.zeros(2, dtype=torch.int32), base[1:])
    with pytest.raises(ValueError, match="bad operands"):
        tr.relay_pack(acc, torch.zeros(3, dtype=torch.int32),
                      torch.zeros((2, 32), dtype=torch.uint8))
    tr.relay_pack(acc, torch.zeros(2, dtype=torch.int32),
                  torch.ones((2, 32), dtype=torch.uint8))
    assert tw.launch_counts()["relay_pack"] == 0


def test_pack_takes_offsets_on_the_host():
    """On the card the offsets are launch arguments: ``off`` is a host
    array or a CPU tensor, and one elsewhere (a read would be a hidden
    sync) raises before anything runs."""
    acc = torch.zeros((2, 32), dtype=torch.uint8)
    new = torch.ones((2, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="on the host"):
        tr.relay_pack(acc, torch.zeros(2, dtype=torch.int32, device="meta"),
                      new)
    with pytest.raises(ValueError, match="bad operands"):
        tr.relay_pack(acc, np.zeros(2, np.float32), new)
    assert tr.relay_pack(acc, np.array([3, 40]), new) is acc  # numpy off
    assert acc[0, :3].sum() == 0 and bool((acc[0, 3:] == 1).all())
    assert acc[1].sum() == 0


# ── P's design as a numpy model ────────────────────────────────────────────

P_THREADS = 256


def pack_model(acc, off, new, acc_base: int, new_base: int):
    """Kernel P as ``csrc/relay_pack.cu`` does it, acc and new [n_dev,
    cap] placed at addresses ``acc_base`` and ``new_base``: (out, the
    vectors of each row stored byte by byte).  A row's blocks start at the
    aligned vector holding its fill point; a thread's source bytes come
    through ``load16_any`` from new's row (the clamp past its end where
    off < 0); a vector wholly inside [max(off, 0), cap) is one 16-byte
    store."""
    n_dev, cap = acc.shape
    out = acc.copy()
    mem = new.reshape(-1)
    byte_vectors = []
    for r in range(n_dev):
        o = int(off[r])
        if o >= cap:  # no block
            byte_vectors.append(0)
            continue
        start = max(o, 0)
        row_addr = acc_base + r * cap
        v0 = ((row_addr + start) & ~15) - row_addr
        vectors = -(-(cap - v0) // 16)
        blocks = -(-vectors // P_THREADS)
        i0 = v0 + 16 * np.arange(blocks * P_THREADS, dtype=np.int64)
        src = new_base + r * cap
        v = kc.load16_any_model(mem, new_base, src + i0 - o, src, src + cap)
        j = i0[:, None] + np.arange(16) - o
        v = np.where(j > cap - 1, new[r, cap - 1], v)
        i = i0[:, None] + np.arange(16)
        full = (i0 >= start) & (i0 + 16 <= cap)
        assert np.all(((row_addr + i0[full]) & 15) == 0)
        keep = (i >= start) & (i < cap)
        assert np.all(keep[~full].sum(1) < 16)  # a byte-stored vector
        out[r, i[keep]] = v[keep]
        byte_vectors.append(int((~full & keep.any(1)).sum()))
        # No block is launched only to return.
        assert keep.reshape(blocks, -1).any(1).all()
    return out, byte_vectors


@pytest.mark.parametrize("n_dev,cap,bases", [
    (1, 256, (0, 0)), (1, 200, (0, 0)), (8, 256, (0, 5)),
    (8, 1000, (0, 0)), (8, 4093, (512, 1027)), (3, 8200, (16, 8)),
])
def test_pack_model_matches_reference(n_dev, cap, bases):
    for name, acc, off, new in kc.relay_cases(n_dev, cap):
        want = np.asarray(jr._pack_impl(acc, off.astype(np.int32), new))
        got, byte_vectors = pack_model(acc, off, new, *bases)
        assert np.array_equal(got, want), name
        # Byte stores only at the fill point and the row's end.
        assert max(byte_vectors) <= 2, name
        acc_t = torch.from_numpy(acc.copy())
        tr.relay_pack(acc_t, off, torch.from_numpy(new))
        assert np.array_equal(acc_t.numpy(), want), name


# ── the relays ──────────────────────────────────────────────────────────


def _steps(seed: int, n: int, cap: int, lo: int, hi: int):
    return [_rows(seed * 100 + i, N_DEV, cap, lo, hi) for i in range(n)]


def _feed(steps, *, cap: int, spill: int = 0):
    """The same appends into both packages' DeviceRelays."""
    ref_st, port_st = {}, {}
    ref = jr.DeviceRelay(_mesh(N_DEV), cap=cap, stats=ref_st,
                         spill_bytes=spill)
    port = tr.DeviceRelay(N_DEV, cap=cap, device="cpu", stats=port_st,
                          spill_bytes=spill)
    for buf, kept in steps:
        ref.append(_ref_dev(buf), kept)
        port.append(torch.from_numpy(buf.copy()), kept)
    return ref, port, ref_st, port_st


def _host(bufs) -> list:
    return [b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            for b in bufs]


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["seals", "spill", "take_sealed",
                                  "host_blocks"])
def test_device_relay_matches_reference(case):
    cap = 64
    spill = N_DEV * cap if case == "spill" else 0  # one resident buffer
    steps = _steps({"seals": 1, "spill": 2, "take_sealed": 3,
                    "host_blocks": 4}[case], 9, cap, 0, 30)
    ref, port, ref_st, port_st = _feed(steps, cap=cap, spill=spill)
    assert port.total_bytes == ref.total_bytes
    if case == "take_sealed":
        got = _host(port.take_sealed())
        assert _same(got, _host(ref.take_sealed())) and got
        port.finish()
        ref.finish()
        assert _same(_host(port.take_sealed()), _host(ref.take_sealed()))
    elif case == "host_blocks":
        got = list(port.host_blocks())
        assert got == list(ref.host_blocks())
        assert sum(map(len, got)) == port.total_bytes > 0
        assert port_st["plan_intermediate_bytes"] == port.total_bytes
    else:
        got = _host(port.batches())
        assert _same(got, _host(ref.batches())) and len(got) >= 2
    assert port_st == ref_st
    if case == "spill":
        assert port_st["plan_spilled_bytes"] > 0
    else:
        assert port_st["plan_relay_buffers"] >= 2


def test_device_relay_concatenates_rows_exactly():
    cap = 64
    steps = _steps(5, 7, cap, 0, 30)
    _, port, _, st = _feed(steps, cap=cap)
    want = [bytearray() for _ in range(N_DEV)]
    for buf, kept in steps:
        for r in range(N_DEV):
            want[r] += buf[r, :kept[r]].tobytes()
    got = [bytearray() for _ in range(N_DEV)]
    for b in _host(port.batches()):
        for r in range(N_DEV):
            nz = np.flatnonzero(b[r])  # test bytes are nonzero
            got[r] += b[r, :int(nz[-1]) + 1 if nz.size else 0].tobytes()
    assert got == want
    assert st["plan_intermediate_bytes"] == 0


def test_host_relay_matches_reference():
    steps = _steps(6, 5, 48, 0, 40)
    ref_st, port_st = {}, {}
    ref, port = jr.HostRelay(stats=ref_st), tr.HostRelay(stats=port_st)
    for buf, kept in steps:
        ref.append(_ref_dev(buf), kept)
        port.append(torch.from_numpy(buf.copy()), kept)
    assert list(port.blocks()) == list(ref.blocks())
    assert port.total_bytes == ref.total_bytes
    assert port_st == ref_st and port_st["plan_intermediate_bytes"] > 0


@pytest.mark.parametrize("source", ["port", "reference"])
def test_capture_restores_across_packages(source):
    cap = 64
    ref, port, _, _ = _feed(_steps(7, 6, cap, 0, 30), cap=cap)
    img = (port if source == "port" else ref).capture()
    assert sorted(img) == sorted((ref if source == "port" else port)
                                 .capture())
    want = _host((ref if source == "port" else port).batches())
    r_st, p_st = {}, {}
    ref2 = jr.DeviceRelay.restore(_mesh(N_DEV), img, cap=cap, stats=r_st)
    port2 = tr.DeviceRelay.restore(N_DEV, img, cap=cap, device="cpu",
                                   stats=p_st)
    assert _same(_host(port2.batches()), want)
    assert _same(_host(ref2.batches()), want)
    assert p_st == r_st and p_st["plan_restored_bytes"] > 0
    # The host flavour's image crosses too.
    h_ref, h_port = jr.HostRelay(), tr.HostRelay()
    for buf, kept in _steps(8, 3, cap, 0, 30):
        h_ref.append(_ref_dev(buf), kept)
        h_port.append(torch.from_numpy(buf.copy()), kept)
    h_img = (h_port if source == "port" else h_ref).capture()
    assert list(tr.HostRelay.restore(h_img).blocks()) == list(
        jr.HostRelay.restore(h_img).blocks()) == [b"".join(h_ref.blocks())]
