"""The port's wire codecs against the JAX package, on the CPU.

The host side of ``dsi_tpu_torch/ops/wirecodec.py`` is a copy of
``dsi_tpu/ops/wirecodec.py``: on the same seeded inputs (those of
``tests/test_wire_ingest.py`` and ``tests/test_net.py``, text landing on
each literal rung, a 7-bit batch, an incompressible batch and an odd
width) every encoder must give the reference's bytes and every decoder its
values.  The plain decode of kernel N (``decode_chunk_plain``) must equal
the reference's jitted ``decode_chunk_device`` on the JAX CPU backend in
both modes, at 1 and 8 shards, and on a hand-made packed tensor whose
escapes exceed its literal region (the clamp).  Tolerance: exact.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dsi_tpu.ops import wirecodec as jwc
from dsi_tpu_torch.ops import wirecodec as twc
from dsi_tpu_torch.ops import wordcount as tw

# 14 frequent symbols (the dictionary's bulk) and rare ones that escape.
_COMMON = np.frombuffer(b"etaoinshrdlu \n", np.uint8)
_RARE = np.frombuffer(b"vwxyzqjkVWXYZQJK", np.uint8)


def _text_batch(n_dev: int, n: int, rare_frac: float, seed: int):
    """[n_dev, n] ASCII text with about ``rare_frac`` of its bytes drawn
    from 16 rare symbols, each rarer than any common one."""
    rng = np.random.default_rng(seed)
    rare = rng.random((n_dev, n)) < rare_frac
    return np.where(rare, rng.choice(_RARE, (n_dev, n)),
                    rng.choice(_COMMON, (n_dev, n))).astype(np.uint8)


def _batches():
    """name -> (batch, expected mode, expected lit_cap)."""
    text = b"the the the and and of of to a in is it " * 2000
    n = 1 << 13
    ingest = np.zeros((2, n), np.uint8)
    ingest[0] = np.frombuffer(text[:n], np.uint8)
    ingest[1, :50] = np.frombuffer(text[:50], np.uint8)
    rng = np.random.default_rng(7)
    return {
        "ingest_nibble": (ingest, "nib", n // 8),
        "rung8_n1": (_text_batch(1, 1 << 12, 0.05, 1), "nib", 512),
        "rung8_n8": (_text_batch(8, 1 << 12, 0.05, 2), "nib", 512),
        "rung4_n1": (_text_batch(1, 1 << 12, 0.18, 3), "nib", 1024),
        "rung4_n8": (_text_batch(8, 1 << 12, 0.18, 4), "nib", 1024),
        "b7_text": (_text_batch(8, 1 << 12, 0.40, 5), "b7", 0),
        "b7_ingest": (rng.integers(0, 128, (3, 1 << 12), dtype=np.uint8),
                      "b7", 0),
        "incompressible": (np.random.default_rng(1).integers(
            0, 256, (2, 1 << 10), dtype=np.uint8), None, None),
        "odd_width": (np.zeros((2, 12), np.uint8), None, None),
        "n_mod8": (_text_batch(2, 1020, 0.05, 6), None, None),
    }


BATCHES = _batches()


@pytest.mark.parametrize("name", list(BATCHES))
def test_encode_chunk_matches_reference(name):
    batch, mode, cap = BATCHES[name]
    got, want = twc.encode_chunk(batch), jwc.encode_chunk(batch)
    if mode is None:
        assert got is None and want is None
        return
    assert want[0] == mode and want[2] == cap  # the rung the case aims at
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1].dtype == want[1].dtype == np.uint8
    assert np.array_equal(got[1], want[1])
    n = batch.shape[1]
    host = twc.decode_chunk_host(got[0], got[1], n)
    assert np.array_equal(host, jwc.decode_chunk_host(*want[:2], n))
    assert np.array_equal(host, batch)


def _jax_decode(packed, n, lit_cap, mode):
    return np.asarray(jwc.decode_chunk_device(
        jax.device_put(packed), n=n, lit_cap=lit_cap, mode=mode))


@pytest.mark.parametrize("name", [k for k, v in BATCHES.items()
                                  if v[1] is not None])
def test_decode_plain_matches_reference(name):
    batch, _, _ = BATCHES[name]
    mode, packed, cap = twc.encode_chunk(batch)
    n = batch.shape[1]
    before = tw.launch_counts()
    got = twc.decode_chunk_device(torch.from_numpy(packed), n=n,
                                  lit_cap=cap, mode=mode)
    assert tw.launch_counts() == before  # a CPU tensor launches nothing
    plain = twc.decode_chunk_plain(torch.from_numpy(packed), n=n,
                                   lit_cap=cap, mode=mode)
    assert got.dtype == torch.uint8 and got.shape == batch.shape
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), _jax_decode(packed, n, cap, mode))
    assert np.array_equal(got.numpy(), batch)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_decode_clamps_escapes_past_lit_cap(n_dev):
    """More escapes than literals: every escape past the region reads the
    last literal, as the reference's clip does."""
    rng = np.random.default_rng(11 + n_dev)
    n, lit_cap = 256, 8
    packed = rng.integers(0, 256, (n_dev, twc.packed_width(n, lit_cap)),
                          dtype=np.uint8)
    packed[:, 16:16 + 40] = 0xFF  # 80 escapes at the row's head
    got = twc.decode_chunk_plain(torch.from_numpy(packed), n=n,
                                 lit_cap=lit_cap, mode="nib")
    want = _jax_decode(packed, n, lit_cap, "nib")
    assert np.array_equal(got.numpy(), want)
    lits = packed[:, 16 + n // 2:]
    assert np.array_equal(got.numpy()[:, 79], lits[:, lit_cap - 1])


def test_decode_rejects_bad_shapes():
    packed = torch.zeros((2, twc.packed_width(64, 8)), dtype=torch.uint8)
    with pytest.raises(ValueError, match="packed width"):
        twc.decode_chunk_device(packed, n=64, lit_cap=16, mode="nib")
    with pytest.raises(ValueError, match="multiple of 8"):
        twc.decode_chunk_device(packed, n=60, lit_cap=8, mode="nib")
    with pytest.raises(ValueError, match="unknown wire mode"):
        twc.decode_chunk_device(packed, n=64, lit_cap=8, mode="raw")
    with pytest.raises(ValueError, match="contiguous"):
        twc.decode_chunk_device(packed.to(torch.int32), n=64, lit_cap=8,
                                mode="nib")


@pytest.mark.parametrize("vals", [
    [0, 1, 127, 128, 255, 16383, 16384, 2 ** 32 - 1, 2 ** 40],
    [],
    list(np.random.default_rng(3).integers(0, 2 ** 62, 500)),
], ids=["boundaries", "empty", "random"])
def test_varints_match_reference(vals):
    enc = twc.varint_encode(vals)
    assert enc == jwc.varint_encode(vals)
    got = twc.varint_decode(enc + b"tail", len(vals))
    want = jwc.varint_decode(enc + b"tail", len(vals))
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    with pytest.raises(ValueError):
        twc.varint_decode(b"\x80\x80", 1)


def _fake_packed_table(n_dev=4, mp=64, kk=4, nus=(50, 3, 0, 64)):
    """The packed result table of ``tests/test_wire_ingest.py``."""
    rows = np.zeros((n_dev, mp, kk + 3), np.uint32)
    words = [b"the", b"a", b"wordcount", b"zz", b"longestword1"]
    for d in range(n_dev):
        for r in range(nus[d]):
            w = words[(d + r) % len(words)] + str(r % 7).encode()
            kb = np.zeros(kk * 4, np.uint8)
            kb[:len(w)] = np.frombuffer(w, np.uint8)
            rows[d, r, :kk] = kb.view(">u4")
            rows[d, r, kk] = len(w)
            rows[d, r, kk + 1] = r + 1
            rows[d, r, kk + 2] = r % 10
    return rows, np.asarray(nus, np.int64)


def _untrimmable():
    rows, nus = _fake_packed_table(nus=(4, 0, 0, 0))
    rows[0, 0, :4] = np.full(16, 0xAB, np.uint8).view(">u4")
    rows[0, 0, 4] = 3  # claims 3 bytes; its lanes hold 16
    return rows, nus


@pytest.mark.parametrize("table", [
    _fake_packed_table(), (np.zeros((2, 8, 7), np.uint32), [0, 0]),
    _untrimmable(),
], ids=["word_rows", "empty", "untrimmable"])
def test_pack_rows_matches_reference(table):
    rows, nus = table
    blob = twc.pack_rows(rows, nus)
    assert blob == jwc.pack_rows(rows, nus)
    assert twc.rows_raw_bytes(nus, rows.shape[2] - 3) == \
        jwc.rows_raw_bytes(nus, rows.shape[2] - 3)
    got, want = twc.unpack_rows(blob), jwc.unpack_rows(blob)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def _kv_corpus(rows: int) -> bytes:
    lines = [b'{"Key": "apple", "Value": "1"}', b'{"Key": "b", "Value": "1"}',
             b'{"Key": "cherry", "Value": "1"}']
    return b"\n".join(lines[i % 3] for i in range(rows)) + b"\n"


@pytest.mark.parametrize("raw", [
    b"", b"\n", b"one line no newline", b"one line\n", b"a\nb\na\nb\na\n",
    b"trailing\nblank\n\n\nlines\n", _kv_corpus(64), _kv_corpus(2000),
    "unicodé line\n".encode(),
])
def test_pack_kv_matches_reference(raw):
    blob = twc.pack_kv(raw)
    assert blob == jwc.pack_kv(raw)
    assert twc.unpack_kv(blob) == jwc.unpack_kv(blob) == raw
    assert twc.kv_raw_bytes(raw) == jwc.kv_raw_bytes(raw)


def test_chunk_shapes_and_switch_match_reference(monkeypatch):
    for n in (64, 1 << 10, 1 << 21):
        assert twc.lit_caps(n) == jwc.lit_caps(n)
        assert twc.packed7_width(n) == jwc.packed7_width(n)
        for cap in twc.lit_caps(n):
            assert twc.packed_width(n, cap) == jwc.packed_width(n, cap)
    assert twc.LIT_FRACS == jwc.LIT_FRACS
    for env in (None, "1", "on", "0", ""):
        if env is None:
            monkeypatch.delenv("DSI_STREAM_WIRE", raising=False)
        else:
            monkeypatch.setenv("DSI_STREAM_WIRE", env)
        for flag in (None, True, False):
            assert twc.wire_upload_default(flag) == \
                jwc.wire_upload_default(flag)
