"""The port's wire codecs against the JAX package, on the CPU.

The host side of ``dsi_tpu_torch/ops/wirecodec.py`` is a copy of
``dsi_tpu/ops/wirecodec.py``: on the same seeded inputs (those of
``tests/test_wire_ingest.py`` and ``tests/test_net.py``, text landing on
each literal rung, a 7-bit batch, an incompressible batch and an odd
width) every encoder must give the reference's bytes and every decoder its
values.  The plain decode of kernel N (``decode_chunk_plain``) must equal
the reference's jitted ``decode_chunk_device`` on the JAX CPU backend in
both modes, at 1 and 8 shards, and on a hand-made packed tensor whose
escapes exceed its literal region (the clamp).  Numpy models of kernel
N's designs (7-bit: one thread a 7-byte group; nibble: one 16-byte load a
thread, its 32 nibbles' escape mask, a tile scan, the decoupled look-back
over the row's tiles under any mix of published states, the dictionary
looked up four nibbles at a time, literals read once in order) are held
to ``_decode_impl`` and ``_decode7_impl`` on ``kernel_cases.wire_cases``
with tiles small enough that a row spans several.  Tolerance: exact.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dsi_tpu.ops import wirecodec as jwc
from dsi_tpu_torch.ops import wirecodec as twc
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.utils import kernel_cases as kc

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


# ── N's designs as numpy models ──────────────────────────────────────────


def decode7_model(packed, n: int):
    """Kernel N's 7-bit mode as ``csrc/wire_decode.cu wire_decode7``: one
    thread a group, its 7 bytes a little-endian u64, lane k = (v >> 7k) &
    0x7F, stored as one u64."""
    grp = packed.reshape(-1, 7).astype(np.uint64)
    v = np.zeros(grp.shape[0], np.uint64)
    for j in range(7):
        v |= grp[:, j] << np.uint64(8 * j)
    o = np.zeros_like(v)
    for k in range(8):
        o |= ((v >> np.uint64(7 * k)) & np.uint64(0x7F)) << np.uint64(8 * k)
    return o.astype("<u8").view(np.uint8).reshape(packed.shape[0], n)


def _swap_nibbles(x):
    return ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)


def _escapes8(sw):
    t = sw & (sw >> 1) & (sw >> 2) & (sw >> 3) & 0x11111111
    t = (t | (t >> 3)) & 0x03030303
    t = (t | (t >> 6)) & 0x000F000F
    return (t | (t >> 12)) & 0xFF


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte k of the result is byte (sel >> 4k) & 7 of
    the 8 bytes y:x."""
    x, y, sel = np.broadcast_arrays(x, y, sel)
    src = np.stack([(x >> (8 * k)) & 0xFF for k in range(4)]
                   + [(y >> (8 * k)) & 0xFF for k in range(4)], -1)
    out = np.zeros_like(x)
    for k in range(4):
        pick = (sel >> (4 * k)) & 7
        out |= np.take_along_axis(src, pick[..., None], -1)[..., 0] << (8 * k)
    return out


def _lookup4(d, sel):
    idx = sel & 0x7777
    lo = _byte_perm(d[0], d[1], idx)
    hi = _byte_perm(d[2], d[3], idx)
    return _byte_perm(lo, hi, 0x3210 | ((sel & 0x8888) >> 1))


def look_back(agg, window: int, rng):
    """Each tile's exclusive prefix as ``common.cuh lb_exclusive`` finds
    it: tile t sees every earlier tile published, each with its aggregate
    alone or already with its inclusive prefix (drawn at random; tile 0
    publishes its prefix at once), and walks back ``window`` tiles a round
    to the nearest inclusive one."""
    inc = np.cumsum(agg)
    ex = np.zeros(len(agg), np.int64)
    for t in range(1, len(agg)):
        shows_inc = rng.random(t) < 0.3
        shows_inc[0] = True
        c, j = 0, t - 1
        while j >= 0:
            lo = max(j - window + 1, 0)
            near = next((q for q in range(j, lo - 1, -1) if shows_inc[q]),
                        None)
            for q in range(j, (lo if near is None else near) - 1, -1):
                c += int(inc[q] if shows_inc[q] else agg[q])
            if near is not None:
                break
            j = lo - 1
        ex[t] = c
    return ex


def decode_nib_model(packed, n: int, lit_cap: int, tile: int, rounds: int,
                     base: int, rng):
    """Kernel N's nibble mode as ``csrc/wire_decode.cu wire_decode_nib``:
    tiles of ``tile`` packed bytes in ``rounds`` rounds (in round q, thread
    t takes the tile's vector q * threads + t: the row's vectors in order),
    the packed tensor at address ``base`` and ``out`` 16-byte aligned:
    (out, each row's literal reads in order, (16-byte stores, 8-byte
    stores))."""
    n_dev, width = packed.shape
    half, threads = n // 2, tile // (16 * rounds)
    tiles = -(-half // tile)
    mem = packed.reshape(-1)
    out = np.zeros((n_dev, n), np.uint8)
    reads, stores = [], [0, 0]
    for s in range(n_dev):
        nib = base + s * width + 16
        j0 = 16 * np.arange(tiles * rounds * threads, dtype=np.int64)
        v = kc.load16_any_model(mem, base, nib + j0, nib, nib + half,
                                warp=min(32, threads))
        sw = _swap_nibbles(v.view("<u4").astype(np.int64))  # [m, 4]
        valid = np.clip(half - j0, 0, 16)
        mask = sum(_escapes8(sw[:, q]) << (8 * q) for q in range(4))
        mask = np.where(valid < 16, mask & ((1 << (2 * valid)) - 1), mask)
        cnt = np.array([bin(int(x)).count("1") for x in mask]).reshape(
            tiles, rounds, threads)
        # One block scan of each thread's rounds in 16-bit fields.
        fields = sum(cnt[:, q, :] << (16 * q) for q in range(rounds))
        totals = fields.sum(1)
        ex_fields = np.cumsum(fields, 1) - fields
        assert np.all(cnt.sum(2) < 1 << 16)
        tile_total = sum((totals >> (16 * q)) & 0xFFFF for q in range(rounds))
        ex = look_back(tile_total, threads, rng)
        first = np.zeros((tiles, rounds, threads), np.int64)
        for q in range(rounds):
            below = sum((((totals >> (16 * p)) & 0xFFFF) for p in range(q)),
                        np.zeros(tiles, np.int64))
            first[:, q, :] = (ex[:, None] + below[:, None]
                              + ((ex_fields >> (16 * q)) & 0xFFFF))
        first = first.reshape(-1)
        d = packed[s, :16].copy().view("<u4").astype(np.int64)
        o = np.zeros((j0.size, 8), np.int64)
        for q in range(4):
            o[:, 2 * q] = _lookup4(d, sw[:, q])
            o[:, 2 * q + 1] = _lookup4(d, sw[:, q] >> 16)
        lits = packed[s, 16 + half:]
        row_reads = []
        per_tile = rounds * threads
        for t in np.flatnonzero(mask):
            # The tile's literal range, staged by its block.
            tl = t // per_tile
            lo = min(int(ex[tl]), lit_cap - 1)
            stage = lits[lo:min(int(ex[tl] + tile_total[tl]) - 1,
                                lit_cap - 1) + 1]
            e = int(first[t])
            for m in range(32):
                if (int(mask[t]) >> m) & 1:
                    k = min(e, lit_cap - 1)
                    row_reads.append(k)
                    o[t, m >> 2] &= ~(0xFF << (8 * (m & 3)))
                    o[t, m >> 2] |= int(stage[k - lo]) << (8 * (m & 3))
                    e += 1
        reads.append(row_reads)
        got = o.astype("<u4").view(np.uint8)  # [m, 32]
        for t in np.flatnonzero(valid):
            dst = s * n + 2 * int(j0[t])
            if valid[t] == 16 and dst % 16 == 0:
                stores[0] += 2
            else:
                assert dst % 8 == 0 and valid[t] % 4 == 0
                stores[1] += int(valid[t]) // 4
            out[s, 2 * j0[t]:2 * j0[t] + 2 * valid[t]] = got[t, :2 * valid[t]]
    return out, reads, stores


@pytest.mark.parametrize("n_dev,n,tile,rounds,base", [
    (1, 256, 32, 1, 0), (2, 200, 16, 1, 0), (3, 1024, 128, 4, 7),
    (2, 2048, 256, 4, 16), (2, 1024, 64, 2, 3),
])
def test_decode_models_match_reference(n_dev, n, tile, rounds, base):
    rng = np.random.default_rng(n + tile)
    for name, packed, lit_cap, batch in kc.wire_cases(n_dev, n, tile):
        want = np.asarray(jwc._decode_impl(packed, n=n))
        got, reads, stores = decode_nib_model(packed, n, lit_cap, tile,
                                              rounds, base, rng)
        assert np.array_equal(got, want), name
        assert np.array_equal(twc.decode_chunk_plain(
            torch.from_numpy(packed), n=n, lit_cap=lit_cap,
            mode="nib").numpy(), want), name
        if batch is not None:
            assert np.array_equal(got, batch), name
        # Literals once each, in order (a clamped escape rereads the last).
        for row in reads:
            k = min(len(row), lit_cap - 1)
            assert row[:k] == list(range(k)) and set(row[k:]) <= {k}, name
        # Whole 16-byte stores where the rows sit on the 16-byte grid: 8-byte
        # ones only in a row's last, partial thread.
        if n % 16 == 0:
            assert stores[1] <= 3 * n_dev, name
        else:
            assert stores[1] >= 4 * (n // 32) * (n_dev // 2), name
    b7 = rng.integers(0, 128, (n_dev, n), dtype=np.uint8)
    mode, packed, _ = twc.encode_chunk(b7)
    assert mode == "b7"
    want = np.asarray(jwc._decode7_impl(packed, n=n))
    assert np.array_equal(decode7_model(packed, n), want)
    assert np.array_equal(want, b7)


def test_wire_decode_c_interface():
    """``chip_smoke.py`` places escapes across N's one tile size, which the
    kernel reports with no arguments; the scratch size and the launch keep
    their parameters."""
    import ctypes

    from dsi_tpu_torch.kernels import build

    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert build.SIGNATURES["dsi_wire_decode_tile_bytes"] == (i64, [])
    assert build.SIGNATURES["dsi_wire_decode_scratch_bytes"] == (
        i64, [c_int, i64])
    assert build.SIGNATURES["dsi_wire_decode"] == (
        c_int, [p, c_int, i64, i64, i64, c_int, p, p, p])
