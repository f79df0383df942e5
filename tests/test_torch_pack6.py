"""The port's 6-bit transport (K7) and upload modes against the JAX
package, on the CPU.

``pack6_encode`` is a host copy and must give the reference's bytes;
``pack6_decode_plain`` (kernel G's plain version) must undo it exactly,
so ``corpus_kernel_packed`` equals ``corpus_kernel`` on the same corpus
and equals the reference's packed program bit for bit.
``corpus_wordcount(pack6=True)`` must equal the raw transport under both
groupers, and fall back to raw bytes when the corpus uses more than 64
byte values.  ``ops/xfer.py put_views`` must move the same bytes in both
upload modes.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.ops import corpus_wc as jc
from dsi_tpu.utils.jaxcompat import x64_scoped
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.ops import corpus_wc as tc
from dsi_tpu_torch.ops import wordcount as tw
from dsi_tpu_torch.ops import xfer

_jax_packed = x64_scoped(jax.jit(
    jc.corpus_kernel_packed,
    static_argnames=("max_word_len", "u_cap", "t_cap_frac", "grouper")))

PIECE = 4096


def _texts(seed: int, n: int, alphabet: bytes = b"abcdefghijklmnopqrstuvwxyz"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    vocab = [letters[rng.integers(0, len(letters), int(rng.integers(1, 14)))]
             .tobytes() for _ in range(300)]
    seps = [b" ", b"\n", b", ", b". "]
    return [b"".join(vocab[i] + seps[i % 4]
                     for i in rng.integers(0, len(vocab), 500))[:4000]
            for _ in range(n)]


WIDE = (b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
        b"!?;:")  # 66 symbols with the separators and the zero padding


def _pieces(buf, size):
    return [buf[i * size:(i + 1) * size] for i in range(len(buf) // size)]


def test_pack6_encode_matches_reference():
    buf, _ = tc.pack_pieces(_texts(1, 3), PIECE)
    got = tc.pack6_encode(buf)
    want = jc.pack6_encode(buf)
    assert got is not None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) == len(buf) * 3 // 4
    wide, _ = tc.pack_pieces(_texts(2, 2, WIDE), PIECE)
    assert tc.pack6_encode(wide) is None and jc.pack6_encode(wide) is None


@pytest.mark.parametrize("case", ("corpus", "all_codes", "one_byte"))
def test_pack6_decode_plain_inverts_the_encoding(case):
    rng = np.random.default_rng(3)
    if case == "corpus":
        buf, _ = tc.pack_pieces(_texts(3, 2), PIECE)
    elif case == "all_codes":  # 64 symbols, every code used
        buf = rng.choice(np.arange(100, 164, dtype=np.uint8), 3 * PIECE)
    else:
        buf = np.full(PIECE, 0x61, np.uint8)
    wire, table = tc.pack6_encode(buf)
    got = tw.pack6_decode(to_tensor(wire), to_tensor(table))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(to_numpy(got), buf)
    np.testing.assert_array_equal(
        to_numpy(tw.pack6_decode_plain(to_tensor(wire), to_tensor(table))),
        buf)


@pytest.mark.parametrize("grouper", ("sort", "hash"))
@pytest.mark.parametrize("mwl", (16, 64))
def test_corpus_kernel_packed_matches_reference(mwl, grouper):
    buf, _ = tc.pack_pieces(_texts(mwl, 3), PIECE)
    wire, table = tc.pack6_encode(buf)
    wpieces = _pieces(wire, PIECE * 3 // 4)
    kw = dict(max_word_len=mwl, u_cap=1 << 12, t_cap_frac=4, grouper=grouper)
    want = np.asarray(_jax_packed(*(jnp.asarray(p) for p in wpieces),
                                  jnp.asarray(table), **kw))
    got = tc.corpus_kernel_packed(*(to_tensor(p) for p in wpieces),
                                  to_tensor(table), **kw)
    raw = tc.corpus_kernel(*(to_tensor(p) for p in _pieces(buf, PIECE)),
                           **kw)
    np.testing.assert_array_equal(to_numpy(got, np.uint32), want)
    np.testing.assert_array_equal(to_numpy(raw), to_numpy(got))


def _out_bytes(res, workdir):
    os.makedirs(workdir)
    tc.write_corpus_output(res, 10, workdir)
    return [Path(p).read_bytes()
            for p in sorted(glob.glob(os.path.join(workdir, "mr-out-*")))]


@pytest.mark.parametrize("wide", (False, True), ids=("pack6", "fallback"))
@pytest.mark.parametrize("grouper", ("sort", "hash"))
def test_corpus_wordcount_pack6_equals_raw_and_reference(grouper, wide,
                                                         tmp_path):
    raws = _texts(5, 3, WIDE if wide else b"abcdefghijklmnopqrstuvwxyz")
    raw = tc.corpus_wordcount(raws, grouper=grouper, device="cpu")
    got = tc.corpus_wordcount(raws, pack6=True, grouper=grouper,
                              device="cpu")
    want = jc.corpus_wordcount(raws, pack6=True, grouper=grouper,
                               use_aot=False)
    for res in (raw, want):
        np.testing.assert_array_equal(got.pos, res.pos)
        np.testing.assert_array_equal(got.lens, res.lens)
        np.testing.assert_array_equal(got.cnt, res.cnt)
    assert (_out_bytes(got, str(tmp_path / "p6"))
            == _out_bytes(raw, str(tmp_path / "raw")))


def test_pack6_decode_rejects_bad_shapes():
    table = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="pack6"):
        tw.pack6_decode(torch.zeros(10, dtype=torch.uint8), table)
    with pytest.raises(ValueError, match="pack6"):
        tw.pack6_decode(torch.zeros(12, dtype=torch.uint8), table[:32])


# ── ops/xfer.py ──────────────────────────────────────────────────────────


@pytest.fixture
def views():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, size=1 << 12, dtype=np.uint8)
            for _ in range(3)] + [np.arange(64, dtype=np.uint8)]


@pytest.mark.parametrize("mode", ("async", "sync", "banana"))
def test_put_views_round_trip(views, mode, monkeypatch):
    monkeypatch.setenv("DSI_UPLOAD_MODE", mode)
    before = xfer.stats["upload_s"]
    out = xfer.put_views(views, "cpu")
    assert len(out) == len(views)
    for host, dev in zip(views, out):
        assert dev.device.type == "cpu" and dev.dtype == torch.uint8
        np.testing.assert_array_equal(to_numpy(dev), host)
    assert xfer.stats["upload_mode"] == ("async" if mode == "banana"
                                         else mode)
    assert xfer.stats["upload_s"] >= before


def test_put_views_needs_the_card_by_default(views, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xfer.put_views(views)
