"""The port's whole-corpus word count against the JAX package, on the CPU.

``corpus_kernel`` output vectors must equal ``dsi_tpu``'s bit for bit at
equal static shapes; ``corpus_wordcount`` + ``write_corpus_output`` must
write ``mr-out-*`` bytes equal to the JAX path's and to the sequential
oracle's.  All outputs are integers or bytes: the tolerance is exact.
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

from dsi_tpu.apps import wc as jax_wc
from dsi_tpu.mr.sequential import run_sequential as jax_run_sequential
from dsi_tpu.ops import corpus_wc as jc
from dsi_tpu.utils.corpus import ensure_corpus as jax_ensure_corpus
from dsi_tpu.utils.jaxcompat import x64_scoped
from dsi_tpu_torch.apps import wc as torch_wc
from dsi_tpu_torch.interop import to_numpy, to_tensor
from dsi_tpu_torch.mr.sequential import run_sequential
from dsi_tpu_torch.ops import corpus_wc as tc
from dsi_tpu_torch.utils.corpus import ensure_corpus

_jax_corpus_kernel = x64_scoped(jax.jit(
    jc.corpus_kernel,
    static_argnames=("max_word_len", "u_cap", "t_cap_frac", "grouper")))


def _texts(seed: int, n: int):
    """n ASCII texts of under 4 KiB each, with repeats across texts."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(1, 20)))
                   .astype(np.uint8)) for _ in range(300)]
    vocab.append(b"Q" * 30)  # wider than 16: the max_word_len 64 rung
    out = []
    for _ in range(n):
        words = [vocab[i] for i in rng.integers(0, len(vocab), 400)]
        out.append(b" ".join(words)[:4000])
    return out


@pytest.mark.parametrize("mwl,u_cap,frac", [
    (16, 1 << 12, 4), (64, 1 << 12, 4), (16, 64, 2), (16, 1 << 12, 16)])
def test_corpus_kernel_matches_jax(mwl, u_cap, frac):
    buf, n_pieces = tc.pack_pieces(_texts(mwl + u_cap, 3), 4096)
    pieces = [buf[i * 4096:(i + 1) * 4096] for i in range(n_pieces)]
    want = np.asarray(_jax_corpus_kernel(
        *(jnp.asarray(p) for p in pieces), max_word_len=mwl, u_cap=u_cap,
        t_cap_frac=frac, grouper="sort"))
    got = tc.corpus_kernel(*(to_tensor(p) for p in pieces), max_word_len=mwl,
                           u_cap=u_cap, t_cap_frac=frac)
    assert want.dtype == np.uint32
    assert np.array_equal(to_numpy(got, np.uint32), want)


def _out_bytes(workdir: str):
    return [Path(p).read_bytes()
            for p in sorted(glob.glob(os.path.join(workdir, "mr-out-*")))]


def _sorted_lines(blobs):
    return sorted(x for b in blobs for x in b.split(b"\n") if x)


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    files = ensure_corpus(str(d), n_files=4, file_size=64 << 10, seed=1234)
    return files, [Path(p).read_bytes() for p in files]


def test_ensure_corpus_bytes_equal_jax(small_corpus, tmp_path):
    files, raws = small_corpus
    jfiles = jax_ensure_corpus(str(tmp_path), n_files=4, file_size=64 << 10,
                               seed=1234)
    assert [Path(p).read_bytes() for p in jfiles] == raws


def test_mr_out_equal_jax_and_oracle(small_corpus, tmp_path):
    files, raws = small_corpus
    port = tc.corpus_wordcount(raws, device="cpu")
    ref = jc.corpus_wordcount(raws, grouper="sort", use_aot=False)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tc.write_corpus_output(port, 10, str(tmp_path / "port"))
    jc.write_corpus_output(ref, 10, str(tmp_path / "jax"))
    port_out = _out_bytes(str(tmp_path / "port"))
    assert len(port_out) == 10
    assert port_out == _out_bytes(str(tmp_path / "jax"))
    oracle = run_sequential(torch_wc.Map, torch_wc.Reduce, files,
                            str(tmp_path / "mr-correct.txt"))
    jax_oracle = jax_run_sequential(jax_wc.Map, jax_wc.Reduce, files,
                                    str(tmp_path / "mr-correct-jax.txt"))
    oracle_bytes = Path(oracle).read_bytes()
    assert oracle_bytes == Path(jax_oracle).read_bytes()
    assert _sorted_lines(port_out) == _sorted_lines([oracle_bytes])
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("extra", [b" caf\xc3\xa9 ", b" " + b"z" * 65 + b" "])
def test_host_path_escapes_match_jax(small_corpus, extra):
    raws = list(small_corpus[1][:1])
    raws[0] = raws[0][:5000] + extra
    assert tc.corpus_wordcount(raws, device="cpu") is None
    assert jc.corpus_wordcount(raws, grouper="sort", use_aot=False) is None


def test_forty_letter_word_takes_the_wide_rung(small_corpus, tmp_path):
    raws = [r[:20000] for r in small_corpus[1][:2]]
    raws[1] += b" " + b"w" * 40
    res = tc.corpus_wordcount(raws, device="cpu")
    tc.write_corpus_output(res, 10, str(tmp_path))
    want = {}
    for r in raws:
        for w in torch_wc.tokenize(r.decode()):
            want[w] = want.get(w, 0) + 1
    assert _sorted_lines(_out_bytes(str(tmp_path))) == sorted(
        f"{w} {c}".encode() for w, c in want.items())


def test_empty_corpus():
    res = tc.corpus_wordcount([], device="cpu")
    assert res is not None and len(res.cnt) == 0


def test_corpus_entry_point_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.corpus_wordcount([b"alpha beta"])


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.uint32, np.int64,
                                   np.uint64])
def test_interop_round_trip(dtype):
    info = np.iinfo(dtype)
    a = np.array([info.min, 0, 1, info.max // 2, info.max], dtype=dtype)
    a.setflags(write=False)  # the JAX package hands out read-only arrays
    t = to_tensor(a)
    assert t.dtype == {np.uint32: torch.int32, np.uint64: torch.int64}.get(
        dtype, torch.from_numpy(np.zeros(1, dtype)).dtype)
    back = to_numpy(t, dtype if dtype in (np.uint32, np.uint64) else None)
    assert back.dtype == a.dtype and np.array_equal(back, a)
