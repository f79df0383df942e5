"""The port's grep tier 4 (kernel I) against the JAX package, on the CPU.

The NFA the port builds (``_build_table``) must be the reference's, its
bit-set form must round-trip, and the same seeded bytes through the
reference's ``nfa_kernel`` (jitted on the CPU) and the port's
``nfa_kernel`` (its plain version) must give equal flags, ``n_lines``
and ``overflow``, in every state bucket.  ``nfagrep_host_result`` is held
against the reference's and against ``re``; the cost model against its
contract on the CPU, on the card and under the pin.  ``nfa_model`` is
kernel I's design in numpy (block relations, in-group prefixes, the
decoupled look-back over groups of ``kernel_cases.NFA_GROUP_BYTES`` with
windows of 32, the re-walk), held against the reference on
``kernel_cases.nfa_cases`` under random and worst-case orders in which
the groups' results become visible.
"""

from __future__ import annotations

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsi_tpu.ops import nfak as jnfak
from dsi_tpu_torch import interop
from dsi_tpu_torch.interop import to_numpy
from dsi_tpu_torch.ops import grepk, nfak
from dsi_tpu_torch.ops.wordcount import _pad_pow2
from dsi_tpu_torch.utils.kernel_cases import NFA_GROUP_BYTES, nfa_cases

TEXT = (b"the quick brown fox\njumps over the lazy dogs\n"
        b"no match here\ncolour and color\nab ac abc abbbc\n"
        b"42 is the answer\n\nfox")

# (pattern, state bucket)
PATTERNS = [("ab*c", 16), ("colou?r", 16), ("[0-9]+", 16), ("^the", 16),
            ("dogs$", 16), ("x+$", 16), ("ab*c|fox", 16), ("b{1,3}?", 16),
            (r"\w+ \w+", 16), ("a{5,20}b", 32), ("qu+ick|dogs?$|o{2,12}", 32),
            ("a{20,40}b", 48), ("[a-z]{10,40}$", 48)]


def _oracle(data: bytes, pattern: str):
    return [ln for ln in data.decode().split("\n") if re.search(pattern, ln)]


def _lines_text(seed: int, n_lines: int = 120) -> bytes:
    """Lines of random lowercase words and digits, some long enough to
    span several 256-byte blocks, no trailing newline."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 ",
                            np.uint8)
    out = []
    for _ in range(n_lines):
        n = int(rng.choice([0, 3, 12, 40, 300]))
        out.append(letters[rng.integers(0, len(letters), n)].tobytes())
    return b"\n".join(out)


@pytest.mark.parametrize("pattern,bucket", PATTERNS)
def test_table_equals_reference_and_bits_round_trip(pattern, bucket):
    got = nfak.parse_nfa_pattern(pattern)
    want = jnfak.parse_nfa_pattern(pattern)
    assert got is not None and got[1] == want[1]
    table, v0 = nfak._build_table(*got)
    jtable, jv0 = jnfak._build_table(*want)
    assert table.shape == (256, bucket, bucket)
    assert np.array_equal(table, jtable) and np.array_equal(v0, jv0)
    bits, v0bits = interop.nfa_table_to_bits(jtable, jv0)
    assert bits.dtype == np.uint64 and bits.shape == (256, bucket)
    back, back_v0 = interop.nfa_table_from_bits(bits, v0bits)
    assert np.array_equal(back, jtable) and np.array_equal(back_v0, jv0)


@functools.lru_cache(maxsize=None)
def _jnfa(s_bucket: int, block: int, l_cap: int):
    return jax.jit(functools.partial(jnfak.nfa_kernel, s_bucket=s_bucket,
                                     block=block, l_cap=l_cap))


TEXTS = {
    "text": TEXT,
    # A $ match on a line followed by a line that does not match: the
    # end-latch must last one position.
    "dollar_then_miss": b"ends with dogs\nno\nxx dogs\nfoo\n",
    "blocks": _lines_text(7),  # many 256-byte blocks, no trailing newline
    "short_lines": b"ab\nc\n" * 200,  # overflows rung 0
}


@pytest.mark.parametrize("pattern,bucket", PATTERNS)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_nfa_kernel_matches_reference(name, pattern, bucket):
    table, v0 = nfak._build_table(*nfak.parse_nfa_pattern(pattern))
    buf = _pad_pow2(TEXTS[name])
    n = len(buf)
    for l_cap in grepk.line_cap_rungs(n):
        want = _jnfa(bucket, min(256, n), l_cap)(
            jnp.asarray(buf), jnp.asarray(table), jnp.asarray(v0))
        got = nfak.nfa_kernel(torch.from_numpy(buf), torch.from_numpy(table),
                              torch.from_numpy(v0), l_cap=l_cap)
        assert np.array_equal(to_numpy(got[0]), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])
        assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("pattern", [p for p, _ in PATTERNS] + [
    "a.*z", "^a.*c$", "f.x$", "z*fox|dogs?$", "ab*?c", "a{2", "x}y",
    "x{,2}s", "[0-9]{2}"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_nfagrep_matches_reference_and_re(name, pattern, monkeypatch):
    monkeypatch.setenv("DSI_NFA_DISPATCH", "device")
    data = TEXTS[name]
    got = nfak.nfagrep_host_result(data, pattern, device="cpu")
    assert got is not None
    assert got == jnfak.nfagrep_host_result(data, pattern)
    assert got == _oracle(data, pattern)


@pytest.mark.parametrize("pattern,data", [
    ("a*", TEXT), ("x*y*", TEXT), ("a{0,3}", TEXT), ("^$", TEXT),
    ("(ab)*", TEXT), ("a{3,2}", TEXT), ("{2}", TEXT), ("a**", TEXT),
    ("a|", TEXT), (r"\bword", TEXT), ("a" * 60, TEXT), ("a{1,60}", TEXT),
    ("fox+", b"a\x00b\nfox\n"), ("fox+", "café fox\n".encode()),
])
def test_nfagrep_declines_where_the_reference_does(pattern, data,
                                                   monkeypatch):
    monkeypatch.setenv("DSI_NFA_DISPATCH", "device")
    assert jnfak.nfagrep_host_result(data, pattern) is None
    assert nfak.nfagrep_host_result(data, pattern, device="cpu") is None


def test_cost_model_pins_and_defaults(monkeypatch, tmp_path):
    """The pin decides; without one and without an entry, the card says
    no (as the reference's accelerator does) and the CPU calibrates."""
    monkeypatch.setattr(nfak, "_cost_path", lambda: tmp_path / "cost.json")
    monkeypatch.setenv("DSI_NFA_DISPATCH", "host")
    assert nfak.tier4_preferred(16, device="cpu") is False
    assert nfak.nfagrep_host_result(TEXT, "ab*c", device="cpu") is None
    monkeypatch.setenv("DSI_NFA_DISPATCH", "device")
    assert nfak.tier4_preferred(16, device="cpu") is True
    monkeypatch.delenv("DSI_NFA_DISPATCH")
    # The card, with no calibration on file: host re.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    assert nfak.tier4_preferred(16, device="cuda") is False
    assert not (tmp_path / "cost.json").exists()


def test_cost_model_cpu_calibrates_persists_and_routes(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(nfak, "_cost_path", lambda: tmp_path / "cost.json")
    monkeypatch.delenv("DSI_NFA_DISPATCH", raising=False)
    first = nfak.tier4_preferred(16, device="cpu")
    costs = nfak._load_costs()
    key = nfak._cost_key(16, torch.device("cpu"))
    entry = costs[key]
    assert entry["quick"] is True and entry["host_mbps"] > 0
    assert first == (entry["kernel_mbps"] > entry["host_mbps"])
    # A persisted entry decides without measuring again, either way.
    for kernel_wins in (True, False):
        costs[key] = {"host_mbps": 1.0,
                      "kernel_mbps": 2.0 if kernel_wins else 0.5}
        (tmp_path / "cost.json").write_text(__import__("json").dumps(costs))
        assert nfak.tier4_preferred(16, device="cpu") is kernel_wins
    # Another card's entry is not this one's.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    assert nfak._cost_key(16, torch.device("cuda")) != key
    assert nfak.tier4_preferred(16, device="cuda") is False


def test_calibration_patterns_fill_their_buckets():
    for bucket, pat in nfak._CAL_PATTERNS.items():
        assert nfak._bucket(nfak.parse_nfa_pattern(pat)[1]) == bucket
    assert nfak._cal_text(50) == jnfak._cal_text(50)


# ── kernel I's design as a numpy model ───────────────────────────────────

_BLK, _WINDOW = 256, 32
NFA_CASES = {c[0]: c[1:] for c in nfa_cases()}


def _step(v: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """v [B, S'] u64 bit sets, each through its relation rows [B, S] u64
    (or one for all, B = 1): the union of the rows of the states set."""
    acc = np.zeros(v.shape, np.uint64)
    for s in range(rows.shape[-1]):
        has = ((v >> np.uint64(s)) & np.uint64(1)).astype(bool)
        acc |= np.where(has, rows[..., s:s + 1], np.uint64(0))
    return acc


def _vstep(v: int, rows: np.ndarray) -> int:
    """One vector through one relation [S] u64."""
    return int(_step(np.array([[v]], np.uint64), rows[None, :])[0, 0])


def _byte_tables(bits: np.ndarray) -> np.ndarray:
    """[256, ceil(S / 8), 256] u64: for byte b, the union of the rows
    bits[b][8c + j] over the bits j set in an 8-bit index, so a step
    through a byte is one lookup per 8 states."""
    S = bits.shape[1]
    x = np.arange(256)
    out = np.zeros((256, -(-S // 8), 256), np.uint64)
    for c in range(out.shape[1]):
        sub = bits[:, 8 * c:8 * c + 8]
        has = ((x[:, None] >> np.arange(sub.shape[1])) & 1).astype(bool)
        out[:, c, :] = np.bitwise_or.reduce(
            np.where(has[None], sub[:, None, :], np.uint64(0)), axis=-1)
    return out


def _byte_step(v: np.ndarray, tables: np.ndarray, byte: np.ndarray):
    """v [B, K] u64 bit sets, each through the table row of its byte
    [B]."""
    acc = np.zeros(v.shape, np.uint64)
    for c in range(tables.shape[1]):
        part = ((v >> np.uint64(8 * c)) & np.uint64(255)).astype(np.intp)
        acc |= tables[byte[:, None], c, part]
    return acc


def nfa_model(buf: np.ndarray, bits: np.ndarray, v0: int, visible):
    """Kernel I's latch mask for ``buf``: ``visible(g, p)`` says whether
    group ``p``'s inclusive vector is published when group ``g`` looks
    back (group 0's always is).  Returns (mask [n] bool, the entry vector
    of every group)."""
    n, S = len(buf), bits.shape[1]
    per = NFA_GROUP_BYTES // _BLK
    nb = -(-n // _BLK)
    blocks = np.zeros((nb, _BLK), np.uint8)
    blocks.reshape(-1)[:n] = buf
    lens = np.minimum(_BLK, n - _BLK * np.arange(nb))
    eye = np.uint64(1) << np.arange(S, dtype=np.uint64)
    tables = _byte_tables(bits)
    # (1) block relations: every state row walked through its block.
    rel = np.broadcast_to(eye, (nb, S)).copy()
    for i in range(_BLK):
        nxt = _byte_step(rel, tables, blocks[:, i])
        rel = np.where((i < lens)[:, None], nxt, rel)
    # (2a) in-group exclusive prefixes and each group's aggregate, every
    # group's k-th block at once.
    m = -(-nb // per)
    pre = np.zeros((nb, S), np.uint64)
    agg = np.broadcast_to(eye, (m, S)).copy()
    for k in range(per):
        at = np.arange(m) * per + k
        live = at < nb
        pre[at[live]] = agg[live]
        agg[live] = _step(agg[live], rel[at[live]])
    # (2b) the decoupled look-back, window by window.
    inc, entry, chain = {}, [], v0
    for g in range(m):
        if g == 0:
            v = v0
        else:
            comp, j = eye.copy(), g - 1
            while True:
                words = [("inc", v0) if j - q < 0 else
                         ("inc", inc[j - q]) if visible(g, j - q) else
                         ("agg", None) for q in range(_WINDOW)]
                q0 = next((q for q, w in enumerate(words) if w[0] == "inc"),
                          None)
                if q0 is not None:
                    v = words[q0][1]
                    for p in range(j - q0 + 1, j + 1):
                        v = _vstep(v, agg[p])
                    v = _vstep(v, comp)
                    break
                rows = eye.copy()
                for p in range(j - _WINDOW + 1, j + 1):
                    rows = _step(rows[None, :], agg[p][None, :])[0]
                comp = _step(rows[None, :], comp[None, :])[0]
                j -= _WINDOW
        assert v == chain  # the plain chain of aggregates from v0
        entry.append(v)
        inc[g] = chain = _vstep(v, agg[g])
    # (3) the re-walk from every block's entry, v_g . P_k.
    v = _step(np.array(entry, np.uint64)[np.arange(nb) // per][:, None],
              pre)
    latch = np.zeros((nb, _BLK), bool)
    for i in range(_BLK):
        nxt = _byte_step(v, tables, blocks[:, i])
        v = np.where((i < lens)[:, None], nxt, v)
        latch[:, i] = (((v[:, 0] >> np.uint64(S - 1))
                        | (v[:, 0] >> np.uint64(S - 2)))
                       & np.uint64(1)).astype(bool)
    return latch.reshape(-1)[:n], entry


@pytest.mark.parametrize("name", sorted(NFA_CASES))
def test_nfa_model_matches_reference(name):
    buf, pattern, bucket, l_cap = NFA_CASES[name]
    table, v0 = nfak._build_table(*nfak.parse_nfa_pattern(pattern))
    assert table.shape[1] == bucket
    bits, v0bits = interop.nfa_table_to_bits(table, v0)
    rng = np.random.default_rng(len(buf))
    last = -(-len(buf) // NFA_GROUP_BYTES) - 1
    seen = {}

    def visible(g, p):  # each group's own random view; the last sees none
        if g == last and g > 1:
            return p == 0
        return seen.setdefault((g, p), bool(rng.random() < 0.3)) or p == 0

    mask, entry = nfa_model(buf, bits, int(v0bits), visible)
    got = grepk.line_flags_from_match(torch.from_numpy(buf),
                                      torch.from_numpy(mask), l_cap)
    want = _jnfa(bucket, min(256, len(buf)), l_cap)(
        jnp.asarray(buf), jnp.asarray(table), jnp.asarray(v0))
    assert np.array_equal(to_numpy(got[0]), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])
    assert bool(got[2]) == bool(want[2])
    if name == "34_groups_s16":
        assert len(entry) == 34  # the last group composes a whole window


def test_nfa_c_interface():
    """``dsi_nfa`` takes the float table and start vector (its first
    launch makes the bit sets) and the phases to run; ``chip_smoke.py``
    reads I's group through ``dsi_nfa_group_bytes``."""
    import ctypes

    from dsi_tpu_torch.kernels import build

    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert build.SIGNATURES["dsi_nfa"] == (
        c_int, [p, i64, p, c_int, p, i64, p, p, p, c_int, p])
    assert build.SIGNATURES["dsi_nfa_scratch_bytes"] == (i64, [i64, c_int])
    assert build.SIGNATURES["dsi_nfa_group_bytes"] == (i64, [])
