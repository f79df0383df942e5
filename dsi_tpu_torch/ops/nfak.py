"""Grep tier 4: variable-length regex as a Glushkov NFA scan, on the card.

Port of ``dsi_tpu/ops/nfak.py``.  Tiers 1-3 cover fixed-length patterns;
this tier runs ``* + ?``, bounded reps ``{m}``/``{m,}``/``{m,n}``
(expanded into optional atoms), their non-greedy forms (existence per
line does not depend on greediness) and top-level alternations mixing
them.  Groups, backrefs and nullable patterns decline to the host app.

The pattern compiles on the host to an NFA of S <= 48 states and a
``[256, S, S]`` boolean transition table (row-vector convention: v' = v @
M[byte]) and a start vector, as in the reference.  Kernel I
(``csrc/nfa.cu``) turns the table into bit-set form on the card — one u64
row mask per (byte, state), as :func:`nfa_table_bits` — and computes the
same per-position latch as the reference's three phases (per-block
products, an exclusive prefix across blocks, here a decoupled look-back
over groups of blocks, and a per-block re-walk), then kernel H's
line-flag epilogue.  The table is a runtime argument: one build serves
every pattern.

Whether an eligible pattern runs on the kernel at all is the tier-4 cost
model's call (:func:`tier4_preferred`), with its own cost file
``build/dsi_tpu_torch/nfa_cost.json`` keyed by the device (the card's
name and ``torch.version.cuda``).  Inputs containing NUL route to the
host (NUL is a line end for the automaton but not for ``re``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from dsi_tpu_torch.kernels.build import BUILD_DIR
from dsi_tpu_torch.ops.altk import split_top_level
from dsi_tpu_torch.ops.grepk import (
    line_cap_rungs,
    line_flags_from_match,
    lines_from_flags,
    retry_line_caps,
)
from dsi_tpu_torch.ops.regexk import ATOM_REJECT, atom_members
from dsi_tpu_torch.ops.wordcount import (
    _launch,
    _lib,
    _on_cuda,
    _on_device,
    _pad_pow2,
    _ptr,
    _require,
    _stream,
    resolve_device,
    to_device,
)

#: State-count buckets (compiled-program granularity): S = 4 fixed
#: states + one per pattern atom, rounded up to the smallest bucket.
_S_BUCKETS = (16, 32, 48)
#: Fixed state indices: 0 = always-alive sentinel, 1 = line-start state,
#: atoms at 2..., end-latch = bucket-2, latch = bucket-1 (_build_table).
_S_ANY, _S_LINE = 0, 1
#: Bytes that end a line for the automaton: newline and the chunk's
#: zero padding.
_LINE_END = (0, 10)


class _Atom:
    __slots__ = ("bitmap", "nullable", "repeat")

    def __init__(self, bitmap: np.ndarray, mod: str):
        self.bitmap = bitmap            # [256] bool, False at 0 and 10
        self.nullable = mod in ("?", "*")   # NOT `mod in "?*"`: '' is a
        self.repeat = mod in ("+", "*")     # substring of every string


def _parse_branch(branch: str):
    """One alternation branch -> (atoms, anchor_start, anchor_end) or
    None.  Anchors bind per branch, exactly re's loosest-| semantics."""
    if not branch or not all(0x01 <= ord(c) <= 0x7E for c in branch):
        return None
    a_start = branch.startswith("^")
    if a_start:
        branch = branch[1:]
    a_end = branch.endswith("$") and not branch.endswith("\\$")
    if a_end:
        branch = branch[:-1]
    if not branch:
        return None
    atoms: List[_Atom] = []
    i = 0
    while i < len(branch):
        if branch[i] in ATOM_REJECT and branch[i] not in "{}":
            # Groups, stray anchors — and a modifier with no atom before
            # it ('*a'), which re rejects as an error.  Braces fall
            # through: a lone '}' is a literal in re, and '{' is handled
            # just below.
            return None
        if branch[i] == "{":
            peek, pi = _parse_bounded_rep(branch, i)
            if peek is not None or pi < 0:
                # A VALID rep shape with nothing to repeat: re errors
                # ("nothing to repeat") — host owns it.  An invalid body
                # ('{2,x}') is a literal brace in re; fall through and
                # parse it as a literal atom.
                return None
        parsed = atom_members(branch, i)
        if parsed is None:
            return None
        members, i = parsed
        mod = ""
        reps: Optional[Tuple[int, int]] = None  # (min, max); max<0 = inf
        if i < len(branch) and branch[i] in "*+?":
            mod = branch[i]
            i += 1
        elif i < len(branch) and branch[i] == "{":
            reps, i = _parse_bounded_rep(branch, i)
            if reps is None and i < 0:
                return None  # malformed in a way re also rejects
            if reps is not None and max(reps) > _S_BUCKETS[-1]:
                # Reject oversized counts BEFORE the expansion loop: the
                # parse runs in every worker task on every platform, and
                # 'a{2000000000}' must fail in microseconds, not expand.
                return None
        if (mod or reps is not None) and i < len(branch) \
                and branch[i] == "?":
            # Non-greedy (*? +? ?? {m,n}?): greediness affects WHICH
            # match is found, never WHETHER one exists, and per-line
            # flags only need existence — greedy-equivalent here.
            i += 1
        if (mod or reps is not None) and i < len(branch) \
                and branch[i] in "*+?":
            return None  # stacked modifiers: host
        members = members - {0, 10}
        if not members and mod not in ("?", "*") and (
                reps is None or reps[0] > 0):
            return None  # required atom can only match padding/newline
        bitmap = np.zeros(256, bool)
        bitmap[list(members)] = True
        if reps is None:
            atoms.append(_Atom(bitmap, mod))
        else:
            # X{m,n} expands to m required copies + (n-m) optional ones;
            # X{m,} to m copies with the last one repeating.  The atom
            # budget (state bucket) naturally bounds the expansion.
            lo, hi = reps
            for _ in range(lo):
                atoms.append(_Atom(bitmap, ""))
            if hi < 0:
                if lo == 0:
                    atoms.append(_Atom(bitmap, "*"))
                else:
                    atoms[-1] = _Atom(bitmap, "+")
            else:
                for _ in range(hi - lo):
                    atoms.append(_Atom(bitmap, "?"))
        if len(atoms) > _S_BUCKETS[-1]:
            return None  # expansion exceeds the largest state bucket
    if all(a.nullable for a in atoms):
        return None  # nullable pattern matches EVERY line: host owns it
    return atoms, a_start, a_end


def _parse_bounded_rep(branch: str, i: int):
    """Parse ``{m}``, ``{m,}``, or ``{m,n}`` at ``branch[i]``.

    Returns ``((lo, hi), next_i)`` with ``hi == -1`` for unbounded, or
    ``(None, i)`` when the brace is not a valid bounded rep (re then
    treats it as a literal '{' — the caller re-parses it as an atom), or
    ``(None, -1)`` for ``{m,n}`` with ``m > n`` (re raises: host)."""
    j = branch.find("}", i)
    if j == -1:
        return None, i
    body = branch[i + 1:j]
    parts = body.split(",")
    if not all(p.isdigit() or p == "" for p in parts) or len(parts) > 2:
        return None, i
    if len(parts) == 1:
        if not parts[0]:
            return None, i  # bare '{}' is a literal brace pair in re
        lo = hi = int(parts[0])
    else:
        # re treats '{,n}' as the quantifier {0,n} (and '{,}' as {0,})
        # on every supported interpreter — "omitting m specifies a lower
        # bound of zero" has been documented re behavior since long
        # before 3.10 (verified against re/_parser.py's brace parse).
        lo = int(parts[0]) if parts[0] else 0
        hi = -1 if parts[1] == "" else int(parts[1])
    if hi >= 0 and lo > hi:
        return None, -1
    return (lo, hi), j + 1


def parse_nfa_pattern(pat: str):
    """Full pattern -> (branches, n_atoms) or None, where each branch is
    (atoms, anchor_start, anchor_end)."""
    raw = split_top_level(pat)
    if raw is None:
        return None
    branches = []
    total = 0
    for b in raw:
        parsed = _parse_branch(b)
        if parsed is None:
            return None
        branches.append(parsed)
        total += len(parsed[0])
    if total + 4 > _S_BUCKETS[-1]:
        return None  # pattern too wide for the largest state bucket
    return branches, total


def _bucket(n_atoms: int) -> int:
    need = n_atoms + 4
    for s in _S_BUCKETS:
        if need <= s:
            return s
    raise AssertionError("parse_nfa_pattern admitted an oversized pattern")


def _build_table(branches, n_atoms: int) -> Tuple[np.ndarray, np.ndarray]:
    """Glushkov NFA -> ([256, S, S] float32 transition table, [S] float32
    start vector).  Row-vector convention: v' = v @ M[byte]."""
    S = _bucket(n_atoms)
    latch = S - 1       # persisting: set mid-line, dies at newline
    end_latch = S - 2   # one-position: set BY a line-end byte for $
    M = np.zeros((256, S, S), np.float32)
    content = np.ones(256, bool)
    content[list(_LINE_END)] = False

    # Fixed machinery: the sentinel is always alive; the line-start state
    # is entered (from the sentinel) by every line-end byte; the latch
    # survives every byte except newline (padding keeps the final line's
    # verdict alive for segment_max).
    M[:, _S_ANY, _S_ANY] = 1.0
    for b in _LINE_END:
        M[b, _S_ANY, _S_LINE] = 1.0
    M[content, latch, latch] = 1.0
    M[0, latch, latch] = 1.0

    pos = 2  # first atom state index
    for atoms, a_start, a_end in branches:
        idx = list(range(pos, pos + len(atoms)))
        pos += len(atoms)

        def successors(i: int) -> List[int]:
            out = []
            if atoms[i].repeat:
                out.append(i)
            j = i + 1
            while j < len(atoms):
                out.append(j)
                if not atoms[j].nullable:
                    break
                j += 1
            return out

        firsts = []
        for j, a in enumerate(atoms):
            firsts.append(j)
            if not a.nullable:
                break
        lasts = []
        for j in range(len(atoms) - 1, -1, -1):
            lasts.append(j)
            if not atoms[j].nullable:
                break
        last_set = set(lasts)

        # Start edges: anchored branches begin only at line starts;
        # unanchored also from the always-alive sentinel (match can
        # start anywhere).
        srcs = [_S_LINE] if a_start else [_S_ANY, _S_LINE]
        edges = [(s, j) for s in srcs for j in firsts]
        edges += [(idx[i], j) for i in range(len(atoms))
                  for j in successors(i)]
        for src, j in edges:
            bm = atoms[j].bitmap
            M[bm, src, idx[j]] = 1.0
            if j in last_set and not a_end:
                # Entering an accepting position completes a match.
                M[bm, src, latch] = 1.0
        if a_end:
            # $-anchored: the match completes only when a line-end byte
            # arrives while an accepting position is active.  It must
            # set the ONE-POSITION end-latch, not the persisting latch:
            # a latch born at the newline would survive through (and
            # falsely flag) the entire NEXT line, since the persisting
            # latch only dies at newlines.
            for j in last_set:
                for b in _LINE_END:
                    M[b, idx[j], end_latch] = 1.0

    v0 = np.zeros(S, np.float32)
    v0[_S_ANY] = 1.0
    v0[_S_LINE] = 1.0
    return M, v0


def nfa_table_bits(table: torch.Tensor, v0: torch.Tensor):
    """The kernel's bit-set form of a ``[256, S, S]`` table and ``[S]``
    start vector: ``bits[b, s]`` (int64 holding u64) has bit t set when
    ``table[b, s, t] > 0``; ``v0bits`` [1] has bit s set when ``v0[s] >
    0``.  S <= 48, so bit 63 is never set.  Torch ops on the tensors'
    device."""
    s = table.shape[1]
    w = torch.ones(s, dtype=torch.int64, device=table.device) << torch.arange(
        s, dtype=torch.int64, device=table.device)
    bits = ((table > 0).to(torch.int64) * w).sum(-1)
    v0bits = ((v0 > 0).to(torch.int64) * w).sum().reshape(1)
    return bits.contiguous(), v0bits


def nfa_kernel_plain(chunk: torch.Tensor, table: torch.Tensor,
                     v0: torch.Tensor, *, l_cap: int):
    """Plain version of kernel I: the reference's three phases in torch
    float (boolean products as ``matmul > 0``), then
    :func:`~dsi_tpu_torch.ops.grepk.line_flags_from_match`."""
    n = chunk.shape[0]
    s = table.shape[1]
    k = min(256, n)
    nb = n // k
    cols = chunk.reshape(nb, k).to(torch.int64)
    eye = torch.eye(s, dtype=torch.float32, device=chunk.device)
    # 1: per-block transition matrices.
    blocks = eye.expand(nb, s, s)
    for j in range(k):
        blocks = (torch.bmm(blocks, table[cols[:, j]]) > 0).float()
    # 2: inclusive prefix products across blocks (Hillis-Steele, log
    # depth, earlier blocks on the left), shifted to exclusive.
    pref = blocks
    d = 1
    while d < nb:
        pref = torch.cat([pref[:d],
                          (torch.bmm(pref[:-d], pref[d:]) > 0).float()])
        d *= 2
    entry = torch.cat([eye[None], pref[:-1]])
    v = (torch.einsum("s,bst->bt", v0, entry) > 0).float()
    # 3: per-block re-walk; either latch flavor flags the position.
    latch = torch.empty((nb, k), dtype=torch.float32, device=chunk.device)
    for j in range(k):
        v = (torch.bmm(v[:, None], table[cols[:, j]])[:, 0] > 0).float()
        latch[:, j] = torch.maximum(v[:, s - 1], v[:, s - 2])
    return line_flags_from_match(chunk, latch.reshape(n) > 0, l_cap)


def nfa_kernel(chunk: torch.Tensor, table: torch.Tensor, v0: torch.Tensor,
               *, l_cap: int):
    """Kernel I (``csrc/nfa.cu``); see :func:`nfa_kernel_plain`.  ``table``
    [256, S, S] float32 and ``v0`` [S] float32 lie on the chunk's device;
    on the card the kernel's first launch turns them into the bit-set
    form.  Returns (line_match [l_cap] int32 in line order, n_lines int32,
    overflow bool), the shared tier contract."""
    _require(chunk, torch.uint8, 1, "nfa chunk")
    n = chunk.shape[0]
    s = table.shape[1]
    if (n < 1 or n % min(256, n) or l_cap < 1 or s not in _S_BUCKETS
            or tuple(table.shape) != (256, s, s) or tuple(v0.shape) != (s,)):
        raise ValueError(f"nfa: bad shapes n={n} table={tuple(table.shape)} "
                         f"v0={tuple(v0.shape)} l_cap={l_cap}")
    _require(table, torch.float32, 3, "nfa table")
    _require(v0, torch.float32, 1, "nfa v0")
    if not _on_cuda(chunk):
        return nfa_kernel_plain(chunk, table, v0, l_cap=l_cap)
    return nfa_launch(chunk, table, v0, l_cap, 3)


def nfa_launch(chunk, table, v0, l_cap: int, phases: int):
    """One C call of kernel I on checked card tensors: one allocation
    (line_match, the two scalars, the scratch), no host sync.  ``phases``
    3 runs everything; 1 or 2 stops the scan after that phase and leaves
    the outputs unwritten, so ``chip_smoke.py`` can time each phase."""
    lib = _lib()
    n, s = chunk.shape[0], table.shape[1]
    with _on_device(chunk.device):
        buf = torch.empty(4 * (l_cap + 2) + lib.dsi_nfa_scratch_bytes(n, s),
                          dtype=torch.uint8, device=chunk.device)
        _launch("nfa", lib.dsi_nfa(
            _ptr(chunk), n, _ptr(table), s, _ptr(v0), l_cap, _ptr(buf),
            _ptr(buf) + 4 * l_cap, _ptr(buf) + 4 * (l_cap + 2), phases,
            _stream(chunk)))
    out = buf[:4 * (l_cap + 1)].view(torch.int32)
    # The overflow word is 0 or 1: its low byte, viewed as bool, needs no
    # launch.
    at = 4 * (l_cap + 1)
    return out[:l_cap], out[l_cap], buf[at:at + 1].view(torch.bool)[0]


# ── the tier-4 cost model ───────────────────────────────────────────────


def _cost_path():
    return BUILD_DIR / "nfa_cost.json"


def _load_costs() -> dict:
    try:
        with open(_cost_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cost(key: str, entry: dict) -> None:
    """Temp file + rename, no fsync: a lost entry just measures again."""
    path = _cost_path()
    costs = _load_costs()
    costs[key] = entry
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(costs, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # cost persistence is an optimization, never a failure


def _cost_key(s_bucket: int, dev: torch.device) -> str:
    """One entry per (device, state bucket): on the card, its name and
    the CUDA version torch was built with."""
    if dev.type == "cuda":
        ident = f"{torch.cuda.get_device_name(dev)}|{torch.version.cuda}"
    else:
        ident = f"cpu|{torch.__version__}"
    fp = hashlib.sha256(ident.encode()).hexdigest()[:8]
    return f"{dev.type}-{fp}|s{s_bucket}"


#: Representative calibration pattern per state bucket (must parse into
#: that bucket: atoms + 4 rounded up — see _bucket).
_CAL_PATTERNS = {16: "qu+ick|dogs?$", 32: "a{5,20}b", 48: "a{20,40}b"}


def _cal_text(n_lines: int = 4000) -> bytes:
    lines = []
    for i in range(n_lines):
        lines.append(f"the quick{'k' * (i % 3)} brown fox jumped over "
                     f"line {'x' * (i % 17)} with dog{'s' * (i % 2)} and "
                     f"{'a' * (i % 31)}b tokens".encode())
    return b"\n".join(lines)


def calibrate_tier4(s_bucket: int, quick: bool = False,
                    device=None) -> dict:
    """Measure host ``re`` against the NFA kernel once for this (device,
    state bucket) and persist the result in the cost file.  ``quick=True``
    is the inline variant (about 8x less text, one timing rep) that
    :func:`tier4_preferred` runs on the CPU; the entry is marked
    ``{"quick": true}`` and a later full calibration overwrites it.
    Returns ``{"host_mbps", "kernel_mbps"[, "quick"]}``."""
    dev = resolve_device(device)
    pat = _CAL_PATTERNS[s_bucket]
    data = _cal_text(500 if quick else 4000)
    text = data.decode()
    rx = re.compile(pat)

    def best(f, reps=1 if quick else 3):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            f()
            out.append(time.perf_counter() - t0)
        return min(out)

    host_s = best(lambda: [ln for ln in text.split("\n") if rx.search(ln)])

    branches, n_atoms = parse_nfa_pattern(pat)
    if _bucket(n_atoms) != s_bucket:
        raise AssertionError(f"{pat!r} is not in bucket {s_bucket}")
    table_np, v0_np = _build_table(branches, n_atoms)
    chunk = to_device(_pad_pow2(data), dev)
    l_cap = line_cap_rungs(chunk.shape[0])[0]
    table = torch.from_numpy(table_np).to(dev)
    v0 = torch.from_numpy(v0_np).to(dev)

    def kernel():
        out = nfa_kernel(chunk, table, v0, l_cap=l_cap)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    kernel()  # warm outside the timed reps
    kern_s = best(kernel)

    mb = len(data) / 1e6
    entry = {"host_mbps": mb / host_s, "kernel_mbps": mb / kern_s}
    if quick:
        entry["quick"] = True  # lower-fidelity entry; a full one overwrites
    _save_cost(_cost_key(s_bucket, dev), entry)
    return entry


def tier4_preferred(s_bucket: int, device=None) -> bool:
    """Should an eligible variable-length pattern run on the kernel?

    ``DSI_NFA_DISPATCH=device|host`` pins the answer.  Otherwise the
    persisted calibration for this (device, bucket) decides; with no
    entry, the CPU calibrates on the spot with the bounded quick variant
    and the card answers False, as the reference answers on an
    accelerator: device dispatch stays opt-in until a calibration on the
    card (``calibrate_tier4``) shows the kernel beating host ``re``."""
    dev = resolve_device(device)
    pin = os.environ.get("DSI_NFA_DISPATCH")
    if pin in ("device", "host"):
        return pin == "device"
    entry = _load_costs().get(_cost_key(s_bucket, dev))
    if entry is None:
        if dev.type != "cpu":
            return False
        entry = calibrate_tier4(s_bucket, quick=True, device=dev)
    return entry["kernel_mbps"] > entry["host_mbps"]


def nfagrep_host_result(data: bytes, pattern: str,
                        device=None) -> Optional[List[str]]:
    """Matching lines of ``data`` (split on '\\n', in order), or None
    when the pattern or data needs the host regex path (or the cost model
    prefers host ``re``).  Same retry discipline as the other tiers."""
    dev = resolve_device(device)
    parsed = parse_nfa_pattern(pattern)
    if parsed is None:
        return None
    if b"\x00" in data:
        return None  # NUL inside a line would disagree with host re
    try:
        text = data.decode("ascii")
    except UnicodeDecodeError:
        return None
    branches, n_atoms = parsed
    if not tier4_preferred(_bucket(n_atoms), dev):
        return None  # measured slower than host re here: host serves it
    table_np, v0_np = _build_table(branches, n_atoms)
    # _pad_pow2 guarantees >= 1 trailing zero — the line-end byte the $
    # latch and final-line handling depend on.
    chunk = to_device(_pad_pow2(data), dev)
    table = torch.from_numpy(table_np).to(dev)
    v0 = torch.from_numpy(v0_np).to(dev)
    line_match, nl = retry_line_caps(
        chunk.shape[0], lambda l_cap: nfa_kernel(chunk, table, v0,
                                                 l_cap=l_cap))
    return lines_from_flags(text, line_match, nl)
