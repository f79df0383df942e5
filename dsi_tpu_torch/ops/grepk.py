"""Grep tier 1: literal substring search over a whole chunk, on the card.

Port of ``dsi_tpu/ops/grepk.py``.  The map hot loop of the grep app
(``apps/grep.py``: a per-line regex scan) becomes kernel H
(``csrc/grep.cu``): the match mask of every byte position, the line id of
each position (newlines strictly before it), and the per-line flags as a
segment max.  ``grep_kernel`` launches H for a literal; the class tier
(``ops/regexk.py``) launches the same kernel with byte ranges, the
alternation tier (``ops/altk.py``) with its branches packed into as few
calls as fit H's word (:func:`pack_branches`), and the NFA tier
(``ops/nfak.py``) reuses H's line-flag pass.  The pattern travels in the
launch's arguments (:func:`grep_spec`).

Scope: fixed printable-ASCII literals without regex metacharacters;
anything else declines (None) so the caller runs the host app, as in the
reference.  The reference's AOT readiness gates (``device_ready``,
``cold_ok``, ``grep_rung_ready``, ``_grep_compiled``) are not ported: the
port compiles no shape at dispatch (ROADMAP Queue 1, the build/warm
cache).  ``retry_line_caps`` keeps its ``ready=`` parameter.
"""

from __future__ import annotations

import functools
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

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

# A line with no position keeps the identity of jax.ops.segment_max on
# int32 (the chunk's last line when the chunk ends in a newline).
_EMPTY_LINE = torch.iinfo(torch.int32).min
# Kernel H's Shift-And word (csrc/grep.cu kItems): the positions of the
# branches of one call; a literal longer than it keeps the rest in its
# tail, in the launch's arguments up to _TAIL_INLINE bytes (kTailInline).
WORD_BITS = 32
_TAIL_INLINE = 2048
# csrc/grep.cu GrepSpec: table[256], keep, inj, inj_eol, last, last_bol,
# m_max, tail_len.
_SPEC = struct.Struct("<256I5I2i")


def shift_left(x: torch.Tensor, s: int) -> torch.Tensor:
    """``x`` shifted left by ``s`` positions, zero-filled: out[i] = x[i+s]
    (the reference's ``_shift_left``)."""
    if s == 0:
        return x
    tail = torch.zeros(min(s, x.shape[0]), dtype=x.dtype, device=x.device)
    return torch.cat([x[s:], tail])


def line_flags_from_match(chunk: torch.Tensor, match: torch.Tensor,
                          l_cap: int):
    """Plain version of kernel H's epilogue, shared by every tier:
    per-position match mask -> (line_match [l_cap] int32 in line order,
    n_lines int32, overflow bool).  Line membership is a cumsum over
    newline bytes, the flags a segment max (a line with no position keeps
    INT32_MIN, as ``jax.ops.segment_max`` leaves an empty segment)."""
    is_nl = (chunk == 10).to(torch.int64)
    cum = torch.cumsum(is_nl, 0)
    line_id = cum - is_nl  # newlines strictly before i
    n_lines = cum[-1] + 1
    seg = line_id.clamp(max=l_cap)
    line_match = torch.full((l_cap + 1,), _EMPTY_LINE, dtype=torch.int32,
                            device=chunk.device)
    line_match.scatter_reduce_(0, seg, match.to(torch.int32), reduce="amax")
    return line_match[:l_cap], n_lines.to(torch.int32), n_lines > l_cap


def line_cap_rungs(n: int):
    """The shared l_cap rung schedule: average line >= 8 bytes first,
    then the n+1 hard bound (every byte a '\\n')."""
    return (max(n // 8, 1), n + 1)


def retry_line_caps(n: int, run, ready=None):
    """Shared l_cap rung schedule (exactness_retry discipline).
    ``run(l_cap)`` -> (line_match, n_lines, overflow).  ``ready(l_cap)``,
    when given, gates every rung: a not-ready rung returns ``(None, -1)``
    and the caller serves the job on the host path."""
    for l_cap in line_cap_rungs(n):
        if ready is not None and not ready(l_cap):
            return None, -1
        line_match, n_lines, overflow = run(l_cap)
        if not bool(overflow):
            break
    return line_match, int(n_lines)


def lines_from_flags(text: str, line_match, nl: int) -> Optional[List[str]]:
    """Map line flags back to text lines; None on a host/device line-count
    disagreement (the host path decides)."""
    flags = line_match[:nl].cpu().numpy()
    lines = text.split("\n")
    if len(lines) != nl:
        return None
    return [lines[i] for i in range(nl) if flags[i]]


def grep_kernel_plain(chunk: torch.Tensor, pattern: bytes, *, l_cap: int):
    """Plain version of kernel H for a literal: ``len(pattern)`` shifted
    byte compares, then :func:`line_flags_from_match`."""
    match = torch.ones(chunk.shape[0], dtype=torch.bool, device=chunk.device)
    for j, b in enumerate(pattern):
        match &= shift_left(chunk, j) == b
    return line_flags_from_match(chunk, match, l_cap)


# A branch of a grep call: (positions, anchor_start, anchor_end), each
# position a tuple of (lo, hi) byte ranges; a literal is one single-byte
# range a position and no anchors.
Branch = Tuple[tuple, bool, bool]


@functools.lru_cache(maxsize=256)
def literal_branch(pattern: bytes) -> Branch:
    """The literal ``pattern`` as a :data:`Branch`."""
    return tuple(((b, b),) for b in pattern), False, False


def pack_branches(branches) -> List[tuple]:
    """``branches`` in order, cut into kernel H's calls: consecutive
    branches while their positions fit the word together, a literal
    longer than the word alone."""
    calls, cur, bits = [], [], 0
    for b in branches:
        m = len(b[0])
        if cur and bits + m > WORD_BITS:
            calls.append(tuple(cur))
            cur, bits = [], 0
        cur.append(b)
        bits += m
        if bits > WORD_BITS:
            calls.append(tuple(cur))
            cur, bits = [], 0
    if cur:
        calls.append(tuple(cur))
    return calls


@functools.lru_cache(maxsize=256)
def grep_spec(branches: tuple) -> Tuple[bytes, bytes]:
    """Kernel H's launch argument for the branches of one call: the packed
    ``GrepSpec`` of ``csrc/grep.cu`` and a long literal's bytes past the
    word (``b""`` otherwise).  Branch k takes bits [o_k, o_k + m_k) of the
    Shift-And word in reverse order: ``table[byte]`` has bit o_k + j set
    where the byte is accepted at position m_k - 1 - j, because the word
    runs backwards over the chunk and sets a branch's last bit where a
    match starts.  ``inj``/``inj_eol`` are the first bits of the branches
    without and with ``$``, ``last``/``last_bol`` the last bits of those
    without and with ``^``.  Raises ValueError for branches that do not fit
    one call (:func:`pack_branches` cuts them)."""
    if not branches:
        raise ValueError("grep: no branch")
    table = np.zeros(256, np.uint32)
    keep, inj, inj_eol, last, last_bol = 0xFFFFFFFF, 0, 0, 0, 0
    at = m_max = 0
    tail = b""
    for positions, anchor_start, anchor_end in branches:
        m = len(positions)
        if m > WORD_BITS:  # a literal: its first WORD_BITS bytes in the word
            rest = positions[WORD_BITS:]
            if (len(branches) > 1 or anchor_start or anchor_end or any(
                    len(rs) != 1 or rs[0][0] != rs[0][1] for rs in rest)):
                raise ValueError(f"grep: a branch of {m} positions must be "
                                 "a literal alone in its call")
            tail = bytes(rs[0][0] for rs in rest)
            positions, m = positions[:WORD_BITS], WORD_BITS
        if m < 1 or at + m > WORD_BITS:
            raise ValueError(f"grep: {at + m} positions in one call")
        for j, ranges in enumerate(positions):
            accept = np.zeros(256, bool)
            for lo, hi in ranges:
                if not 0 <= lo <= hi <= 255:
                    raise ValueError(f"grep: bad byte range ({lo}, {hi})")
                accept[lo:hi + 1] = True
            table[accept] |= np.uint32(1 << (at + m - 1 - j))
        first, lst = 1 << at, 1 << (at + m - 1)
        keep &= ~first
        if anchor_end:
            inj_eol |= first
        else:
            inj |= first
        if anchor_start:
            last_bol |= lst
        else:
            last |= lst
        m_max = max(m_max, m)
        at += m
    return (_SPEC.pack(*table.tolist(), keep, inj, inj_eol, last, last_bol,
                       m_max, len(tail)), tail)


@functools.lru_cache(maxsize=64)
def _grep_bytes(n: int, l_cap: int) -> int:
    return _lib().dsi_grep_bytes(n, l_cap)


def launch_grep(chunk: torch.Tensor, branches: tuple, *, l_cap: int):
    """Kernel H on a CUDA chunk for the branches of one call
    (:func:`grep_spec`): a memset and one kernel, one allocation (the
    flags, the two scalars and the look-back state), no host-to-device
    copy (but of a literal's bytes past the word beyond _TAIL_INLINE) and
    no host sync.  Returns (line_match [l_cap] int32, n_lines int32,
    overflow bool), views of that allocation."""
    spec, tail = grep_spec(branches)
    n = chunk.shape[0]
    dev = chunk.device
    tail_dev = None
    if len(tail) > _TAIL_INLINE:
        tail_dev = torch.frombuffer(bytearray(tail), dtype=torch.uint8).to(dev)
    with _on_device(dev):
        buf = torch.empty(_grep_bytes(n, l_cap), dtype=torch.uint8,
                          device=dev)
        _launch("grep", _lib().dsi_grep(
            _ptr(chunk), n, spec, tail or None, _ptr(tail_dev), l_cap,
            _ptr(buf), _stream(chunk)))
    out = buf.view(torch.int32)
    # The overflow word is 0 or 1: its low byte, viewed as bool, needs no
    # launch.
    return out[:l_cap], out[l_cap], buf[4 * (l_cap + 1)].view(torch.bool)


def grep_kernel(chunk: torch.Tensor, pattern: bytes, *, l_cap: int):
    """Kernel H (``csrc/grep.cu``) for a literal; see
    :func:`grep_kernel_plain`.  Returns (line_match [l_cap] int32 flags in
    line order, n_lines int32, overflow bool).  Lines are
    '\\n'-delimited; padding zeros never match a printable pattern."""
    _require(chunk, torch.uint8, 1, "grep chunk")
    if chunk.shape[0] < 1 or l_cap < 1 or not pattern:
        raise ValueError(f"grep: bad shape n={chunk.shape[0]} l_cap={l_cap} "
                         f"m={len(pattern)}")
    if not _on_cuda(chunk):
        return grep_kernel_plain(chunk, pattern, l_cap=l_cap)
    return launch_grep(chunk, (literal_branch(pattern),), l_cap=l_cap)


_REGEX_META = set(".^$*+?{}[]()|\\")


def is_literal_pattern(pat: str) -> bool:
    """True when the regex ``pat`` is a plain literal the kernel can run:
    printable ASCII (0x20..0x7E) only — control bytes could match the
    chunk's zero padding — and no regex metacharacters; a match can then
    never span lines, and byte-equality search == regex search."""
    return (bool(pat)
            and all(0x20 <= ord(c) <= 0x7E for c in pat)
            and not set(pat) & _REGEX_META)


def grep_host_result(data: bytes, pattern: str,
                     device=None) -> Optional[List[str]]:
    """Matching lines of ``data`` (split on '\\n', in order), or None when
    the pattern needs the host regex path.  Retries the line buffer on
    overflow (average line >= 8 bytes first, then n+1)."""
    dev = resolve_device(device)
    if not is_literal_pattern(pattern):
        return None
    try:
        text = data.decode("ascii")
    except UnicodeDecodeError:
        return None
    if len(pattern) > len(data):
        return []  # a literal longer than the data cannot match any line
    chunk = to_device(_pad_pow2(data), dev)
    pat = pattern.encode("ascii")
    line_match, nl = retry_line_caps(
        chunk.shape[0], lambda l_cap: grep_kernel(chunk, pat, l_cap=l_cap))
    return lines_from_flags(text, line_match, nl)
