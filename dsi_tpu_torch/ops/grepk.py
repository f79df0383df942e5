"""Grep tier 1: literal substring search over a whole chunk, on the card.

Port of ``dsi_tpu/ops/grepk.py``.  The map hot loop of the grep app
(``apps/grep.py``: a per-line regex scan) becomes kernel H
(``csrc/grep.cu``): the match mask of every byte position, the line id of
each position (newlines strictly before it), and the per-line flags as a
segment max.  ``grep_kernel`` launches H for a literal; the class tier
(``ops/regexk.py``) launches the same kernel with byte ranges, and the
NFA tier (``ops/nfak.py``) reuses H's line-flag epilogue.

Scope: fixed printable-ASCII literals without regex metacharacters;
anything else declines (None) so the caller runs the host app, as in the
reference.  The reference's AOT readiness gates (``device_ready``,
``cold_ok``, ``grep_rung_ready``, ``_grep_compiled``) are not ported: the
port compiles no shape at dispatch (ROADMAP Queue 1, the build/warm
cache).  ``retry_line_caps`` keeps its ``ready=`` parameter.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from dsi_tpu_torch.ops.wordcount import (
    _launch,
    _lib,
    _on_cuda,
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
_MAX_POS = 32      # class positions kernel H takes (regexk._MAX_PATTERN)
_MAX_RANGES = 8    # ranges a position (regexk._MAX_RANGES)


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


def launch_grep(chunk: torch.Tensor, *, pattern: Optional[bytes] = None,
                ranges=None, anchor_start: bool = False,
                anchor_end: bool = False, l_cap: int):
    """Kernel H on a CUDA chunk: a literal ``pattern`` (any length) or
    class ``ranges`` (<= 32 positions of <= 8 ``(lo, hi)`` pairs).
    Returns (line_match [l_cap] int32, n_lines int32, overflow bool), all
    on the card."""
    n = chunk.shape[0]
    dev = chunk.device
    lib = _lib()
    pat = lo = hi = nr = None
    if pattern is not None:
        m = len(pattern)
        pat = torch.frombuffer(bytearray(pattern), dtype=torch.uint8).to(dev)
    else:
        m = len(ranges)
        if not 1 <= m <= _MAX_POS or any(
                not 1 <= len(rs) <= _MAX_RANGES for rs in ranges):
            raise ValueError(f"grep: {m} positions or too many ranges")
        lo = np.zeros((_MAX_POS, _MAX_RANGES), np.uint8)
        hi = np.zeros((_MAX_POS, _MAX_RANGES), np.uint8)
        nr = np.zeros(_MAX_POS, np.uint8)
        for j, rs in enumerate(ranges):
            nr[j] = len(rs)
            for r, (a, b) in enumerate(rs):
                lo[j, r], hi[j, r] = a, b
    line_match = torch.empty(l_cap, dtype=torch.int32, device=dev)
    scalars = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.dsi_grep_scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        _launch("grep", lib.dsi_grep(
            _ptr(chunk), n, _ptr(pat),
            *(None if a is None else a.ctypes.data for a in (lo, hi, nr)),
            m, int(anchor_start), int(anchor_end), l_cap, _ptr(line_match),
            _ptr(scalars), _ptr(scratch), _stream(chunk)))
    return line_match, scalars[0], scalars[1] != 0


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
    return launch_grep(chunk, pattern=pattern, l_cap=l_cap)


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
