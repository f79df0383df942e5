"""Grep tier 2: fixed-length character-class patterns, on the card.

Port of ``dsi_tpu/ops/regexk.py``.  Patterns that are a fixed-length
sequence of byte classes — literal characters, ``.``, ``[...]`` /
``[^...]`` classes with ranges, ``\\d``/``\\w``/``\\s``, escaped
literals — optionally anchored with a leading ``^`` or trailing ``$``
(the reference harness's ``[Tt]he``, ``test-mr.sh:47``) run as kernel H
(``csrc/grep.cu``) with the pattern as a launch argument
(``grepk.grep_spec``: a byte table of the positions and the anchors): one
build serves every pattern.  Variable-length operators and groups decline
to the host app.

Cross-line discipline: every class excludes ``\\n`` (byte 10) and
``\\0`` (padding), so a match window can never span lines or leak into
padding; inputs containing NUL bytes route to the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from dsi_tpu_torch.ops.grepk import (
    launch_grep,
    line_flags_from_match,
    lines_from_flags,
    retry_line_caps,
    shift_left,
)
from dsi_tpu_torch.ops.wordcount import (
    _on_cuda,
    _pad_pow2,
    _require,
    resolve_device,
    to_device,
)

# The reference's limits (ranges a position, positions a pattern), kept so
# the tier declines where it does; kernel H's table takes any ranges and
# up to grepk.WORD_BITS positions.
_MAX_RANGES = 8
_MAX_PATTERN = 32

_ESCAPE_CLASSES = {
    "d": [(0x30, 0x39)],
    "w": [(0x30, 0x39), (0x41, 0x5A), (0x5F, 0x5F), (0x61, 0x7A)],
    # Python re's \s on str matches [ \t\n\v\f\r\x1c-\x1f] within ASCII;
    # \n is excluded here because lines are newline-split before matching.
    "s": [(0x09, 0x09), (0x0B, 0x0D), (0x1C, 0x1F), (0x20, 0x20)],
}


def _find_class_end(pat: str, start: int) -> int:
    """Index of the closing ']' of a class opened at ``start`` ('['),
    honoring backslash escapes (``[a\\]b]`` closes at the FINAL bracket);
    -1 when unterminated.  A ']' directly after '[' or '[^' is literal in
    re, which the caller's empty-body check rejects to the host path."""
    i = start + 1
    if pat[i:i + 1] == "^":
        i += 1
    while i < len(pat):
        if pat[i] == "\\":
            i += 2
        elif pat[i] == "]":
            return i
        else:
            i += 1
    return -1


def _compress(members: set) -> List[Tuple[int, int]]:
    """Sorted byte set -> minimal (lo, hi) range list."""
    out: List[Tuple[int, int]] = []
    for b in sorted(members):
        if out and b == out[-1][1] + 1:
            out[-1] = (out[-1][0], b)
        else:
            out.append((b, b))
    return out


#: Characters that cannot START an atom in any device tier: modifiers,
#: bounded reps, groups, stray anchors.  (Tier 4 consumes ``* + ?`` as
#: modifiers AFTER a valid atom and splits ``|`` before parsing, so one
#: set serves every tier — see ops/nfak.py.)
ATOM_REJECT = "*+?{}()|^$"


def atom_members(pat: str, i: int):
    """Parse one atom starting at ``pat[i]`` — ``.``, an escape, a
    ``[...]`` class, or a literal character — into its byte-member set.

    Returns ``(members, next_i)`` or None when the atom needs the host
    regex engine.  The SINGLE definition of atom/class semantics shared
    by the class tier (here) and the NFA tier (``ops/nfak.py``), so the
    tiers can never disagree on what a class means.  Callers reject
    ``ATOM_REJECT`` characters first.  Members are raw — callers
    subtract ``{0, 10}`` per their padding/newline discipline."""
    c = pat[i]
    if c == ".":
        return set(range(1, 256)) - {10}, i + 1
    if c == "\\":
        if i + 1 >= len(pat):
            return None
        e = pat[i + 1]
        if e in _ESCAPE_CLASSES:
            return ({b for lo, hi in _ESCAPE_CLASSES[e]
                     for b in range(lo, hi + 1)}, i + 2)
        if not e.isalnum():  # \. \[ \\ etc: escaped literal
            return {ord(e)}, i + 2
        return None  # \b \A \Z back-refs etc.: host
    if c == "[":
        j = _find_class_end(pat, i)
        if j == -1:
            return None
        body = pat[i + 1:j]
        negate = body.startswith("^")
        if negate:
            body = body[1:]
        members: set = set()
        k = 0
        while k < len(body):
            if body[k] == "\\" and k + 1 < len(body):
                e = body[k + 1]
                if e in _ESCAPE_CLASSES:
                    members |= {b for lo, hi in _ESCAPE_CLASSES[e]
                                for b in range(lo, hi + 1)}
                elif not e.isalnum():
                    members.add(ord(e))
                else:
                    return None
                k += 2
            elif k + 2 < len(body) and body[k + 1] == "-":
                lo, hi = ord(body[k]), ord(body[k + 2])
                if lo > hi:
                    return None
                members |= set(range(lo, hi + 1))
                k += 3
            else:
                members.add(ord(body[k]))
                k += 1
        if not members:
            return None
        if negate:
            members = set(range(1, 256)) - members
        return members, j + 1
    return {ord(c)}, i + 1


def parse_class_pattern(pat: str):
    """Parse the supported regex subset.

    Returns ``(ranges, anchor_start, anchor_end)`` where ``ranges`` is one
    tuple of ``(lo, hi)`` byte pairs per pattern position, or ``None``
    when the pattern needs the host regex engine.  Every position's class
    excludes bytes 0 and 10 (see module docstring).
    """
    if not pat or not all(0x01 <= ord(c) <= 0x7E for c in pat):
        return None
    anchor_start = pat.startswith("^")
    if anchor_start:
        pat = pat[1:]
    anchor_end = pat.endswith("$") and not pat.endswith("\\$")
    if anchor_end:
        pat = pat[:-1]
    if not pat:
        return None

    positions: List[Tuple[Tuple[int, int], ...]] = []
    i = 0
    while i < len(pat):
        if pat[i] in ATOM_REJECT:
            return None  # variable-length / group / stray anchor: host
        parsed = atom_members(pat, i)
        if parsed is None:
            return None
        members, i = parsed
        members -= {0, 10}
        if not members:
            return None  # class can only match padding/newline: host
        ranges = _compress(members)
        if len(ranges) > _MAX_RANGES:
            return None
        positions.append(tuple(ranges))

    if not positions or len(positions) > _MAX_PATTERN:
        return None
    return tuple(positions), anchor_start, anchor_end


def classgrep_kernel_plain(chunk: torch.Tensor, *, ranges,
                           anchor_start: bool, anchor_end: bool, l_cap: int):
    """Plain version of kernel H for a class pattern: per position an OR
    of ``lo <= b <= hi`` tests over the shifted chunk, the anchors, then
    :func:`~dsi_tpu_torch.ops.grepk.line_flags_from_match`."""
    n = chunk.shape[0]
    match = torch.ones(n, dtype=torch.bool, device=chunk.device)
    for j, rs in enumerate(ranges):
        c = shift_left(chunk, j)
        pos_ok = torch.zeros(n, dtype=torch.bool, device=chunk.device)
        for lo, hi in rs:
            pos_ok |= (c == lo) if lo == hi else (c >= lo) & (c <= hi)
        match &= pos_ok
    if anchor_start:
        prev = torch.cat([torch.full((1,), 10, dtype=torch.uint8,
                                     device=chunk.device), chunk[:-1]])
        match &= prev == 10
    if anchor_end:
        nxt = shift_left(chunk, len(ranges))  # the byte just past the window
        match &= (nxt == 10) | (nxt == 0)
    return line_flags_from_match(chunk, match, l_cap)


def classgrep_kernel(chunk: torch.Tensor, *, ranges, anchor_start: bool,
                     anchor_end: bool, l_cap: int):
    """Kernel H (``csrc/grep.cu``) for a class pattern; see
    :func:`classgrep_kernel_plain`.  Same contract as
    ``grepk.grep_kernel``: (line_match [l_cap] int32 flags in line order,
    n_lines int32, overflow bool)."""
    _require(chunk, torch.uint8, 1, "classgrep chunk")
    if chunk.shape[0] < 1 or l_cap < 1 or not ranges:
        raise ValueError(f"classgrep: bad shape n={chunk.shape[0]} "
                         f"l_cap={l_cap} positions={len(ranges)}")
    if not _on_cuda(chunk):
        return classgrep_kernel_plain(chunk, ranges=ranges,
                                      anchor_start=anchor_start,
                                      anchor_end=anchor_end, l_cap=l_cap)
    return launch_grep(chunk, (class_branch(ranges, anchor_start,
                                            anchor_end),), l_cap=l_cap)


def class_branch(ranges, anchor_start: bool, anchor_end: bool):
    """A class pattern as a ``grepk.Branch`` (hashable, so its launch
    argument is built once)."""
    try:
        hash(ranges)
    except TypeError:
        ranges = tuple(tuple((int(lo), int(hi)) for lo, hi in rs)
                       for rs in ranges)
    return ranges, bool(anchor_start), bool(anchor_end)


def classgrep_host_result(data: bytes, pattern: str,
                          device=None) -> Optional[List[str]]:
    """Matching lines of ``data`` (split on '\\n', in order), or None when
    the pattern or data needs the host regex path.  Same retry discipline
    as ``grepk.grep_host_result``."""
    dev = resolve_device(device)
    parsed = parse_class_pattern(pattern)
    if parsed is None:
        return None
    ranges, anchor_start, anchor_end = parsed
    if b"\x00" in data:
        return None  # NUL inside a line would disagree with host re
    try:
        text = data.decode("ascii")
    except UnicodeDecodeError:
        return None
    chunk = to_device(_pad_pow2(data), dev)
    line_match, nl = retry_line_caps(
        chunk.shape[0], lambda l_cap: classgrep_kernel(
            chunk, ranges=ranges, anchor_start=anchor_start,
            anchor_end=anchor_end, l_cap=l_cap))
    return lines_from_flags(text, line_match, nl)
