"""Grep tier 3: top-level alternation of fixed-length branches.

Port of ``dsi_tpu/ops/altk.py``.  A pattern that is a top-level
``|``-alternation whose every branch is device-eligible — a plain literal
(``ops/grepk.py``) or a fixed-length class pattern (``ops/regexk.py``) —
matches the lines where some branch matches (``re.search(a|b, line)`` is
``search(a) or search(b)`` per line; anchors bind per branch).  The
reference runs K13/K14 per branch and ORs the flags with ``jnp.maximum``
(:func:`altgrep_kernel_plain`); on the card the branches are packed into
one kernel H call while they fit its word (``grepk.pack_branches``), so
``the|and`` reads the chunk and writes the flags once, and only the calls
past the first are OR-ed by ``torch.maximum``.  Any ineligible branch
declines to the host app.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from dsi_tpu_torch.ops.grepk import (
    is_literal_pattern,
    launch_grep,
    lines_from_flags,
    literal_branch,
    pack_branches,
    retry_line_caps,
)
from dsi_tpu_torch.ops.regexk import (
    classgrep_kernel_plain,
    parse_class_pattern,
)
from dsi_tpu_torch.ops.wordcount import (
    _on_cuda,
    _pad_pow2,
    _require,
    resolve_device,
    to_device,
)


def split_top_level(pat: str) -> Optional[List[str]]:
    """Split ``pat`` on top-level ``|`` (escape-aware; ``|`` inside a
    ``[...]`` class is a literal) into branches, in order and without
    dedup.  None on an unterminated class or any empty branch (``a|`` —
    the empty regex matches every line; host handles it).  A pattern
    with no top-level ``|`` returns a single-element list.  Shared with
    the NFA tier (``ops/nfak.py``), which accepts single branches."""
    branches, cur, in_class, i = [], [], False, 0
    while i < len(pat):
        c = pat[i]
        if c == "\\" and i + 1 < len(pat):
            cur += [c, pat[i + 1]]
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        elif c == "|" and not in_class:
            branches.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(c)
        i += 1
    branches.append("".join(cur))
    if in_class or any(not b for b in branches):
        return None
    return branches


def split_alternation(pat: str) -> Optional[List[str]]:
    """Split ``pat`` on top-level ``|`` into >= 2 non-empty branches, or
    None when it isn't a plain alternation.  Duplicate branches add
    kernel passes but never change the OR, so they are removed; a
    pattern that collapses to one distinct branch ('a|a') is not a real
    alternation — tiers 1/2 or the host own it, keeping the >= 2
    contract exact for callers."""
    branches = split_top_level(pat)
    if branches is None:
        return None
    branches = list(dict.fromkeys(branches))
    if len(branches) < 2:
        return None
    return branches


def altgrep_kernel_plain(chunk: torch.Tensor, branches, *, l_cap: int):
    """Plain version of :func:`altgrep_kernel`: each branch's plain flags
    (``regexk.classgrep_kernel_plain``; a literal is a class of single
    bytes), OR-ed by ``torch.maximum`` as the reference's ``jnp.maximum``."""
    total = n_lines = overflow = None
    for positions, anchor_start, anchor_end in branches:
        lm, n_lines, overflow = classgrep_kernel_plain(
            chunk, ranges=positions, anchor_start=anchor_start,
            anchor_end=anchor_end, l_cap=l_cap)
        total = lm if total is None else torch.maximum(total, lm)
    return total, n_lines, overflow


def altgrep_kernel(chunk: torch.Tensor, branches, *, l_cap: int):
    """Kernel H for the alternation of ``branches`` (``grepk.Branch``
    tuples): one H call for the branches that fit its word together
    (``grepk.pack_branches``), the flags of any further calls OR-ed on the
    card.  Returns (line_match [l_cap] int32, n_lines int32, overflow
    bool); see :func:`altgrep_kernel_plain`."""
    _require(chunk, torch.uint8, 1, "altgrep chunk")
    if chunk.shape[0] < 1 or l_cap < 1 or not branches:
        raise ValueError(f"altgrep: bad shape n={chunk.shape[0]} "
                         f"l_cap={l_cap} branches={len(branches)}")
    if not _on_cuda(chunk):
        return altgrep_kernel_plain(chunk, branches, l_cap=l_cap)
    total = n_lines = overflow = None
    for call in pack_branches(branches):
        lm, n_lines, overflow = launch_grep(chunk, call, l_cap=l_cap)
        total = lm if total is None else torch.maximum(total, lm)
    return total, n_lines, overflow


def altgrep_host_result(data: bytes, pattern: str,
                        device=None) -> Optional[List[str]]:
    """Matching lines of ``data`` (split on '\\n', in order), or None when
    the pattern or data needs the host regex path.  Same retry discipline
    as the single-branch tiers, applied to all branches per rung so the
    flag vectors share one ``l_cap``."""
    dev = resolve_device(device)
    branches = split_alternation(pattern)
    if branches is None:
        return None
    any_class = False
    live = []  # a literal longer than the DATA (not the padded chunk:
    # padding is zeros, unmatchable by printable literals) cannot match
    for b in branches:
        if is_literal_pattern(b):
            if len(b) <= len(data):
                live.append(literal_branch(b.encode("ascii")))
            continue
        parsed = parse_class_pattern(b)
        if parsed is None:
            return None  # branch outside both device tiers
        live.append(parsed)
        any_class = True
    if any_class and b"\x00" in data:
        return None  # NUL inside a line would disagree with host re
    try:
        text = data.decode("ascii")
    except UnicodeDecodeError:
        return None
    n_host_lines = data.count(b"\n") + 1
    chunk = to_device(_pad_pow2(data), dev)

    def run(l_cap: int):
        if not live:  # no branch can match: no launch
            return (torch.zeros(l_cap, dtype=torch.int32, device=dev),
                    n_host_lines, n_host_lines > l_cap)
        return altgrep_kernel(chunk, live, l_cap=l_cap)

    line_match, nl = retry_line_caps(chunk.shape[0], run)
    return lines_from_flags(text, line_match, nl)
