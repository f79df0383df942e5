"""Grep tier 3: top-level alternation of fixed-length branches.

Port of ``dsi_tpu/ops/altk.py``.  A pattern that is a top-level
``|``-alternation whose every branch is device-eligible — a plain literal
(``ops/grepk.py``) or a fixed-length class pattern (``ops/regexk.py``) —
runs as one kernel H launch PER BRANCH with the per-line flags OR-ed by
``torch.maximum``, as the reference does (``re.search(a|b, line)`` is
``search(a) or search(b)`` per line; anchors bind per branch).  No kernel
of its own: K13/K14's flags, OR-ed.  Any ineligible branch declines to
the host app.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from dsi_tpu_torch.ops.grepk import (
    grep_kernel,
    is_literal_pattern,
    lines_from_flags,
    retry_line_caps,
)
from dsi_tpu_torch.ops.regexk import classgrep_kernel, parse_class_pattern
from dsi_tpu_torch.ops.wordcount import _pad_pow2, resolve_device, to_device


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


def _branch_flags(chunk, n_data: int, n_host_lines: int, branch: str,
                  l_cap: int):
    """(line_match, n_lines, overflow) for one branch at one rung —
    literal branches as ``grep_kernel``, class branches as
    ``classgrep_kernel`` (both kernel H).  A literal longer than the DATA
    (not the padded chunk: padding is zeros, unmatchable by printable
    literals) cannot match; its flags are zero without a launch."""
    if is_literal_pattern(branch):
        if len(branch) > n_data:
            return (torch.zeros(l_cap, dtype=torch.int32,
                                device=chunk.device),
                    n_host_lines, n_host_lines > l_cap)
        return grep_kernel(chunk, branch.encode("ascii"), l_cap=l_cap)
    ranges, anchor_start, anchor_end = parse_class_pattern(branch)
    return classgrep_kernel(chunk, ranges=ranges, anchor_start=anchor_start,
                            anchor_end=anchor_end, l_cap=l_cap)


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
    for b in branches:
        if is_literal_pattern(b):
            continue
        if parse_class_pattern(b) is None:
            return None  # branch outside both device tiers
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
        total, n_lines, overflow = None, None, None
        for b in branches:
            lm, nl, of = _branch_flags(chunk, len(data), n_host_lines, b,
                                       l_cap)
            total = lm if total is None else torch.maximum(total, lm)
            n_lines, overflow = nl, of  # chunk-derived: same every branch
        return total, n_lines, overflow

    line_match, nl = retry_line_caps(chunk.shape[0], run)
    return lines_from_flags(text, line_match, nl)
