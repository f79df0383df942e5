"""Distributed grep app: copy of ``dsi_tpu/apps/grep.py`` (``Map``,
``Reduce``, ``_pattern``).

Pattern: the ``DSI_GREP_PATTERN`` environment variable (a Python regex;
the default matches nothing).  Map emits ``{matching_line, ""}`` per
matching line (the reference's per-line regex match, ``mrapps/dgrep.go``
:27-35); Reduce returns the number of occurrences of the line across the
corpus.
"""

from __future__ import annotations

import os
import re
from typing import List

from dsi_tpu_torch.mr.types import KeyValue


def _pattern() -> "re.Pattern[str]":
    return re.compile(os.environ.get("DSI_GREP_PATTERN", r"(?!x)x"))


def Map(filename: str, contents: str) -> List[KeyValue]:
    pat = _pattern()
    return [KeyValue(line, "") for line in contents.split("\n")
            if pat.search(line)]


def Reduce(key: str, values: List[str]) -> str:
    return str(len(values))
