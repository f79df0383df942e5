"""Word count app: copy of ``dsi_tpu/apps/wc.py``.

Reference: ``mrapps/wc.go`` — Map splits contents into maximal runs of
Unicode letters (``strings.FieldsFunc`` with ``!unicode.IsLetter``,
wc.go:21-34) and emits ``{word, "1"}`` per word; Reduce returns
``strconv.Itoa(len(values))`` (wc.go:41-44).  ``tokenize`` matches Go's
``unicode.IsLetter`` exactly (category L only); on ASCII the letter class
is ``[A-Za-z]`` and a compiled regex is used for speed.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List

from dsi_tpu_torch.mr.types import KeyValue

ASCII_WORD_RE = re.compile(r"[A-Za-z]+")


def is_letter(ch: str) -> bool:
    """Go ``unicode.IsLetter``: Unicode category L, nothing else."""
    return unicodedata.category(ch).startswith("L")


class _NonLettersToSpace(dict):
    """``str.translate`` table mapping non-letters to a space, memoized
    lazily per code point."""

    def __missing__(self, cp: int):
        out = chr(cp) if is_letter(chr(cp)) else " "
        self[cp] = out
        return out


_XLATE = _NonLettersToSpace()


def tokenize(contents: str) -> List[str]:
    """Maximal runs of Unicode letters — exactly
    ``strings.FieldsFunc(contents, !unicode.IsLetter)`` (wc.go:21-34)."""
    if contents.isascii():
        return ASCII_WORD_RE.findall(contents)
    # All whitespace is non-letter, so mapping every non-letter to " " and
    # splitting on whitespace yields exactly the maximal letter runs.
    return contents.translate(_XLATE).split()


def Map(filename: str, contents: str) -> List[KeyValue]:
    return [KeyValue(w, "1") for w in tokenize(contents)]


def Reduce(key: str, values: List[str]) -> str:
    return str(len(values))
