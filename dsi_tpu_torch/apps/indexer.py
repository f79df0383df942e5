"""Inverted-index app: copy of ``dsi_tpu/apps/indexer.py`` over the
port's ``tokenize``.

The MIT 6.5840 lab app: Map emits one ``{word, document}`` pair per
distinct word of a document; Reduce returns ``"<count> <doc1>,<doc2>,..."``
with the documents sorted and deduplicated.  The device path
(``parallel/grepstream.py write_indexer_output``) writes the same bytes.
"""

from __future__ import annotations

from typing import List

from dsi_tpu_torch.apps.wc import tokenize
from dsi_tpu_torch.mr.types import KeyValue


def Map(filename: str, contents: str) -> List[KeyValue]:
    words = sorted(set(tokenize(contents)))
    return [KeyValue(w, filename) for w in words]


def Reduce(key: str, values: List[str]) -> str:
    docs = sorted(set(values))
    return f"{len(docs)} {','.join(docs)}"
