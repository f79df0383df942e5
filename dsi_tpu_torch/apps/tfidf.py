"""TF-IDF app: copy of ``dsi_tpu/apps/tfidf.py`` (``n_docs_from_env``,
``format_value``, ``Map``, ``Reduce``) over the port's ``tokenize``.

* Map(doc, contents) emits one ``{word, "<doc>\\t<tf>"}`` record per
  distinct word of the document, tf its count there;
* Reduce(word, values) sees one record per document holding the word, so
  ``df = len(distinct docs)``; it scores each document ``tf * ln(N / df)``
  and returns ``"<df> <doc1>:<score1>,<doc2>:<score2>,..."``, documents
  sorted.

``N`` (the number of documents) is job-level configuration a per-key
reduce cannot derive, so it comes from ``DSI_TFIDF_NDOCS``; a missing
value raises.  The device path (``parallel/tfidf.py``) writes its lines
through the same :func:`format_value`, so both produce the same bytes.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple

from dsi_tpu_torch.apps.wc import tokenize
from dsi_tpu_torch.mr.types import KeyValue


def n_docs_from_env() -> int:
    raw = os.environ.get("DSI_TFIDF_NDOCS")
    if not raw:
        raise RuntimeError(
            "tfidf needs DSI_TFIDF_NDOCS (total document count) — a per-key "
            "reduce cannot derive N, and a silently wrong idf would defeat "
            "output parity checks")
    return int(raw)


def format_value(pairs: Sequence[Tuple[str, int]], n_docs: int) -> str:
    """The reduce output string: ``"<df> doc:score,..."``, docs sorted,
    scores fixed to 6 decimals."""
    by_doc = dict(pairs)  # one entry per doc by contract
    df = len(by_doc)
    idf = math.log(n_docs / df)
    scored = ",".join(f"{d}:{tf * idf:.6f}"
                      for d, tf in sorted(by_doc.items()))
    return f"{df} {scored}"


def Map(filename: str, contents: str) -> List[KeyValue]:
    counts: dict = {}
    for w in tokenize(contents):
        counts[w] = counts.get(w, 0) + 1
    return [KeyValue(w, f"{filename}\t{c}") for w, c in sorted(counts.items())]


def Reduce(key: str, values: List[str]) -> str:
    pairs = []
    for v in values:
        doc, _, tf = v.rpartition("\t")
        pairs.append((doc, int(tf)))
    return format_value(pairs, n_docs_from_env())
