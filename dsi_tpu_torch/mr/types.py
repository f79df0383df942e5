"""Core record type: copy of ``dsi_tpu/mr/types.py:KeyValue``
(reference ``mr/worker.go:17-20``)."""

from __future__ import annotations

from typing import NamedTuple


class KeyValue(NamedTuple):
    """The record type apps produce and consume (mr/worker.go:17-20)."""

    key: str
    value: str
