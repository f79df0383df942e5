"""Sync cadence for the device-resident accumulator.

Copy of ``dsi_tpu/device/policy.py`` (``SyncPolicy`` and
``sync_every_default``).  The device table (``device/table.py``) keeps
confirmed step outputs on the card; the host pulls the merged table only
at sync points, every ``sync_every`` confirmed folds, plus at stream end.
The correctness story never depends on the cadence: every path drains at
stream end, and the widen protocol drains on demand.
"""

from __future__ import annotations

import os

#: Environment default for the fold-to-pull ratio (K).
_SYNC_EVERY_ENV = "DSI_STREAM_SYNC_EVERY"
_SYNC_EVERY_DEFAULT = 8


def sync_every_default(sync_every: int | None = None) -> int:
    """Resolve K: an explicit value wins, else ``DSI_STREAM_SYNC_EVERY``
    (default 8), floored at 1 (sync after every fold)."""
    if sync_every is None:
        try:
            sync_every = int(os.environ.get(_SYNC_EVERY_ENV,
                                            str(_SYNC_EVERY_DEFAULT)))
        except ValueError:
            sync_every = _SYNC_EVERY_DEFAULT
    return max(1, sync_every)


class SyncPolicy:
    """Pull the device table to the host every ``sync_every`` confirmed
    folds (plus, by caller contract, once at stream end).

    Counts *folds*, not steps: an empty step contributes nothing to the
    table, so pulling for it would be a wasted round trip — and
    ``sync_pulls == ceil(folds / K)`` holds absent widens.
    """

    def __init__(self, sync_every: int | None = None):
        self.sync_every = sync_every_default(sync_every)
        self._since = 0

    def note_fold(self) -> None:
        self._since += 1

    def due(self) -> bool:
        return self._since >= self.sync_every

    def reset(self) -> None:
        self._since = 0
