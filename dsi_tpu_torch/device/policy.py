"""Sync cadence and mesh-sharding degree for the device-resident
accumulator.

Copy of ``dsi_tpu/device/policy.py`` (``SyncPolicy``,
``sync_every_default`` and ``mesh_shards_default``).  The device table
(``device/table.py``) keeps confirmed step outputs on the card; the host
pulls the merged table only at sync points, every ``sync_every``
confirmed folds, plus at stream end.
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


#: Environment default for the mesh-sharded table's degree (0 = off).
_MESH_SHARDS_ENV = "DSI_STREAM_MESH_SHARDS"


def mesh_shards_default(mesh_shards: int | None = None) -> int:
    """Resolve the mesh-sharding degree of the device table: an explicit
    value wins, else ``DSI_STREAM_MESH_SHARDS`` (default 0 = off),
    floored at 0."""
    if mesh_shards is None:
        try:
            mesh_shards = int(os.environ.get(_MESH_SHARDS_ENV, "0"))
        except ValueError:
            mesh_shards = 0
    return max(0, int(mesh_shards))


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
