"""On-device top-k and histogram services for the streaming grep.

Port of ``dsi_tpu/device/topk.py`` (``KeyCounts``, ``DeviceTopK``,
``DeviceHistogram``, with their checkpoint images).

* :class:`DeviceTopK` — the persistent (key, count) table of
  :class:`~dsi_tpu_torch.device.table.DeviceTable` (folds lag the
  engine's window, an overflowing fold is recovered by drain, widen x4
  and re-fold, counts are u64), with one change: a sync pulls a
  count-sorted top-k SNAPSHOT — k rows, not the capacity — and leaves the
  table on the card, so the final ``close()`` drain stays the one exact
  hand-off to the host accumulator.  The snapshot (K17) sorts each
  shard's rows with kernel B by (~count, key lanes, len) and keeps the
  first k.
* :class:`DeviceHistogram` — a persistent ``[n_dev, slots]`` int64 (u64)
  vector on the card, folded by an in-place add per confirmed step.  No
  flags, no lag, no widen: an add cannot overflow a rung.  With
  ``mesh_shards`` a pull sums over the shards on the card first and
  pulls one ``[slots]`` vector.
* :class:`KeyCounts` — the host accumulator for drains whose kk=2 key
  lanes are one opaque u64 identity (grep's global line numbers).

Checkpoint images (``ckpt/``) are the reference's arrays: the top-k
table's come from :class:`DeviceTable` (its fold keeps the delta log;
``sync`` only flushes and snapshots, so the log stays right), the
histogram's is its ``[n_dev, slots]`` uint64 vector, copied behind an
event at the capture because the next fold adds into it in place, and
``KeyCounts``' are (uint64 keys, int64 counts).

Snapshots are observability only; they are never an input to a result.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ckpt.delta import Deferred
from dsi_tpu_torch.device.table import DeviceTable
from dsi_tpu_torch.interop import to_tensor
from dsi_tpu_torch.ops.wordcount import (
    HostCopy,
    _u32_value,
    pack_key_lanes,
    radix_sort,
)
from dsi_tpu_torch.parallel.pipeline import timed


class KeyCounts:
    """Host accumulator for drains whose kk=2 key lanes encode one opaque
    uint64 identity (hi, lo).  The slice of the ``PackedCounts`` interface
    ``DeviceTable._pull_merge`` drives (``add(keys, lens, cnts, parts)``);
    lens/parts ride the wire format and are ignored."""

    def __init__(self):
        self._counts: Dict[int, int] = {}

    def add(self, keys: np.ndarray, lens, cnts, parts) -> None:
        k = np.asarray(keys, dtype=np.uint64)
        key64 = (k[:, 0] << np.uint64(32)) | k[:, 1]
        for key, c in zip(key64.tolist(), np.asarray(cnts).tolist()):
            self._counts[key] = self._counts.get(key, 0) + int(c)

    def finalize(self) -> Dict[int, int]:
        return dict(self._counts)

    # ── checkpoint image (ckpt/) ──

    def snapshot(self) -> Dict[str, np.ndarray]:
        if not self._counts:
            return {}
        n = len(self._counts)
        return {"keys": np.fromiter(self._counts.keys(), dtype=np.uint64,
                                    count=n),
                "cnts": np.fromiter(self._counts.values(), dtype=np.int64,
                                    count=n)}

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        self._counts = {}
        if not arrays or "keys" not in arrays:
            return
        for k, c in zip(np.asarray(arrays["keys"], np.uint64).tolist(),
                        np.asarray(arrays["cnts"], np.int64).tolist()):
            self._counts[int(k)] = int(c)


def topk_rows(tkeys: torch.Tensor, tlens: torch.Tensor, tcnts: torch.Tensor,
              *, k: int):
    """K17 (reference ``_topk_impl``): each shard's rows sorted by
    (~count, key lanes, len), the first ``k`` kept.  ``tkeys`` [n_dev, cap,
    kk] int32 (u32 lanes), ``tlens`` [n_dev, cap] int32, ``tcnts`` [n_dev,
    cap] int64 (u64).  Empty rows carry count 0, so ~0 sorts them last.
    Kernel B sorts the u64 words (~count, the lanes packed pairwise, len)
    once per shard; unsigned order is B's own.  Returns (keys [n_dev, k,
    kk], lens [n_dev, k], counts [n_dev, k])."""
    n_dev, cap, kk = tkeys.shape
    k = min(k, cap)
    out = []
    for d in range(n_dev):
        lanes = tuple(tkeys[d][:, j] for j in range(kk))
        words = torch.stack([~tcnts[d], *pack_key_lanes(lanes),
                             tlens[d].to(torch.int64)])
        _, perm = radix_sort(words)
        top = perm[:k].to(torch.int64)
        out.append((tkeys[d][top], tlens[d][top], tcnts[d][top]))
    return tuple(torch.stack([o[i] for o in out]) for i in range(3))


class DeviceTopK(DeviceTable):
    """Persistent (key, count) table on the card with count-sorted top-k
    snapshot syncs.

    Folding, lagged confirmation, overflow recovery and the final drain
    are :class:`DeviceTable`'s; :meth:`sync` pulls the k heaviest rows
    per shard (``snapshot``) instead of draining.  ``topk_snapshots``
    counts snapshot pulls; ``sync_pulls`` counts data drains only (the
    close) and ``widens`` the recovery drains.  ``mesh_shards`` is
    inherited whole: a global winner is in its owning shard's top-k under
    the same order, so per-shard pruning stays exact.
    """

    def __init__(self, n_dev: int, *, kk: int, cap: int, k: int, acc,
                 device, lag: int = 1, stats=None, mesh_shards: int = 0):
        super().__init__(n_dev, kk=kk, cap=cap, acc=acc, device=device,
                         lag=lag, stats=stats, mesh_shards=mesh_shards)
        self.k = int(k)
        self.stats.setdefault("topk_snapshots", 0)
        #: Last snapshot: ((count, key_lanes_tuple, len), ...) count
        #: desc, key asc — observability only, never a result input.
        self.snapshot: Tuple = ()

    def sync(self) -> bool:
        """The K-fold snapshot pull: flush the fold lag (recovering any
        late-detected overflow), then pull the top-k rows — no drain, no
        clear.  Returns True when a snapshot crossed (an empty table
        skips it)."""
        with timed(self.stats, "sync_s"):
            orphans = self._flush_pending()
            if orphans:
                self._recover(orphans)
            if not int(self._nrows.max()):
                return False
            tkeys, tlens, tcnts, _, _ = self._state
            skeys, slens, scnts = topk_rows(tkeys, tlens, tcnts, k=self.k)
            keys_np = skeys.cpu().numpy().view(np.uint32)
            lens_np = slens.cpu().numpy()
            cnts_np = scnts.cpu().numpy()
            rows: List[Tuple] = []
            for d in range(self.n_dev):
                # Rows past this shard's occupancy sorted last with count
                # 0: drop them by count, not by position, so a shard with
                # fewer than k rows contributes exactly its own.
                for i in range(min(self.k, int(self._nrows[d]))):
                    c = int(cnts_np[d, i])
                    if c <= 0:
                        break
                    rows.append((c, tuple(keys_np[d, i].tolist()),
                                 int(lens_np[d, i])))
            rows.sort(key=lambda r: (-r[0], r[1]))
            self.snapshot = tuple(rows[:self.k])
            self.stats["topk_snapshots"] += 1
        return True


class DeviceHistogram:
    """Persistent ``[n_dev, slots]`` u64 (int64 bits) accumulation vector
    on the card, folded by an in-place add per confirmed step.  The grep
    engine keeps per-line match-count buckets plus the running totals
    (lines, matched, occurrences) in it, so one fold and one pull cover
    every scalar of the stream.

    ``pull()`` returns the running totals summed over shards without
    clearing; ``close()`` is the final pull.  ``stats`` receives
    ``hist_folds``/``hist_pulls``/``hist_s``/``pull_bytes``.  With
    ``mesh_shards`` the sum over shards runs on the card and one
    ``[slots]`` vector crosses (``pull_bytes`` shows it).
    """

    def __init__(self, n_dev: int, *, slots: int, device, stats=None,
                 mesh_shards: int = 0):
        self.n_dev = int(n_dev)
        self.slots = int(slots)
        self.mesh_shards = max(0, int(mesh_shards))
        self.stats = stats if stats is not None else {}
        for key in ("hist_folds", "hist_pulls", "pull_bytes"):
            self.stats.setdefault(key, 0)
        self.stats.setdefault("hist_s", 0.0)
        if self.mesh_shards:
            self.stats.setdefault("mesh_shards", self.mesh_shards)
        self.device = torch.device(device)
        self._state = torch.zeros((self.n_dev, self.slots), dtype=torch.int64,
                                  device=self.device)

    def fold(self, step: torch.Tensor) -> None:
        """Add one confirmed step's ``[n_dev, slots]`` u32 (int32 bits)
        vector into the running totals, in place (no host sync)."""
        with timed(self.stats, "hist_s"):
            self._state += _u32_value(step)
            self.stats["hist_folds"] += 1

    def pull(self) -> np.ndarray:
        """Running totals summed over shards — ``[slots]`` int64.  No
        clear."""
        with timed(self.stats, "hist_s"):
            if self.mesh_shards:
                merged = self._state.sum(dim=0).cpu().numpy()
                self.stats["pull_bytes"] += merged.nbytes
                out = merged
            else:
                full = self._state.cpu().numpy()
                self.stats["pull_bytes"] += full.nbytes
                out = full.sum(axis=0)
            self.stats["hist_pulls"] += 1
        return out

    def close(self) -> np.ndarray:
        out = self.pull()
        self._state = None
        return out

    # ── checkpoint image (ckpt/) ──

    def checkpoint_capture(self) -> Deferred:
        """Capture half of the image: a fold is an add with no flags, so
        the last one dispatched is confirmed once it lands.  The vector
        (KBs) is copied to pinned host memory behind an event now, before
        the next fold adds into it in place; ``materialize()`` waits on
        that event alone."""
        copy = HostCopy(self._state, view=np.uint64)
        return Deferred(lambda: {"hist": copy.wait()})

    def checkpoint_state(self) -> dict:
        """Capture and materialize at once: the synchronous image."""
        return self.checkpoint_capture().materialize()

    def restore_state(self, img: dict) -> None:
        """Upload a :meth:`checkpoint_state` image (the u64 totals as
        int64 bits)."""
        self._state = to_tensor(np.asarray(img["hist"], np.uint64)).to(
            self.device)
