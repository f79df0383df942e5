"""Device-resident merge table: the streaming word count's cross-step
accumulator.

Port of ``dsi_tpu/device/table.py`` (``DeviceTable`` without
checkpoints).  The merged table stays on the card: keys as big-endian u32
lanes (int32 bits), u64 counts (int64 bits), occupancy per virtual shard.

* ``fold`` (K10, ``fold_step``): every shard holds only words of the
  reduce partitions it owns (``parallel/shuffle.py`` routing); per shard,
  concatenate the table with the step's rows (rows past the step's unique
  count masked to pad), sort with kernel B, group with kernel C at
  ``u_cap = cap``.  The commit is all-or-nothing across shards — the
  reference's ``lax.pmax`` is a reduction over the leading dimension, and
  ``torch.where`` keeps every shard's old table on the card if any shard
  overflowed, with no host sync inside the fold.
* ``mesh_shards=n`` (K11, ``mesh_fold_step``): the fold routes every
  valid step row to shard ``ihash(key) % n`` first (``ops/meshroute.py``:
  kernel D for the hash, kernel E for the exchange), then each shard
  merges the rows it owns with B and C over ``cap + n_dev*rows`` rows.
  The commit is per shard: an ``apply`` mask says which shards merge at
  all, and an overflowed shard keeps its old rows while the others
  commit.  The widen protocol is per shard too: only the hot shards
  drain to the host, come back empty in the wider allocation and re-fold
  the orphaned steps under ``apply = hot``; cold shards are carried over
  on the card.  ``shard_widens`` counts the widens per shard and
  ``shard_imbalance`` is the max over the mean shard occupancy.
* overflow never drops keys: a fold whose merged uniques exceed the
  capacity reports it in its ``[n_dev, 2]`` flags; ``widen`` drains the
  table to the host accumulator (``PackedCounts``), reallocates at the
  next rung (x4) and re-folds the orphaned steps, whose packed tensors
  were kept alive for this.  The same protocol re-keys the table when the
  word window widens mid-stream.
* flag checks are LAGGED: each fold's flags go to the host as a
  ``non_blocking`` copy into pinned memory with a CUDA event, and a fold
  is confirmed (the event waited on) only ``lag`` folds later, so the
  confirmation never waits out kernels queued behind it.

Results are the same with and without ``mesh_shards``: routing changes
which shard holds a key, never its count, and every drain ends in the
same host accumulator.  Sync cadence is owned by ``device/policy.py``;
the caller drives ``sync()``/``close()``.  ``stats`` receives ``folds``,
``fold_overflows``, ``sync_pulls``, ``widens``, ``pull_bytes``,
``table_cap``, the ``fold_s``/``sync_s``/``widen_s`` wall seconds and,
with ``mesh_shards``, ``mesh_shards``, ``shard_widens`` and
``shard_imbalance``.
"""

from __future__ import annotations

import collections
from typing import Deque, Optional, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ops.meshroute import exchange_rows, route_dest
from dsi_tpu_torch.ops.wordcount import (
    _PAD_KEY32,
    _PAD_KEY64,
    HostCopy,
    _u32_value,
    group_sorted,
    pack_key_lanes,
    radix_sort,
    unpack_key_rows,
)
from dsi_tpu_torch.parallel.pipeline import timed
from dsi_tpu_torch.parallel.shuffle import occupied_prefix


def _merge_operands(tkeys, tlens, tcnts, tparts, skeys, slens, scnts,
                    sparts, kk: int):
    """One shard's table rows and the step rows it merges, concatenated:
    (u64 key words [k64, cap+rows], counts int64, lengths, partitions)."""
    allkeys = torch.cat([tkeys, skeys])
    keys64 = torch.stack(pack_key_lanes(tuple(allkeys[:, j]
                                              for j in range(kk))))
    return (keys64, torch.cat([tcnts, scnts]), torch.cat([tlens, slens]),
            torch.cat([tparts, sparts]))


def _fold_operands(tkeys, tlens, tcnts, tparts, packed, scal, kk: int):
    """The fold's sort operands for one shard: the table shard and this
    shard's slice of the step, with step rows past the step's unique
    count (garbage: zero keys, not pad) masked to pad rows."""
    rows = packed.shape[0]
    svalid = torch.arange(rows, device=packed.device) < scal[0]
    return _merge_operands(
        tkeys, tlens, tcnts, tparts,
        torch.where(svalid[:, None], packed[:, :kk], _PAD_KEY32),
        torch.where(svalid, packed[:, kk], 0),
        torch.where(svalid, _u32_value(packed[:, kk + 1]), 0),
        torch.where(svalid, packed[:, kk + 2], 0), kk)


def _received_operands(tkeys, tlens, tcnts, tparts, recv, kk: int):
    """The mesh fold's sort operands for one shard: the table shard and
    the rows the exchange delivered to it (pad rows already pad, with
    zero payload)."""
    return _merge_operands(tkeys, tlens, tcnts, tparts, recv[:, :kk],
                           recv[:, kk], _u32_value(recv[:, kk + 1]),
                           recv[:, kk + 2], kk)


def _merge_shard(keys64, allcnts, alllens, allparts, cap: int, kk: int):
    """Sort (B) and group (C) one shard's merge operands into at most
    ``cap`` rows (reference ``_fold_device`` :134-175).  Pad rows carry
    all-ones key lanes (u64-max after pairwise packing), so they sort last
    and kernel C skips them — the invariant every fold output
    re-establishes.  Returns (keys, lens, counts, parts, m_unique)."""
    skeys64, perm = radix_sort(keys64)
    pl = perm.to(torch.int64)
    keys_u, tot, upos, len_u, m_unique = group_sorted(
        skeys64, allcnts[pl], cap, payload=alllens, perm=perm)
    ovalid = torch.arange(cap, device=keys64.device) < m_unique
    new_keys = unpack_key_rows(
        torch.where(ovalid[None, :], keys_u, _PAD_KEY64).T, kk)
    new_cnts = torch.where(ovalid, tot, 0)
    new_parts = torch.where(ovalid, allparts[pl[upos.to(torch.int64)]], 0)
    return new_keys, len_u, new_cnts, new_parts, m_unique


def _commit(old, new, keep_old, tn, m_unique, cap: int, ov):
    """Per-shard commit: shards with ``keep_old`` keep their rows; the new
    table and flags [n_dev, 2] = (overflow, occupancy)."""
    out = tuple(torch.where(keep_old.reshape(-1, *(1,) * (o.dim() - 1)), o,
                            torch.stack([x[i] for x in new]))
                for i, o in enumerate(old))
    out_n = torch.where(keep_old, tn, m_unique.clamp(max=cap))
    return (*out, out_n, torch.stack([ov.to(torch.int32), out_n], dim=1))


def fold_step(tkeys, tlens, tcnts, tparts, tn, packed, scal):
    """K10: fold one step's packed reduce output ``packed`` [n_dev, rows,
    kk+3] (scalars ``scal`` [n_dev, 5]) into the table (``tkeys`` [n_dev,
    cap, kk] int32, ``tlens``/``tparts`` [n_dev, cap] int32, ``tcnts``
    [n_dev, cap] int64 holding u64, ``tn`` [n_dev] int32).

    Returns the new table and flags [n_dev, 2] int32 = (overflow on any
    shard, occupancy).  On overflow every shard keeps its old table: a
    partial commit would double-count the folded shards when the step is
    recovered whole.  Runs where the tensors lie, without a host sync."""
    n_dev, cap, kk = tkeys.shape
    new = [_merge_shard(*_fold_operands(tkeys[d], tlens[d], tcnts[d],
                                        tparts[d], packed[d], scal[d], kk),
                        cap, kk) for d in range(n_dev)]
    m_unique = torch.stack([x[4].to(torch.int32) for x in new])
    keep_old = (m_unique > cap).any().expand(n_dev)
    return _commit((tkeys, tlens, tcnts, tparts), new, keep_old, tn,
                   m_unique, cap, keep_old)


def _route_operands(packed, scal):
    """The step rows as ``route_dest`` takes them: (key lanes [n_dev*rows,
    kk], lengths, valid), rows past each shard's unique count masked."""
    n_dev, rows, w = packed.shape
    kk = w - 3
    svalid = (torch.arange(rows, device=packed.device)[None, :]
              < scal[:, :1])
    skeys = torch.where(svalid[..., None], packed[..., :kk], _PAD_KEY32)
    slens = torch.where(svalid, packed[..., kk], 0)
    return skeys.reshape(-1, kk), slens.reshape(-1), svalid.reshape(-1)


def mesh_fold_step(tkeys, tlens, tcnts, tparts, tn, packed, scal, apply, *,
                   n_shards: int):
    """K11: the mesh-sharded fold (reference ``_mesh_fold_device``
    :213-283): route the step's rows to their owning shards
    (``ihash(key) % n_shards`` by kernel D, rows past each shard's unique
    count parked on ``n_dev``; then the exchange, kernel E), then per
    shard merge the table with the rows it received (B and C over ``cap +
    n_dev*rows`` rows).  ``apply`` [n_dev]
    bool masks which shards merge at all.  The commit is per shard: a
    shard that is not applied or overflowed keeps its old rows and only
    an applied shard reports its own overflow; the others commit.
    Returns the new table and flags [n_dev, 2] int32 = (overflow,
    occupancy)."""
    n_dev, cap, kk = tkeys.shape
    dest = route_dest(*_route_operands(packed, scal), n_shards=n_shards,
                      park=n_dev)
    recv = exchange_rows(packed, dest.view(n_dev, -1), n_dev=n_dev, kk=kk)
    new = [_merge_shard(*_received_operands(tkeys[d], tlens[d], tcnts[d],
                                            tparts[d], recv[d], kk),
                        cap, kk) for d in range(n_dev)]
    m_unique = torch.stack([x[4].to(torch.int32) for x in new])
    ov = apply & (m_unique > cap)
    return _commit((tkeys, tlens, tcnts, tparts), new, ov | ~apply, tn,
                   m_unique, cap, ov)


def grow_table(tkeys, tlens, tcnts, tparts, tn, keep, new_cap: int):
    """Widen reallocation (reference ``_grow_device`` :307): kept shards
    (``keep`` [n_dev] bool) carry their rows into the wider allocation on
    the card, dropped shards come back empty."""
    n_dev, old_cap, kk = tkeys.shape
    k3 = keep[:, None, None]
    k2 = keep[:, None]
    gkeys = torch.full((n_dev, new_cap, kk), _PAD_KEY32, dtype=torch.int32,
                       device=tkeys.device)
    gkeys[:, :old_cap] = torch.where(k3, tkeys, _PAD_KEY32)
    grown = []
    for t in (tlens, tcnts, tparts):
        g = torch.zeros((n_dev, new_cap), dtype=t.dtype, device=t.device)
        g[:, :old_cap] = torch.where(k2, t, 0)
        grown.append(g)
    return (gkeys, *grown, torch.where(keep, tn, 0))


def clear_table(tkeys, tlens, tcnts, tparts, tn) -> None:
    """Reset the table to empty on the card, in place (reference
    ``_clear_device`` :388): a sync re-uploads nothing."""
    tkeys.fill_(_PAD_KEY32)
    for t in (tlens, tcnts, tparts, tn):
        t.zero_()


def pack_prefix(tkeys, tlens, tparts, tcnts, *, mp: int):
    """Prefix slice + pack for a table drain (reference
    ``_pack_prefix_impl`` :412): one int32 tensor [n_dev, mp, kk+2] (keys
    + len + part) plus the int64 count prefix — two copies per sync."""
    packed = torch.cat([tkeys[:, :mp], tlens[:, :mp, None],
                        tparts[:, :mp, None]], dim=2)
    return packed, tcnts[:, :mp]


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class DeviceTable:
    """Persistent merged word/count table on the card, folded per step,
    drained per sync window.

    ``acc`` is the host :class:`~dsi_tpu_torch.parallel.merge.PackedCounts`
    every drain merges into; ``lag`` is how many folds may stay
    unconfirmed before the oldest's flags are read (the streaming engine
    passes its pipeline depth minus one); ``sync()``/``close()``/widen
    flush the lag entirely.  ``mesh_shards`` > 0 switches the fold to the
    mesh-sharded fold (module docstring); it may not exceed ``n_dev``.
    """

    def __init__(self, n_dev: int, *, kk: int, cap: int, acc, device,
                 lag: int = 1, stats: Optional[dict] = None,
                 mesh_shards: int = 0):
        self.n_dev = int(n_dev)
        self.kk = int(kk)
        self.cap = _pow2(cap)
        self.acc = acc
        self.device = torch.device(device)
        self.lag = max(0, int(lag))
        self.mesh_shards = max(0, int(mesh_shards))
        if self.mesh_shards > self.n_dev:
            raise ValueError(
                f"mesh_shards={self.mesh_shards} exceeds the mesh size "
                f"({self.n_dev} shards); shards map 1:1 onto the mesh")
        self.stats = stats if stats is not None else {}
        for key in ("folds", "fold_overflows", "sync_pulls", "widens",
                    "pull_bytes"):
            self.stats.setdefault(key, 0)
        for key in ("fold_s", "sync_s", "widen_s"):
            self.stats.setdefault(key, 0.0)
        if self.mesh_shards:
            self.stats.setdefault("mesh_shards", self.mesh_shards)
            self.stats.setdefault("shard_widens", [0] * self.n_dev)
            self.stats.setdefault("shard_imbalance", 0.0)
        self._apply_all = torch.ones(self.n_dev, dtype=torch.bool,
                                     device=self.device)
        self._state = self._alloc(self.cap, self.kk)
        # Occupancy per shard after the last CONFIRMED fold (a no-op'd
        # fold reports the old occupancy, so this stays exact either way).
        self._nrows = np.zeros(self.n_dev, dtype=np.int64)
        # (flags copy, packed, scal) per unconfirmed fold: the step
        # tensors stay referenced until their fold is proven clean, so an
        # overflowed (no-op) fold can be replayed after a widen.
        self._pending: Deque[Tuple] = collections.deque()
        self.stats["table_cap"] = self.cap

    def _alloc(self, cap: int, kk: int):
        """Fresh empty table tensors, made on the card (no upload)."""
        opts = {"device": self.device}
        return (torch.full((self.n_dev, cap, kk), _PAD_KEY32,
                           dtype=torch.int32, **opts),
                torch.zeros((self.n_dev, cap), dtype=torch.int32, **opts),
                torch.zeros((self.n_dev, cap), dtype=torch.int64, **opts),
                torch.zeros((self.n_dev, cap), dtype=torch.int32, **opts),
                torch.zeros(self.n_dev, dtype=torch.int32, **opts))

    # ── the fold path ──

    def fold(self, packed_dev, scal_dev, scal_np: np.ndarray) -> None:
        """Dispatch one confirmed step's fold (no waiting) and confirm
        folds older than ``lag``.  ``packed_dev`` is the step's
        full-capacity packed reduce output ``[n_dev, rows, kk+3]``;
        ``scal_np`` its already host-checked scalar block."""
        step_kk = int(packed_dev.shape[2]) - 3
        if step_kk != self.kk:
            # The word window widened mid-stream: re-key via the widen
            # protocol (drain, reallocate at the new width, resume).
            self._rekey(step_kk, int(packed_dev.shape[1]))
        with timed(self.stats, "fold_s"):
            flags = self._dispatch_fold(packed_dev, scal_dev)
            self._pending.append((flags, packed_dev, scal_dev))
            self.stats["folds"] += 1
            while len(self._pending) > self.lag:
                self._confirm_oldest()

    def _dispatch_fold(self, packed_dev, scal_dev,
                       apply_np: Optional[np.ndarray] = None) -> HostCopy:
        """Launch one fold.  ``apply_np`` restricts a mesh fold to the
        masked shards (the recovery re-fold); normal folds apply to
        every shard."""
        if self.mesh_shards:
            apply = (self._apply_all if apply_np is None else
                     torch.as_tensor(apply_np, dtype=torch.bool,
                                     device=self.device))
            *state, flags = mesh_fold_step(*self._state, packed_dev,
                                           scal_dev, apply,
                                           n_shards=self.mesh_shards)
        else:
            *state, flags = fold_step(*self._state, packed_dev, scal_dev)
        self._state = tuple(state)
        return HostCopy(flags)

    def _note_flags(self, flags_np: np.ndarray) -> None:
        self._nrows = flags_np[:, 1].astype(np.int64)
        if self.mesh_shards:
            occ = self._nrows[:self.mesh_shards]
            tot = int(occ.sum())
            if tot:
                self.stats["shard_imbalance"] = round(
                    float(occ.max()) * self.mesh_shards / tot, 3)

    def _confirm_oldest(self) -> None:
        flags, packed_dev, scal_dev = self._pending.popleft()
        flags_np = flags.wait()  # blocks until this fold lands
        self._note_flags(flags_np)
        if flags_np[:, 0].any():
            self.stats["fold_overflows"] += 1
            self._recover([(packed_dev, scal_dev, flags_np[:, 0] > 0)])

    def _flush_pending(self):
        """Confirm every outstanding fold; return the (packed, scal,
        overflow mask) triples of folds that no-op'd, oldest first (the
        mask is per shard in mesh mode, every shard otherwise)."""
        orphans = []
        while self._pending:
            flags, packed_dev, scal_dev = self._pending.popleft()
            flags_np = flags.wait()
            self._note_flags(flags_np)
            if flags_np[:, 0].any():
                self.stats["fold_overflows"] += 1
                orphans.append((packed_dev, scal_dev, flags_np[:, 0] > 0))
        return orphans

    # ── overflow / widen protocol ──

    def _recover(self, orphans) -> None:
        """A fold overflowed and was a no-op (everywhere, or on the
        overflowed shards in mesh mode).  Later folds may already sit in
        the queue: flush them first (successes merged into the old table
        and drain with it; further overflows join the orphans), then widen
        and re-fold every orphan."""
        with timed(self.stats, "widen_s"):
            orphans = list(orphans) + self._flush_pending()
            if self.mesh_shards:
                self._recover_mesh(orphans)
                return
            while orphans:
                rows = max(int(p.shape[1]) for p, _, _ in orphans)
                self._widen(_pow2(max(4 * self.cap, rows)), self.kk)
                still = []
                for packed_dev, scal_dev, _ in orphans:
                    flags_np = self._dispatch_fold(packed_dev,
                                                   scal_dev).wait()
                    self._note_flags(flags_np)
                    if flags_np[:, 0].any():  # rung still too narrow
                        still.append((packed_dev, scal_dev, None))
                orphans = still

    def _recover_mesh(self, orphans) -> None:
        """Per-shard recovery: only the hot shards (the union of the
        orphans' overflow masks) drain to the host, come back empty in the
        wider allocation, and receive the orphaned steps' re-folds — each
        orphan re-applied only to its failed shards, so the shards that
        committed the first time never double-count.  Cold shards are
        carried over on the card."""
        while orphans:
            hot = np.zeros(self.n_dev, dtype=bool)
            for _, _, mask in orphans:
                hot |= np.asarray(mask, dtype=bool)
            rows = max(int(p.shape[1]) for p, _, _ in orphans)
            # The x4 rung ladder; the loop re-widens while orphans remain.
            self._widen(_pow2(max(4 * self.cap, rows)), self.kk, keep=~hot)
            for s in np.flatnonzero(hot):
                self.stats["shard_widens"][int(s)] += 1
            still = []
            for packed_dev, scal_dev, mask in orphans:
                flags_np = self._dispatch_fold(
                    packed_dev, scal_dev,
                    apply_np=np.asarray(mask, dtype=bool)).wait()
                self._note_flags(flags_np)
                if flags_np[:, 0].any():
                    still.append((packed_dev, scal_dev, flags_np[:, 0] > 0))
            orphans = still

    def _widen(self, new_cap: int, new_kk: int,
               keep: Optional[np.ndarray] = None) -> None:
        """Drain into the host accumulator and reallocate at
        ``new_cap``/``new_kk``.  Into an empty table at ``cap >= rows`` a
        single step always fits, so the re-fold loop terminates.  With
        ``keep`` (the per-shard protocol) only the dropped shards drain,
        and the kept shards carry their rows over on the card."""
        if keep is None or new_kk != self.kk:
            self._pull_merge()
            self.cap, self.kk = new_cap, new_kk
            self._state = self._alloc(self.cap, self.kk)
            self._nrows[:] = 0
        else:
            drain = ~np.asarray(keep, dtype=bool)
            self._pull_merge(only=drain)
            keep_dev = torch.as_tensor(np.asarray(keep, dtype=bool),
                                       device=self.device)
            self._state = grow_table(*self._state, keep_dev, new_cap)
            self.cap = new_cap
            self._nrows[drain] = 0
        self.stats["widens"] += 1
        self.stats["table_cap"] = self.cap

    def _rekey(self, new_kk: int, rows: int) -> None:
        with timed(self.stats, "widen_s"):
            # Outstanding folds still match the OLD width: confirm them
            # first (their steps' words provably fit the old window).
            orphans = self._flush_pending()
            if orphans:
                self._recover(orphans)
            self._widen(_pow2(max(self.cap, rows)), new_kk)

    def _pull_merge(self, only: Optional[np.ndarray] = None) -> bool:
        """Pull the occupied table prefix and merge it into the host
        accumulator.  Returns True if anything crossed to the host.  With
        ``only`` (a per-shard bool mask, the per-shard widen's drain) just
        the masked shards' slices cross, one copy each.  ``pull_bytes``
        counts what crossed."""
        sel = (self._nrows if only is None
               else np.where(np.asarray(only, dtype=bool), self._nrows, 0))
        m = int(sel.max())
        if m == 0:
            return False
        mp = occupied_prefix(m, self.cap)
        tkeys, tlens, tcnts, tparts, _ = self._state
        packed_dev, cnts_dev = pack_prefix(tkeys, tlens, tparts, tcnts,
                                           mp=mp)
        if only is None:
            shards = range(self.n_dev)
            packed = packed_dev.cpu().numpy().view(np.uint32)
            cnts = cnts_dev.cpu().numpy()
            self.stats["pull_bytes"] += packed.nbytes + cnts.nbytes
        else:
            shards = [int(d) for d in np.flatnonzero(sel)]
            packed = {d: packed_dev[d].cpu().numpy().view(np.uint32)
                      for d in shards}
            cnts = {d: cnts_dev[d].cpu().numpy() for d in shards}
            self.stats["pull_bytes"] += sum(packed[d].nbytes + cnts[d].nbytes
                                            for d in shards)
        for d in shards:
            n = int(self._nrows[d])
            if n == 0:
                continue
            r = packed[d][:n]
            self.acc.add(r[:, :self.kk], r[:, self.kk], cnts[d][:n],
                         r[:, self.kk + 1])
        return True

    def sync(self) -> bool:
        """The K-step host pull: flush the fold lag, drain the table into
        the accumulator, reset it to empty on the card.  Returns True when
        a pull happened (an empty window is not counted)."""
        with timed(self.stats, "sync_s"):
            orphans = self._flush_pending()
            if orphans:
                self._recover(orphans)
            pulled = self._pull_merge()
            if pulled:
                self.stats["sync_pulls"] += 1
                clear_table(*self._state)
                self._nrows[:] = 0
        return pulled

    def close(self) -> None:
        """Stream-end drain: flush + final pull, no reset (the table is
        dropped with the service)."""
        with timed(self.stats, "sync_s"):
            orphans = self._flush_pending()
            if orphans:
                self._recover(orphans)
            if self._pull_merge():
                self.stats["sync_pulls"] += 1
            self._state = None
