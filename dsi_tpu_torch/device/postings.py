"""Append-only postings buffer on the card for the TF-IDF and indexer
wave walks.

Port of ``dsi_tpu/device/postings.py`` (``_append_device``,
``_mesh_append_device`` and ``DevicePostings``).  A wave's output is
postings, (word, len, tf, doc, part) rows that accumulate rather than
merge, so the buffer is an append: each confirmed wave's valid rows go
to ``[n_dev, cap, width]`` at the shard's write offset, and the host
pulls the buffer once per ``sync_every`` waves (``device/policy.py``) or
when it fills.

* ``postings_append`` (K20a): kernel M (``csrc/postings_append.cu``).
  The write offsets, the sticky ``dirty`` bit and the wave's row counts
  stay on the card; the overflow is global (the reference's ``pmax`` is
  a max over the leading dimension) and a no-op keeps the old buffer
  byte for byte, so the committed buffer is always an order-exact prefix
  of the appended waves.
* ``mesh_postings_append`` (K20b, ``mesh_shards``): every valid row is
  re-routed to shard ``ihash(word) % n_shards`` before the append, a
  chain of the port's kernels: D (``route_dest``; rows past a shard's
  count park on ``n_dev``), E (``exchange_rows``), L
  (``compact_received``, the received rows valid-first in received
  order) and M, given the compacted rows and L's counts.  A word's rows
  come from one source shard (the wave's shuffle grouped them) and E
  keeps source order, so per-word posting order survives the re-route;
  the overflow stays global and ``dirty`` sticky, as M computes them.
* flags are confirmed ``lag`` appends late, as the device table's are:
  a ``non_blocking`` copy into pinned memory with a CUDA event, waited
  on only when the append leaves the window.  An append that overflowed
  set ``dirty``, so every later one no-op'd too; recovery drains the
  committed prefix, then re-appends the orphans oldest-first, widening
  an empty buffer that one wave does not fit.  Overflow is an early sync
  or a widen, never a loss, and wave order in the sink is kept.

The checkpoint image is not ported yet.  ``stats`` receives ``appends``,
``append_overflows``, ``sync_pulls``, ``postings_widens``,
``pull_bytes``, ``append_s`` and ``drain_s``.
"""

from __future__ import annotations

import collections
from typing import Callable, Deque, Optional, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ops.meshroute import (compact_received, exchange_rows,
                                         route_dest)
from dsi_tpu_torch.ops.wordcount import (
    _PAD_KEY32,
    HostCopy,
    _launch,
    _lib,
    _on_cuda,
    _ptr,
    _require,
    _stream,
)
from dsi_tpu_torch.device.table import _pow2
from dsi_tpu_torch.parallel.pipeline import timed
from dsi_tpu_torch.parallel.shuffle import occupied_prefix


def postings_append_plain(buf, n, dirty, rows, scal):
    """Plain version of kernel M (reference ``_append_device`` :57-86):
    scatter each shard's first ``scal[d, 0]`` rows of ``rows`` [n_dev, r,
    w] at offset ``n[d]`` of ``buf`` [n_dev, cap, w] with ``index_copy``
    (rows past a shard's count, or past ``cap``, land on a dump row), then
    commit with ``torch.where``: every shard keeps its old rows if any
    shard would pass ``cap`` or ``dirty`` is set.  Updates ``buf`` in
    place; returns (n_out, dirty_out [n_dev] int32, flags [n_dev, 2] int32
    = (no_op, n_out))."""
    n_dev, cap, w = buf.shape
    r = rows.shape[1]
    dev = buf.device
    nr = scal[:, 0]
    new_n = n + nr
    ov = (new_n > cap).any().to(torch.int32)
    no_op = torch.maximum(ov, dirty)
    keep_old = no_op > 0
    j = torch.arange(r, device=dev)
    idx = torch.where(j[None, :] < nr[:, None], n[:, None] + j, cap)
    flat = (torch.arange(n_dev, device=dev)[:, None] * (cap + 1)
            + idx.clamp(max=cap)).reshape(-1)
    target = torch.cat([buf, torch.zeros((n_dev, 1, w), dtype=buf.dtype,
                                         device=dev)], dim=1)
    new_buf = target.view(-1, w).index_copy_(
        0, flat, rows.reshape(-1, w)).view(n_dev, cap + 1, w)[:, :cap]
    buf.copy_(torch.where(keep_old[:, None, None], buf, new_buf))
    out_n = torch.where(keep_old, n, new_n)
    return out_n, no_op, torch.stack([no_op, out_n], dim=1)


def postings_append(buf, n, dirty, rows, scal):
    """Kernel M (``csrc/postings_append.cu``); see
    :func:`postings_append_plain`.  The new counts come back in fresh
    tensors: the kernel never writes the ``n`` and ``dirty`` its blocks
    read."""
    _require(buf, torch.int32, 3, "postings buf")
    _require(n, torch.int32, 1, "postings n")
    _require(dirty, torch.int32, 1, "postings dirty")
    _require(rows, torch.int32, 3, "postings rows")
    _require(scal, torch.int32, 2, "postings scal")
    n_dev, cap, w = buf.shape
    r = rows.shape[1]
    if (rows.shape[0] != n_dev or rows.shape[2] != w or r < 1 or cap < 1
            or tuple(n.shape) != (n_dev,) or tuple(dirty.shape) != (n_dev,)
            or scal.shape[0] != n_dev or scal.shape[1] < 1):
        raise ValueError(f"postings_append: bad shapes buf={tuple(buf.shape)}"
                         f" rows={tuple(rows.shape)} scal={tuple(scal.shape)}")
    if not _on_cuda(buf):
        return postings_append_plain(buf, n, dirty, rows, scal)
    lib = _lib()
    opts = {"dtype": torch.int32, "device": buf.device}
    n_out = torch.empty(n_dev, **opts)
    dirty_out = torch.empty(n_dev, **opts)
    flags = torch.empty((n_dev, 2), **opts)
    with torch.cuda.device(buf.device):
        _launch("postings_append", lib.dsi_postings_append(
            _ptr(buf), n_dev, cap, w, _ptr(n), _ptr(dirty), _ptr(rows), r,
            _ptr(scal), scal.shape[1], _ptr(n_out), _ptr(dirty_out),
            _ptr(flags), _stream(buf)))
    return n_out, dirty_out, flags


def mesh_postings_append(buf, n, dirty, rows, scal, *, kk: int,
                         n_shards: int):
    """K20b (reference ``_mesh_append_device`` :104-141): re-route the
    wave's rows ``rows`` [n_dev, r, w] (the first ``scal[d, 0]`` of each
    shard valid; ``kk`` key lanes then the length) to shard ``ihash(word)
    % n_shards`` with D and E, compact what each shard received with L,
    and append it with M.  The received rows can number ``n_dev * r`` on
    one shard.  Returns M's (n_out, dirty_out, flags)."""
    n_dev, r, _ = rows.shape
    valid = (torch.arange(r, device=rows.device)[None, :]
             < scal[:, :1])
    keys = torch.where(valid[..., None], rows[..., :kk], _PAD_KEY32)
    lens = torch.where(valid, rows[..., kk], 0)
    dest = route_dest(keys.reshape(-1, kk), lens.reshape(-1),
                      valid.reshape(-1), n_shards=n_shards, park=n_dev)
    recv = exchange_rows(rows, dest.view(n_dev, r), n_dev=n_dev, kk=kk)
    crows, n_recv = compact_received(recv)
    return postings_append(buf, n, dirty, crows,
                           n_recv.view(n_dev, 1))


def _not_ported(what: str) -> NotImplementedError:
    from dsi_tpu_torch.parallel.streaming import _not_ported as nie

    return nie(what, "checkpoints")


class DevicePostings:
    """Persistent ``[n_dev, cap, width]`` append buffer on ``device``.
    ``append`` dispatches one wave's append (no waiting); its flags are
    confirmed ``lag`` appends later.  Drains hand each shard's occupied
    rows to ``sink`` (one ``[n, width]`` uint32 block per shard, shard
    order, wave order kept), on ``sync`` (the K-wave cadence), ``close``
    (end of walk) or overflow recovery.

    ``mesh_shards`` > 0 (at most ``n_dev``) appends through
    :func:`mesh_postings_append`: buffered postings shard by key, not by
    the wave's partition placement.  ``kk`` is the key-lane count
    (default ``width - 4``, the (keys, len, payload...) layout of both
    wave walks)."""

    def __init__(self, n_dev: int, *, width: int, cap: int,
                 sink: Callable[[np.ndarray], None], device,
                 lag: int = 0, stats: Optional[dict] = None,
                 mesh_shards: int = 0, kk: Optional[int] = None):
        self.n_dev = int(n_dev)
        self.width = int(width)
        self.cap = _pow2(cap)
        self.sink = sink
        self.device = torch.device(device)
        self.lag = max(0, int(lag))
        self.mesh_shards = max(0, int(mesh_shards))
        self.kk = int(kk) if kk is not None else self.width - 4
        if self.mesh_shards > self.n_dev:
            raise ValueError(
                f"mesh_shards={self.mesh_shards} exceeds the mesh size "
                f"({self.n_dev} shards)")
        self.stats = stats if stats is not None else {}
        for key in ("appends", "append_overflows", "sync_pulls",
                    "postings_widens", "pull_bytes"):
            self.stats.setdefault(key, 0)
        for key in ("append_s", "drain_s"):
            self.stats.setdefault(key, 0.0)
        self._alloc(self.cap)
        self._nrows = np.zeros(self.n_dev, dtype=np.int64)
        # (flags copy, rows, scal) per unconfirmed append: the wave
        # tensors stay referenced until the append is proven committed,
        # so a no-op'd append can be replayed after the drain.
        self._pending: Deque[Tuple] = collections.deque()

    def _alloc(self, cap: int) -> None:
        """A fresh empty buffer, made on the card (no upload)."""
        opts = {"dtype": torch.int32, "device": self.device}
        self._buf = torch.zeros((self.n_dev, cap, self.width), **opts)
        self._n = torch.zeros(self.n_dev, **opts)
        self._dirty = torch.zeros(self.n_dev, **opts)

    # ── the append path ──

    def _dispatch(self, rows_dev, scal_dev) -> HostCopy:
        if self.mesh_shards:
            self._n, self._dirty, flags = mesh_postings_append(
                self._buf, self._n, self._dirty, rows_dev, scal_dev,
                kk=self.kk, n_shards=self.mesh_shards)
        else:
            self._n, self._dirty, flags = postings_append(
                self._buf, self._n, self._dirty, rows_dev, scal_dev)
        return HostCopy(flags)

    def append(self, rows_dev, scal_dev) -> None:
        """Append one wave's valid rows and confirm appends older than
        ``lag``.  ``rows_dev`` is the wave's compacted received rows
        ``[n_dev, r, width]``, ``scal_dev`` its scalar block, column 0
        the valid row count (already checked exact by the caller)."""
        with timed(self.stats, "append_s"):
            flags = self._dispatch(rows_dev, scal_dev)
            self._pending.append((flags, rows_dev, scal_dev))
            while len(self._pending) > self.lag:
                self._confirm_oldest()

    def _confirm_oldest(self) -> None:
        flags, rows_dev, scal_dev = self._pending.popleft()
        flags_np = flags.wait()  # blocks until this append lands
        if flags_np[:, 0].any():
            self.stats["append_overflows"] += 1
            self._recover([(rows_dev, scal_dev)])
        else:
            self._nrows = flags_np[:, 1].astype(np.int64)
            self.stats["appends"] += 1

    def _flush_pending(self) -> list:
        """Confirm every outstanding append; return the (rows, scal)
        pairs that no-op'd, oldest first."""
        orphans = []
        while self._pending:
            flags, rows_dev, scal_dev = self._pending.popleft()
            flags_np = flags.wait()
            if flags_np[:, 0].any():
                self.stats["append_overflows"] += 1
                orphans.append((rows_dev, scal_dev))
            else:
                self._nrows = flags_np[:, 1].astype(np.int64)
                self.stats["appends"] += 1
        return orphans

    def _recover(self, orphans: list) -> None:
        """An append no-op'd, and so did every later one (sticky dirty):
        drain the committed prefix, then re-append the orphans
        oldest-first."""
        orphans = orphans + self._flush_pending()
        self._drain()
        for rows_dev, scal_dev in orphans:
            flags_np = self._dispatch(rows_dev, scal_dev).wait()
            if flags_np[:, 0].any():
                # Earlier orphans refilled the buffer: drain what fit, in
                # order, and retry into the empty buffer at this cap.
                self._drain()
                flags_np = self._dispatch(rows_dev, scal_dev).wait()
            if flags_np[:, 0].any():
                # A lone wave larger than the whole empty buffer: grow
                # it to hold the wave (the new allocation clears dirty).
                # The mesh route can deliver every shard's rows of one
                # wave to one shard.
                wave_rows = int(rows_dev.shape[-2]) * (
                    self.n_dev if self.mesh_shards else 1)
                self.cap = _pow2(max(4 * self.cap, wave_rows))
                self._alloc(self.cap)
                self._nrows[:] = 0
                self.stats["postings_widens"] += 1
                flags_np = self._dispatch(rows_dev, scal_dev).wait()
                if flags_np[:, 0].any():  # cap >= rows: cannot happen
                    raise RuntimeError(
                        "device postings buffer smaller than one wave"
                        f" (cap={self.cap})")
            self._nrows = flags_np[:, 1].astype(np.int64)
            self.stats["appends"] += 1

    # ── checkpoint image (not ported) ──

    def checkpoint_capture(self):
        raise _not_ported("DevicePostings.checkpoint_capture")

    def checkpoint_state(self):
        raise _not_ported("DevicePostings.checkpoint_state")

    def restore_state(self, img):
        raise _not_ported("DevicePostings.restore_state")

    def enable_delta(self, max_steps: int = 64):
        raise _not_ported("DevicePostings.enable_delta")

    def take_delta(self):
        raise _not_ported("DevicePostings.take_delta")

    # ── drains ──

    def _drain(self) -> None:
        """Pull every shard's committed rows (one sliced copy for the
        whole buffer), hand them to the sink, reset the counts on the
        card.  Buffer rows past the write offset are never read."""
        with timed(self.stats, "drain_s"):
            m = int(self._nrows.max())
            if m:
                mp = occupied_prefix(m, self.cap)
                pulled = self._buf[:, :mp].cpu().numpy().view(np.uint32)
                self.stats["pull_bytes"] += pulled.nbytes
                for d in range(self.n_dev):
                    nr = int(self._nrows[d])
                    if nr:
                        self.sink(pulled[d, :nr])
                self.stats["sync_pulls"] += 1
            self._n = torch.zeros_like(self._n)
            self._dirty = torch.zeros_like(self._dirty)
            self._nrows[:] = 0

    def sync(self) -> None:
        """The K-wave host pull: flush the append lag (recovering any
        late-found overflow), then drain to the sink."""
        orphans = self._flush_pending()
        if orphans:
            self._recover(orphans)
        self._drain()

    def close(self) -> None:
        """End-of-walk drain; the buffer is dropped with the service."""
        self.sync()
        self._buf = None
