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
  count park on ``n_dev``), E (``exchange_rows`` with its per-pair
  totals) and M's received entry (``postings_append_received``), which
  does ``compact_received``'s work inside the append: it reads only each
  pair's routed rows, drops those whose lane 0 is all ones, and writes
  the rest in received order.  A word's rows come from one source shard
  (the wave's shuffle grouped them) and E keeps source order, so
  per-word posting order survives the re-route; the overflow stays
  global and ``dirty`` sticky, as M computes them.
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
import functools
from typing import Callable, Deque, Optional, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ops.meshroute import (compact_rows_plain, exchange_rows,
                                         route_dest)
from dsi_tpu_torch.ops.wordcount import (
    _PAD_KEY32,
    HostCopy,
    _launch,
    _lib,
    _on_cuda,
    _on_device,
    _ptr,
    _require,
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


def _append_outputs(buf: torch.Tensor, extra_words: int = 0):
    """One allocation for an append's (n_out, dirty_out, flags) and
    ``extra_words`` of scratch: the tensors, and the address of each."""
    n_dev = buf.shape[0]
    outs = torch.empty(4 * n_dev + extra_words, dtype=torch.int32,
                       device=buf.device)
    base = _ptr(outs)
    return ((outs.as_strided((n_dev,), (1,), 0),
             outs.as_strided((n_dev,), (1,), n_dev),
             outs.as_strided((n_dev, 2), (2, 1), 2 * n_dev)),
            (base, base + 4 * n_dev, base + 8 * n_dev, base + 16 * n_dev))


def postings_append(buf, n, dirty, rows, scal):
    """Kernel M (``csrc/postings_append.cu``); see
    :func:`postings_append_plain`.  The new counts come back in fresh
    tensors, one allocation: the kernel never writes the ``n`` and
    ``dirty`` its blocks read."""
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
    dev = buf.device
    outs, (p_n, p_dirty, p_flags, _) = _append_outputs(buf)
    with _on_device(dev):
        rc = lib.dsi_postings_append(
            _ptr(buf), n_dev, cap, w, _ptr(n), _ptr(dirty), _ptr(rows), r,
            _ptr(scal), scal.shape[1], p_n, p_dirty, p_flags,
            torch._C._cuda_getCurrentRawStream(dev.index))
    _launch("postings_append", rc)
    return outs


def postings_append_received_plain(buf, n, dirty, recv, totals):
    """Plain version of kernel M's received entry: of ``recv`` [n_dev,
    n_dev*r, w] (an :func:`exchange_rows` result) only each pair's routed
    rows ``recv[d, s*r : s*r + totals[s, d]]`` count, less those whose
    lane 0 is all ones (``compact_received``'s pad test); the rest are
    compacted in received order with :func:`compact_rows_plain` and
    appended with :func:`postings_append_plain`.  Returns its (n_out,
    dirty_out, flags)."""
    n_dev, rr, _ = recv.shape
    r = rr // n_dev
    j = torch.arange(r, device=recv.device)
    routed = (j[None, None, :] < totals.t()[:, :, None]).reshape(n_dev, rr)
    rows = torch.where(routed[..., None], recv, _PAD_KEY32)
    crows, n_recv = compact_rows_plain(rows, pad_lanes=1)
    return postings_append_plain(buf, n, dirty, crows, n_recv.view(n_dev, 1))


@functools.lru_cache(maxsize=None)
def _received_scratch_words(n_dev: int, r: int) -> int:
    return -(-_lib().dsi_postings_append_received_scratch_bytes(n_dev, r)
             // 4)


def postings_append_received(buf, n, dirty, recv, totals):
    """Kernel M's received entry (``csrc/postings_append.cu``, counted as
    ``postings_append``); see :func:`postings_append_received_plain`.
    Fuses K20b's ``compact_received`` (kernel L's work) into the append:
    two launches, no pad row read or written.  ``totals`` [n_dev, n_dev]
    int32 is :func:`exchange_rows`'s; ``recv`` must be as kernel E wrote
    it (pad rows past each pair's routed rows, lane 0 all ones).  One
    allocation: the outputs and the kernel's scratch."""
    for t, nd, what in ((buf, 3, "postings buf"), (n, 1, "postings n"),
                        (dirty, 1, "postings dirty"),
                        (recv, 3, "received rows"),
                        (totals, 2, "route totals")):
        _require(t, torch.int32, nd, what)
    n_dev, cap, w = buf.shape
    rr = recv.shape[1]
    if (recv.shape[0] != n_dev or recv.shape[2] != w or rr < n_dev
            or rr % n_dev or cap < 1 or not 1 <= n_dev <= 1024
            or tuple(n.shape) != (n_dev,) or tuple(dirty.shape) != (n_dev,)
            or tuple(totals.shape) != (n_dev, n_dev)):
        raise ValueError(f"postings_append_received: bad shapes buf="
                         f"{tuple(buf.shape)} recv={tuple(recv.shape)} "
                         f"totals={tuple(totals.shape)}")
    if not _on_cuda(buf):
        return postings_append_received_plain(buf, n, dirty, recv, totals)
    lib = _lib()
    dev = buf.device
    r = rr // n_dev
    outs, (p_n, p_dirty, p_flags, p_scratch) = _append_outputs(
        buf, _received_scratch_words(n_dev, r))
    with _on_device(dev):
        rc = lib.dsi_postings_append_received(
            _ptr(buf), n_dev, cap, w, _ptr(n), _ptr(dirty), _ptr(recv), r,
            _ptr(totals), p_n, p_dirty, p_flags, p_scratch,
            torch._C._cuda_getCurrentRawStream(dev.index))
    _launch("postings_append", rc)
    return outs


def mesh_postings_append(buf, n, dirty, rows, scal, *, kk: int,
                         n_shards: int):
    """K20b (reference ``_mesh_append_device`` :104-141): re-route the
    wave's rows ``rows`` [n_dev, r, w] (the first ``scal[d, 0]`` of each
    shard valid; ``kk`` key lanes then the length) to shard ``ihash(word)
    % n_shards`` with D and E, and append what each shard received with
    M's received entry, which compacts it as the reference's
    ``compact_received`` does.  The received rows can number ``n_dev * r``
    on one shard.  Returns M's (n_out, dirty_out, flags)."""
    n_dev, r, _ = rows.shape
    if kk < 1:
        raise ValueError(f"mesh_postings_append: kk={kk}, want a key lane")
    valid = (torch.arange(r, device=rows.device)[None, :]
             < scal[:, :1])
    keys = torch.where(valid[..., None], rows[..., :kk], _PAD_KEY32)
    lens = torch.where(valid, rows[..., kk], 0)
    dest = route_dest(keys.reshape(-1, kk), lens.reshape(-1),
                      valid.reshape(-1), n_shards=n_shards, park=n_dev)
    recv, totals = exchange_rows(rows, dest.view(n_dev, r), n_dev=n_dev,
                                 kk=kk, totals=True)
    return postings_append_received(buf, n, dirty, recv, totals)


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
