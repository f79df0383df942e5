"""Key routing for the mesh-sharded device services.

Port of ``dsi_tpu/ops/meshroute.py`` (``route_dest``, ``exchange_rows``,
``compact_received``, ``host_shard_of``, ``pack_host_rows``).  A key
belongs to shard ``ihash(key) % n_shards`` — the paper's partition
rule (``mr/worker.go:76``), ``fnv1a32(key) & 0x7fffffff`` over the key's
bytes, bit-exact with the host's ``ihash``.  The mesh is ``n_dev``
virtual shards, the leading tensor dimension, so the reference's
per-device routing and its ``all_to_all`` run for all shards at once:

* ``route_dest``: kernel D on the key lanes as they lie, over the first
  ``len`` bytes, with ``& 0x7fffffff`` and ``% n_shards`` in its
  epilogue; invalid rows park on ``n_dev``;
* ``exchange_rows``: kernel E, every shard's rows to their owning shard
  in stable order, one block per (destination, source) pair; with
  ``totals`` also each pair's routed row count, which E computes anyway;
* ``compact_received`` (``:83``): kernel L (``csrc/compact.cu``, through
  :func:`compact_rows`), the stable valid-first partition of the
  received rows that the TF-IDF wave step shares
  (``parallel/tfidf.py``).  The mesh-sharded postings append fuses it
  into kernel M instead (``device/postings.py``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from dsi_tpu_torch.mr.sequential import fnv32a
from dsi_tpu_torch.ops.wordcount import (
    _PAD_KEY32,
    _launch,
    _lib,
    _on_cuda,
    _on_device,
    _ptr,
    _require,
    fnv1a32_route,
    shuffle_rows,
)


def route_dest(keys: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
               *, n_shards: int, park: int) -> torch.Tensor:
    """Owning shard per row: ``ihash(key) % n_shards`` for valid rows,
    ``park`` otherwise.  ``keys`` [rows, kk] int32 (big-endian u32 lanes),
    ``lens`` [rows] int32 key byte lengths, ``valid`` [rows] bool; returns
    int32 [rows].  One launch of kernel D on the lanes, its epilogue the
    rule."""
    return fnv1a32_route(keys.contiguous(), lens.contiguous(),
                         4 * keys.shape[1], n_part=n_shards,
                         n_dest=n_shards, park=park,
                         valid=valid.contiguous())[2]


def exchange_rows(rows: torch.Tensor, dest: torch.Tensor, *, n_dev: int,
                  kk: int, totals: bool = False):
    """All-to-all every shard's rows ``rows`` [n_dev, r, kk+p] (int32) to
    their owning shards ``dest`` [n_dev, r] (``n_dev`` parks a row).
    Returns [n_dev, n_dev*r, kk+p]: per destination, the source blocks in
    shard order, each its rows in order then pad rows (key lanes all ones,
    zero payload).  With ``totals``, returns (recv, totals [n_dev, n_dev]
    int32): ``totals[s, d]`` rows of source s went to d, so
    ``recv[d, s*r : s*r + totals[s, d]]`` are that pair's rows.  On the
    card ``totals`` is a view of the scratch kernel E leaves behind
    ``recv`` (``dsi_route_totals_offset``); on the CPU the destination
    counts that :func:`shuffle_rows_plain` scatters by."""
    recv = shuffle_rows(rows, dest, n_dev=n_dev, k=kk)
    if not totals:
        return recv
    if not _on_cuda(recv):
        return recv, route_totals_plain(dest, n_dev=n_dev)
    r, w = rows.shape[1], rows.shape[2]
    return recv, recv.as_strided(
        (n_dev, n_dev), (n_dev, 1),
        n_dev * n_dev * r * w + _route_totals_word(n_dev, r, w))


def route_totals_plain(dest: torch.Tensor, *, n_dev: int) -> torch.Tensor:
    """[n_dev, n_dev] int32: per source shard (row of ``dest`` [n_dev,
    r]), its rows bound for each destination; a dest outside [0, n_dev)
    is dropped, as :func:`shuffle_rows_plain` parks it."""
    d = dest.to(torch.int64)
    d = torch.where((d < 0) | (d > n_dev), n_dev, d)
    src = torch.arange(dest.shape[0], device=dest.device)[:, None]
    counts = torch.bincount((src * (n_dev + 1) + d).reshape(-1),
                            minlength=dest.shape[0] * (n_dev + 1))
    return counts.view(-1, n_dev + 1)[:, :n_dev].to(torch.int32)


@functools.lru_cache(maxsize=None)
def _route_totals_word(n_dev: int, r: int, w: int) -> int:
    """Where kernel E's per-pair totals sit in its scratch, in int32
    words."""
    return _lib().dsi_route_totals_offset(n_dev, r, w) // 4


def compact_rows_plain(rows: torch.Tensor, *, pad_lanes: int):
    """Plain version of kernel L: per shard of ``rows`` [n_dev, r, w]
    (int32 bits), a stable ``torch.argsort`` of the pad flag (the first
    ``pad_lanes`` lanes all ones) and the gather it gives.  Returns (rows
    valid-first then pad, each side in row order; n_valid [n_dev] int32)."""
    is_pad = (rows[..., :pad_lanes] == _PAD_KEY32).all(dim=-1)
    order = torch.argsort(is_pad.to(torch.int8), dim=1, stable=True)
    out = torch.gather(rows, 1, order[..., None].expand_as(rows))
    return out, (~is_pad).sum(dim=1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _compact_scratch_words(n_dev: int, r: int, w: int) -> int:
    """Kernel L's scratch for one shape, in int32 words."""
    return -(-_lib().dsi_compact_scratch_bytes(n_dev, r, w) // 4)


def compact_rows(rows: torch.Tensor, *, pad_lanes: int):
    """Kernel L (``csrc/compact.cu``); see :func:`compact_rows_plain`.
    Replaces the stable pad-bit partitions of ``dsi_tpu``'s TF-IDF wave
    step (``parallel/tfidf.py:124-134``, ``pad_lanes`` 2: the first
    packed u64 key word) and of ``compact_received`` (``pad_lanes`` 1).
    On the card: one allocation (the rows, then ``n_valid``, then the
    kernel's scratch), one C call, two launches."""
    _require(rows, torch.int32, 3, "compact rows")
    n_dev, r, w = rows.shape
    if n_dev < 1 or r < 1 or not 1 <= pad_lanes <= w:
        raise ValueError(f"compact: bad shape {tuple(rows.shape)} "
                         f"pad_lanes={pad_lanes}")
    if not _on_cuda(rows):
        return compact_rows_plain(rows, pad_lanes=pad_lanes)
    lib = _lib()
    dev = rows.device
    words = n_dev * r * w
    buf = torch.empty(words + n_dev + _compact_scratch_words(n_dev, r, w),
                      dtype=torch.int32, device=dev)
    out = buf.as_strided((n_dev, r, w), (r * w, w, 1), 0)
    n_valid = buf.as_strided((n_dev,), (1,), words)
    base = _ptr(buf)
    with _on_device(dev):
        rc = lib.dsi_compact(_ptr(rows), n_dev, r, w, pad_lanes, base,
                             base + 4 * words, base + 4 * (words + n_dev),
                             torch._C._cuda_getCurrentRawStream(dev.index))
    _launch("compact", rc)
    return out, n_valid


def compact_received(recv: torch.Tensor):
    """Compact an :func:`exchange_rows` result ``recv`` [n_dev, R, w]: per
    shard, the real rows (lane 0 not all ones) first in received order,
    then the pad rows in received order.  Returns (rows, n_valid [n_dev]
    int32), the order-keeping prefix a postings append consumes."""
    return compact_rows(recv, pad_lanes=1)


def host_shard_of(word_bytes: bytes, n_shards: int) -> int:
    """The host oracle for :func:`route_dest`: ihash over the key bytes,
    mod the shard count."""
    return (fnv32a(word_bytes) & 0x7FFFFFFF) % n_shards


def pack_host_rows(words: Sequence[bytes], n_shards: int,
                   kk: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Byte-string keys in the routed-row layout (big-endian u32 lanes +
    length) plus the oracle shard of each: (keys [n, kk] uint32, lens [n]
    int32, shards [n] int32)."""
    n = len(words)
    keys = np.zeros((n, kk), dtype=np.uint32)
    lens = np.zeros(n, dtype=np.int32)
    shards = np.zeros(n, dtype=np.int32)
    for i, w in enumerate(words):
        b = w.ljust(4 * kk, b"\x00")[:4 * kk]
        keys[i] = np.frombuffer(b, dtype=">u4").astype(np.uint32)
        lens[i] = len(w)
        shards[i] = host_shard_of(w, n_shards)
    return keys, lens, shards
