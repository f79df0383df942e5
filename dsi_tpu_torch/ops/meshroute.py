"""Key routing for the mesh-sharded device table.

Port of ``dsi_tpu/ops/meshroute.py`` (``route_dest``, ``exchange_rows``,
``host_shard_of``, ``pack_host_rows``).  A key belongs to shard
``ihash(key) % n_shards`` — the paper's partition rule (``mr/worker.go:76``),
``fnv1a32(key) & 0x7fffffff`` over the key's bytes, bit-exact with the
host's ``ihash``.  The mesh is ``n_dev`` virtual shards, the leading
tensor dimension, so the reference's per-device routing and its
``all_to_all`` run for all shards at once:

* ``route_dest``: the key lanes packed into u64 key words, kernel D over
  the first ``len`` bytes, then ``& 0x7fffffff`` and ``% n_shards``;
  invalid rows park on ``n_dev``;
* ``exchange_rows``: kernel E, every shard's rows to their owning shard
  in stable order, one block per (destination, source) pair.

``compact_received`` (``:83``), which only the mesh-sharded postings
append reads, is ported with the postings (ROADMAP Queue 1, indexer and
TF-IDF).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from dsi_tpu_torch.mr.sequential import fnv32a
from dsi_tpu_torch.ops.wordcount import (
    _u32_value,
    fnv1a32_packed,
    pack_key_lanes,
    shuffle_rows,
)


def route_dest(keys: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
               *, n_shards: int, park: int) -> torch.Tensor:
    """Owning shard per row: ``ihash(key) % n_shards`` for valid rows,
    ``park`` otherwise.  ``keys`` [rows, kk] int32 (big-endian u32 lanes),
    ``lens`` [rows] int32 key byte lengths, ``valid`` [rows] bool; returns
    int32 [rows]."""
    kk = keys.shape[1]
    keys64 = torch.stack(pack_key_lanes(tuple(keys[:, j]
                                              for j in range(kk))))
    h = fnv1a32_packed(keys64, lens.contiguous(), 4 * kk)
    dest = ((_u32_value(h) & 0x7FFFFFFF) % n_shards).to(torch.int32)
    return torch.where(valid, dest, park).to(torch.int32)


def exchange_rows(rows: torch.Tensor, dest: torch.Tensor, *, n_dev: int,
                  kk: int) -> torch.Tensor:
    """All-to-all every shard's rows ``rows`` [n_dev, r, kk+p] (int32) to
    their owning shards ``dest`` [n_dev, r] (``n_dev`` parks a row).
    Returns [n_dev, n_dev*r, kk+p]: per destination, the source blocks in
    shard order, each its rows in order then pad rows (key lanes all ones,
    zero payload)."""
    return shuffle_rows(rows, dest, n_dev=n_dev, k=kk)


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
