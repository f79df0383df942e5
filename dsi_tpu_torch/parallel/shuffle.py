"""SPMD MapReduce step on one card: map + shuffle + reduce per shard.

Port of ``dsi_tpu/parallel/shuffle.py``.  The reference runs one program
per device of a mesh and exchanges rows with ``lax.all_to_all``; here the
mesh is an integer ``n_dev`` of virtual shards, kept as the leading
tensor dimension on one card, and the all-to-all is the block transpose
that kernel E (``csrc/route.cu``, launched by ``ops/wordcount.py
shuffle_rows``) writes directly:

* map     = per-shard tokenize / group (kernels A-C through
  ``ops/wordcount.py group_chunk``), then kernel D with the partition
  rule ``part = fnv & 0x7fffffff % n_reduce``, ``dest = part % n_dev``
  in its epilogue (``fnv1a32_route``);
* shuffle = kernel E: every shard's rows to their destination shard, in
  stable order, one ``u_cap``-row block per (destination, source);
* reduce  = per-shard sort (kernel B) and group (kernel C) of the
  received rows, summing their counts.

Partitions map to shards round-robin, so shard ``d`` owns the reduce
partitions ``{r : r % n_dev == d}`` and the per-shard tables are
disjoint.  Exactness escapes (non-ASCII bytes, words longer than
``max_word_len``, more uniques or tokens than the buffers hold) come back
as per-shard scalars; ``wordcount_sharded`` retries wider or returns None
for the host path, as ``ops/wordcount.py`` does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ops.wordcount import (
    _u32_value,
    exactness_retry,
    fnv1a32_route,
    group_chunk,
    group_sorted,
    grouper_ladder,
    pack_key_lanes,
    radix_sort,
    resolve_device,
    shuffle_rows,
    to_device,
    unpack_key_rows,
)

# ── the step: map, shuffle, reduce ───────────────────────────────────────


def map_prologue(chunk: torch.Tensor, *, n_dev: int, n_reduce: int,
                 max_word_len: int, u_cap: int, t_cap_frac: int,
                 grouper: str = "sort"):
    """Per-shard map phase: tokenize + combine + partition.

    The one place the reference-parity partition rule lives on the card:
    ``part = fnv1a32(word) & 0x7fffffff % n_reduce`` (mr/worker.go:33-37,
    76) with destination shard ``part % n_dev``; invalid rows are parked
    on ``n_dev`` for :func:`shuffle_rows`.

    Returns (packed_u, len_u, cnt_u, part, dest, scalars) with scalars =
    (n_unique, max_len, has_high, token_overflow); part and dest int32."""
    keys_u, packed_u, len_u, cnt_u, n_unique, *scal = group_chunk(
        chunk, max_word_len=max_word_len, u_cap=u_cap,
        t_cap_frac=t_cap_frac, grouper=grouper)
    # Kernel D with its epilogue: the hash, part and dest in one launch.
    _, part, dest = fnv1a32_route(keys_u, len_u, max_word_len,
                                  n_part=n_reduce, n_dest=n_dev, park=n_dev,
                                  n_valid=n_unique)
    return packed_u, len_u, cnt_u, part, dest, (n_unique, *scal)


def _reduce_shard(recv: torch.Tensor, k: int, out_cap: int):
    """One shard's reduce half (reference ``_device_step`` :143-164):
    sort the received rows by key words (kernel B), then group them
    (kernel C) summing their counts; length and partition are functions
    of the word, so any row of a run gives them."""
    keys64 = torch.stack(pack_key_lanes(tuple(recv[:, j]
                                              for j in range(k))))
    skeys, perm = radix_sort(keys64)
    pl = perm.to(torch.int64)
    counts = _u32_value(recv[:, k + 1])[pl]
    keys_u, tot, upos, len_u, m_unique = group_sorted(
        skeys, counts, out_cap, payload=recv[:, k].contiguous(), perm=perm)
    ovalid = torch.arange(out_cap, device=recv.device) < m_unique
    part_u = torch.where(ovalid, recv[:, k + 2][pl[upos.to(torch.int64)]],
                         0)
    return (unpack_key_rows(keys_u.T, k), len_u, tot.to(torch.int32),
            part_u, m_unique)


def mapreduce_step(chunks: torch.Tensor, *, n_dev: int, n_reduce: int,
                   max_word_len: int, u_cap: int, t_cap_frac: int = 4,
                   grouper: str = "sort"):
    """The full SPMD job step over ``chunks`` [n_dev, L] uint8, one
    zero-padded text shard per virtual shard; runs where ``chunks`` lies
    and never waits on the card.

    Returns per-shard tensors stacked on dim 0, the outputs of the
    reference's ``mapreduce_step``: word keys [n_dev, n_dev*u_cap, K]
    (u32 bits), byte lengths, summed counts, reduce partitions (int32),
    and an [n_dev, 5] int32 scalar block (m_unique, n_unique, max_len,
    has_high, token_overflow)."""
    if chunks.dim() != 2 or chunks.shape[0] != n_dev:
        raise ValueError(f"mapreduce_step: chunks {tuple(chunks.shape)} "
                         f"for n_dev={n_dev}")
    k = max_word_len // 4
    rows, dests, map_scal = [], [], []
    for s in range(n_dev):
        packed_u, len_u, cnt_u, part, dest, sc = map_prologue(
            chunks[s], n_dev=n_dev, n_reduce=n_reduce,
            max_word_len=max_word_len, u_cap=u_cap, t_cap_frac=t_cap_frac,
            grouper=grouper)
        rows.append(torch.cat([packed_u, len_u[:, None], cnt_u[:, None],
                               part[:, None]], dim=1))
        dests.append(dest)
        map_scal.append(torch.stack([x.to(torch.int32) for x in sc]))
    recv = shuffle_rows(torch.stack(rows), torch.stack(dests), n_dev=n_dev,
                        k=k)
    out = [_reduce_shard(recv[d], k, n_dev * u_cap) for d in range(n_dev)]
    scal = torch.stack([torch.cat([o[4].to(torch.int32).reshape(1), m])
                        for o, m in zip(out, map_scal)])
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]),
            torch.stack([o[2] for o in out]),
            torch.stack([o[3] for o in out]), scal)


def occupied_prefix(m: int, cap_rows: int) -> int:
    """Pow2-rounded occupied prefix of a ``cap_rows``-row result table with
    ``m`` valid rows (m >= 1): the one shape-bounding rule shared by every
    sliced device-to-host pull."""
    return min(cap_rows, 1 << max(6, (m - 1).bit_length()))


def _slice_pack(keys, lens, cnts, parts, *, mp: int) -> torch.Tensor:
    """Prefix slice + pack of a step's four result tables into ONE int32
    tensor [n_dev, mp, K+3] (u32 bits), so a pull is one copy.  Lengths,
    counts and partitions are small non-negative ints."""
    return torch.cat([keys[:, :mp], lens[:, :mp, None], cnts[:, :mp, None],
                      parts[:, :mp, None]], dim=2)


def _is_letter_byte(b: int) -> bool:
    return (65 <= b <= 90) or (97 <= b <= 122)


def shard_text(data: bytes, n_shards: int) -> Tuple[np.ndarray, int]:
    """Split text into n equal-ish shards, cutting only at non-letter
    boundaries so no token straddles a shard, and zero-pad all shards to
    one power-of-two length.  Returns ([n_shards, L] uint8, L)."""
    n = len(data)
    cuts = [0]
    for i in range(1, n_shards):
        c = min(i * n // n_shards, n)
        # Advance past any letter run so data[c-1], data[c] are never both
        # letters (a cut inside a run would split a token).
        while 0 < c < n and _is_letter_byte(data[c - 1]) and \
                _is_letter_byte(data[c]):
            c += 1
        cuts.append(min(c, n))
    cuts.append(n)
    cuts = sorted(cuts)
    longest = max(cuts[i + 1] - cuts[i] for i in range(n_shards))
    size = 1 << max(8, longest.bit_length())
    out = np.zeros((n_shards, size), dtype=np.uint8)
    for i in range(n_shards):
        piece = data[cuts[i]:cuts[i + 1]]
        out[i, :len(piece)] = np.frombuffer(piece, dtype=np.uint8)
    return out, size


def wordcount_sharded(
        data: bytes, n_dev: int = 1, n_reduce: int = 10,
        max_word_len: int = 16, u_cap: int = 1 << 15,
        device=None) -> Optional[Dict[str, Tuple[int, int]]]:
    """Count words over the whole corpus with one step per attempt over
    ``n_dev`` virtual shards.

    Returns ``{word: (count, reduce_partition)}`` — exact, or None when
    the input needs the host path (non-ASCII bytes or words longer than
    64).  Retries with wider shapes on capacity overflow, and through the
    device's grouper ladder, as ``ops.wordcount.count_words_host_result``
    does."""
    dev = resolve_device(device)
    chunks_np, shard_len = shard_text(data, n_dev)
    chunks = to_device(chunks_np.reshape(-1), dev).view(n_dev, -1)
    groupers = grouper_ladder(dev)

    def run(mwl: int, cap: int):
        for g in groupers:
            for frac in (4, 2):  # exact token bound is n//2+1
                keys, lens, cnts, parts, scal_dev = mapreduce_step(
                    chunks, n_dev=n_dev, n_reduce=n_reduce,
                    max_word_len=mwl, u_cap=cap, t_cap_frac=frac,
                    grouper=g)
                scal = scal_dev.cpu().numpy()
                if not scal[:, 4].any():
                    break
            if not scal[:, 4].any():
                break

        def payload():
            # One sliced pull per attempt, merged on the host by the
            # vectorized table: the shards' tables are disjoint.
            from dsi_tpu_torch.parallel.merge import PackedCounts

            m = int(scal[:, 0].max())
            if m == 0:
                return {}
            mp = occupied_prefix(m, keys.shape[1])
            kk = keys.shape[2]
            packed = _slice_pack(keys, lens, cnts, parts,
                                 mp=mp).cpu().numpy().view(np.uint32)
            acc = PackedCounts()
            acc.add_packed_step(packed, scal[:, 0], kk)
            return acc.finalize()

        return (bool(scal[:, 3].any()), int(scal[:, 1].max()),
                int(scal[:, 2].max()), payload)

    payload = exactness_retry(run, shard_len, max_word_len, u_cap)
    return None if payload is None else payload()


def write_partitioned_output(result: Dict[str, Tuple[int, int]],
                             n_reduce: int, workdir: str = ".") -> List[str]:
    """Materialise mr-out-<r> files from a sharded result — the file
    layout, line format ("%v %v\\n", mr/worker.go:144) and within-file key
    order of the reference's reduce tasks (worker.go:124-146)."""
    from dsi_tpu_torch.utils.atomicio import atomic_write

    by_part: List[List[Tuple[str, int]]] = [[] for _ in range(n_reduce)]
    for w, (c, r) in result.items():
        by_part[r].append((w, c))
    paths = []
    for r in range(n_reduce):
        path = os.path.join(workdir, f"mr-out-{r}")
        with atomic_write(path) as f:
            for w, c in sorted(by_part[r]):
                f.write(f"{w} {c}\n")
        paths.append(path)
    return paths
