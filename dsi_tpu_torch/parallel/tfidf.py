"""SPMD TF-IDF on the card: documents in waves of ``n_dev``, one per
virtual shard, from ``pg-*.txt`` to ``mr-out-*``.

Port of ``dsi_tpu/parallel/tfidf.py`` (``tfidf_wave_step``,
``plan_waves``, ``_wave_chunk``, ``TfidfStep``, ``tfidf_sharded``,
``FileDocs``, ``write_tfidf_output``).  The mesh is ``n_dev`` virtual
shards, the leading tensor dimension, as in ``parallel/shuffle.py``.  A
wave (K18, :func:`tfidf_wave_step`):

* map = per shard, ``map_prologue`` over its document (kernels A-D):
  each unique word a row of key lanes + (len, tf, doc, part);
* shuffle = kernel E routes every row to the shard that owns its reduce
  partition (``ihash % n_reduce % n_dev``);
* kernel L partitions each shard's received rows valid-first, both sides
  in received order (the reference's one-key ``lax.sort`` on the pad
  bit), and the wave returns ``[n_rows, n_unique, max_len, has_high,
  token_overflow]`` per shard.

The host walks the waves longest-first (``plan_waves``), ``depth``
waves in flight on the pipeline core (``parallel/pipeline.py``); a wave's
scalars are checked when it leaves the window, and a wave that overflowed
its rung replays alone through the ladder at a wider, then sticky,
(capacity, grouper, token buffer) rung.  Confirmed waves go to the host's
``PostingsTable`` (``parallel/merge.py``), one sliced pull a wave, or,
with ``device_accumulate``, append into the card's postings buffer
(``device/postings.py``, kernel M) that the host drains every
``sync_every`` waves; with ``mesh_shards`` the buffer re-routes every
appended row to shard ``ihash(word) % n_shards`` first (kernels D, E, L,
then M).  Scores are formatted at output time by the app's
``format_value``, so ``mr-out-*`` equal the sequential oracle's bytes.

With ``checkpoint_dir`` the walk is crash-resumable (``ckpt/``): the
cursor is the confirmed-wave ordinal, and a snapshot holds the postings
table, the postings buffer's image and the sticky rung, tagged with its
word-window rung (:class:`_WaveCkpt`); the resumed result equals an
uninterrupted walk's, and the chains are the reference's.

Not ported yet (raising ``NotImplementedError`` naming its ROADMAP
item): ``input_range``.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsi_tpu_torch.ckpt import (
    CheckpointPolicy,
    CheckpointStore,
    CheckpointWriter,
    DeltaSteps,
    HostDeltaLog,
    checkpoint_async_default,
    checkpoint_delta_default,
    drain_packed_steps,
    drain_posting_steps,
    fault_point,
)
from dsi_tpu_torch.device.policy import SyncPolicy, mesh_shards_default
from dsi_tpu_torch.device.postings import DevicePostings
from dsi_tpu_torch.device.table import DeviceTable
from dsi_tpu_torch.obs import span as _span
from dsi_tpu_torch.ops.meshroute import compact_rows
from dsi_tpu_torch.ops.wordcount import (
    HostCopy,
    grouper_ladder,
    resolve_device,
    rung0_cap,
    shuffle_rows,
    to_device,
)
from dsi_tpu_torch.parallel.merge import PostingsTable
from dsi_tpu_torch.parallel.pipeline import (
    StepPipeline,
    fold_source_stats,
    pipeline_depth,
    timed,
)
from dsi_tpu_torch.parallel.shuffle import map_prologue, occupied_prefix
from dsi_tpu_torch.parallel.stepobj import EngineStep
from dsi_tpu_torch.parallel.streaming import _not_ported


def wave_rows(chunks: torch.Tensor, doc_ids: torch.Tensor, *, n_dev: int,
              n_reduce: int, max_word_len: int, u_cap: int,
              t_cap_frac: int = 4, grouper: str = "sort",
              tf_ones: bool = False):
    """The wave's map (kernels A-D): per shard, its send rows [n_dev,
    u_cap, K+4] int32 (u32 bits: key lanes, len, tf, doc, part), their
    destinations [n_dev, u_cap] int32 and the map's [n_dev, 4] int32
    scalars (n_unique, max_len, has_high, token_overflow).

    The tf lane carries each word's count in its document, or 1 with
    ``tf_ones`` (the indexer's posting rows, one per distinct word)."""
    if chunks.dim() != 2 or chunks.shape[0] != n_dev \
            or tuple(doc_ids.shape) != (n_dev,):
        raise ValueError(f"tfidf wave: chunks {tuple(chunks.shape)} "
                         f"doc_ids {tuple(doc_ids.shape)} n_dev={n_dev}")
    rows, dests, map_scal = [], [], []
    for s in range(n_dev):
        packed_u, len_u, cnt_u, part, dest, sc = map_prologue(
            chunks[s], n_dev=n_dev, n_reduce=n_reduce,
            max_word_len=max_word_len, u_cap=u_cap, t_cap_frac=t_cap_frac,
            grouper=grouper)
        doc = doc_ids[s:s + 1].expand(u_cap)
        if tf_ones:
            cnt_u = torch.ones_like(cnt_u)
        rows.append(torch.cat([packed_u, len_u[:, None], cnt_u[:, None],
                               doc[:, None], part[:, None]], dim=1))
        dests.append(dest)
        map_scal.append(torch.stack([x.to(torch.int32) for x in sc]))
    return torch.stack(rows), torch.stack(dests), torch.stack(map_scal)


def wave_received(chunks: torch.Tensor, doc_ids: torch.Tensor, *,
                  n_dev: int, n_reduce: int, max_word_len: int, u_cap: int,
                  t_cap_frac: int = 4, grouper: str = "sort",
                  tf_ones: bool = False):
    """The wave's map and shuffle (kernels A-E): per shard, its received
    rows [n_dev, n_dev*u_cap, K+4] int32 in received order (source blocks
    in shard order, each its rows then pad rows), and the map's [n_dev, 4]
    int32 scalars; see :func:`wave_rows`."""
    rows, dests, map_scal = wave_rows(
        chunks, doc_ids, n_dev=n_dev, n_reduce=n_reduce,
        max_word_len=max_word_len, u_cap=u_cap, t_cap_frac=t_cap_frac,
        grouper=grouper, tf_ones=tf_ones)
    recv = shuffle_rows(rows, dests, n_dev=n_dev, k=max_word_len // 4)
    return recv, map_scal


def tfidf_wave_step(chunks: torch.Tensor, doc_ids: torch.Tensor, *,
                    n_dev: int, n_reduce: int, max_word_len: int,
                    u_cap: int, t_cap_frac: int = 4, grouper: str = "sort"):
    """One wave (K18): ``chunks`` [n_dev, L] uint8, one zero-padded
    document a shard; ``doc_ids`` [n_dev] int32.  Runs where the tensors
    lie and never waits on the card.

    Returns the outputs of the reference's ``tfidf_wave_step``: per-shard
    rows [n_dev, n_dev*u_cap, K+4] int32 (u32 bits: key lanes, len, tf,
    doc, part), valid rows first in received order, then the pad rows;
    and [n_dev, 5] int32 scalars (n_rows, n_unique, max_len, has_high,
    token_overflow)."""
    recv, map_scal = wave_received(
        chunks, doc_ids, n_dev=n_dev, n_reduce=n_reduce,
        max_word_len=max_word_len, u_cap=u_cap, t_cap_frac=t_cap_frac,
        grouper=grouper)
    # The reference's pad test is on the first packed u64 key word: lanes
    # 0 and 1 both all ones.
    srecv, n_rows = compact_rows(recv, pad_lanes=2)
    return srecv, torch.cat([n_rows[:, None], map_scal], dim=1)


def plan_waves(doc_lens: Sequence[int],
               n_dev: int) -> List[Tuple[List[int], int]]:
    """Assign documents to waves of ``n_dev``, longest-first: ``[(doc
    indices, chunk size), ...]``, the size the power of two holding the
    wave's own longest document (at least 256)."""
    order = sorted(range(len(doc_lens)), key=lambda i: doc_lens[i],
                   reverse=True)
    waves = []
    for w in range(0, len(order), n_dev):
        idxs = order[w:w + n_dev]
        longest = max(doc_lens[i] for i in idxs)
        waves.append((idxs, 1 << max(8, int(longest).bit_length())))
    return waves


def _wave_chunk(docs: Sequence[bytes], idxs: Sequence[int], n_dev: int,
                size: int) -> np.ndarray:
    """One wave's [n_dev, size] zero-padded block, built when the wave
    comes up, so host memory tracks the wave, not the corpus."""
    out = np.zeros((n_dev, size), dtype=np.uint8)
    for r, i in enumerate(idxs):
        out[r, :len(docs[i])] = np.frombuffer(docs[i], dtype=np.uint8)
    return out


class _AbortRung(Exception):
    """A wave proved this word-window rung's results will be discarded
    (non-ASCII input, or a word wider than the packed window): unwind the
    pipeline."""


def _check_rung(scal_np: np.ndarray, mwl: int, outcome: dict) -> None:
    """A wave's word-window check: non-ASCII input (``outcome["high"]``)
    or a word wider than ``mwl`` discards the rung (``_AbortRung``)."""
    if bool(scal_np[:, 3].any()):
        outcome["high"] = True
        raise _AbortRung
    if int(scal_np[:, 2].max()) > mwl:
        raise _AbortRung


def _replay_ladder(call, groupers: Sequence[str], cap: int, mwl: int,
                   outcome: dict):
    """The full exactness ladder for ONE wave, the replay path of a
    failed deferred check: ``call(cap, frac, grouper)`` launches the wave
    (its last output the scalars), through each grouper and token-buffer
    fraction until the tokens fit, then x4 capacity until the uniques
    do.  Returns (outputs, scalars on the host, (cap, grouper, frac)),
    the rung that cleared."""
    while True:
        for g in groupers:
            for frac in (4, 2):
                out = call(cap, frac, g)
                scal_np = out[-1].cpu().numpy()
                if not scal_np[:, 4].any():
                    break
            if not scal_np[:, 4].any():
                break
        _check_rung(scal_np, mwl, outcome)
        if int(scal_np[:, 1].max()) > cap:
            cap *= 4  # uniques <= tokens <= size/2: terminates
            continue
        return out, scal_np, (cap, g, frac)


def _wave_items(docs, waves, n_dev: int):
    """Each wave's (chunk [n_dev, size] uint8, doc ids [n_dev] int32),
    built when it comes up.  Padding slots of a short last wave carry doc
    id ``len(docs)``, which the engines' sinks discard."""
    n_real = len(docs)
    for idxs, size in waves:
        ids = np.array(list(idxs) + [n_real] * (n_dev - len(idxs)),
                       dtype=np.int32)
        yield _wave_chunk(docs, idxs, n_dev, size), ids


def _lens_crc(doc_lens) -> int:
    """CRC-32 of the per-document length vector: the wave plan, and with
    it the cursor's meaning, is a function of it, so it is part of a
    chain's identity (the same count and total in another order must
    refuse, not misalign the waves)."""
    return zlib.crc32(np.asarray(doc_lens, np.int64).tobytes())


class _WaveCkpt:
    """The wave walks' checkpoint chain (``ckpt/``, the reference's
    wave-cursor variant, shared by TF-IDF and the indexer): the store
    under ``ident``, the chain a resume loaded (``meta``, ``arrays``,
    ``deltas``; None when there was none), and the per-rung writer.

    A checkpoint belongs to one word-window rung: a rung restart discards
    the rung's state, so each rung gets a fresh writer (its first save is
    full) and the chain applies only at the rung it was saved at."""

    def __init__(self, checkpoint_dir, checkpoint_every, checkpoint_async,
                 checkpoint_delta, resume: bool, engine: str, ident: dict):
        self.every = checkpoint_every
        self.async_ = checkpoint_async_default(checkpoint_async)
        self.delta = checkpoint_delta_default(checkpoint_delta)
        self.store: Optional[CheckpointStore] = None
        self.meta = self.arrays = None
        self.deltas: list = []
        if checkpoint_dir:
            self.store = CheckpointStore(checkpoint_dir, engine, ident)
            if resume:
                loaded = self.store.load_latest_chain()
                if loaded is not None:
                    self.meta, self.arrays, self.deltas = loaded
            else:
                self.store.reset()  # a fresh lineage: no stale chain

    def rungs(self, rungs: tuple) -> tuple:
        """The word-window rungs to walk: a resume starts at the chain's
        own rung (an earlier one had aborted before it began)."""
        if self.meta is None:
            return rungs
        return tuple(m for m in rungs if m >= int(self.meta["mwl"])) or rungs

    def rung(self, mwl: int, stats: dict, state: dict, table, buf_dev,
             sync_policy, sink, mesh_shards: int, df_acc=None,
             make_topk=None) -> "_RungCkpt":
        """Rung ``mwl``'s checkpoints over its host table, postings buffer
        (None on the host path) and, for the indexer, its df accumulator
        and top-k factory."""
        return _RungCkpt(self, mwl, stats, state, table, buf_dev,
                         sync_policy, sink, mesh_shards, df_acc, make_topk)

    def restore_point(self, mwl: int):
        """The restore point's meta (the last delta's, newest wins) when
        the chain was saved at rung ``mwl``, else None."""
        eff = self.deltas[-1][0] if self.deltas else self.meta
        return eff if eff is not None and int(eff["mwl"]) == mwl else None

    def prefixed(self, prefix: str) -> dict:
        """The base image's arrays under ``prefix``, the prefix cut."""
        return {k[len(prefix):]: v for k, v in self.arrays.items()
                if k.startswith(prefix)}


class _RungCkpt:
    """One word-window rung's checkpoints, shared by TF-IDF and the
    indexer: the confirmed-wave cursor, the policy and writer (None
    without a store), the host path's delta log, and the restore and save
    over the rung's host table (``pt_``), postings buffer (``pb_``) and,
    for the indexer (``df_acc`` given), its df accumulator (``df_``) and
    df top-k (``table_``, deltas ``tk_``).  The indexer makes its df
    top-k at the first confirmed wave (:meth:`df_topk`) unless a
    same-degree full image restores it; ``topk`` is None until then."""

    def __init__(self, chain: _WaveCkpt, mwl, stats, state, table, buf_dev,
                 sync_policy, sink, mesh_shards, df_acc, make_topk):
        self.chain, self.mwl, self.stats, self.state = chain, mwl, stats, state
        self.table, self.buf, self.sync, self.sink = (table, buf_dev,
                                                      sync_policy, sink)
        self.mesh_shards = mesh_shards
        self.df_acc, self._make_topk = df_acc, make_topk
        self.topk = None
        self.wave = self.start_wave = 0  # absolute confirmed-wave ordinals
        self.host_delta = HostDeltaLog()
        self.policy = self.writer = None
        if chain.store is not None:
            self.policy = CheckpointPolicy(chain.every)
            stats.setdefault("ckpt_saves", 0)
            stats.setdefault("ckpt_s", 0.0)
            stats.setdefault("ckpt_capture_s", 0.0)
            stats.update({"ckpt_every": self.policy.every,
                          "ckpt_async": chain.async_,
                          "ckpt_delta": chain.delta})
            self.writer = CheckpointWriter(chain.store, stats,
                                           async_=chain.async_,
                                           delta=chain.delta)
        self.logging = self.writer is not None and chain.delta
        if self.logging and buf_dev is not None:
            buf_dev.enable_delta()
        self._restore()

    def df_topk(self, kk: int, cap: int):
        """The indexer's df top-k, made at its first use at ``cap``
        rows."""
        if self.topk is None:
            self.topk = self._make_topk(kk, cap)
            if self.logging:
                self.topk.enable_delta()
        return self.topk

    def _restore(self) -> None:
        """The loaded chain, when it was saved at this rung: the cursor
        and sticky rung, the host table, the services' images (uploaded
        at the same sharding degree from a full image, else drained into
        the host side), then each delta's waves, oldest first, through
        the sink (per-word posting order kept) and the df accumulator."""
        chain, st = self.chain, self.stats
        eff = (chain.restore_point(self.mwl) if self.writer is not None
               else None)
        if eff is None:
            return
        t_res = time.perf_counter()
        self.start_wave = self.wave = int(eff["wave"])
        self.state.update({"cap": int(eff["cap"]), "grouper": eff["grouper"],
                           "frac": int(eff["frac"])})
        self.table.restore(chain.prefixed("pt_"))
        if self.buf is not None:
            meta = chain.meta
            full = not chain.deltas
            saved = int(meta.get("mesh_shards", 0))
            if meta.get("pb_cap"):
                img = {"buf": chain.arrays["pb_buf"],
                       "nrows": chain.arrays["pb_nrows"],
                       "cap": meta["pb_cap"]}
                if full and saved == self.mesh_shards:
                    self.buf.restore_state(img)
                    if chain.delta:
                        self.buf.enable_delta()
                else:
                    DevicePostings.drain_image(self.sink, img)
                    if saved != self.mesh_shards:
                        st["resharded_resume"] = saved
            if self.df_acc is not None:
                self.df_acc.restore(chain.prefixed("df_"))
                if meta.get("table_cap"):
                    img = chain.prefixed("table_")
                    if full and saved == self.mesh_shards:
                        # The df table re-enters at the image's capacity
                        # and width.
                        self.topk = self._make_topk(int(meta["table_kk"]),
                                                    int(meta["table_cap"]))
                        self.topk.restore_state(img)
                        if chain.delta:
                            self.topk.enable_delta()
                    else:
                        DeviceTable.drain_image(self.df_acc, img)
                        if saved != self.mesh_shards:
                            st["resharded_resume"] = saved
            self.sync.restore(eff.get("sync_since", 0))
        for _, darr in chain.deltas:
            drain_posting_steps(self.sink, darr, "pb_")
            if self.df_acc is not None:
                drain_packed_steps(self.df_acc, darr, "tk_")
        st["resume_gap_s"] = time.perf_counter() - t_res
        st["resume_wave"] = self.start_wave

    def note_pulled(self, rows_np: np.ndarray, nvalid: np.ndarray) -> None:
        """The host path's pulled wave, kept for the next delta save."""
        if self.logging:
            self.host_delta.append(rows_np, nvalid)

    def after_wave(self) -> None:
        """A confirmed wave (empty waves too: the cursor passes them): the
        ``mid-fold`` fault point before the cursor moves, then a save when
        one is due."""
        fault_point("mid-fold")
        if self.policy is not None:
            self.wave += 1
            self.policy.note_step()
            if self.policy.due():
                self.save()
                self.policy.reset()

    def _delta_parts(self, meta: dict):
        """The payloads kept since the previous save (the services' logs
        with the buffer on, the pulled rows otherwise), or None when a log
        overflowed its window."""
        if self.buf is not None:
            pb = self.buf.take_delta()
            tk = self.topk.take_delta() if self.topk is not None else []
        else:
            pb, tk = self.host_delta.take(), []
        if pb is None or tk is None:
            return None
        parts = [("pb_", DeltaSteps(pb))]
        if self.df_acc is not None:
            parts.append(("tk_", DeltaSteps(tk)))
        if self.buf is not None:
            meta["sync_since"] = self.sync.snapshot()
        return parts

    def _full_parts(self, meta: dict) -> list:
        """A full image, and a fresh delta window: payloads recorded
        before this base are inside it."""
        parts = []
        if self.buf is not None:
            parts.append(("pb_", self.buf.checkpoint_capture()))
            meta["pb_cap"] = self.buf.cap
            meta["mesh_shards"] = self.buf.mesh_shards
            if self.topk is not None:
                parts.append(("table_", self.topk.checkpoint_capture()))
                meta["table_cap"] = self.topk.cap
                meta["table_kk"] = self.topk.kk
            if self.df_acc is not None:
                parts.append(("df_", self.df_acc.snapshot()))
            meta["sync_since"] = self.sync.snapshot()
            if self.chain.delta:
                self.buf.take_delta()
                if self.topk is not None:
                    self.topk.take_delta()
        self.host_delta.reset()
        parts.append(("pt_", self.table.snapshot()))
        return parts

    def save(self) -> None:
        """One consistent snapshot at a confirmed-wave boundary: capture
        here, commit inline or in the background writer.  Device captures
        first (flushing the postings buffer's lag drains into the host
        table on an overflow's recovery, and flushing the df top-k's can
        widen into ``df_acc``), the host residue second, so both sides of
        such a move land in the same image.  Every
        ``DSI_STREAM_CKPT_REBASE``-th save, and any save after a window
        that overflowed its log, is full; the others are deltas."""
        st, state = self.stats, self.state
        with _span("ckpt", stats=st, key="ckpt_s", wave=self.wave):
            meta = {"mwl": self.mwl, "wave": self.wave, "cap": state["cap"],
                    "grouper": state["grouper"], "frac": state["frac"]}
            with _span("ckpt_capture", lane="ckpt", stats=st,
                       key="ckpt_capture_s"):
                parts = (self._delta_parts(meta)
                         if self.writer.want_delta() else None)
                kind = "full" if parts is None else "delta"
                if parts is None:
                    parts = self._full_parts(meta)
            fault_point("mid-capture")
            self.writer.commit(parts, meta, kind=kind)

    def end(self, close_services: bool = True) -> None:
        """The walk's end: with ``close_services`` the final ``pre-sync``
        and the services' last drain; then the writer drained (commit
        errors surface before the result and the save counters are read)
        and shut down whatever happened."""
        try:
            if close_services and self.buf is not None:
                fault_point("pre-sync")
                self.buf.close()
                if self.topk is not None:
                    self.topk.close()
            if self.writer is not None:
                self.writer.drain()
        finally:
            if self.writer is not None:
                self.writer.shutdown()


def _postings_buffer(n_dev: int, kk: int, cap: int, sink, dev, depth: int,
                     stats: dict, mesh_shards: int, sync_every):
    """A rung's postings buffer on the card and its sync policy.  The
    capacity is ``cap`` (one worst-case wave, so drain-and-retry always
    fits) unless ``DSI_DEVICE_POSTINGS_CAP`` trims it (overflow then just
    syncs earlier, or widens for a lone larger wave)."""
    try:
        pcap = int(os.environ.get("DSI_DEVICE_POSTINGS_CAP", "0"))
    except ValueError:
        pcap = 0
    buf = DevicePostings(n_dev, width=kk + 4, cap=pcap if pcap > 0 else cap,
                         sink=sink, device=dev, lag=max(0, depth - 1),
                         stats=stats, mesh_shards=mesh_shards, kk=kk)
    policy = SyncPolicy(sync_every)
    stats["sync_every"] = policy.sync_every
    stats["mesh_shards"] = mesh_shards
    return buf, policy


class WaveWalkStep(EngineStep):
    """Step object base of the wave walks (TF-IDF here, the indexer in
    ``parallel/grepstream.py``): a wave proving the word window too
    narrow tears the rung down and the walk restarts at the 64-byte
    rung; non-ASCII input, or a word wider than 64 bytes, routes to the
    host path.  The engine's setup sets ``_rungs``, ``_begin_rung``,
    ``_mwl`` and ``_outcome``."""

    _rung_excs = (_AbortRung,)

    def _next_rung(self) -> bool:
        self._pipe.end()
        if self._writer is not None:
            self._writer.shutdown()  # a rung restart discards rung state
        if not self._outcome["high"]:
            nxt = [m for m in self._rungs if m > self._mwl]
            if nxt:
                self._begin_rung(nxt[0])
                return True
        # Non-ASCII, or a word wider than 64 bytes: the host path's job.
        self.result = None
        self._phase = "hostpath"
        return False


class TfidfStep(WaveWalkStep):
    """Step object over the TF-IDF wave walk (``parallel/stepobj.py``
    lifecycle, the word-window ladder of :class:`WaveWalkStep`);
    parameters as :func:`tfidf_sharded`."""

    def __init__(self, docs: Sequence[bytes], n_dev: int = 1,
                 n_reduce: int = 10, max_word_len: int = 16,
                 u_cap: int = 1 << 15, partitions: Optional[set] = None,
                 packed: bool = False, device_accumulate: bool = False,
                 sync_every: Optional[int] = None,
                 mesh_shards: Optional[int] = None,
                 wave_stats: Optional[dict] = None,
                 depth: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_async: Optional[bool] = None,
                 checkpoint_delta: Optional[bool] = None,
                 resume: bool = False,
                 input_range: Optional[tuple] = None,
                 device=None):
        super().__init__()
        if input_range is not None:
            raise _not_ported("input_range", "the plan and serving layers")
        _tfidf_setup(self, docs, n_dev, n_reduce, max_word_len, u_cap,
                     partitions, packed, device_accumulate, sync_every,
                     mesh_shards, wave_stats, depth, checkpoint_dir,
                     checkpoint_every, checkpoint_async, checkpoint_delta,
                     resume, resolve_device(device))


def tfidf_sharded(
        docs: Sequence[bytes], n_dev: int = 1, n_reduce: int = 10,
        max_word_len: int = 16, u_cap: int = 1 << 15,
        partitions: Optional[set] = None, packed: bool = False,
        device_accumulate: bool = False, sync_every: Optional[int] = None,
        mesh_shards: Optional[int] = None,
        wave_stats: Optional[dict] = None, depth: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_async: Optional[bool] = None,
        checkpoint_delta: Optional[bool] = None, resume: bool = False,
        input_range: Optional[tuple] = None, device=None,
):
    """Whole-corpus TF-IDF in waves of ``n_dev`` documents over ``n_dev``
    virtual shards on ``device`` (None = the card), ``depth`` waves in
    flight (default ``DSI_STREAM_PIPELINE_DEPTH``, 2).

    Returns ``{word: (reduce_partition, [(doc_index, tf), ...])}``, or
    ``merge.PackedPostings`` with ``packed=True``; None when a document
    needs the host path (non-ASCII bytes, a word longer than 64).  Exact
    and the same at every depth: a wave's deferred check that fails
    replays that wave alone through the ladder, and only waves proven
    exact reach the accumulator, in wave order.

    ``partitions`` keeps only those reduce partitions (the slices' union
    is the full result).  ``docs`` may be any sequence yielding bytes
    (:class:`FileDocs` reads each document when its wave comes up); a
    ``lengths`` attribute sizes the waves without loading them.

    ``device_accumulate=True`` appends each confirmed wave into the
    card's postings buffer (``device/postings.py``) and pulls it every
    ``sync_every`` appends (default ``DSI_STREAM_SYNC_EVERY``, 8), when
    it fills, and at the end; ``DSI_DEVICE_POSTINGS_CAP`` sets its
    capacity (default one wave's worst case, ``n_dev`` times the rung-0
    capacity).

    ``wave_stats``, if given, receives the wall seconds
    ``materialize_s``, ``materialize_wait_s``, ``upload_s``,
    ``dispatch_s`` (launching the waves; the reference does not report
    it), ``kernel_s`` (blocked on a wave's deferred check), ``pull_s``,
    ``merge_s`` and ``replay_s``, the counts ``waves``, ``depth``,
    ``replays``, ``max_inflight_waves`` and ``step_pulls``, and with
    ``device_accumulate`` the buffer's ``appends``, ``append_overflows``,
    ``sync_pulls``, ``postings_widens``, ``pull_bytes``, ``append_s``,
    ``drain_s`` and ``sync_every``.

    ``mesh_shards`` (default ``DSI_STREAM_MESH_SHARDS``, 0 = off; at
    most ``n_dev``; implies ``device_accumulate``) re-routes the buffered
    rows by ``ihash(word) % mesh_shards`` inside the append
    (``device/postings.py mesh_postings_append``); the result, posting
    order included, is the same.

    ``checkpoint_dir`` enables crash-resume (``ckpt/``): every
    ``checkpoint_every`` confirmed waves (default
    ``DSI_STREAM_CKPT_EVERY``, 32) a snapshot of the postings table, the
    buffer's image and the sticky rung, cursor the confirmed-wave ordinal;
    ``resume=True`` restores the newest chain and skips the waves before
    its cursor, the result equal to an uninterrupted walk's.
    ``checkpoint_async``/``checkpoint_delta`` (``DSI_STREAM_CKPT_ASYNC``/
    ``DSI_STREAM_CKPT_DELTA``) commit in the background writer and save
    only the waves since the previous save.  ``wave_stats`` then also
    receives the ``ckpt_*`` counters and, on resume, ``resume_gap_s`` and
    ``resume_wave``.  ``input_range`` keeps the reference's signature and
    raises ``NotImplementedError``.
    """
    return TfidfStep(
        docs, n_dev=n_dev, n_reduce=n_reduce, max_word_len=max_word_len,
        u_cap=u_cap, partitions=partitions, packed=packed,
        device_accumulate=device_accumulate, sync_every=sync_every,
        mesh_shards=mesh_shards, wave_stats=wave_stats, depth=depth,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        checkpoint_async=checkpoint_async,
        checkpoint_delta=checkpoint_delta, resume=resume,
        input_range=input_range, device=device).close()


def _tfidf_setup(step, docs, n_dev, n_reduce, max_word_len, u_cap,
                 partitions, packed, device_accumulate, sync_every,
                 mesh_shards, wave_stats, depth, checkpoint_dir,
                 checkpoint_every, checkpoint_async, checkpoint_delta,
                 resume, dev: torch.device):
    """The engine body behind :class:`TfidfStep`: corpus-wide setup (the
    chain to resume loaded), then ``begin_rung`` arms the pipeline and
    attaches the lifecycle hooks."""
    depth = pipeline_depth(depth)
    # ``mesh_shards`` re-routes the postings buffer by ``ihash(word) %
    # n_shards`` inside its append; it needs the buffer.
    mesh_shards = mesh_shards_default(mesh_shards)
    if mesh_shards:
        device_accumulate = True
    doc_lens = getattr(docs, "lengths", None)
    if doc_lens is None:
        doc_lens = [len(d) for d in docs]
    waves = plan_waves(doc_lens, n_dev)
    longest = max(doc_lens, default=1)
    size_max = 1 << max(8, int(longest).bit_length())  # capacity hard ref
    n_real = len(docs)
    stats = {"waves": len(waves), "step_pulls": 0, "depth": depth,
             "replays": 0, "device_accumulate": device_accumulate,
             "upload_s": 0.0, "dispatch_s": 0.0, "kernel_s": 0.0,
             "pull_s": 0.0, "merge_s": 0.0, "replay_s": 0.0}
    groupers = grouper_ladder(dev)
    chain = _WaveCkpt(
        checkpoint_dir, checkpoint_every, checkpoint_async, checkpoint_delta,
        resume, "tfidf",
        {"n_dev": n_dev, "n_reduce": n_reduce, "u_cap": u_cap,
         "n_docs": n_real, "doc_lens_crc32": _lens_crc(doc_lens),
         "partitions": (sorted(int(p) for p in partitions)
                        if partitions is not None else None),
         "device_accumulate": bool(device_accumulate)})

    def begin_rung(mwl: int):
        """One word-window rung: arm the pipelined wave walk at packed
        width ``mwl``.  A capacity overflow replays the one wave wider
        (and the rung sticks); non-ASCII input and a word wider than the
        window raise ``_AbortRung`` through the lifecycle."""
        kk = mwl // 4
        # A discarded rung drops its whole table (and device buffer), so
        # a partial rung never leaks into the result.
        table = PostingsTable()
        part_arr = (None if partitions is None
                    else np.fromiter(partitions, dtype=np.uint32))
        # Sticky dispatch rung: only ever moves toward more headroom.
        state = {"cap": rung0_cap(size_max, u_cap),
                 "grouper": groupers[0], "frac": 4}
        outcome = {"high": False}

        def buffer_rows(r: np.ndarray) -> None:
            """One shard's pulled rows into the host table, filtered
            first: the last wave's padding documents (doc id >= n_real)
            and, for a partition slice, other slices' rows."""
            r = r[r[:, kk + 2] < n_real]
            if part_arr is not None:
                r = r[np.isin(r[:, kk + 3], part_arr)]
            if len(r):
                table.add(r, kk)

        buf_dev = policy = None
        if device_accumulate:
            buf_dev, policy = _postings_buffer(
                n_dev, kk, n_dev * state["cap"], buffer_rows, dev, depth,
                stats, mesh_shards, sync_every)

        # Checkpoints: a fresh writer per rung, and the loaded chain
        # applied only at its own rung.
        ck = chain.rung(mwl, stats, state, table, buf_dev, policy,
                        buffer_rows, mesh_shards)

        def wave_call(chunk_np, ids_np, cap, frac, g):
            """Upload and launch one wave at one rung; no waiting."""
            with timed(stats, "upload_s"):
                chunks = to_device(chunk_np.reshape(-1), dev).view(n_dev, -1)
                ids = torch.as_tensor(ids_np, device=dev)
            with timed(stats, "dispatch_s"):
                return tfidf_wave_step(chunks, ids, n_dev=n_dev,
                                       n_reduce=n_reduce, max_word_len=mwl,
                                       u_cap=cap, t_cap_frac=frac, grouper=g)

        def dispatch(item):
            chunk_np, ids_np = item
            rows, scal = wave_call(chunk_np, ids_np, state["cap"],
                                   state["frac"], state["grouper"])
            out = (chunk_np, ids_np, rows, scal, HostCopy(scal),
                   state["cap"])
            fault_point("post-dispatch")
            return out

        def replay_wave(chunk_np, ids_np):
            """The exactness ladder for ONE wave; the rung that cleared
            sticks."""
            stats["replays"] += 1
            with timed(stats, "replay_s"):
                (rows, scal), scal_np, rung = _replay_ladder(
                    lambda cap, frac, g: wave_call(chunk_np, ids_np, cap,
                                                   frac, g),
                    groupers, state["cap"], mwl, outcome)
            state["cap"], state["grouper"], state["frac"] = rung
            return rows, scal, scal_np

        def commit(rows, scal, scal_np):
            m = int(scal_np[:, 0].max())
            if m == 0:
                return
            if buf_dev is not None:
                pulls_before = stats["sync_pulls"]
                buf_dev.append(rows, scal,
                               nvalid=scal_np[:, 0].astype(np.int64))
                policy.note_fold()
                if stats["sync_pulls"] != pulls_before:
                    policy.reset()  # an overflow recovery just drained:
                    # that was this window's pull
                elif policy.due():
                    fault_point("pre-sync")
                    buf_dev.sync()
                    policy.reset()
                return
            # Pull only the occupied prefix (pow2-rounded): the copy
            # tracks this wave's postings, not the capacity.
            with timed(stats, "pull_s"):
                mp = occupied_prefix(m, rows.shape[1])
                rows_np = rows[:, :mp].cpu().numpy().view(np.uint32)
                stats["step_pulls"] += 1
            with timed(stats, "merge_s"):
                for d in range(n_dev):
                    nr = int(scal_np[d, 0])
                    if nr:
                        buffer_rows(rows_np[d, :nr])
                ck.note_pulled(rows_np, scal_np[:, 0])

        def finish(rec):
            """Retire the oldest in-flight wave: deferred scalar check,
            then commit (clean) or replay at a wider rung (overflow)."""
            chunk_np, ids_np, rows, scal, scal_host, cap = rec
            with timed(stats, "kernel_s"):
                scal_np = scal_host.wait()  # blocks until the wave lands
            _check_rung(scal_np, mwl, outcome)
            if scal_np[:, 4].any() or int(scal_np[:, 1].max()) > cap:
                # Late-found overflow: replay just this wave.  Exactly
                # once: the optimistic attempt's rows are dropped
                # uncommitted, the replay's commit here and nowhere else.
                rows, scal, scal_np = replay_wave(chunk_np, ids_np)
            commit(rows, scal, scal_np)
            ck.after_wave()

        pipe = StepPipeline(depth=depth, dispatch=dispatch, finish=finish,
                            stats=stats, produce_key="materialize_s",
                            wait_key="materialize_wait_s",
                            inflight_key="max_inflight_waves",
                            thread_name="dsi-wave-materializer")
        step._pipe = pipe
        step._mwl = mwl
        step._outcome = outcome
        step._save = ck.save if ck.policy is not None else None
        step._writer = ck.writer
        pipe.begin(lambda: _wave_items(docs, waves[ck.start_wave:], n_dev))

        def end_ok():
            ck.end()  # the end-of-walk sync, then the writer's drain
            step.result = (table.finalize_packed() if packed
                           else table.finalize())

        step._on_complete = end_ok

    # The word-window ladder: a word wider than the packed window re-keys
    # every row, so that overflow class restarts the walk at 64.
    step._rungs = chain.rungs((max_word_len, 64) if max_word_len < 64
                              else (max_word_len,))
    step._begin_rung = begin_rung

    released = []

    def release():
        if released:
            return
        released.append(True)
        if step._writer is not None:  # the current rung's writer
            step._writer.shutdown()
        fold_source_stats(stats, docs)  # a doc source may pool-read too
        if wave_stats is not None:
            wave_stats.update(stats)

    step._release = release
    begin_rung(step._rungs[0])


class FileDocs:
    """Lazy document sequence for :func:`tfidf_sharded`: each document is
    read from disk when its wave comes up, not held resident."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        self.lengths = [os.path.getsize(p) for p in self.paths]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> bytes:
        with open(self.paths[i], "rb") as f:
            return f.read()


def write_tfidf_output(result: Dict[str, Tuple[int, List[Tuple[int, int]]]],
                       doc_names: Sequence[str], n_reduce: int,
                       workdir: str = ".") -> List[str]:
    """``mr-out-<r>`` files byte-identical to the host tfidf app's reduce
    output: scores by the shared ``format_value``, files by the shared
    partitioned writer (``shuffle.write_partitioned_output``)."""
    from dsi_tpu_torch.apps.tfidf import format_value
    from dsi_tpu_torch.parallel.shuffle import write_partitioned_output

    n_docs = len(doc_names)
    formatted = {
        w: (format_value([(doc_names[d], tf) for d, tf in pairs], n_docs), r)
        for w, (r, pairs) in result.items()}
    return write_partitioned_output(formatted, n_reduce, workdir)
