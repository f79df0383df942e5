"""Versioned, CRC-guarded checkpoint store.

Copy of ``dsi_tpu/ckpt/store.py``.

One checkpoint = one numpy payload (``state-<seq>.npz``: every array the
engine needs back, host accumulators and pulled device-service images
alike) plus one JSON manifest (``manifest-<seq>.json``: format version,
engine name, job identity, cursor and sticky-rung metadata, and the
payload's name + CRC32).  Both files go through the shared durable-write
path (``utils/atomicio.write_bytes_durable``: temp + fsync + rename +
CRC32 sidecar + parent-dir fsync) — the same discipline the control
plane's journal uses, so a crash at ANY instant leaves either a fully
valid checkpoint or recognisable garbage, never a half-truth:

* crash mid-payload: a ``.tmp-*`` orphan, no manifest — invisible to
  the loader, reaped by the next save;
* crash between payload and manifest: a payload with no manifest —
  invisible;
* torn/corrupt file that somehow survives rename: the CRC sidecar (and
  the payload CRC recorded in the manifest) fails verification and the
  loader falls back to the previous checkpoint — which is why the last
  TWO checkpoints are retained and only older ones garbage-collected.

The manifest carries the job identity (engine name + the shape knobs
that change byte layout); resuming against a different job is refused
rather than silently corrupting state — the journal-header rule.

Payloads may be COMPRESSED (``DSI_STREAM_CKPT_COMPRESS``,
default ``deltas``): the serialize step swaps ``np.savez`` for
``np.savez_compressed`` into the same ``BytesIO``, so the durable
commit path (CRC sidecar, tmp+fsync+rename) and every loader are
byte-for-byte unchanged — ``np.load`` reads both flavors, mixed
chains restore fine, and the mode is deliberately NOT part of the job
identity.  ``last_payload_raw_bytes``/``last_compress_s`` feed the
``ckpt_delta_raw_bytes``/``ckpt_compress_s`` attribution through the
writer.

## Delta chains (incremental snapshots)

A checkpoint may be INCREMENTAL: ``save_delta`` writes a
``delta-<seq>.npz`` payload whose manifest carries ``kind: "delta"`` and
``prev: <seq>`` — the checkpoint it extends.  A chain is one full image
(``state-<seq>.npz``, the base) plus the ordered deltas chained onto it;
restoring a chain = restore the base, then re-apply each delta's
increment oldest-first (the engines re-ingest the delta rows through
their host drain path, which is order-insensitive for count merges and
order-preserving for postings — the same argument the cross-degree
resume already rests on).  Newest-valid-wins generalizes to chains: the
loader walks manifests newest→oldest and returns the first seq whose
ENTIRE chain back to a base verifies; a torn middle delta invalidates
every seq above it and the walk falls back to the last complete chain
(ultimately the bare base).  GC is chain-aware: the last two restore
points are retained *with every chain member they reference*, so a
live delta chain can never lose its base to retention.
"""

from __future__ import annotations

import io
import json
import os
import re
import time
import zlib
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from dsi_tpu_torch.ckpt.policy import checkpoint_compress_default
from dsi_tpu_torch.obs import trace_event as _trace_event
from dsi_tpu_torch.utils.atomicio import (
    read_bytes_verified,
    reap_tmp_files,
    write_bytes_durable,
)

#: Bumped whenever the payload/manifest layout changes incompatibly; a
#: loader refuses versions it does not know instead of misreading them.
CKPT_VERSION = 1

_MANIFEST_RE = re.compile(r"^manifest-(\d{6})\.json$")


class CheckpointMismatch(RuntimeError):
    """A valid checkpoint exists but belongs to a different job."""


def _zlevel() -> int:
    """Deflate level for compressed payloads (``DSI_STREAM_CKPT_ZLEVEL``,
    default 1): on the 2-core boxes the CommitWorker shares with the
    engine, level 1 keeps ~85% of level 6's ratio at ~1/3 the CPU —
    cadence-1 overhead stays flat while the bytes still drop 2-5x."""
    try:
        return min(9, max(1, int(os.environ.get("DSI_STREAM_CKPT_ZLEVEL",
                                                "1"))))
    except ValueError:
        return 1


def _write_npz_compressed(buf, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez_compressed`` with a CHOSEN deflate level (numpy
    hardcodes the zlib default): same zip-of-.npy container, so
    ``np.load`` reads it identically and mixed chains stay readable."""
    import zipfile

    from numpy.lib import format as npformat

    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=_zlevel()) as zf:
        for k, v in arrays.items():
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                npformat.write_array(f, np.asarray(v),
                                     allow_pickle=False)


def skip_stream(blocks: Iterable[bytes], skip: int) -> Iterator[bytes]:
    """Drop the first ``skip`` bytes of a block stream — the resume
    seek.  The engines' batchers are pure functions of the byte stream,
    so feeding them the suffix from the confirmed cursor reproduces the
    uninterrupted run's remaining batches exactly."""
    remaining = int(skip)
    for b in blocks:
        if remaining:
            if len(b) <= remaining:
                remaining -= len(b)
                continue
            b = bytes(memoryview(b)[remaining:])
            remaining = 0
        yield b


class CheckpointStore:
    """Save/load numbered (payload, manifest) checkpoint pairs in one
    directory, newest-valid-wins, last two retained."""

    def __init__(self, directory: str, engine: str, job: Dict,
                 compress: Optional[str] = None):
        self.dir = directory
        self.engine = engine
        #: The identity a checkpoint must match to be resumable: every
        #: knob that changes byte layout or stream cutting (chunk size,
        #: mesh width, reduce count, pattern, ...).  JSON-normalised so
        #: tuple-vs-list spelling differences can't refuse a real match.
        self.job = json.loads(json.dumps(job))
        #: Payload-compression mode (``ckpt/policy.py
        #: checkpoint_compress_default``: off / deltas / all).  Purely a
        #: serialization choice — ``np.load`` reads both npz flavors, so
        #: mixed chains restore fine and the mode is NOT part of the job
        #: identity.
        self.compress = checkpoint_compress_default(compress)
        #: Serialized payload size of the most recent save — the writer's
        #: ``ckpt_full_bytes``/``ckpt_delta_bytes`` add it up.
        self.last_payload_bytes = 0
        #: Raw array bytes behind the most recent payload (sum of
        #: ``nbytes`` — the compression ratio's denominator) and the
        #: seconds the compressing serialize spent (0.0 for a raw save);
        #: the writer maps these to ``ckpt_delta_raw_bytes`` /
        #: ``ckpt_compress_s``.
        self.last_payload_raw_bytes = 0
        self.last_compress_s = 0.0
        os.makedirs(self.dir, exist_ok=True)

    # ── paths ──

    def _manifest_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"manifest-{seq:06d}.json")

    def _payload_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"state-{seq:06d}.npz")

    def _delta_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"delta-{seq:06d}.npz")

    def _seqs(self) -> list[int]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := _MANIFEST_RE.match(n)))

    # ── writing ──

    def reset(self) -> None:
        """Start a fresh lineage: remove every manifest/payload/sidecar
        (and orphan temp file) so a later ``--resume`` can never pick up
        a checkpoint from a PREVIOUS job's run that this run has since
        diverged from."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for n in names:
            if (n.startswith(("manifest-", "state-", "delta-", ".tmp-"))
                    and not os.path.isdir(os.path.join(self.dir, n))):
                try:
                    os.remove(os.path.join(self.dir, n))
                except OSError:
                    pass
        # Make the unlinks durable BEFORE the new lineage's first save:
        # without this, a crash after save() could resurrect a
        # higher-seq checkpoint of the PREVIOUS run (same job identity,
        # diverged state) and load_latest would prefer it.
        from dsi_tpu_torch.utils.atomicio import fsync_dir

        fsync_dir(self.dir)

    def save(self, arrays: Dict[str, np.ndarray], meta: Dict) -> int:
        """Commit one FULL checkpoint (a chain base); returns its
        sequence number.  The payload lands durably BEFORE the manifest
        that names it, so the manifest's existence implies a complete
        payload."""
        return self._commit(arrays, meta, kind="full")

    def save_delta(self, arrays: Dict[str, np.ndarray], meta: Dict) -> int:
        """Commit one INCREMENTAL checkpoint chained onto the newest
        existing one (full or delta).  Refuses when the store is empty —
        a delta with nothing under it could never restore; the engines
        write a full base first (and re-base every
        ``DSI_STREAM_CKPT_REBASE`` saves)."""
        if not self._seqs():
            raise RuntimeError("delta checkpoint with no base: the first "
                               "save of a lineage must be full")
        return self._commit(arrays, meta, kind="delta")

    def _commit(self, arrays: Dict[str, np.ndarray], meta: Dict,
                kind: str) -> int:
        seqs = self._seqs()
        seq = (seqs[-1] + 1) if seqs else 1
        buf = io.BytesIO()
        compress = (self.compress == "all"
                    or (self.compress == "deltas" and kind == "delta"))
        if compress:
            # Same serialize-then-commit idiom, deflated payload; with
            # --ckpt-async this runs on the CommitWorker, so the
            # compression wall never lands on the engine thread.
            t0 = time.perf_counter()
            _write_npz_compressed(buf, arrays)
            self.last_compress_s = time.perf_counter() - t0
        else:
            np.savez(buf, **arrays)
            self.last_compress_s = 0.0
        self.last_payload_raw_bytes = sum(
            int(np.asarray(v).nbytes) for v in arrays.values())
        payload = buf.getvalue()
        path = (self._delta_path(seq) if kind == "delta"
                else self._payload_path(seq))
        crc = write_bytes_durable(path, payload)
        manifest = {
            "version": CKPT_VERSION,
            "engine": self.engine,
            "job": self.job,
            "seq": seq,
            "payload": os.path.basename(path),
            "payload_crc32": crc,
            "meta": meta,
        }
        if kind == "delta":
            manifest["kind"] = "delta"
            manifest["prev"] = seqs[-1]
        write_bytes_durable(
            self._manifest_path(seq),
            json.dumps(manifest, sort_keys=True).encode("utf-8"))
        self.last_payload_bytes = len(payload)
        self._gc()
        reap_tmp_files(self.dir)
        _trace_event("ckpt_save", lane="ckpt", engine=self.engine,
                     seq=seq, bytes=len(payload), kind=kind)
        return seq

    def _chain_members(self, seq: int) -> Tuple[set, bool]:
        """The seqs a restore at ``seq`` needs — ``seq`` itself plus,
        for a delta, everything down its ``prev`` links to the base —
        and whether the walk reached a full image.  Reads manifests
        WITHOUT CRC verification; an unreadable link ends the walk
        INCOMPLETE, and GC must then err toward retention: everything
        below the hole might be the complete chain the loader falls
        back to."""
        members = set()
        while seq not in members:
            members.add(seq)
            try:
                with open(self._manifest_path(seq), "rb") as f:
                    m = json.loads(f.read())
            except (OSError, ValueError):
                return members, False
            if m.get("kind") != "delta":
                return members, True
            seq = int(m.get("prev", seq))
        return members, False  # prev-link cycle: same retention rule

    def _gc(self) -> None:
        """Chain-aware last-two retention: keep the newest two restore
        points AND every chain member they reference (a live delta
        chain must never lose its base `state-<seq>.npz` to
        retention); remove everything else.  A chain walk that cannot
        reach its base (unreadable mid-chain manifest) protects every
        OLDER seq too — the loader's fallback could need any of them,
        and GC never reaps what the loader might still read."""
        seqs = self._seqs()
        protect: set = set()
        for seq in seqs[-2:]:
            members, complete = self._chain_members(seq)
            protect |= members
            if not complete:
                protect |= {s for s in seqs if s <= min(members)}
        for seq in seqs:
            if seq in protect:
                continue
            for path in (self._manifest_path(seq), self._payload_path(seq),
                         self._delta_path(seq)):
                for p in (path, path + ".crc32"):
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    # ── reading ──

    def _load_one(self, seq: int) -> Optional[Tuple[Dict,
                                                    Dict[str, np.ndarray]]]:
        """One verified (manifest, arrays) pair, or None when any check
        fails — manifest CRC, version, payload CRC.  A VALID manifest
        for a different job refuses loudly instead (silently starting
        fresh would overwrite a good lineage)."""
        raw = read_bytes_verified(self._manifest_path(seq))
        if raw is None:
            return None  # torn manifest
        try:
            manifest = json.loads(raw)
        except ValueError:
            return None
        if manifest.get("version") != CKPT_VERSION:
            return None
        if (manifest.get("engine") != self.engine
                or manifest.get("job") != self.job):
            raise CheckpointMismatch(
                f"checkpoint {self._manifest_path(seq)} belongs to a "
                f"different job (engine/job mismatch); refusing to "
                f"resume")
        payload = read_bytes_verified(
            os.path.join(self.dir, manifest["payload"]))
        if payload is None:
            return None
        if zlib.crc32(payload) != manifest["payload_crc32"]:
            return None
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files}
        return manifest, arrays

    def load_latest(self) -> Optional[Tuple[Dict, Dict[str, np.ndarray]]]:
        """Newest FULL checkpoint that passes every check, or None when
        no usable one exists.  A corrupt newest falls back to its
        predecessor (that is what last-two retention buys).  Delta
        manifests are skipped — a delta alone is not restorable; chain
        consumers use :meth:`load_latest_chain`."""
        for seq in reversed(self._seqs()):
            raw = read_bytes_verified(self._manifest_path(seq))
            if raw is None:
                continue
            try:
                if json.loads(raw).get("kind") == "delta":
                    continue  # manifest-only skip: no payload read for
                    # a delta this view can never return
            except ValueError:
                continue
            loaded = self._load_one(seq)
            if loaded is None:
                continue
            manifest, arrays = loaded
            _trace_event("ckpt_restore", lane="ckpt",
                         engine=self.engine, seq=seq)
            return manifest["meta"], arrays
        return None

    def load_latest_chain(self) -> Optional[Tuple[
            Dict, Dict[str, np.ndarray], list]]:
        """Newest restore point whose ENTIRE chain verifies, as
        ``(base_meta, base_arrays, deltas)`` with ``deltas`` the ordered
        ``[(delta_meta, delta_arrays), ...]`` oldest-first (empty for a
        bare full checkpoint — then this is exactly
        :meth:`load_latest`).  A chain torn anywhere — missing middle
        delta, corrupt base — invalidates every seq above the tear and
        the walk falls back to the last complete chain."""
        for seq in reversed(self._seqs()):
            chain = []
            seen = set()
            s = seq
            ok = True
            while True:
                if s in seen:  # corrupt prev link: never walk a cycle
                    ok = False
                    break
                seen.add(s)
                loaded = self._load_one(s)
                if loaded is None:
                    ok = False
                    break
                manifest, arrays = loaded
                chain.append((manifest, arrays))
                if manifest.get("kind") != "delta":
                    break
                s = int(manifest["prev"])
            if not ok:
                continue
            chain.reverse()
            base_manifest, base_arrays = chain[0]
            deltas = [(m["meta"], a) for m, a in chain[1:]]
            _trace_event("ckpt_restore", lane="ckpt", engine=self.engine,
                         seq=seq, deltas=len(deltas))
            return base_manifest["meta"], base_arrays, deltas
        return None
