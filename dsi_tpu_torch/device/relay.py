"""Device-resident stage relay: the plan layer's inter-stage byte buffer.

Port of ``dsi_tpu/device/relay.py``.  A multi-stage plan
(``dsi_tpu_torch/plan``) chains engines so that stage N+1's upload IS
stage N's device-resident output.  The unit of that handoff is a byte
stream in the engines' batch layout — ``[n_dev, cap]`` uint8 rows,
zero-padded past the fill point — and this module owns the two relay
flavours the plan driver chooses between:

* :class:`DeviceRelay` — the chained path.  A producing stage appends
  each confirmed step's compacted output (the grep emit epilogue's
  matching-line bytes) without pulling it: kernel P (:func:`relay_pack`,
  ``csrc/relay_pack.cu``, K21) writes the new bytes after the fill point
  of a resident accumulation buffer, in place; a buffer seals when the
  next append would pass ``cap`` in any row, and the next one starts
  from the appended chunk itself.  The consuming stage iterates
  :meth:`DeviceRelay.batches` and feeds the buffers straight into its
  step: no intermediate byte crosses the host
  (``plan_intermediate_bytes`` stays 0) unless a spill budget forces the
  oldest sealed buffers out.
* :class:`HostRelay` — the staged baseline.  Every append pulls the
  compacted bytes to the host and the consumer reads a plain block
  stream; the same bytes as the device path by construction, which makes
  the two modes comparable bit for bit end to end.

Producers append whole newline-terminated lines per row, so every row
boundary falls on a line boundary and a buffer row's zero tail ends its
last token: a word count over the relay sees the staged baseline's token
multiset, whatever the buffer chunking.

The relay's kernels, its producer's and its consumer's all run on the
caller's current CUDA stream (the plan driver launches every stage from
one thread), so a pack is ordered before any step that reads its buffer.
:meth:`DeviceRelay.capture` writes the reference's arrays (``rbuf{i}``,
``rlen{i}``, ``rcount``; ``hbytes`` for :class:`HostRelay`), so a relay
image crosses between the two packages.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from dsi_tpu_torch.ops.wordcount import (
    _launch,
    _lib,
    _on_cuda,
    _on_device,
    _ptr,
    _require,
    _stream,
    resolve_device,
)


# ── P: the relay pack (K21) ────────────────────────────────────────────


def relay_pack_plain(acc: torch.Tensor, off: torch.Tensor,
                     new: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel P, the reference's ``_pack_impl``: per row,
    ``out[r, i] = acc[r, i]`` for ``i < off[r]``, else ``new[r, i -
    off[r]]`` (the index clipped to the row).  Returns a new tensor."""
    n = acc.shape[1]
    idx = torch.arange(n, device=acc.device)[None, :]
    offc = off[:, None].to(torch.int64)
    shifted = new.gather(1, (idx - offc).clamp(0, n - 1))
    return torch.where(idx < offc, acc, shifted)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a.device == b.device and a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def relay_pack(acc: torch.Tensor, off, new: torch.Tensor) -> torch.Tensor:
    """Kernel P (``csrc/relay_pack.cu``): :func:`relay_pack_plain`'s
    function written in place into ``acc`` (the reference donates it), so
    only each row's ``[off[r], cap)`` moves.  ``acc`` and ``new`` [n_dev,
    cap] uint8; ``new`` must not alias ``acc``.  ``off`` [n_dev] is on the
    host, an integer numpy array or a CPU int32 tensor: on the card the
    offsets are the launch's arguments, so a CUDA ``off`` (a hidden sync
    to read) raises.  Returns ``acc``."""
    _require(acc, torch.uint8, 2, "relay_pack acc")
    _require(new, torch.uint8, 2, "relay_pack new")
    if isinstance(off, torch.Tensor):
        _require(off, torch.int32, 1, "relay_pack off")
        if off.device.type != "cpu":
            raise ValueError(f"relay_pack: off must be on the host, got "
                             f"{off.device}")
        off = off.numpy()
    off = np.asarray(off)
    n_dev, cap = acc.shape
    if (tuple(new.shape) != (n_dev, cap) or off.shape != (n_dev,)
            or off.dtype.kind not in "iu" or cap < 1
            or acc.device != new.device):
        raise ValueError(f"relay_pack: bad operands acc={tuple(acc.shape)} "
                         f"new={tuple(new.shape)} off={off.shape} "
                         f"{off.dtype} on {acc.device}, {new.device}")
    if _overlap(acc, new):
        raise ValueError("relay_pack: new aliases acc")
    if not _on_cuda(acc):
        return acc.copy_(relay_pack_plain(acc, torch.from_numpy(off), new))
    off = np.ascontiguousarray(off, dtype=np.int64)
    if min(off.tolist()) >= cap:
        return acc  # nothing to write, nothing launched
    with _on_device(acc.device):
        _launch("relay_pack", _lib().dsi_relay_pack(
            _ptr(acc), n_dev, cap, off.ctypes.data, _ptr(new), _stream(acc)))
    return acc


def _host(buf) -> np.ndarray:
    """A relay buffer (tensor or host array) as a host array."""
    if isinstance(buf, torch.Tensor):
        return buf.cpu().numpy()
    return np.asarray(buf)


class DeviceRelay:
    """Device-resident inter-stage byte buffer (module docstring).

    ``stats`` is the plan run's scope: ``plan_intermediate_bytes`` counts
    bytes that crossed the host on the handoff path (0 here unless
    spilled), ``plan_handoff_bytes`` the content appended,
    ``plan_relay_buffers`` the sealed buffers and ``plan_spilled_bytes``
    the spill volume.  ``spill_bytes`` bounds device residency: when the
    relay's buffer bytes exceed it, the oldest sealed buffers are pulled
    to the host (counted) until it is back under.
    """

    def __init__(self, n_dev: int, *, cap: int, device=None,
                 stats: Optional[dict] = None, spill_bytes: int = 0):
        self.n_dev = int(n_dev)
        self.cap = int(cap)
        self.device = resolve_device(device)
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("plan_intermediate_bytes", 0)
        self.stats.setdefault("plan_handoff_bytes", 0)
        self.stats.setdefault("plan_relay_buffers", 0)
        self.stats.setdefault("plan_spilled_bytes", 0)
        self.spill_bytes = max(0, int(spill_bytes))
        #: Sealed buffers in append order: tensors on the device, or
        #: np.ndarray (spilled or restored), each with its fill lengths.
        self._sealed: List = []
        self._sealed_lens: List[np.ndarray] = []
        self._acc: Optional[torch.Tensor] = None
        self._lens = np.zeros(self.n_dev, dtype=np.int64)
        #: Total content bytes appended (the logical intermediate size).
        self.total_bytes = 0

    # ── producer side ──

    def append(self, comp_dev: torch.Tensor, kept: np.ndarray) -> None:
        """Append one confirmed step's compacted ``[n_dev, cap]`` output
        (``kept[r]`` bytes in row r, zero tail).  ``comp_dev`` is consumed
        (packed into the open buffer, or adopted as the next one): the
        producer must not reuse it."""
        kept = np.asarray(kept, dtype=np.int64)
        content = int(kept.sum())
        if content == 0:
            return
        if (tuple(comp_dev.shape) != (self.n_dev, self.cap)
                or comp_dev.device.type != self.device.type):
            raise ValueError(f"relay append: want [{self.n_dev}, {self.cap}]"
                             f" on {self.device}, got "
                             f"{tuple(comp_dev.shape)} on {comp_dev.device}")
        self.total_bytes += content
        self.stats["plan_handoff_bytes"] += content
        filled = self._lens + kept
        if self._acc is None or int(filled.max()) > self.cap:
            if self._acc is not None:
                self._seal()
            self._acc = comp_dev
            self._lens = kept.copy()
        else:
            self._acc = relay_pack(self._acc, self._lens, comp_dev)
            self._lens = filled
        self._maybe_spill()

    def _seal(self) -> None:
        self._sealed.append(self._acc)
        self._sealed_lens.append(self._lens.copy())
        self._acc = None
        self.stats["plan_relay_buffers"] += 1

    def _maybe_spill(self) -> None:
        if not self.spill_bytes:
            return
        buf_bytes = self.n_dev * self.cap

        def resident() -> int:
            live = sum(1 for b in self._sealed
                       if not isinstance(b, np.ndarray))
            return (live + (1 if self._acc is not None else 0)) * buf_bytes

        i = 0
        while resident() > self.spill_bytes and i < len(self._sealed):
            if not isinstance(self._sealed[i], np.ndarray):
                content = int(self._sealed_lens[i].sum())
                self._sealed[i] = _host(self._sealed[i])
                self.stats["plan_spilled_bytes"] += content
                self.stats["plan_intermediate_bytes"] += content
            i += 1

    # ── consumer side ──

    def batches(self) -> Iterator:
        """Yield every buffer (sealed first, then the open tail) in append
        order, dropping the relay's own reference as each is handed over:
        the downstream stage owns it.  Host-resident buffers (spills,
        restores) yield as np.ndarray, which the consumer uploads."""
        if self._acc is not None:
            self._seal()
        while self._sealed:
            yield self._sealed.pop(0)
            self._sealed_lens.pop(0)

    def take_sealed(self) -> List:
        """Pop the sealed buffers (append order) without sealing the open
        one: the pipelined driver's handoff, taken while the producer
        keeps appending.  Call :meth:`finish`, then take once more, when
        the producer is done."""
        out: List = []
        while self._sealed:
            out.append(self._sealed.pop(0))
            self._sealed_lens.pop(0)
        return out

    def finish(self) -> None:
        """Seal the open buffer: the producer has appended its last byte."""
        if self._acc is not None:
            self._seal()

    def host_blocks(self) -> Iterator[bytes]:
        """Destructively pull every buffer as per-row byte blocks: the
        counted host path for a consumer with no device-batch input (the
        grep→grep cascade).  Rows hold whole lines, so the blocks are a
        valid line stream; the pull counts in
        ``plan_intermediate_bytes``."""
        if self._acc is not None:
            self._seal()
        while self._sealed:
            buf = self._sealed.pop(0)
            lens = self._sealed_lens.pop(0)
            host = _host(buf)
            self.stats["plan_intermediate_bytes"] += int(lens.sum())
            for r in range(host.shape[0]):
                k = int(lens[r])
                if k:
                    yield host[r, :k].tobytes()

    # ── durability (the stage-commit payload) ──

    def capture(self) -> Dict[str, np.ndarray]:
        """Non-destructive host image of every live buffer, in the
        reference's arrays; the device buffers stay resident."""
        arrays: Dict[str, np.ndarray] = {}
        bufs = list(self._sealed) + (
            [self._acc] if self._acc is not None else [])
        lens = list(self._sealed_lens) + (
            [self._lens] if self._acc is not None else [])
        for i, (b, ln) in enumerate(zip(bufs, lens)):
            arrays[f"rbuf{i}"] = _host(b).copy()
            arrays[f"rlen{i}"] = np.asarray(ln, dtype=np.int64)
        arrays["rcount"] = np.array([len(bufs)], dtype=np.int64)
        return arrays

    @classmethod
    def restore(cls, n_dev: int, arrays: Dict[str, np.ndarray], *,
                cap: int, device=None,
                stats: Optional[dict] = None) -> "DeviceRelay":
        """Rebuild a relay from a :meth:`capture` image, host-resident (the
        consumer uploads it again, counted in ``plan_restored_bytes``)."""
        relay = cls(n_dev, cap=cap, device=device, stats=stats)
        relay.stats.setdefault("plan_restored_bytes", 0)
        n = int(arrays.get("rcount", np.zeros(1))[0])
        for i in range(n):
            relay._sealed.append(np.asarray(arrays[f"rbuf{i}"],
                                            dtype=np.uint8))
            ln = np.asarray(arrays[f"rlen{i}"], dtype=np.int64)
            relay._sealed_lens.append(ln)
            relay.total_bytes += int(ln.sum())
            relay.stats["plan_restored_bytes"] += int(ln.sum())
        relay.stats["plan_relay_buffers"] += n
        return relay


class HostRelay:
    """The staged baseline's handoff: every append pulls the compacted
    bytes to the host, and the consumer reads one contiguous block stream
    — the full host round trip between stages, the same bytes as
    :class:`DeviceRelay`'s."""

    def __init__(self, stats: Optional[dict] = None):
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("plan_intermediate_bytes", 0)
        self.stats.setdefault("plan_handoff_bytes", 0)
        self._chunks: List[bytes] = []
        self.total_bytes = 0

    def append(self, comp_dev, kept: np.ndarray) -> None:
        comp_np = _host(comp_dev)
        kept = np.asarray(kept, dtype=np.int64)
        for r in range(comp_np.shape[0]):
            k = int(kept[r])
            if k:
                self._chunks.append(comp_np[r, :k].tobytes())
        content = int(kept.sum())
        self.total_bytes += content
        self.stats["plan_handoff_bytes"] += content
        self.stats["plan_intermediate_bytes"] += content

    def blocks(self) -> Iterator[bytes]:
        yield from self._chunks

    def capture(self) -> Dict[str, np.ndarray]:
        """Stage-commit payload: the materialised stream as one array."""
        joined = b"".join(self._chunks)
        return {"hbytes": np.frombuffer(joined, dtype=np.uint8).copy()}

    @classmethod
    def restore(cls, arrays: Dict[str, np.ndarray],
                stats: Optional[dict] = None) -> "HostRelay":
        relay = cls(stats=stats)
        raw = np.asarray(arrays.get("hbytes", np.zeros(0, np.uint8)),
                         dtype=np.uint8).tobytes()
        if raw:
            relay._chunks.append(raw)
            relay.total_bytes = len(raw)
        return relay
