"""Word count per split: tokenize + group + count on the card.

Port of ``dsi_tpu/ops/wordcount.py``, with both groupers (the exact
lexicographic sort and the hash grouper with its exact dirty repair) and
the platform-adaptive grouper ladder.  Same contract as the JAX program:
tokens are maximal runs of ASCII letters, grouped by their exact first
``max_word_len`` bytes, packed big-endian into u32 lanes and pairwise into
u64 key words; any byte >= 0x80, a word longer than the window, more
uniques than ``u_cap``, more tokens than the token buffer or more dirty
tokens than the hash grouper's repair buffer is reported so the host
wrapper retries wider or falls back (``exactness_retry`` and the grouper
ladder), so the result is always exact.

Every hand-written CUDA kernel of the port (``csrc/``) is launched from
this module, each with its plain PyTorch version beside it.  The steps
of the word count:

* ``tokenize``       — ``csrc/tokenize.cu``   (K1+K2, K6 front end)
* ``radix_sort``     — ``csrc/radix_sort.cu`` (K3 sort)
* ``group_sorted``   — ``csrc/group.cu``      (K3 group)
* ``fnv1a32_packed`` — ``csrc/fnv.cu``        (K4), and ``fnv1a32_route``,
  the same launch with the partition rule of K8 and K11 as its epilogue
* ``hash_group``     — ``csrc/hash_group.cu`` (K5, with B and C for the
  dirty repair)
* ``pack6_decode``   — ``csrc/pack6.cu``      (K7, the 6-bit transport)

and the shuffle of the streaming SPMD step (``parallel/shuffle.py``) and
of the mesh-sharded fold (``ops/meshroute.py``):

* ``shuffle_rows``   — ``csrc/route.cu``      (K8, K11)

The grep and TF-IDF kernels launch from their own modules through the same
``_launch`` (one count each in ``LAUNCHES``): ``grep_kernel`` and
``classgrep_kernel`` (``ops/grepk.py``, ``ops/regexk.py``) —
``csrc/grep.cu`` (K13, K14); ``nfa_kernel`` (``ops/nfak.py``) —
``csrc/nfa.cu`` (K15); ``grep_step`` (``parallel/grepstream.py``) —
``csrc/grep_step.cu`` (K16), and ``grep_emit``, its emit epilogue
(K16e); ``relay_pack`` (``device/relay.py``) — ``csrc/relay_pack.cu``
(K21); ``compact`` (``ops/meshroute.py``) —
``csrc/compact.cu`` (K18's partition, ``compact_received``);
``postings_append`` (``device/postings.py``) —
``csrc/postings_append.cu`` (K20a, and K20b's compaction and append in
its received entry); ``wire_decode`` (``ops/wirecodec.py``)
— ``csrc/wire_decode.cu`` (K22); ``crash_sim`` (``parallel/simulate.py``)
— ``csrc/crash_sim.cu`` (K23).

A wrapper given a CUDA tensor launches its kernel (adding one to its
count in ``LAUNCHES``) or raises; given a CPU tensor it runs the plain
version.  There is no other path.

torch lacks unsigned shifts on the CPU, so in tensors u32 lanes, u32
outputs and u64 key words are held as the same bits in int32/int64.  The
plain versions flip the sign bit where order matters, so the pad key
(all ones) sorts last as it does unsigned; the CUDA code reads the same
storage as uint32_t/uint64_t.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_PAD_KEY = 0xFFFFFFFF  # u32 lane of a pad row; sorts after every real word
_PAD_KEY32 = -1        # the same lane as int32 bits
_PAD_KEY64 = -1        # a pad row's u64 key word (all ones) as int64 bits
_SIGN64 = torch.iinfo(torch.int64).min  # 1 << 63 as int64 bits
# u32 mask keeping the first `keep` (0..4) big-endian bytes, by `keep`.
_BYTE_MASKS = (0, 0xFF000000, 0xFFFF0000, 0xFFFFFF00, 0xFFFFFFFF)
# The widest row kernel E takes (``csrc/route.cu`` kMaxWidth).
_ROUTE_MAX_WIDTH = 32768

# Launches of each kernel in this process; a plain-version call adds none.
# The names of the kernels after J enter the dict at their first launch, so
# a process that never launches them sees the dict it always saw;
# ``launch_counts`` lists every kernel, zeros included.
LAUNCHES: Dict[str, int] = {"tokenize": 0, "radix_sort": 0, "group": 0,
                            "fnv": 0, "route": 0, "hash_group": 0,
                            "pack6": 0, "grep": 0, "nfa": 0,
                            "grep_step": 0}
KERNEL_NAMES = tuple(LAUNCHES) + ("compact", "postings_append",
                                  "wire_decode", "crash_sim", "grep_emit",
                                  "relay_pack")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count in this process, by name: each of
    ``KERNEL_NAMES``, zero for a kernel that has not launched."""
    return {**{name: 0 for name in KERNEL_NAMES}, **LAUNCHES}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``, which
    raises when CUDA is absent; the CPU only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_grouper(device) -> str:
    """The grouping strategy for ``device``: ``hash`` on the CPU, ``sort``
    on the card, as the reference picks ``hash`` on its CPU platform and
    ``sort`` on accelerators until on-chip evidence says otherwise.
    ``DSI_WC_GROUPER`` pins either one."""
    env = os.environ.get("DSI_WC_GROUPER")
    if env in ("sort", "hash"):
        return env
    return "hash" if torch.device(device).type == "cpu" else "sort"


def grouper_ladder(device) -> tuple:
    """The grouper rungs every wrapper walks on ``device``: the preferred
    grouper first, the always-exact sort grouper last (a hash-grouper
    dirty overflow cannot clear at frac 2; the sort never overflows
    there)."""
    g0 = default_grouper(device)
    return (g0, "sort") if g0 != "sort" else ("sort",)


def to_device(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a uint8 host buffer: one pinned staging copy and one
    ``non_blocking`` host-to-device transfer on the card."""
    if device.type == "cpu":
        return torch.from_numpy(np.ascontiguousarray(buf))
    staging = torch.empty(len(buf), dtype=torch.uint8, pin_memory=True)
    staging.numpy()[:] = buf
    return staging.to(device, non_blocking=True)


class HostCopy:
    """A device-to-host copy in flight: on the card, a ``non_blocking``
    copy into pinned memory plus a CUDA event recorded behind it, so the
    caller decides when to wait; on the CPU, a copy made at once.  The
    copy holds the values ``t`` had when it was made, whatever later
    work on the same stream writes into ``t``.  ``view`` (e.g.
    ``np.uint32``) reinterprets the host bits on :meth:`wait`."""

    def __init__(self, t: torch.Tensor, view=None):
        self._view = view
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.detach().clone()
            self._event = None

    def wait(self) -> np.ndarray:
        """Block until the copy has landed; the host values as numpy."""
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a if self._view is None else a.view(self._view)


# ── bit helpers (u32/u64 carried in int32/int64) ─────────────────────────


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor of the same 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _u32_value(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def pack_key_lanes(cols: tuple) -> tuple:
    """Pack u32 key lanes (int32 bits) pairwise into u64 key words (int64
    bits): lane j is the high word, lane j+1 the low; a missing odd tail
    lane is the PAD constant, so a pad row stays all ones and real rows
    keep their lexicographic order (``dsi_tpu`` ``pack_key_lanes``)."""
    out = []
    for j in range(0, len(cols), 2):
        hi = cols[j]
        lo = (cols[j + 1] if j + 1 < len(cols)
              else torch.full_like(hi, _PAD_KEY32))
        out.append(torch.stack([lo, hi], dim=-1).view(torch.int64)[..., 0])
    return tuple(out)


def unpack_key_lanes(cols64, k: int) -> tuple:
    """Inverse of :func:`pack_key_lanes`: k u32 lanes (int32 bits) back out
    of the packed u64 key words."""
    halves = [w.contiguous().view(torch.int32).view(*w.shape, 2)
              for w in cols64]
    return tuple(halves[j // 2][..., 1 - j % 2] for j in range(k))


def unpack_key_rows(rows64: torch.Tensor, k: int) -> torch.Tensor:
    """[n, ceil(k/2)] packed u64 key rows -> [n, k] u32 lane rows."""
    cols = unpack_key_lanes(
        tuple(rows64[:, j] for j in range(rows64.shape[1])), k)
    return torch.stack(cols, dim=1)


def _compact(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Positions of the set entries of ``mask``, in order, cut or padded
    with ``fill`` to ``size`` (``jnp.nonzero(size=, fill_value=)``)."""
    pos = torch.nonzero(mask).squeeze(1)[:size]
    out = torch.full((size,), fill, dtype=torch.int64, device=mask.device)
    out[:pos.numel()] = pos
    return out


# ── kernel plumbing ──────────────────────────────────────────────────────


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, from
    the private binding PyTorch's generated code uses, a small fraction of
    the host time of ``torch.cuda.current_stream(dev).cuda_stream``.
    ``chip_smoke.py stream_handle_failures`` holds the two equal on the
    card, on the default and a side stream, and logs both times beside
    the PyTorch version, so a release that renames the binding fails
    there first."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _on_device(dev: torch.device):
    """The context a launch on ``dev`` runs in: none when ``dev`` is the
    current device (the check costs less host time than the switch)."""
    return (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


def _require(t: torch.Tensor, dtype: torch.dtype, ndim: int,
             what: str) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def _lib():
    from dsi_tpu_torch.kernels.build import library

    return library()


# ── A: tokenize ──────────────────────────────────────────────────────────


def tokenize_plain(chunk: torch.Tensor, *, max_word_len: int, t_cap: int,
                   with_poslen: bool = False):
    """Plain version of kernel A.  Returns (keys [k64, t_cap] int64,
    lengths [t_cap] int32, poslen [t_cap] int32 or None, scalars [4] int32:
    n_tokens, max_len, has_high, 0)."""
    n = chunk.shape[0]
    k = max_word_len // 4
    dev = chunk.device
    c = chunk.to(torch.int64)
    letter = ((c >= 65) & (c <= 90)) | ((c >= 97) & (c <= 122))
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    starts = letter & ~torch.cat([no, letter[:-1]])
    ends = letter & ~torch.cat([letter[1:], no])
    n_tokens = starts.sum()
    start_pos = _compact(starts, t_cap, n - 1)
    end_pos = _compact(ends, t_cap, n - 1)
    valid = torch.arange(t_cap, device=dev) < n_tokens
    lengths = torch.where(valid, end_pos - start_pos + 1, 0)
    max_len = lengths.max()
    cz = torch.cat([c, torch.zeros(3, dtype=torch.int64, device=dev)])
    b32 = (cz[:-3] << 24) | (cz[1:-2] << 16) | (cz[2:-1] << 8) | cz[3:]
    masks = torch.tensor(_BYTE_MASKS, dtype=torch.int64, device=dev)
    lanes = []
    for j in range(k):
        lane = (b32[(start_pos + 4 * j).clamp(max=n - 1)]
                & masks[(lengths - 4 * j).clamp(0, 4)])
        lanes.append(_u32_bits(torch.where(valid, lane, _PAD_KEY)))
    keys = torch.stack(pack_key_lanes(tuple(lanes)))
    poslen = None
    if with_poslen:
        poslen = _u32_bits(torch.where(valid, (start_pos << 7) | lengths, 0))
    has_high = (c >= 128).any()
    scalars = torch.stack([n_tokens, max_len, has_high.to(torch.int64),
                           torch.zeros((), dtype=torch.int64, device=dev)])
    return keys, lengths.to(torch.int32), poslen, scalars.to(torch.int32)


def tokenize(chunk: torch.Tensor, *, max_word_len: int, t_cap: int,
             with_poslen: bool = False):
    """Kernel A (``csrc/tokenize.cu``); see :func:`tokenize_plain`."""
    _require(chunk, torch.uint8, 1, "tokenize chunk")
    n = chunk.shape[0]
    if n < 1 or t_cap < 1 or max_word_len < 4 or max_word_len % 4:
        raise ValueError(f"tokenize: bad shape n={n} t_cap={t_cap} "
                         f"max_word_len={max_word_len}")
    if not _on_cuda(chunk):
        return tokenize_plain(chunk, max_word_len=max_word_len, t_cap=t_cap,
                              with_poslen=with_poslen)
    lib = _lib()
    k = max_word_len // 4
    opts = {"device": chunk.device}
    keys = torch.empty(((k + 1) // 2, t_cap), dtype=torch.int64, **opts)
    lengths = torch.empty(t_cap, dtype=torch.int32, **opts)
    poslen = (torch.empty(t_cap, dtype=torch.int32, **opts)
              if with_poslen else None)
    scalars = torch.empty(4, dtype=torch.int32, **opts)  # A writes all 4
    scratch = torch.empty(lib.dsi_tokenize_scratch_bytes(n),
                          dtype=torch.uint8, **opts)
    with torch.cuda.device(chunk.device):
        _launch("tokenize", lib.dsi_tokenize(
            _ptr(chunk), n, k, t_cap, _ptr(keys), _ptr(lengths),
            _ptr(poslen), _ptr(scalars), _ptr(scratch), _stream(chunk)))
    return keys, lengths, poslen, scalars


# ── B: radix sort ────────────────────────────────────────────────────────


def _sort_rows(n_sort: Optional[torch.Tensor], t: int) -> int:
    """Rows the prefix sort covers: ``n_sort`` clamped to [0, t]."""
    return t if n_sort is None else min(max(int(n_sort[0]), 0), t)


def radix_sort_plain(keys: torch.Tensor,
                     n_sort: Optional[torch.Tensor] = None):
    """Plain version of kernel B: stable lexicographic sort of the u64 key
    words ``keys`` [k64, t] (int64 bits).  Returns (sorted keys, perm
    int32) with ``sorted[w][i] == keys[w][perm[i]]``, ties in input order.

    ``n_sort`` (int32 [1]): the kernel sorts only the rows below it and
    leaves the rest in place.  That equals the full stable sort when the
    rows from ``n_sort`` on are identical and each is, unsigned and
    lexicographically, at least every row below it; this version sorts
    every row and raises ``ValueError`` when that precondition fails."""
    t = keys.shape[1]
    perm = torch.arange(t, device=keys.device)
    for w in reversed(range(keys.shape[0])):
        word = keys[w][perm] ^ _SIGN64  # unsigned order as signed order
        perm = perm[torch.sort(word, stable=True).indices]
    skeys = keys[:, perm]
    n = _sort_rows(n_sort, t)
    if n < t:
        tail = keys[:, n:n + 1]
        if not (bool((keys[:, n:] == tail).all())
                and bool((skeys[:, n:] == tail).all())):
            raise ValueError(f"radix_sort: rows from n_sort={n} on are not "
                             "identical rows at least every row before")
    return skeys, perm.to(torch.int32)


def radix_sort(keys: torch.Tensor, n_sort: Optional[torch.Tensor] = None):
    """Kernel B (``csrc/radix_sort.cu``); see :func:`radix_sort_plain`."""
    _require(keys, torch.int64, 2, "radix_sort keys")
    k64, t = keys.shape
    if k64 < 1 or t < 1 or t >= 1 << 31:
        raise ValueError(f"radix_sort: bad shape {tuple(keys.shape)}")
    if n_sort is not None:
        _require(n_sort, torch.int32, 1, "radix_sort n_sort")
        if n_sort.shape[0] != 1 or n_sort.device != keys.device:
            raise ValueError("radix_sort: n_sort is one int32 on the keys' "
                             "device")
    if not _on_cuda(keys):
        return radix_sort_plain(keys, n_sort)
    lib = _lib()
    sorted_keys = torch.empty_like(keys)
    perm = torch.empty(t, dtype=torch.int32, device=keys.device)
    scratch = torch.empty(lib.dsi_radix_sort_scratch_bytes(t),
                          dtype=torch.uint8, device=keys.device)
    with torch.cuda.device(keys.device):
        _launch("radix_sort", lib.dsi_radix_sort_ex(
            _ptr(keys), k64, t, _ptr(n_sort), _ptr(sorted_keys), _ptr(perm),
            _ptr(scratch), _stream(keys), 0))
    return sorted_keys, perm


# ── C: group runs ────────────────────────────────────────────────────────


def group_sorted_plain(skeys: torch.Tensor, counts: torch.Tensor,
                       u_cap: int, payload: Optional[torch.Tensor] = None,
                       perm: Optional[torch.Tensor] = None):
    """Plain version of kernel C: group adjacent equal rows of sorted key
    words ``skeys`` [k64, t] (pad rows, all ones, last).

    ``counts`` [t] int64 per sorted row; ``payload`` [t] int32 in pre-sort
    row order, read through ``perm`` at each run head.  Returns (keys_u
    [k64, u_cap] int64, totals [u_cap] int64, upos [u_cap] int32,
    payload_u [u_cap] int32, n_unique int32 scalar); rows past n_unique
    are 0 (upos t-1)."""
    k64, t = skeys.shape
    dev = skeys.device
    valid = skeys[0] != _PAD_KEY64
    prev = torch.cat([torch.full((k64, 1), _PAD_KEY64, dtype=torch.int64,
                                 device=dev), skeys[:, :-1]], dim=1)
    is_new = (skeys != prev).any(dim=0) & valid
    n_unique = is_new.sum()
    uid = torch.cumsum(is_new.to(torch.int64), 0) - 1
    seg = torch.where(valid & (uid < u_cap), uid, u_cap)
    totals = torch.zeros(u_cap + 1, dtype=torch.int64, device=dev)
    totals = totals.index_add_(0, seg, torch.where(valid, counts, 0))[:u_cap]
    upos = _compact(is_new, u_cap, t - 1)
    ovalid = torch.arange(u_cap, device=dev) < n_unique
    keys_u = torch.where(ovalid, skeys[:, upos], 0)
    payload_u = torch.zeros(u_cap, dtype=torch.int32, device=dev)
    if payload is not None:
        payload_u = torch.where(ovalid, payload[perm[upos].long()], 0)
    return (keys_u, totals, upos.to(torch.int32), payload_u.to(torch.int32),
            n_unique.to(torch.int32))


def group_sorted(skeys: torch.Tensor, counts: torch.Tensor, u_cap: int,
                 payload: Optional[torch.Tensor] = None,
                 perm: Optional[torch.Tensor] = None):
    """Kernel C (``csrc/group.cu``); see :func:`group_sorted_plain`."""
    _require(skeys, torch.int64, 2, "group keys")
    k64, t = skeys.shape
    _require(counts, torch.int64, 1, "group counts")
    if (payload is None) != (perm is None):
        raise ValueError("group: payload and perm go together")
    if payload is not None:
        _require(payload, torch.int32, 1, "group payload")
        _require(perm, torch.int32, 1, "group perm")
    if (t < 1 or u_cap < 1 or counts.shape[0] != t
            or (payload is not None and payload.shape[0] != t)):
        raise ValueError(f"group: bad shapes t={t} u_cap={u_cap}")
    if not _on_cuda(skeys):
        return group_sorted_plain(skeys, counts, u_cap, payload, perm)
    lib = _lib()
    opts = {"device": skeys.device}
    keys_u = torch.empty((k64, u_cap), dtype=torch.int64, **opts)
    totals = torch.empty(u_cap, dtype=torch.int64, **opts)
    upos = torch.empty(u_cap, dtype=torch.int32, **opts)
    payload_u = torch.empty(u_cap, dtype=torch.int32, **opts)
    n_unique = torch.empty(1, dtype=torch.int32, **opts)
    scratch = torch.empty(lib.dsi_group_scratch_bytes(t, u_cap),
                          dtype=torch.uint8, **opts)
    with torch.cuda.device(skeys.device):
        _launch("group", lib.dsi_group(
            _ptr(skeys), k64, t, _ptr(counts), _ptr(payload), _ptr(perm),
            u_cap, _ptr(keys_u), _ptr(totals), _ptr(upos), _ptr(payload_u),
            _ptr(n_unique), _ptr(scratch), _stream(skeys)))
    return keys_u, totals, upos, payload_u, n_unique[0]


# ── D: FNV-1a, with the partition rule it feeds ──────────────────────────

_FNV_WORDS, _FNV_LANES = 0, 1  # dsi_fnv's layouts


def _key_byte(keys: torch.Tensor, j: int) -> torch.Tensor:
    """Byte ``j`` (int64, 0..255) of every row's big-endian key bytes:
    u64 key words word-major [k64, u] (int64) or u32 lanes row-major [u,
    kk] (int32)."""
    if keys.dtype == torch.int64:
        return (keys[j // 8] >> (56 - 8 * (j % 8))) & 0xFF
    return (keys[:, j // 4].to(torch.int64) >> (24 - 8 * (j % 4))) & 0xFF


def _fnv_layout(keys: torch.Tensor, lens: torch.Tensor,
                max_word_len: int) -> tuple:
    """(layout, rows, width) of D's key operand, checked against
    ``lens`` and ``max_word_len``."""
    if keys.dtype == torch.int64:
        _require(keys, torch.int64, 2, "fnv keys")
        layout, (width, u), per = _FNV_WORDS, keys.shape, 8
    else:
        _require(keys, torch.int32, 2, "fnv keys")
        layout, (u, width), per = _FNV_LANES, keys.shape, 4
    _require(lens, torch.int32, 1, "fnv lengths")
    if lens.shape[0] != u or per * width < max_word_len:
        raise ValueError(f"fnv: bad shapes {tuple(keys.shape)} "
                         f"{tuple(lens.shape)} mwl={max_word_len}")
    return layout, u, width


def fnv1a32_packed_plain(keys_u: torch.Tensor, len_u: torch.Tensor,
                         max_word_len: int) -> torch.Tensor:
    """Plain version of kernel D: FNV-1a 32 (Go hash/fnv.New32a,
    mr/worker.go:33-37) over the first min(len, max_word_len) bytes of
    each row of ``keys_u``: u64 key words [k64, u] (int64 bits) or the
    reference's big-endian u32 lanes [u, kk] (int32 bits); int32 bits."""
    u = keys_u.shape[1] if keys_u.dtype == torch.int64 else keys_u.shape[0]
    h = torch.full((u,), _FNV_OFFSET, dtype=torch.int64,
                   device=keys_u.device)
    for j in range(max_word_len):
        b = _key_byte(keys_u, j)
        h = torch.where(j < len_u, ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF, h)
    return _u32_bits(h)


def fnv1a32_route_plain(keys: torch.Tensor, lens: torch.Tensor,
                        max_word_len: int, *, n_part: int, n_dest: int,
                        park: int, valid: Optional[torch.Tensor] = None,
                        n_valid: Optional[torch.Tensor] = None):
    """Plain version of kernel D with its epilogue: the hash ``h`` of
    :func:`fnv1a32_packed_plain`, ``part = (h & 0x7fffffff) % n_part``
    and ``dest = part % n_dest`` where the row is valid, ``park``
    elsewhere.  A row is valid where the bool mask ``valid`` is set, else
    below the int32 device scalar ``n_valid``, else always.  Returns (h,
    part, dest), each int32 [u]."""
    h = fnv1a32_packed_plain(keys, lens, max_word_len)
    part = (_u32_value(h) & 0x7FFFFFFF) % n_part
    if valid is None:
        valid = (torch.arange(h.shape[0], device=h.device) < n_valid
                 if n_valid is not None else torch.ones_like(h, dtype=bool))
    dest = torch.where(valid, part % n_dest, park)
    return h, part.to(torch.int32), dest.to(torch.int32)


def _fnv(keys, lens, max_word_len, shape, ep=None):
    """Kernel D's launch on operands of ``shape`` (``_fnv_layout``'s);
    ``ep`` = (n_part, n_dest, park, valid, n_valid) adds the epilogue.
    Returns h, or (h, part, dest) with ``ep``."""
    layout, u, width = shape
    dev = keys.device
    # h, part and dest: views of one allocation (the host sets this call's
    # time, and as_strided is its cheapest view).
    out = torch.empty(u if ep is None else 3 * u, dtype=torch.int32,
                      device=dev)
    h = out.as_strided((u,), (1,), 0)
    part = dest = valid = n_valid = None
    n_part = n_dest = park = 0
    if ep is not None:
        n_part, n_dest, park, valid, n_valid = ep
        part = out.as_strided((u,), (1,), u)
        dest = out.as_strided((u,), (1,), 2 * u)
    if u > 0:
        lib = _lib()
        with _on_device(dev):
            rc = lib.dsi_fnv(
                _ptr(keys), layout, u, width, _ptr(lens), max_word_len,
                _ptr(h), _ptr(valid), _ptr(n_valid), n_part, n_dest, park,
                _ptr(part), _ptr(dest),
                torch._C._cuda_getCurrentRawStream(dev.index))
        _launch("fnv", rc)
    return h if ep is None else (h, part, dest)


def fnv1a32_packed(keys_u: torch.Tensor, len_u: torch.Tensor,
                   max_word_len: int) -> torch.Tensor:
    """Kernel D (``csrc/fnv.cu``); see :func:`fnv1a32_packed_plain`."""
    shape = _fnv_layout(keys_u, len_u, max_word_len)
    if not _on_cuda(keys_u):
        return fnv1a32_packed_plain(keys_u, len_u, max_word_len)
    return _fnv(keys_u, len_u, max_word_len, shape)


def fnv1a32_route(keys: torch.Tensor, lens: torch.Tensor, max_word_len: int,
                  *, n_part: int, n_dest: int, park: int,
                  valid: Optional[torch.Tensor] = None,
                  n_valid: Optional[torch.Tensor] = None):
    """Kernel D with its epilogue, one launch (``csrc/fnv.cu``); see
    :func:`fnv1a32_route_plain`.  The reference computes the same in the
    jitted program of the hash: ``map_prologue``'s partition rule
    (``parallel/shuffle.py:98-121``) and ``route_dest``
    (``ops/meshroute.py:48-63``)."""
    shape = _fnv_layout(keys, lens, max_word_len)
    u = shape[1]
    if n_part < 1 or n_dest < 1 or (valid is not None
                                    and n_valid is not None):
        raise ValueError(f"fnv route: n_part={n_part} n_dest={n_dest}, "
                         "valid and n_valid are exclusive")
    if valid is not None:
        _require(valid, torch.bool, 1, "fnv valid")
        if valid.shape[0] != u:
            raise ValueError(f"fnv route: valid {tuple(valid.shape)} for "
                             f"{u} rows")
    if n_valid is not None and (n_valid.dtype != torch.int32
                                or n_valid.numel() != 1):
        raise ValueError("fnv route: n_valid must be one int32 value")
    if any(t is not None and t.device != keys.device
           for t in (lens, valid, n_valid)):
        raise ValueError("fnv route: operands on different devices")
    if not _on_cuda(keys):
        return fnv1a32_route_plain(keys, lens, max_word_len, n_part=n_part,
                                   n_dest=n_dest, park=park, valid=valid,
                                   n_valid=n_valid)
    return _fnv(keys, lens, max_word_len, shape,
                (n_part, n_dest, park, valid, n_valid))


# ── E: route rows to their destination shard ────────────────────────────


def shuffle_rows_plain(rows: torch.Tensor, dest: torch.Tensor, *,
                       n_dev: int, k: int) -> torch.Tensor:
    """Plain version of kernel E: the reference's algorithm per source
    shard (stable argsort of ``dest``, bincount, scatter into one
    ``r``-row block per destination with a parking row for
    ``dest == n_dev``), then the all-to-all as a transpose.

    ``rows`` [n_dev, r, k+p] int32 (u32 bits: k key lanes, p payload
    lanes), ``dest`` [n_dev, r] int32.  Returns recv [n_dev, n_dev*r,
    k+p]: ``recv[d, s*r + j]`` is the j-th row of source s bound for d;
    unfilled rows are the pad row (key lanes all ones, zero payload)."""
    _, r, w = rows.shape
    dev = rows.device
    pad_row = torch.cat([
        torch.full((k,), _PAD_KEY32, dtype=torch.int32, device=dev),
        torch.zeros(w - k, dtype=torch.int32, device=dev)])
    sendbuf = pad_row.expand(n_dev, n_dev * r + 1, w).clone()
    for s in range(n_dev):
        d = dest[s].to(torch.int64)
        d = torch.where((d < 0) | (d > n_dev), n_dev, d)
        order = torch.sort(d, stable=True).indices
        sdest = d[order]
        counts = torch.bincount(sdest, minlength=n_dev + 1)
        starts = torch.cumsum(counts, 0) - counts
        pos_in = torch.arange(r, device=dev) - starts[sdest]
        flat = torch.where(sdest < n_dev, sdest * r + pos_in, n_dev * r)
        sendbuf[s][flat] = rows[s][order]
    send = sendbuf[:, :n_dev * r].reshape(n_dev, n_dev, r, w)
    return send.transpose(0, 1).reshape(n_dev, n_dev * r, w).contiguous()


@functools.lru_cache(maxsize=None)
def _route_scratch_words(n_dev: int, r: int, w: int) -> int:
    """Kernel E's scratch for one shape, in int32 words."""
    return -(-_lib().dsi_route_scratch_bytes(n_dev, r, w) // 4)


def shuffle_rows(rows: torch.Tensor, dest: torch.Tensor, *, n_dev: int,
                 k: int) -> torch.Tensor:
    """Kernel E (``csrc/route.cu``); see :func:`shuffle_rows_plain`.
    Replaces the reference's ``shuffle_rows``
    (``parallel/shuffle.py``: argsort + scatter + ``lax.all_to_all``) for
    any payload width, so the mesh fold, TF-IDF and indexer steps can
    reuse it.  On the card: one allocation (recv with the kernel's
    scratch behind it), one C call, a memset and two launches."""
    _require(rows, torch.int32, 3, "shuffle rows")
    _require(dest, torch.int32, 2, "shuffle dest")
    n_src, r, w = rows.shape
    if (n_src != n_dev or tuple(dest.shape) != (n_dev, r) or r < 1
            or not 1 <= n_dev <= 1024 or not 0 <= k <= w
            or not 1 <= w <= _ROUTE_MAX_WIDTH):
        raise ValueError(f"shuffle: bad shapes rows={tuple(rows.shape)} "
                         f"dest={tuple(dest.shape)} n_dev={n_dev} k={k}")
    if not _on_cuda(rows):
        return shuffle_rows_plain(rows, dest, n_dev=n_dev, k=k)
    lib = _lib()
    dev = rows.device
    n_recv = n_dev * n_dev * r * w
    buf = torch.empty(n_recv + _route_scratch_words(n_dev, r, w),
                      dtype=torch.int32, device=dev)
    recv = buf.as_strided((n_dev, n_dev * r, w), (n_dev * r * w, w, 1), 0)
    with _on_device(dev):
        rc = lib.dsi_route(_ptr(rows), _ptr(dest), n_dev, r, w, k,
                           _ptr(recv), _ptr(recv) + 4 * n_recv,
                           torch._C._cuda_getCurrentRawStream(dev.index))
    _launch("route", rc)
    return recv


# ── F: the hash grouper ──────────────────────────────────────────────────


def hash_group_shape(t: int) -> tuple:
    """(n_buckets, d_cap) of the reference's ``_hash_group`` for ``t``
    token rows: about t buckets, a power of two; a dirty buffer of t/16
    rows, at least 256."""
    return 1 << max(10, int(t).bit_length() - 1), max(1 << 8, t // 16)


def _repair_sort_group(dkeys: torch.Tensor, dlen: torch.Tensor, k64: int,
                       u_cap: int, n_dirty: torch.Tensor,
                       plain: bool = False):
    """The hash grouper's dirty repair: sort the dirty rows ``dkeys``
    [k64 (+1), d_cap] with B (with ``extra`` it rides as the last key
    word, so each run's first row holds the group's minimum), then group
    them on their ``k64`` key words with C, carrying ``dlen``.  Only the
    ``n_dirty`` rows are sorted: the pad rows after them are all ones (key
    words and ``extra``; real keys are letters), so they stay last in
    place.  Returns kernel C's outputs and the sorted key words.
    ``plain``: B's and C's plain versions, wherever the rows lie."""
    sort, group = ((radix_sort_plain, group_sorted_plain) if plain
                   else (radix_sort, group_sorted))
    skeys, perm = sort(dkeys, n_dirty)
    ones = torch.ones(dkeys.shape[1], dtype=torch.int64,
                      device=dkeys.device)
    return group(skeys[:k64], ones, u_cap, dlen, perm), skeys


def hash_group_plain(keys: torch.Tensor, lengths: torch.Tensor,
                     fnv: torch.Tensor, n_valid: torch.Tensor, u_cap: int,
                     extra: Optional[torch.Tensor] = None):
    """Plain version of kernel F, the reference's ``_hash_group``
    (``dsi_tpu/ops/wordcount.py:199-320``).

    ``keys`` [k64, t] u64 key words (int64 bits), ``lengths`` [t] int32,
    ``fnv`` [t] the tokens' FNV-1a (int32 bits), ``n_valid`` [1] int32
    (rows below it are tokens), ``extra`` [t] u32 (int32 bits) reduced by
    unsigned MIN per group, or None.  Tokens go to bucket ``fnv &
    (n_buckets-1)``; a bucket is dirty when some key word's min differs
    from its max.  Dirty tokens are compacted in token order to ``d_cap``
    rows, sorted and grouped exactly.  Output rows: the clean buckets in
    bucket order, then the dirty uniques in sorted order, cut at
    ``u_cap``; zero past n_unique.  Returns (keys_u [k64, u_cap] int64,
    len_u [u_cap] int32, cnt_u [u_cap] int64, extra_u [u_cap] int32 or
    None, n_unique int32, group_overflow bool); n_unique stays true above
    u_cap."""
    k64, t = keys.shape
    dev = keys.device
    nb, d_cap = hash_group_shape(t)
    valid = torch.arange(t, device=dev) < n_valid[0]
    idx = torch.where(valid, _u32_value(fnv) & (nb - 1), nb)

    def per_bucket(vals, how, init):
        out = torch.full((nb + 1,), init, dtype=torch.int64, device=dev)
        return out.scatter_reduce(0, idx, vals, how, include_self=False)[:nb]

    tot1 = per_bucket(valid.to(torch.int64), "sum", 0)
    len1 = per_bucket(lengths.to(torch.int64), "amax", 0)
    ex1 = (per_bucket(_u32_value(extra), "amin", 0xFFFFFFFF)
           if extra is not None else None)
    dirty = torch.zeros(nb, dtype=torch.bool, device=dev)
    keys1 = []
    for w in range(k64):
        flipped = keys[w] ^ _SIGN64  # unsigned order as signed order
        mn = per_bucket(flipped, "amin", 0)
        mx = per_bucket(flipped, "amax", 0)
        dirty |= mn != mx
        keys1.append(mx ^ _SIGN64)
    occ1 = tot1 > 0
    dirty &= occ1

    in_dirty = valid & dirty[idx.clamp(max=nb - 1)]
    n_dirty = in_dirty.sum()
    dpos = _compact(in_dirty, d_cap, 0)
    dvalid = torch.arange(d_cap, device=dev) < n_dirty
    dlen = torch.where(dvalid, lengths[dpos], 0).to(torch.int32)
    dkeys = torch.where(dvalid, keys[:, dpos], _PAD_KEY64)
    if extra is not None:
        dex = torch.where(dvalid, _u32_value(extra)[dpos], 0xFFFFFFFF)
        dkeys = torch.cat([dkeys, dex[None]])
    n_sort = n_dirty.clamp(max=d_cap).to(torch.int32)[None]
    (dgk, dtot, dupos, dlen_u, n_du), skeys = _repair_sort_group(
        dkeys, dlen, k64, u_cap, n_sort, plain=True)

    clean1 = occ1 & ~dirty
    n_clean = clean1.sum()
    cpos1 = _compact(clean1, u_cap, nb - 1)
    v1 = torch.arange(u_cap, device=dev) < n_clean
    keys_u = torch.where(v1, torch.stack(keys1)[:, cpos1], 0)
    len_u = torch.where(v1, len1[cpos1], 0)
    cnt_u = torch.where(v1, tot1[cpos1], 0)
    ex_u = torch.where(v1, ex1[cpos1], 0) if extra is not None else None
    i = torch.arange(u_cap, device=dev)
    put = (i < n_du) & (i + n_clean < u_cap)
    dst, src = (i + n_clean)[put], i[put]
    keys_u[:, dst] = dgk[:, src]
    len_u[dst] = dlen_u[src].to(torch.int64)
    cnt_u[dst] = dtot[src]
    if ex_u is not None:
        ex_u[dst] = skeys[k64][dupos[src].to(torch.int64)]
        ex_u = _u32_bits(ex_u)
    return (keys_u, len_u.to(torch.int32), cnt_u, ex_u,
            (n_clean + n_du).to(torch.int32), n_dirty > d_cap)


def hash_group(keys: torch.Tensor, lengths: torch.Tensor, fnv: torch.Tensor,
               n_valid: torch.Tensor, u_cap: int,
               extra: Optional[torch.Tensor] = None):
    """Kernel F (``csrc/hash_group.cu``); see :func:`hash_group_plain`.

    Two launches of F around the exact repair: the first resets the bucket
    state, accumulates the buckets (one claimed representative each) and
    compacts, in input order, the dirty tokens to the repair rows and the
    clean buckets to the output; kernels B (over the ``n_dirty`` rows) and
    C sort and group the repair rows; the second launch of F places the
    dirty uniques after the clean rows."""
    _require(keys, torch.int64, 2, "hash_group keys")
    _require(lengths, torch.int32, 1, "hash_group lengths")
    _require(fnv, torch.int32, 1, "hash_group fnv")
    _require(n_valid, torch.int32, 1, "hash_group n_valid")
    if extra is not None:
        _require(extra, torch.int32, 1, "hash_group extra")
    k64, t = keys.shape
    if (k64 < 1 or t < 1 or u_cap < 1 or n_valid.shape[0] != 1
            or lengths.shape[0] != t or fnv.shape[0] != t
            or (extra is not None and extra.shape[0] != t)):
        raise ValueError(f"hash_group: bad shapes keys={tuple(keys.shape)} "
                         f"u_cap={u_cap}")
    if not _on_cuda(keys):
        return hash_group_plain(keys, lengths, fnv, n_valid, u_cap, extra)
    lib = _lib()
    nb, d_cap = hash_group_shape(t)
    e = 0 if extra is None else 1
    opts = {"device": keys.device}
    scratch = torch.empty(lib.dsi_hash_group_scratch_bytes(k64, t, nb),
                          dtype=torch.uint8, **opts)
    dkeys = torch.empty((k64 + e, d_cap), dtype=torch.int64, **opts)
    dlen = torch.empty(d_cap, dtype=torch.int32, **opts)
    n_dirty = torch.empty(1, dtype=torch.int32, **opts)
    keys_u = torch.empty((k64, u_cap), dtype=torch.int64, **opts)
    len_u = torch.empty(u_cap, dtype=torch.int32, **opts)
    cnt_u = torch.empty(u_cap, dtype=torch.int64, **opts)
    extra_u = (torch.empty(u_cap, dtype=torch.int32, **opts) if e
               else None)
    with torch.cuda.device(keys.device):
        _launch("hash_group", lib.dsi_hash_bucket(
            _ptr(keys), k64, t, _ptr(lengths), _ptr(fnv), _ptr(n_valid),
            _ptr(extra), nb, d_cap, u_cap, _ptr(dkeys), _ptr(dlen),
            _ptr(n_dirty), _ptr(keys_u), _ptr(len_u), _ptr(cnt_u),
            _ptr(extra_u), _ptr(scratch), _stream(keys)))
    (dgk, dtot, dupos, dlen_u, n_du), skeys = _repair_sort_group(
        dkeys, dlen, k64, u_cap, n_dirty)
    scal = torch.empty(2, dtype=torch.int32, **opts)
    with torch.cuda.device(keys.device):
        _launch("hash_group", lib.dsi_hash_assemble(
            k64, nb, d_cap, u_cap, _ptr(dgk), _ptr(dtot), _ptr(dupos),
            _ptr(dlen_u), _ptr(n_du), _ptr(skeys[k64]) if e else None,
            _ptr(keys_u), _ptr(len_u), _ptr(cnt_u), _ptr(extra_u),
            _ptr(scal), _ptr(scratch), _stream(keys)))
    return keys_u, len_u, cnt_u, extra_u, scal[0], scal[1] != 0


# ── G: the 6-bit transport decode ────────────────────────────────────────


def pack6_decode_plain(packed: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G, the inverse transform at the head of the
    reference's ``corpus_kernel_packed`` (``dsi_tpu/ops/corpus_wc.py:107-
    116``): every 3 wire bytes ``v = b0<<16 | b1<<8 | b2`` hold four 6-bit
    codes, high first, each mapped through the 64-entry code-to-byte
    ``table``.  Returns the uint8 corpus, 4/3 the wire length."""
    b = packed.view(-1, 3).to(torch.int64)
    v = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
    codes = torch.stack([(v >> 18) & 63, (v >> 12) & 63, (v >> 6) & 63,
                         v & 63], dim=1).reshape(-1)
    return table[codes]


def pack6_decode(packed: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Kernel G (``csrc/pack6.cu``); see :func:`pack6_decode_plain`."""
    _require(packed, torch.uint8, 1, "pack6 wire bytes")
    _require(table, torch.uint8, 1, "pack6 table")
    m = packed.shape[0]
    if m < 3 or m % 3 or table.shape[0] != 64:
        raise ValueError(f"pack6: bad shapes wire={m} "
                         f"table={tuple(table.shape)}")
    if not _on_cuda(packed):
        return pack6_decode_plain(packed, table)
    lib = _lib()
    out = torch.empty(m // 3 * 4, dtype=torch.uint8, device=packed.device)
    with torch.cuda.device(packed.device):
        _launch("pack6", lib.dsi_pack6(_ptr(packed), m // 3, _ptr(table),
                                       _ptr(out), _stream(packed)))
    return out


# ── the per-split program and its host wrapper ───────────────────────────


def group_chunk(chunk: torch.Tensor, *, max_word_len: int, u_cap: int,
                t_cap_frac: int, grouper: str):
    """The chunk's unique words, before their hash: (keys_u [k64, u_cap]
    int64, packed_u [u_cap, K] u32 bits, len_u, cnt_u [u_cap] i32,
    n_unique i32, max_len i32, has_high bool, token_overflow bool).  See
    :func:`tokenize_group_core`."""
    if grouper not in ("sort", "hash"):
        raise ValueError(f"unknown grouper {grouper!r}")
    n = chunk.shape[0]
    k = max_word_len // 4
    t_cap = n // t_cap_frac + 1
    keys, lengths, _, sc = tokenize(chunk, max_word_len=max_word_len,
                                    t_cap=t_cap)
    token_overflow = sc[0] > t_cap
    if grouper == "hash":
        fnv_t = fnv1a32_packed(keys, lengths, max_word_len)
        keys_u, len_u, totals, _, n_unique, group_of = hash_group(
            keys, lengths, fnv_t, sc[:1], u_cap)
        token_overflow = token_overflow | group_of
    else:
        skeys, perm = radix_sort(keys)
        ones = torch.ones(t_cap, dtype=torch.int64, device=chunk.device)
        keys_u, totals, _, len_u, n_unique = group_sorted(
            skeys, ones, u_cap, payload=lengths, perm=perm)
    return (keys_u, unpack_key_rows(keys_u.T, k), len_u,
            totals.to(torch.int32), n_unique, sc[1], sc[2] != 0,
            token_overflow)


def tokenize_group_core(chunk: torch.Tensor, *, max_word_len: int = 16,
                        u_cap: int = 1 << 17, t_cap_frac: int = 4,
                        grouper: str = "sort"):
    """Exact unique-word counts over one uint8 chunk (zero-padded tail);
    runs where ``chunk`` lies.

    Returns (packed_u [u_cap, K] u32 bits, len_u [u_cap] i32, cnt_u
    [u_cap] i32, fnv_u [u_cap] u32 bits, n_unique i32, max_len i32,
    has_high bool, token_overflow bool) — the outputs of
    ``dsi_tpu.ops.wordcount.tokenize_group_core``.  ``grouper`` is
    ``"sort"`` (kernels B and C over all tokens: rows in word order) or
    ``"hash"`` (kernel D per token, then kernel F: clean buckets in
    bucket order, then the dirty uniques); a hash attempt that cannot
    prove exactness reports ``token_overflow`` so the grouper ladder
    re-runs the chunk through the sort grouper.
    """
    keys_u, packed_u, len_u, cnt_u, *scal = group_chunk(
        chunk, max_word_len=max_word_len, u_cap=u_cap,
        t_cap_frac=t_cap_frac, grouper=grouper)
    fnv_u = fnv1a32_packed(keys_u, len_u, max_word_len)
    return (packed_u, len_u, cnt_u, fnv_u, *scal)


def _pad_pow2(data: bytes, min_size: int = 256) -> np.ndarray:
    """Zero-pad to the next power of two so a few shapes recur.  Zero bytes
    are non-letters, so padding can't create or extend tokens."""
    n = max(min_size, len(data) + 1)
    size = 1 << (n - 1).bit_length()
    buf = np.zeros(size, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf


def decode_packed(packed_u: np.ndarray, len_u: np.ndarray,
                  n_unique: int) -> list:
    """Host detokenization: packed big-endian u32 rows -> word strings."""
    nu = int(n_unique)
    rows = np.ascontiguousarray(np.asarray(packed_u[:nu])).astype(">u4")
    buf = rows.tobytes()
    stride = rows.shape[1] * 4
    lens = np.asarray(len_u[:nu]).tolist()
    return [buf[i * stride:i * stride + lens[i]].decode("ascii")
            for i in range(nu)]


def rung0_cap(shard_len: int, u_cap: int) -> int:
    """exactness_retry's starting capacity: ``u_cap`` bounded by the
    token-count hard cap for this shard length (n//2+1, pow2-rounded),
    floored at 1 (a zero start could never widen)."""
    hard_cap = 1 << (shard_len // 2).bit_length()
    return max(1, min(u_cap, hard_cap))


def exactness_retry(run, shard_len: int, max_word_len: int, u_cap: int):
    """Shared overflow/retry discipline (``dsi_tpu`` ``exactness_retry``).

    ``run(mwl, cap)`` returns ``(has_high, n_unique, max_len, payload)``.
    Retries with ``cap*4`` while uniques overflow, then with a 64-byte word
    window if a word overflowed the packed window.  Returns the payload, or
    None when the input needs the host path (non-ASCII bytes, or words
    longer than 64)."""
    ladder = (max_word_len, 64) if max_word_len < 64 else (max_word_len,)
    for mwl in ladder:
        cap = rung0_cap(shard_len, u_cap)
        while True:
            has_high, n_unique_max, max_len, payload = run(mwl, cap)
            if has_high:
                return None
            if n_unique_max > cap:
                cap *= 4
                continue
            break
        if max_len > mwl:
            continue  # a word overflowed the packed window: widen kernel
        return payload
    return None


def count_words_host_result(
        data: bytes, *, max_word_len: int = 16, u_cap: int = 1 << 17,
        device=None) -> Optional[Dict[str, tuple]]:
    """Run the per-split program (retrying wider on overflow) and return
    ``{word: (count, ihash)}``, or None if and only if the text needs the
    host path (non-ASCII bytes, or words longer than 64 bytes)."""
    dev = resolve_device(device)
    chunk = to_device(_pad_pow2(data), dev)
    groupers = grouper_ladder(dev)

    def run(mwl: int, cap: int):
        for g in groupers:
            for frac in (4, 2):  # exact token bound is n//2+1
                out = tokenize_group_core(chunk, max_word_len=mwl, u_cap=cap,
                                          t_cap_frac=frac, grouper=g)
                nu, max_len, has_high, tok_of = torch.stack(
                    [out[4], out[5], out[6].to(torch.int32),
                     out[7].to(torch.int32)]).tolist()
                if not tok_of:
                    break
            if not tok_of:
                break

        def payload():
            packed_u, len_u, cnt_u, fnv_u = (x[:nu].cpu().numpy()
                                             for x in out[:4])
            words = decode_packed(packed_u.view(np.uint32), len_u, nu)
            hashes = fnv_u.view(np.uint32) & 0x7FFFFFFF
            return {w: (int(cnt_u[i]), int(hashes[i]))
                    for i, w in enumerate(words)}

        return bool(has_high), nu, max_len, payload

    payload = exactness_retry(run, chunk.shape[0], max_word_len, u_cap)
    return None if payload is None else payload()
