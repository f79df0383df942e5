"""Checkpoint cadence for the streaming engines.

Copy of ``dsi_tpu/ckpt/policy.py``.

Mirrors ``device/policy.py``'s :class:`SyncPolicy` exactly in shape: one
place decides what "checkpoint every K confirmed steps" means and where
the knobs live, so the word-count stream, the grep stream, and the wave
walks cannot read them differently.  Two triggers, OR-combined:

* every ``every`` CONFIRMED steps (``--checkpoint-every`` /
  ``DSI_STREAM_CKPT_EVERY``, default 32) — confirmed, not dispatched:
  a checkpoint is only consistent at a confirmed-step boundary, where
  every merged/folded step has passed its deferred exactness check and
  nothing in the accumulators is provisional;
* every ``secs`` wall seconds (``DSI_STREAM_CKPT_SECS``, default off) —
  the cap on how much wall-clock a crash can lose on a slow stream
  (steps can take minutes each on a congested tunnel).

The policy is deliberately trivial because the *correctness* story
never depends on it: a missed checkpoint costs replay work after a
crash, never data — the engines re-read the input from the last durable
cursor and the exactly-once merge discipline does the rest.
"""

from __future__ import annotations

import os
import time

_CKPT_EVERY_ENV = "DSI_STREAM_CKPT_EVERY"
_CKPT_SECS_ENV = "DSI_STREAM_CKPT_SECS"
_CKPT_ASYNC_ENV = "DSI_STREAM_CKPT_ASYNC"
_CKPT_DELTA_ENV = "DSI_STREAM_CKPT_DELTA"
_CKPT_REBASE_ENV = "DSI_STREAM_CKPT_REBASE"
#: Delta saves between full rebases: long chains cost restore work
#: (base + every delta re-applied) and pin every chain member against
#: GC, so the store periodically compacts by writing a fresh full image.
_CKPT_REBASE_DEFAULT = 8
#: 32 confirmed steps at 2 MiB chunks is ~64 MB of replay exposure —
#: small against a GB-scale stream.
_CKPT_EVERY_DEFAULT = 32


def checkpoint_every_default(every: int | None = None) -> int:
    """Resolve K: an explicit value wins, else ``DSI_STREAM_CKPT_EVERY``
    (default 32), floored at 1 (checkpoint after every confirmed step —
    the degenerate cadence the crash-resume tests lean on)."""
    if every is None:
        try:
            every = int(os.environ.get(_CKPT_EVERY_ENV,
                                       str(_CKPT_EVERY_DEFAULT)))
        except ValueError:
            every = _CKPT_EVERY_DEFAULT
    return max(1, every)


def checkpoint_secs_default(secs: float | None = None) -> float:
    """Resolve T (0 = disabled): explicit wins, else
    ``DSI_STREAM_CKPT_SECS`` (default 0)."""
    if secs is None:
        try:
            secs = float(os.environ.get(_CKPT_SECS_ENV, "0"))
        except ValueError:
            secs = 0.0
    return max(0.0, secs)


def _bool_env(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "on",
                                                        "yes")


def checkpoint_async_default(flag: bool | None = None) -> bool:
    """Resolve the async-commit switch: explicit wins, else
    ``DSI_STREAM_CKPT_ASYNC`` (default off — off is the plain synchronous
    behavior: capture + commit inline at the confirmed-step boundary)."""
    if flag is None:
        return _bool_env(_CKPT_ASYNC_ENV)
    return bool(flag)


def checkpoint_delta_default(flag: bool | None = None) -> bool:
    """Resolve the incremental-snapshot switch: explicit wins, else
    ``DSI_STREAM_CKPT_DELTA`` (default off — every save a full image,
    the synchronous shape)."""
    if flag is None:
        return _bool_env(_CKPT_DELTA_ENV)
    return bool(flag)


_CKPT_COMPRESS_ENV = "DSI_STREAM_CKPT_COMPRESS"
#: Which checkpoint payload kinds are zlib-compressed
#: (``np.savez_compressed`` through the store's BytesIO
#: serialize-then-commit idiom — the durable path is untouched).
#: Default ``deltas``: delta payloads are written at cadence (every
#: save on a delta chain) and their packed word tables compress 2-5x,
#: while full images are the latency-sensitive sync-save path, so they
#: stay raw unless ``all`` is asked for.
_CKPT_COMPRESS_DEFAULT = "deltas"
_CKPT_COMPRESS_MODES = ("off", "deltas", "all")


def checkpoint_compress_default(mode: str | None = None) -> str:
    """Resolve the payload-compression mode — one of ``off`` (every
    payload raw npz, the uncompressed bytes), ``deltas`` (default:
    ``delta-<seq>.npz`` compressed, full images raw), ``all``: explicit
    wins, else ``DSI_STREAM_CKPT_COMPRESS`` with the historical bool
    spellings accepted (``0``/``off``/``false`` → off, ``1``/``on`` →
    deltas)."""
    if mode is None:
        mode = os.environ.get(_CKPT_COMPRESS_ENV,
                              _CKPT_COMPRESS_DEFAULT)
    m = str(mode).strip().lower()
    if m in ("0", "off", "false", "no", "none"):
        return "off"
    if m in ("1", "on", "true", "yes", "delta", "deltas"):
        return "deltas"
    if m in ("2", "all", "full"):
        return "all"
    return _CKPT_COMPRESS_DEFAULT


def checkpoint_rebase_default(every: int | None = None) -> int:
    """Resolve the rebase cadence — every Nth save is a full image,
    i.e. up to ``N - 1`` deltas chain between fulls: explicit wins,
    else ``DSI_STREAM_CKPT_REBASE`` (default 8), floored at 1
    (= every save full, deltas effectively disabled)."""
    if every is None:
        try:
            every = int(os.environ.get(_CKPT_REBASE_ENV,
                                       str(_CKPT_REBASE_DEFAULT)))
        except ValueError:
            every = _CKPT_REBASE_DEFAULT
    return max(1, every)


class CheckpointPolicy:
    """Fire every ``every`` confirmed steps and/or every ``secs``
    seconds.  Counts CONFIRMED steps (the caller notes a step only after
    its merge/fold committed), so ``due()`` is only ever consulted at a
    consistent boundary."""

    def __init__(self, every: int | None = None,
                 secs: float | None = None):
        self.every = checkpoint_every_default(every)
        self.secs = checkpoint_secs_default(secs)
        self._since = 0
        self._last = time.monotonic()

    def note_step(self) -> None:
        self._since += 1

    def due(self) -> bool:
        if self._since >= self.every:
            return True
        return bool(self.secs) and self._since > 0 \
            and time.monotonic() - self._last >= self.secs

    def reset(self) -> None:
        self._since = 0
        self._last = time.monotonic()
