"""Checkpoint/restore for the streaming engines.

Copy of ``dsi_tpu/ckpt/``: the same environment names, on-disk layout,
``CKPT_VERSION`` and manifest format, so the two packages read each
other's chains.  The streaming word count, grep, the indexer and TF-IDF
checkpoint; the plan layer's stage commits refuse ``checkpoint_dir``.

The reference system's whole fault-tolerance story is re-execution: a
task that dies is re-run from its input files (10 s presumed-dead
timeout, ``mr/coordinator.go``), and the control-plane journal
(``mr/journal.py``) extends that to coordinator death.  The streaming
engines broke that model's assumption — their value IS the gigabytes of
cross-step state held on device (`dsi_tpu/device/`) with ``step_pulls=0``
— so a worker death lost the whole stream and the only recovery was a
full replay.  This package closes that gap:

* :mod:`~dsi_tpu_torch.ckpt.policy` — :class:`CheckpointPolicy`, the cadence
  (every K confirmed steps and/or T seconds), mirroring
  ``device/policy.SyncPolicy``;
* :mod:`~dsi_tpu_torch.ckpt.store` — :class:`CheckpointStore`, the durable
  versioned (payload, manifest) pairs with CRC sidecars, parent-dir
  fsync, newest-valid-wins loading and last-two retention;
* :mod:`~dsi_tpu_torch.ckpt.fault` — :func:`fault_point`, the named
  kill-points (``DSI_FAULT_POINT``/``DSI_FAULT_STEP``) that let tests
  and ``chip_smoke.py`` prove resume against REAL crashes;
* :mod:`~dsi_tpu_torch.ckpt.writer` — :class:`CheckpointWriter`, the
  capture/commit split (``--ckpt-async``: snapshot pulls overlap the
  next pipeline window, a background writer runs the durable path);
* :mod:`~dsi_tpu_torch.ckpt.delta` — the incremental payload format
  (``--ckpt-delta``: a save ships only the confirmed step payloads
  appended since the previous one; the store chains ``delta-<seq>``
  manifests onto their base, restore = base + ordered deltas).

The consistency contract, owned here and honored by every engine that
checkpoints (``parallel/streaming.py``, ``parallel/grepstream.py``,
``parallel/tfidf.py``): a checkpoint is taken
only at a CONFIRMED-step boundary and contains (a) the host accumulators, (b) drain-free images
of every live device service (flushed of lagged flags, pulled but NOT
cleared), (c) the sticky dispatch-rung state, and (d) the input cursor
of the last confirmed step.  Steps in the in-flight window — dispatched
but with deferred checks unread — are deliberately EXCLUDED: their
outputs were never merged, so re-reading the input from the cursor and
re-processing them preserves exactly-once through the same
replay-at-sticky-rungs ladder that makes the pipelined engines
bit-identical to ``depth=1``.  Resume therefore yields bit-identical
final output to an uninterrupted run — the parity gate
``tests/test_torch_ckpt_stream.py`` enforces per fault point, mode and
device_accumulate setting, against the reference's uninterrupted run.
"""

from dsi_tpu_torch.ckpt.fault import (
    FAULT_EXIT,
    FAULT_POINTS,
    FaultInjected,
    fault_point,
    reset_faults,
)
from dsi_tpu_torch.ckpt.delta import (
    Deferred,
    DeltaSteps,
    HostDeltaLog,
    drain_packed_steps,
    drain_posting_steps,
    iter_delta_steps,
)
from dsi_tpu_torch.ckpt.policy import (
    CheckpointPolicy,
    checkpoint_async_default,
    checkpoint_compress_default,
    checkpoint_delta_default,
    checkpoint_every_default,
    checkpoint_rebase_default,
    checkpoint_secs_default,
)
from dsi_tpu_torch.ckpt.store import (
    CKPT_VERSION,
    CheckpointMismatch,
    CheckpointStore,
    skip_stream,
)
from dsi_tpu_torch.ckpt.writer import CheckpointWriter

__all__ = [
    "CKPT_VERSION",
    "CheckpointMismatch",
    "CheckpointPolicy",
    "CheckpointStore",
    "CheckpointWriter",
    "Deferred",
    "DeltaSteps",
    "HostDeltaLog",
    "FAULT_EXIT",
    "FAULT_POINTS",
    "FaultInjected",
    "checkpoint_async_default",
    "checkpoint_compress_default",
    "checkpoint_delta_default",
    "checkpoint_every_default",
    "checkpoint_rebase_default",
    "checkpoint_secs_default",
    "drain_packed_steps",
    "drain_posting_steps",
    "fault_point",
    "iter_delta_steps",
    "reset_faults",
    "skip_stream",
]
