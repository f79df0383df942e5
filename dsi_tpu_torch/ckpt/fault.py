"""Fault injection: kill the process at named engine points.

Copy of ``dsi_tpu/ckpt/fault.py`` without its chaos half
(``DSI_CHAOS_WORKER_KILL``), which comes with the worker loop that uses
it.

The crash-resume guarantee is only evidence if the crashes are real —
a mocked "restore from dict" test cannot catch a snapshot that forgot
to fsync, a manifest torn mid-rename, or device state that was captured
while a fold was still in flight.  This module lets the test grid and
``chip_smoke.py`` kill a live engine at the points where
those bugs would hide:

* ``post-dispatch`` — right after a step/wave kernel is dispatched (the
  in-flight window holds unconfirmed work that a checkpoint must NOT
  contain);
* ``mid-fold``     — right after a confirmed step's merge/fold is
  issued, before the cursor advances (the classic torn-update point);
* ``pre-sync``     — immediately before a device-service drain/sync
  pull (host and device state maximally divergent);
* ``post-ckpt``    — right after a checkpoint manifest commits (resume
  must pick THIS checkpoint, and replay exactly the uncheckpointed
  tail);
* ``mid-capture``  — inside an async save, after the snapshot's device
  pulls are dispatched but before the capture is handed to the commit
  writer (nothing of this save may be visible to a resume);
* ``mid-commit``   — in the commit writer, after the capture
  materialized but before the payload/manifest pair lands (a
  half-written delta or image must LOSE to the previous complete
  chain — the newest-valid-wins walk's async edge);
* ``mid-serve``    — in the partition server, after the FIRST chunk of
  a streamed fetch hits the socket (the consumer sees a half-sent
  payload and a dead peer — the network data plane's re-fetch-from-
  replacement trigger).

Knobs (all read per call, so a subprocess inherits them from its env):

* ``DSI_FAULT_POINT`` — one of the names above; unset = disabled.
* ``DSI_FAULT_STEP``  — fire on the n-th occurrence of that point in
  this process (default 1).
* ``DSI_FAULT_MODE``  — ``exit`` (default): ``os._exit(FAULT_EXIT)``,
  a real crash with no teardown, no atexit, no flushes — exactly what
  a SIGKILL'd worker looks like; ``raise``: raise
  :class:`FaultInjected` instead, for the in-process parity grid
  (tests/test_torch_ckpt_stream.py) where spawning an interpreter per grid
  cell would not fit the tier-1 budget.  The subprocess tests and the
  CI/evidence smoke steps use ``exit`` — real crashes, not mocks.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

#: The injected-crash exit code — distinct from every code the CLIs use
#: (0/1/2) and from SIGKILL's 137, so a harness can assert "the fault
#: fired" rather than "something died".
FAULT_EXIT = 87

#: The ENGINE-level points — the crash-resume parity grid
#: (tests/test_torch_ckpt_stream.py) parametrizes over exactly this tuple, so
#: points that fire outside an engine run (``mid-serve`` in the
#: partition server, the plan layer's ``plan-stage<i>-advance``) are
#: deliberately not listed; they fire by name through
#: :func:`fault_point` all the same.
FAULT_POINTS = ("post-dispatch", "mid-fold", "pre-sync", "post-ckpt",
                "mid-capture", "mid-commit")

_counters: Dict[str, int] = {}


class FaultInjected(RuntimeError):
    """Raised instead of exiting under ``DSI_FAULT_MODE=raise``."""


def reset_faults() -> None:
    """Forget per-point occurrence counts (in-process test isolation)."""
    _counters.clear()


def fault_point(point: str) -> None:
    """Note one occurrence of ``point``; crash if the env says so.

    Free when ``DSI_FAULT_POINT`` is unset (one env read); the per-point
    counter only advances for the armed point, so unrelated engines in
    the same process don't consume the budget.
    """
    armed = os.environ.get("DSI_FAULT_POINT")
    if not armed or armed != point:
        return
    n = _counters.get(point, 0) + 1
    _counters[point] = n
    try:
        at = int(os.environ.get("DSI_FAULT_STEP", "1"))
    except ValueError:
        at = 1
    if n != max(1, at):
        return
    if os.environ.get("DSI_FAULT_MODE") == "raise":
        raise FaultInjected(f"injected fault at {point} #{n}")
    print(f"FAULT: injected crash at {point} #{n}", file=sys.stderr,
          flush=True)
    # Commit the trace buffer BEFORE dying: the tracer flush rides the
    # same atomicio durable-write path as the checkpoints, so a traced
    # crash leaves a complete, loadable trace.json — the observability
    # half of the crash-resume evidence.  Never let tracing break the
    # fault itself.
    try:
        from dsi_tpu_torch.obs import trace as _obs_trace

        tracer = _obs_trace.get_tracer()
        tracer.event("fault", point=point, n=n)
        tracer.flush()
    except Exception:
        pass
    # A real crash: no interpreter unwind, no atexit, no buffered-IO
    # flush — anything the checkpoint path did not make durable BEFORE
    # this instant is gone, which is the whole point.
    os._exit(FAULT_EXIT)
