"""Host-to-device upload of a list of host arrays, in one of two modes.

Port of ``dsi_tpu/ops/xfer.py``.  The mode is a runtime switch,
``DSI_UPLOAD_MODE``, read at every call:

* ``async`` (default): every piece is copied into pinned host memory and
  sent with a ``non_blocking`` copy, all of them before any wait; then
  one CUDA event recorded behind the last copy is waited on;
* ``sync``: one piece at a time, each copy waited on before the next
  starts.

Either way the call returns only when every piece has landed, so the
caller's timing has an honest upload boundary.  ``stats`` accumulates
the wall seconds (``upload_s``) until its reader zeroes it, and records
the mode of the last call (``upload_mode``).  On the CPU the pieces are
copied into tensors.
"""

from __future__ import annotations

import os
import time
from typing import List, Sequence

import numpy as np
import torch

from dsi_tpu_torch.ops.wordcount import resolve_device

stats = {"upload_s": 0.0, "upload_mode": "async"}


def upload_mode() -> str:
    mode = os.environ.get("DSI_UPLOAD_MODE", "async")
    return mode if mode in ("async", "sync") else "async"


def put_views(views: Sequence[np.ndarray], device=None) -> List[torch.Tensor]:
    """Upload ``views`` (host arrays) to ``device`` (None = the card) in
    the ``DSI_UPLOAD_MODE`` mode; the tensors in input order."""
    dev = resolve_device(device)
    mode = upload_mode()
    t0 = time.perf_counter()
    if dev.type == "cpu":
        out = [torch.from_numpy(np.array(v)) for v in views]
    elif mode == "sync":
        out = []
        for v in views:
            staged = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            out.append(staged.to(dev, non_blocking=True))
            torch.cuda.current_stream(dev).synchronize()
    else:
        staged = [torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for v in views]
        out = [s.to(dev, non_blocking=True) for s in staged]
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()  # the pinned staging may be freed after this
    stats["upload_s"] += time.perf_counter() - t0
    stats["upload_mode"] = mode
    return out
