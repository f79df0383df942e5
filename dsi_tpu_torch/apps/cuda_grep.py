"""cuda_grep: distributed grep with the line filter on the card.

Port of ``dsi_tpu/apps/tpu_grep.py``.  Same job and output as ``grep``
(``apps/grep.py``): Map emits ``{line, ""}`` per matching line, Reduce
counts occurrences.  :func:`cuda_map` walks the four device tiers in the
reference's order: a plain ASCII literal ``DSI_GREP_PATTERN``
(``ops/grepk.py``, kernel H), a fixed-length class pattern
(``ops/regexk.py``, kernel H), a top-level alternation of those
(``ops/altk.py``, one H launch a branch), a variable-length pattern
(``ops/nfak.py``, kernel I, behind the tier-4 cost model).  Anything
wider returns None, and the caller runs the host ``Map``.
"""

from __future__ import annotations

import os
from typing import List, Optional

from dsi_tpu_torch.apps.grep import Map, Reduce  # noqa: F401  (host path)
from dsi_tpu_torch.mr.types import KeyValue
from dsi_tpu_torch.ops.altk import altgrep_host_result
from dsi_tpu_torch.ops.grepk import grep_host_result
from dsi_tpu_torch.ops.nfak import nfagrep_host_result
from dsi_tpu_torch.ops.regexk import classgrep_host_result


def cuda_map(filename: str, raw: bytes,
             device=None) -> Optional[List[KeyValue]]:
    """The matching lines of ``raw`` as ``{line, ""}`` records, from the
    first device tier that takes the pattern, or None when none does.
    ``device=None`` is the card."""
    pattern = os.environ.get("DSI_GREP_PATTERN", r"(?!x)x")
    for tier in (grep_host_result, classgrep_host_result,
                 altgrep_host_result, nfagrep_host_result):
        lines = tier(raw, pattern, device=device)
        if lines is not None:
            return [KeyValue(line, "") for line in lines]
    return None
