"""Host-path word count, the ``wcstream`` fallback.

Copy of ``host_wordcount`` from ``dsi_tpu/serve/pack.py`` (the packed
serving schedulers wait for the serving slice).
"""

from __future__ import annotations

from typing import Dict


def host_wordcount(files, n_reduce: int) -> Dict[str, tuple]:
    """The host-path word count: ``apps.wc.Map`` tokens + ``ihash %
    n_reduce`` partitions — the result the device path produces, by the
    oracle's definition."""
    from dsi_tpu_torch.apps import wc
    from dsi_tpu_torch.mr.sequential import ihash

    counts: Dict[str, int] = {}
    for f in files:
        with open(f, "rb") as fh:
            text = fh.read().decode("utf-8", errors="replace")
        for kv in wc.Map(f, text):
            counts[kv.key] = counts.get(kv.key, 0) + 1
    return {w: (c, ihash(w) % n_reduce) for w, c in counts.items()}
