"""The plan rebuild a stage host and ``planrun`` share.

Port of ``build_plan`` from ``dsi_tpu/plan/stagehost.py``.  The stage
host itself (one process a stage, relays served over TCP) goes with the
control plane (ROADMAP Queue 1, #5).
"""

from __future__ import annotations

from typing import Dict


def build_plan(spec: Dict):
    """Rebuild the canonical plan a spec describes (``planrun``'s
    ``_plan_spec``): the same plan graph, and so the same
    ``Plan.signature()``, as the reference's for the same spec."""
    from dsi_tpu_torch.plan import (grep_cascade_plan, grep_wordcount_plan,
                                    indexer_join_plan, wordcount_topk_plan)

    defaults = dict(chunk_bytes=spec.get("chunk_bytes", 1 << 20),
                    depth=spec.get("depth"),
                    device_accumulate=bool(
                        spec.get("device_accumulate", False)),
                    sync_every=spec.get("sync_every"),
                    mesh_shards=spec.get("mesh_shards"),
                    aot=bool(spec.get("aot", False)),
                    n_reduce=spec.get("n_reduce", 10),
                    u_cap=spec.get("u_cap", 1 << 12),
                    topk=spec.get("topk", 16))
    chain = spec["chain"]
    files = list(spec.get("files") or ())
    if chain == "grep-wc":
        return grep_wordcount_plan(spec["pattern"], paths=files,
                                   **defaults)
    if chain == "grep-grep":
        return grep_cascade_plan(spec["pattern"], spec["pattern2"],
                                 paths=files, **defaults)
    if chain == "wc-topk":
        return wordcount_topk_plan(defaults["topk"], paths=files,
                                   **defaults)
    if chain == "indexer":
        docs = []
        for path in files:
            with open(path, "rb") as f:
                docs.append(f.read())
        return indexer_join_plan(docs, **defaults)
    raise ValueError(f"unknown chain {chain!r}")
