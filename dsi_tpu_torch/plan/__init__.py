"""dsi_tpu_torch.plan — multi-stage dataflow plans without the host round
trip, on the card.

Port of ``dsi_tpu/plan``: the engines chain so that stage N+1's upload IS
stage N's device-resident output.

* :mod:`~dsi_tpu_torch.plan.graph`  — the :class:`Plan`/:class:`Stage`
  DAG model and the canonical chains (grep → word count over the matching
  lines, grep → grep, word count → top-k, indexer → df top-k → postings
  join);
* :mod:`~dsi_tpu_torch.plan.driver` — :func:`run_plan`, driving each stage
  as a step object with relay handoffs (``device/relay.py``), staged,
  pipelined or stage-sharded, with durable stage commits and resume.

Entry point: ``python -m dsi_tpu_torch.cli.planrun``.
"""

from dsi_tpu_torch.plan.graph import (
    STAGE_KINDS,
    Plan,
    PlanError,
    Stage,
    grep_cascade_plan,
    grep_wordcount_plan,
    indexer_join_plan,
    wordcount_topk_plan,
)
from dsi_tpu_torch.plan.driver import (
    PlanHostPath,
    PlanResult,
    run_plan,
)

__all__ = [
    "STAGE_KINDS",
    "Plan",
    "PlanError",
    "PlanHostPath",
    "PlanResult",
    "Stage",
    "grep_cascade_plan",
    "grep_wordcount_plan",
    "indexer_join_plan",
    "run_plan",
    "wordcount_topk_plan",
]
