"""dsi_tpu_torch.obs — unified tracing + metrics across every runtime layer.

Copy of ``dsi_tpu/obs/__init__.py``; the whole ``obs`` package is copied so
the port imports nothing of ``dsi_tpu``.  Wired so far: the checkpoint
writer's and store's spans and events (``ckpt/``) and the stage histograms
they feed.

Four parts, one subsystem:

* :mod:`~dsi_tpu_torch.obs.trace` — the :class:`Tracer`: nested spans,
  instant events, counters, buffered in memory and flushed durably as a
  JSONL event log plus a Chrome/Perfetto ``trace.json`` (one lane per
  pipeline stage, plus device-service and control-plane lanes).
  Enabled by ``DSI_TRACE_DIR`` or the CLIs' ``--trace-dir``; ~free
  when disabled (``DSI_TRACE=1`` stays the stderr event stream's knob).
* :mod:`~dsi_tpu_torch.obs.registry` — the :class:`MetricsRegistry` every
  engine's phase dict registers into, with the single documented key
  schema that subsumes ``pipeline_stats``/``stream_phases``/
  ``wave_phases``/``grep_phases``.

* :mod:`~dsi_tpu_torch.obs.hist` — log-bucketed stage latency histograms
  (p50/p90/p99/max, HDR-style constant memory), recorded at span close
  for the pinned hot stages whenever the plane is active; plus the
  live-pipeline registry the sampler and stall watchdog read.
* :mod:`~dsi_tpu_torch.obs.live` — the live telemetry plane: a sampler
  thread with a bounded ``live.jsonl`` ring and localhost ``/statusz``
  + ``/metrics`` endpoints (``--statusz-port`` / ``DSI_STATUSZ_PORT``;
  default off = zero threads).

Render a trace with ``scripts/tracecat.py``; open the ``trace.json`` at
https://ui.perfetto.dev.  DESIGN.md "Observability" and "Live
telemetry" document the span taxonomy, lane map, and sampler design.
"""

import sys

from dsi_tpu_torch.obs.hist import (
    HIST_SNAPSHOT_KEYS,
    HIST_STAGES,
    LatencyHistogram,
    StageHistograms,
    active_histograms,
)
from dsi_tpu_torch.obs.registry import (
    COUNTER_KEYS,
    ENGINES,
    LEGACY_ALIASES,
    PHASE_KEYS,
    SCHEMA_KEYS,
    MetricsRegistry,
    MetricsScope,
    get_registry,
    metrics_scope,
)
from dsi_tpu_torch.obs.trace import (
    LANES,
    SPAN_NAMES,
    Tracer,
    configure,
    count,
    event,
    flush,
    get_tracer,
    span,
)

#: CLI-facing aliases (the engine modules import ``span``/``event``
#: directly; the CLIs read better with the explicit names).
configure_tracing = configure
flush_tracing = flush
trace_event = event


def flush_tracing_report(trace_dir: str, prog: str = "") -> None:
    """Flush the global tracer and print the canonical
    where-is-my-trace line — the one exit block every single-process
    ``--trace-dir`` entry point (wcstream/grepstream/the soaks) shares,
    so the wording cannot drift per CLI."""
    paths = flush()
    if paths:
        tag = f"{prog}: " if prog else ""
        print(f"{tag}trace written to {paths[1]} "
              f"(render: python scripts/tracecat.py {trace_dir})",
              file=sys.stderr)

__all__ = [
    "ENGINES",
    "HIST_SNAPSHOT_KEYS",
    "HIST_STAGES",
    "LANES",
    "LatencyHistogram",
    "StageHistograms",
    "active_histograms",
    "COUNTER_KEYS",
    "LEGACY_ALIASES",
    "PHASE_KEYS",
    "SCHEMA_KEYS",
    "MetricsRegistry",
    "MetricsScope",
    "SPAN_NAMES",
    "Tracer",
    "configure",
    "configure_tracing",
    "count",
    "event",
    "flush",
    "flush_tracing",
    "flush_tracing_report",
    "get_registry",
    "get_tracer",
    "metrics_scope",
    "span",
    "trace_event",
]
