"""The one metrics registry behind every engine's phase dict.

Copy of ``dsi_tpu/obs/registry.py``: the key schema is the reference's,
so a port engine's stats dict reads the same keys.

Before this module each engine grew its own stats dict with its own
spellings — ``pipeline_stats``/``stream_phases`` (word count),
``wave_phases`` (TF-IDF), the grep variants — and bench.py, the CLIs,
and ``scripts/summarize_onchip.py`` each re-learned every shape.  Now an
engine's stats dict IS a :class:`MetricsScope` registered here under the
engine's name, and every consumer reads one documented schema.

## The unified key schema

Phase wall-seconds (suffix ``_s``; a key is present when the engine has
that phase):

* ``materialize_s``      — building host-side step items (batch slicing,
  wave chunk assembly); in the producer thread at depth > 1
* ``materialize_wait_s`` — consumer starvation on the producer queue
* ``upload_s``           — H2D puts of step inputs
* ``kernel_s``           — time blocked on a step's deferred scalar/flag
  check (the device-compute wall the window failed to hide)
* ``pull_s``             — D2H result pulls
* ``merge_s``            — host-side accumulation of pulled results
* ``replay_s``           — exactness-ladder replays of overflowed steps
* ``fold_s`` / ``append_s`` / ``hist_s`` — device-service folds
* ``sync_s`` / ``drain_s``               — device-service pulls/drains
* ``widen_s``            — drain→realloc→re-fold recoveries
* ``ckpt_s``             — checkpoint snapshot + durable write (with
  async commits, only the boundary-side work: capture + any barrier)
* ``ckpt_capture_s``     — the capture half of a save: flag flushes,
  snapshot-pull dispatches, host snapshot-by-reference (engine thread)
* ``ckpt_commit_s``      — the commit half: materialize the in-flight
  pulls, serialize, durable write (the background writer thread under
  ``--ckpt-async``, inline otherwise)
* ``ckpt_barrier_s``     — engine-thread stalls on the commit writer
  (the NEXT save or the end-of-stream drain found a commit in flight)

Counters / gauges: ``steps`` (or ``waves``), ``depth``, ``replays``,
``step_pulls``, ``sync_pulls``, ``widens``, ``folds``,
``fold_overflows``, ``appends``, ``append_overflows``,
``postings_widens``, ``topk_snapshots``, ``hist_folds``, ``hist_pulls``,
``table_cap``, ``l_cap``, ``sync_every``, ``max_inflight``,
``buffer_allocs``, ``ckpt_saves``, ``ckpt_every``, ``resume_gap_s``,
``resume_cursor``/``resume_wave``, ``device_accumulate``.

Async/incremental checkpoint keys (``dsi_tpu/ckpt`` writer/delta —
present when checkpointing is on): ``ckpt_async``/``ckpt_delta`` (the
mode flags), ``ckpt_deltas`` (incremental saves among ``ckpt_saves``),
``ckpt_full_bytes``/``ckpt_delta_bytes`` (serialized payload totals by
kind — the bench's delta-vs-full evidence).

Compressed wire + ingest keys: ``ingest_readers``/
``ingest_blocks``/``readahead_hit_pct`` and the ``ingest_wait_s``
phase come from the parallel reader pool (``utils/ioread.py``, folded
into the engine scope at release by ``parallel/pipeline.py
fold_source_stats``); ``wire_upload`` (the chunk-codec mode flag),
``wire_steps``/``wire_raw_steps`` (packed vs raw-fallback uploads),
``wire_packed_bytes``, ``wire_ratio`` (raw/packed upload bytes) and
the ``decode_s`` phase (host encode + decode-prologue dispatch) come
from the chunk-upload codec (``ops/wirecodec.py``);
``ckpt_compress``/``ckpt_delta_raw_bytes`` and the
``ckpt_compress_s`` phase are the compressed-checkpoint attribution
(``ckpt/store.py`` via the writer).

Plan-layer keys (``dsi_tpu/plan`` — the "plan" scope of a multi-stage
chain run): ``plan_stages`` (stage count), ``plan_handoff``
(``device``/``host`` — which relay flavor carried the intermediates),
``plan_intermediate_bytes`` (bytes that crossed the host on the
inter-stage handoff path: 0 on an unspilled device-relay chain, the
full materialization on the staged baseline), ``plan_handoff_bytes``
(total intermediate content the relays carried — the saved-bytes
denominator), ``plan_relay_buffers`` /
``plan_spilled_bytes`` / ``plan_restored_bytes`` (relay residency
accounting), ``plan_commit_bytes`` (durable stage-manifest payloads —
durability cost, deliberately NOT handoff bytes),
``plan_resumed_stages`` (stages skipped by a resume from stage
manifests), ``plan_stage_walls`` (per-stage wall seconds, keyed by
stage name), plus the ``plan_s`` / ``stage_commit_s`` phases.

Mesh-sharded service keys (``mesh_shards`` > 0, the shuffle-fold path
— ``device/table.py``): ``mesh_shards`` (the sharding degree),
``pull_bytes`` (total D2H drain payload, counted in BOTH modes — the
bench A/B's evidence), ``shard_widens`` (per-shard widen counts, a
length-``n_dev`` list whose sum tracks the per-shard drain→realloc→
re-fold recoveries), ``shard_imbalance`` (max/mean shard occupancy
after the last confirmed fold; ~1.0 under FNV routing), and
``resharded_resume`` (set when a resume crossed sharding degrees via
the drain path; its value is the checkpoint's OLD degree, which is
legitimately 0 resuming a host-merge image into a mesh run — key
presence, not truthiness, is the signal).  Fold spans land in the tracer's ``shuffle`` lane in
mesh mode; span totals still reconcile with ``fold_s`` — the span IS
the stats accumulator.

## Live telemetry keys (``obs/hist.py`` + ``obs/live.py``)

When the telemetry plane is active (tracing enabled, or a
``--statusz-port`` live sampler running), :meth:`MetricsRegistry.
snapshot` additionally carries ``histograms`` — one log-bucketed
latency distribution per hot stage (the pinned ``hist.HIST_STAGES``:
kernel/upload/pull/finish/fold/sync/ckpt_commit), each under the
pinned ``hist.HIST_SNAPSHOT_KEYS`` (``count``/``total_s``/``p50_ms``/
``p90_ms``/``p99_ms``/``max_ms``).  The stall watchdog
(``parallel/pipeline.py``) adds the ``stalls`` counter to an engine's
scope and publishes the ``pipeline_stall`` gauge (engine, step, age,
threshold of the most recent stall); the coordinator publishes
``mr_worker_heartbeat_age_s`` (current ages) and
``mr_worker_heartbeat_hist`` (per-worker contact-gap histogram
snapshots — the percentile-aware requeue signal) gauges.

Engines keep their historical spellings inside the scope (external
consumers — tests, soaks, BENCH artifacts — read those keys today);
:meth:`MetricsScope.unified` maps the legacy spellings onto the schema
above, which is the view new consumers (``scripts/tracecat.py``, the
trace-file registry snapshot, the schema contract test) use.  The
aliases below are the complete drift list — adding an engine key that
needs a NEW alias is a schema change and belongs in this table.

The prose above is backed by ONE machine-readable
tuple: :data:`SCHEMA_KEYS` (= :data:`PHASE_KEYS` +
:data:`COUNTER_KEYS`).  The ``metric-schema`` dsicheck rule gates
every stats-scope write against it and the bench contract test pins
every engine's unified view inside it, so adding an engine key is
exactly one edit here — and forgetting that edit fails both the static
gate and tier-1.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from dsi_tpu_torch.obs.hist import active_histograms as _active_histograms

#: Legacy engine-specific spellings → unified schema names.  The
#: streaming word-count/grep engines predate the schema ("batch" for the
#: materialize phase, per-engine inflight names); everything else
#: already matches.
LEGACY_ALIASES = {
    "batch_s": "materialize_s",
    "batch_wait_s": "materialize_wait_s",
    "max_inflight_chunks": "max_inflight",
    "max_inflight_waves": "max_inflight",
    "batch_allocs": "buffer_allocs",
}

#: The canonical phase keys (module docstring) — what the schema
#: contract test pins.
PHASE_KEYS = (
    "materialize_s", "materialize_wait_s", "upload_s", "kernel_s",
    "pull_s", "merge_s", "replay_s", "fold_s", "append_s", "hist_s",
    "sync_s", "drain_s", "widen_s", "ckpt_s", "ckpt_capture_s",
    "ckpt_commit_s", "ckpt_barrier_s",
    # compressed wire + ingest
    "decode_s", "ingest_wait_s", "ckpt_compress_s",
    # plan layer: per-stage walls + stage-commit writes
    "plan_s", "stage_commit_s",
    # elastic dataflow: wall spent with two adjacent stages
    # advancing concurrently (seal-driven pipelining)
    "plan_overlap_s",
    # overlapped shuffle: consumer time blocked on the
    # prefetch pool vs dialer wire time hidden behind the decode
    "net_fetch_wait_s", "net_overlap_s",
)

#: The canonical counter/gauge keys (module docstring) — previously
#: prose; now machine-readable because the ``metric-schema`` dsicheck
#: rule and the bench contract test both read THIS tuple, so the
#: docstring, the static gate, and the test cannot drift apart.
COUNTER_KEYS = (
    # pipeline / engine counters
    "steps", "waves", "depth", "replays", "step_pulls", "sync_pulls",
    "widens", "folds", "fold_overflows", "appends", "append_overflows",
    "postings_widens", "topk_snapshots", "hist_folds", "hist_pulls",
    "table_cap", "l_cap", "sync_every", "max_inflight",
    "buffer_allocs", "device_accumulate", "donate_chunks", "stalls",
    "upload_mode",
    # checkpoint/restore
    "ckpt_saves", "ckpt_every", "ckpt_async", "ckpt_delta",
    "ckpt_deltas", "ckpt_full_bytes", "ckpt_delta_bytes",
    "resume_gap_s", "resume_cursor", "resume_wave",
    # mesh-sharded services
    "mesh_shards", "pull_bytes", "shard_widens", "shard_imbalance",
    "resharded_resume",
    # compressed wire + parallel ingest: reader-pool fold
    # (utils/ioread.py ingest_stats → fold_source_stats) and the
    # chunk-upload codec's attribution (ops/wirecodec.py)
    "ingest_readers", "ingest_blocks", "readahead_hit_pct",
    "wire_upload", "wire_steps", "wire_raw_steps", "wire_packed_bytes",
    "wire_ratio", "ckpt_delta_raw_bytes", "ckpt_compress",
    # serving daemon (the "serve"/"serve_grep" scopes, serve/pack.py):
    # rung_widens counts grep lanes sticky-widened to the hard-bound
    # l_cap rung (the per-tenant AOT rung-affinity move)
    "packed_steps", "packed_rows", "max_tenants_per_step",
    "host_fallbacks", "rung_widens",
    # plan layer (the "plan" scope, dsi_tpu/plan + device/relay.py):
    # multi-stage chain accounting — handoff bytes vs commit bytes is
    # the zero-host-round-trip evidence
    "plan_stages", "plan_handoff", "plan_handoff_bytes",
    "plan_intermediate_bytes", "plan_commit_bytes",
    "plan_relay_buffers", "plan_spilled_bytes", "plan_restored_bytes",
    "plan_resumed_stages", "plan_stage_walls",
    # elastic dataflow: pipelined pair + stage-shard fan-out
    "plan_pipelined", "plan_stage_shards",
    # network data plane (the "net" scope, dsi_tpu/net):
    # worker-served shuffle attribution — raw vs wire bytes is the
    # codec's evidence, locality_hits the placement policy's, and
    # net_refetches the re-fetch-from-replacement machinery's
    "net_fetches", "net_local_reads", "net_bytes_raw", "net_bytes_wire",
    "net_ratio", "net_fetch_failures", "net_refetches", "locality_hits",
    # overlapped shuffle: the effective prefetch window
    # (gauge — 1 means the serial path ran)
    "net_prefetch_window",
    # replicated control plane (dsi_tpu/replica): the Raft
    # node's status surface — log-application progress and leadership
    # churn per replica (group_status / the failover harness read them)
    "applied_index", "failovers",
)

#: THE schema: every key an engine scope may carry, under its unified
#: spelling.  Legacy spellings (LEGACY_ALIASES keys) are additionally
#: accepted at write sites; ``unified()`` maps them here.
SCHEMA_KEYS = PHASE_KEYS + COUNTER_KEYS

#: The engine names the four streaming engines register under.
ENGINES = ("stream", "tfidf", "grep", "indexer")

#: Every ``dsi_serve_*`` series name the daemon may emit on
#: ``/metrics`` (``serve/daemon.py _metrics_section``).  Pinned the same
#: way SCHEMA_KEYS is: the ``metric-schema`` dsicheck rule requires any
#: ``dsi_serve_``-prefixed string literal in the tree to name (or be a
#: truncated f-string head of) a series listed here, and the bench
#: contract test asserts the daemon's emission stays inside this set —
#: so the serving surface cannot grow an unregistered series, and its
#: cardinality stays bounded by construction (per-tenant series are
#: emitted for the top ``DSI_SERVE_METRICS_TENANTS`` tenants only).
SERVE_SERIES = (
    "dsi_serve_jobs_total", "dsi_serve_queued", "dsi_serve_resident",
    "dsi_serve_tenants_total", "dsi_serve_queue_depth",
    "dsi_serve_shed_total", "dsi_serve_rate_limited_total",
    "dsi_serve_evictions_p99_total", "dsi_serve_evictions_quota_total",
    "dsi_serve_packed_steps", "dsi_serve_packed_rows",
    "dsi_serve_grep_packed_steps", "dsi_serve_grep_packed_rows",
    "dsi_serve_grep_rung_widens",
    "dsi_serve_tenant_steps", "dsi_serve_tenant_rows",
    "dsi_serve_tenant_evictions", "dsi_serve_tenant_resumes",
    "dsi_serve_tenant_done",
    "dsi_serve_tenant_resume_gap_seconds",
    "dsi_serve_tenant_p99_ms",
)

#: Every ``dsi_replica_*`` gauge the replicated control plane
#: (``dsi_tpu/replica/node.py``) publishes — pinned alongside
#: SERVE_SERIES for the same reason: the failover evidence surface
#: (``scripts/tracecat.py`` replica lane, the tier-1 replication smoke)
#: keys on these names, so growing one is a schema change that starts
#: here.
REPLICA_SERIES = (
    "dsi_replica_term", "dsi_replica_elections",
    "dsi_replica_applied_index",
)


class MetricsScope(dict):
    """One engine's stats dict, registered in the registry at creation.
    Behaves exactly like the plain dict it replaces (engines mutate it
    with ``+=``/``setdefault``/``update``); :meth:`unified` is the
    schema-normalized read view."""

    def __init__(self, engine: str):
        super().__init__()
        self.engine = engine

    def unified(self) -> Dict:
        """The scope under the documented schema: legacy spellings
        renamed, everything else passed through."""
        return {LEGACY_ALIASES.get(k, k): v for k, v in self.items()}


class MetricsRegistry:
    """Process-global map of live engine scopes + named gauges.  An
    engine re-registers its scope per run (latest wins) — the registry
    answers "what did the most recent <engine> run report", which is
    what bench rows, the CLIs' ``--stats``, and the trace-file snapshot
    all want."""

    def __init__(self):
        self._lock = threading.Lock()
        self._scopes: Dict[str, MetricsScope] = {}
        self._gauges: Dict[str, object] = {}

    def scope(self, engine: str) -> MetricsScope:
        """A fresh scope for one engine run, registered as the engine's
        current phase dict."""
        sc = MetricsScope(engine)
        with self._lock:
            self._scopes[engine] = sc
        return sc

    def phases(self, engine: str) -> Optional[MetricsScope]:
        """The engine's current phase dict (None before its first run)."""
        with self._lock:
            return self._scopes.get(engine)

    def engines(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._scopes))

    def set_gauge(self, name: str, value) -> None:
        """Publish a named gauge (e.g. the coordinator's per-worker
        heartbeat ages) — read back via :meth:`gauge`/:meth:`snapshot`;
        the speculative-execution hook consumes these."""
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str, default=None):
        with self._lock:
            return self._gauges.get(name, default)

    def snapshot(self) -> Dict:
        """JSON-ready dump: every engine's unified view + the gauges —
        embedded in trace files by ``obs/trace.py`` at flush — plus the
        stage latency histograms whenever the live telemetry plane is
        active (``obs/hist.py``)."""
        with self._lock:
            scopes = dict(self._scopes)
            gauges = dict(self._gauges)
        out = {"engines": {e: sc.unified() for e, sc in scopes.items()},
               "gauges": gauges}
        hs = _active_histograms()
        if hs is not None:
            out["histograms"] = hs.snapshot()
        return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def metrics_scope(engine: str) -> MetricsScope:
    """Shorthand: a fresh registered scope on the global registry — the
    one-liner every engine calls where it used to build ``stats = {}``."""
    return _REGISTRY.scope(engine)
