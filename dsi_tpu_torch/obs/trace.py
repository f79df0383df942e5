"""Unified tracer: nested spans, counters, Perfetto/JSONL export.

Copy of ``dsi_tpu/obs/trace.py``.

The paper ships counters and a live status page as first-class framework
features (Dean & Ghemawat §4.7–4.8); until this module the repo's
equivalent was four ad-hoc stats dicts with no per-step timeline and no
control-plane visibility.  :class:`Tracer` is the one timeline every
layer writes into:

* **spans** — ``with tracer.span("upload", step=n): ...`` times a named
  region.  Spans nest (a per-thread depth counter rides each event), are
  thread-safe (the buffer append is the only shared write, under one
  lock), and are ~free when tracing is disabled: a pure span returns a
  shared no-op singleton (zero allocation), and a span carrying a
  ``stats``/``key`` sink degenerates to exactly the two
  ``perf_counter`` calls the engines' hand-rolled phase timing already
  paid — the sink write IS the phase accounting, so the span totals and
  the ``stream_phases``-style registry values cannot disagree.
* **events** — ``tracer.event("requeue", ...)`` instant records (the
  control-plane lane).
* **counters** — ``tracer.count("steps")`` monotonic counters, emitted
  as Chrome ``"C"`` samples.

Everything buffers in memory (bounded by ``DSI_TRACE_BUFFER_EVENTS``,
drops counted — a silent cap would read as "covered everything") and
:meth:`Tracer.flush` writes two artifacts through
``utils/atomicio.write_bytes_durable`` (temp + fsync + rename + CRC32
sidecar — the checkpoint store's torn-write discipline, so a trace
survives the same crashes the checkpoints do):

* ``<basename>.jsonl`` — one JSON record per event, head record carries
  process metadata, counters, and the metrics-registry snapshot;
* ``<basename>.json``  — Chrome/Perfetto ``traceEvents``: one lane
  (tid) per pipeline stage (materialize/upload/dispatch/kernel/pull/
  merge/replay/fold/sync/widen/ckpt) plus the control-plane lane; load
  it at https://ui.perfetto.dev or chrome://tracing.

The process-global tracer (:func:`get_tracer`) is enabled by
``DSI_TRACE_DIR=<dir>`` (buffer + durable flush at exit — how
``mrrun --trace-dir`` reaches its child coordinator/workers) or by
:func:`configure` (the CLIs' ``--trace-dir``; ``enabled=True`` alone is
the bench's in-memory rollup mode).  Buffering without a consumer is a
pure memory cost, so ``DSI_TRACE=1`` keeps its historical stderr-only
meaning (``utils/tracing.log_event``) and does NOT enable the buffer.
``ckpt/fault.py`` flushes it right before ``os._exit``, so traces
survive injected crashes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import dsi_tpu_torch.obs.hist as _hist

#: Span names recorded into the live stage histograms when the
#: telemetry plane is active (obs/hist.py owns the pinned set).
_HOT_STAGES = frozenset(_hist.HIST_STAGES)

#: The lane taxonomy: every span/event lands in one of these Perfetto
#: lanes (a span's lane defaults to its name).  Pipeline stages first in
#: display order, then the device-service lanes, then the control plane.
LANES = (
    "materialize", "upload", "dispatch", "kernel", "pull", "merge",
    "replay", "shuffle", "fold", "sync", "widen", "ckpt", "plan",
    "net", "replica", "control", "counters",
)

#: The pinned span-name schema: every span opened anywhere in the repo
#: draws its name from this set (lanes double as span names for the
#: simple stages; the rest are the documented sub-stages).  The
#: ``span-discipline`` rule in ``dsi_tpu/analysis`` enforces it
#: statically, and ``scripts/tracecat.py``'s flame/straggler tables key
#: on these names — an off-schema span would silently fall out of every
#: rollup, so adding one is a schema change and belongs here first.
SPAN_NAMES = frozenset(LANES) | frozenset((
    "wait", "finish", "drain", "append", "hist_fold", "hist_pull",
    "ckpt_capture", "ckpt_commit", "ckpt_save", "ckpt_restore", "task",
    "decode", "stage_commit", "resplit", "stage_overlap",
))

_BUFFER_ENV = "DSI_TRACE_BUFFER_EVENTS"
_BUFFER_DEFAULT = 500_000


class _NoopSpan:
    """The disabled-mode fast path: one shared instance, no allocation,
    no clock reads."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span.  ``tr`` is None when only the stats sink is wanted
    (tracing disabled but the engine still needs its phase seconds)."""

    __slots__ = ("_tr", "name", "lane", "_stats", "_key", "_fields",
                 "_t0", "_depth", "elapsed_s")

    def __init__(self, tr: Optional["Tracer"], name: str, lane: str,
                 stats: Optional[dict], key: Optional[str],
                 fields: Optional[dict]):
        self._tr = tr
        self.name = name
        self.lane = lane
        self._stats = stats
        self._key = key
        self._fields = fields
        self.elapsed_s = 0.0

    def __enter__(self) -> "_Span":
        tr = self._tr
        if tr is not None:
            tls = tr._tls
            self._depth = getattr(tls, "depth", 0)
            tls.depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        self.elapsed_s = dur
        if self._stats is not None:
            self._stats[self._key] = self._stats.get(self._key, 0.0) + dur
        # Stage histogram recording at span close (the tentpole of the
        # live telemetry plane): one module-attribute load when the
        # plane is off, one dict lookup + O(1) bucket bump when on.
        hs = _hist._active
        if hs is not None:
            hs.record(self.name, dur)
        tr = self._tr
        if tr is not None:
            tr._tls.depth = self._depth
            tr._record("X", self.name, self.lane, self._t0, dur,
                       self._depth, self._fields)
        return False


class Tracer:
    """Buffered span/event/counter recorder with durable Perfetto export
    (module docstring for the full contract)."""

    def __init__(self, enabled: bool = False,
                 trace_dir: Optional[str] = None, basename: str = "trace",
                 buffer_cap: Optional[int] = None):
        self._lock = threading.Lock()
        self._tls = threading.local()
        #: (ph, name, lane, t_perf, dur_s, depth, fields) tuples.
        self._events: List[Tuple] = []
        self.dropped = 0
        self.counters: Dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        # Construction never DEactivates the histogram plane (another
        # tracer may be feeding it); only an explicit ``enabled=False``
        # assignment does — see the property setter.
        self._enabled = bool(enabled)
        if self._enabled:
            _hist.activate()
        self.trace_dir: Optional[str] = None
        self.basename = basename
        if buffer_cap is None:
            try:
                buffer_cap = int(os.environ.get(_BUFFER_ENV,
                                                str(_BUFFER_DEFAULT)))
            except ValueError:
                buffer_cap = _BUFFER_DEFAULT
        self.buffer_cap = max(1, buffer_cap)
        if trace_dir:
            self.set_trace_dir(trace_dir, basename)

    # ── configuration ──

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, v) -> None:
        """Enabling tracing also activates the stage-histogram plane
        (hot spans record their close latency); disabling deactivates
        it UNLESS the live sampler holds it — statusz must keep its
        percentiles when a bench toggles its in-memory tracer off."""
        self._enabled = bool(v)
        if self._enabled:
            _hist.activate()
        else:
            _hist.deactivate()

    def set_trace_dir(self, trace_dir: str,
                      basename: Optional[str] = None) -> None:
        """Enable tracing with durable flush into ``trace_dir``.  Reaps
        orphans from a previous writer killed mid-commit — the
        checkpoint store's startup discipline — but only THIS process's
        basename: mrrun's children share one trace dir, and a blanket
        reap could delete a sibling's in-flight temp mid-commit."""
        from dsi_tpu_torch.utils.atomicio import reap_tmp_files

        os.makedirs(trace_dir, exist_ok=True)
        if basename:
            self.basename = basename
        reap_tmp_files(trace_dir, prefix=f".tmp-{self.basename}.")
        self.trace_dir = trace_dir
        self.enabled = True

    # ── recording ──

    def span(self, name: str, /, *, lane: Optional[str] = None,
             stats: Optional[dict] = None, key: Optional[str] = None,
             **fields):
        """A context manager timing one region.  With ``stats``/``key``
        the elapsed seconds are ALSO added to ``stats[key]`` (the
        engines' phase dicts — one measurement, two consumers).
        Disabled and sink-less returns the shared no-op singleton —
        unless the live histogram plane is active and the span is a hot
        stage, which still needs its close latency recorded (statusz-
        without-tracing mode)."""
        if not self.enabled:
            if stats is not None:
                return _Span(None, name, "", stats,
                             key or (name + "_s"), None)
            if _hist._active is not None and name in _HOT_STAGES:
                return _Span(None, name, "", None, None, None)
            return _NOOP_SPAN
        return _Span(self, name, lane or name, stats,
                     (key or (name + "_s")) if stats is not None else None,
                     fields or None)

    def event(self, name: str, /, *, lane: str = "control",
              **fields) -> None:
        """Record one instant event (control-plane lane by default)."""
        if not self.enabled:
            return
        self._record("I", name, lane, time.perf_counter(), 0.0,
                     getattr(self._tls, "depth", 0), fields or None)

    def record_span(self, name: str, dur_s: float, /, *,
                    lane: str = "control", **fields) -> None:
        """Record an already-timed region ending now — for measurements
        taken elsewhere (the worker's task ``Span``s mirror through
        here), so they land as real spans, not instants.  The start is
        clamped to the tracer's epoch: the global tracer is built
        lazily, so the first mirrored span may have BEGUN before ``_t0``
        and would otherwise export a negative timestamp."""
        if not self.enabled:
            return
        hs = _hist._active
        if hs is not None:
            hs.record(name, dur_s)
        self._record("X", name, lane,
                     max(self._t0, time.perf_counter() - dur_s),
                     dur_s, 0, fields or None)

    def count(self, name: str, /, n: float = 1, *,
              lane: str = "counters") -> None:
        """Bump a monotonic counter; emits a Chrome counter sample."""
        if not self.enabled:
            return
        with self._lock:
            v = self.counters.get(name, 0) + n
            self.counters[name] = v
        self._record("C", name, lane, time.perf_counter(), 0.0, 0,
                     {"value": v})

    def _record(self, ph: str, name: str, lane: str, t_perf: float,
                dur_s: float, depth: int, fields: Optional[dict]) -> None:
        with self._lock:
            if len(self._events) >= self.buffer_cap:
                self.dropped += 1
                return
            self._events.append((ph, name, lane, t_perf - self._t0,
                                 dur_s, depth, fields))

    # ── reading back ──

    def mark(self) -> int:
        """Current buffer position — pass to :meth:`rollup` to scope a
        rollup to the events recorded since."""
        with self._lock:
            return len(self._events)

    def counters_snapshot(self) -> Dict[str, float]:
        """A consistent copy of the counters — readers on other
        threads (the statusz endpoints, the live sampler) must not
        iterate the live dict while :meth:`count` inserts into it."""
        with self._lock:
            return dict(self.counters)

    def rollup(self, since: int = 0) -> Dict[str, dict]:
        """Per-span-name totals over the buffered events:
        ``{name: {"total_s", "count", "max_s", "p50_ms", "p99_ms"}}`` —
        the per-phase span rollup the bench rows publish.  The
        percentiles are EXACT over the buffered durations (the buffer
        holds every one), scoped by ``since`` like the totals — so a
        bench row's rollup carries its own latency distribution, not
        the whole process's."""
        with self._lock:
            evs = self._events[since:]
        out: Dict[str, dict] = {}
        durs: Dict[str, list] = {}
        for ph, name, lane, ts, dur, depth, fields in evs:
            if ph != "X":
                continue
            r = out.setdefault(name, {"total_s": 0.0, "count": 0,
                                      "max_s": 0.0})
            r["total_s"] += dur
            r["count"] += 1
            if dur > r["max_s"]:
                r["max_s"] = dur
            durs.setdefault(name, []).append(dur)
        for name, r in out.items():
            d = sorted(durs[name])
            n = len(d)
            # Nearest-rank percentiles, index ceil(q*n)-1 — the same
            # rank rule as LatencyHistogram.percentile, so the rollup
            # and the live histograms cannot disagree on definition
            # (p99 of 100 samples is the 99th, NOT the max).
            r["p50_ms"] = round(1e3 * d[(n + 1) // 2 - 1], 4)
            r["p99_ms"] = round(1e3 * d[(99 * n + 99) // 100 - 1], 4)
            r["total_s"] = round(r["total_s"], 4)
            r["max_s"] = round(r["max_s"], 4)
        return out

    # ── export ──

    def _meta(self, counters: Dict, dropped: int) -> dict:
        meta = {"pid": os.getpid(), "wall0": round(self._wall0, 3),
                "basename": self.basename, "dropped_events": dropped,
                "counters": counters}
        try:
            from dsi_tpu_torch.obs.registry import get_registry

            meta["registry"] = get_registry().snapshot()
        except Exception:
            pass
        return meta

    def flush(self) -> Optional[Tuple[str, str]]:
        """Write ``<basename>.jsonl`` + ``<basename>.json`` durably into
        the trace dir; returns their paths, or None when no dir is
        configured (in-memory tracing: :meth:`rollup` is the consumer).
        Idempotent — each call rewrites the full buffer, so a fault-point
        flush followed by nothing still leaves complete artifacts."""
        if not self.enabled or self.trace_dir is None:
            return None
        from dsi_tpu_torch.utils.atomicio import write_bytes_durable

        with self._lock:
            evs = list(self._events)
            counters = dict(self.counters)
            dropped = self.dropped
        meta = self._meta(counters, dropped)

        lines = [json.dumps({"type": "meta", **meta}, sort_keys=True)]
        for ph, name, lane, ts, dur, depth, fields in evs:
            rec = {"ph": ph, "name": name, "lane": lane,
                   "ts": round(ts, 6), "dur": round(dur, 6),
                   "depth": depth}
            if fields:
                rec.update(fields)
            lines.append(json.dumps(rec, sort_keys=True, default=str))
        jsonl_path = os.path.join(self.trace_dir, self.basename + ".jsonl")
        write_bytes_durable(jsonl_path,
                            ("\n".join(lines) + "\n").encode("utf-8"))

        pid = os.getpid()
        lanes = [l for l in LANES if any(e[2] == l for e in evs)]
        lanes += sorted({e[2] for e in evs} - set(lanes))
        tid_of = {l: i for i, l in enumerate(lanes)}
        tev: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0,
                            "args": {"name": f"dsi {self.basename}"}}]
        for lane, tid in tid_of.items():
            tev.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": lane}})
            tev.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"sort_index": tid}})
        for ph, name, lane, ts, dur, depth, fields in evs:
            ev = {"name": name, "cat": lane, "pid": pid,
                  "tid": tid_of[lane], "ts": round(ts * 1e6, 3)}
            if ph == "X":
                ev.update(ph="X", dur=round(dur * 1e6, 3))
            elif ph == "C":
                ev.update(ph="C")
            else:
                ev.update(ph="i", s="t")
            if fields:
                ev["args"] = fields
            tev.append(ev)
        doc = {"traceEvents": tev, "displayTimeUnit": "ms",
               "otherData": meta}
        json_path = os.path.join(self.trace_dir, self.basename + ".json")
        write_bytes_durable(json_path,
                            json.dumps(doc, default=str).encode("utf-8"))
        return jsonl_path, json_path


# ── the process-global tracer ──────────────────────────────────────────

_global_lock = threading.Lock()
_global: Optional[Tracer] = None
_atexit_registered = False


def _register_atexit() -> None:
    """Flush at interpreter exit when a trace dir is configured — how an
    env-inherited child (mrrun's coordinator/workers) commits its
    ``trace-<pid>.json`` without any CLI plumbing of its own."""
    global _atexit_registered
    if _atexit_registered:
        return
    _atexit_registered = True
    import atexit

    def _flush():
        try:
            if _global is not None:
                _global.flush()
        except Exception:
            pass

    atexit.register(_flush)


def get_tracer() -> Tracer:
    """The process-global tracer, lazily built from the env:
    ``DSI_TRACE_DIR`` enables buffering with a per-process durable
    flush target (``trace-<pid>.*``).  ``DSI_TRACE=1`` alone does NOT
    enable it — buffered events with no flush target are dead weight on
    long runs, and that knob's stderr stream is ``utils/tracing``'s."""
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                env_dir = os.environ.get("DSI_TRACE_DIR")
                t = Tracer(enabled=bool(env_dir))
                if env_dir:
                    t.set_trace_dir(env_dir,
                                    basename=f"trace-{os.getpid()}")
                _global = t
                if env_dir:
                    _register_atexit()
    return _global


def configure(trace_dir: Optional[str] = None, basename: str = "trace",
              enabled: Optional[bool] = None) -> Tracer:
    """Configure the global tracer (the CLIs' ``--trace-dir`` entry):
    with ``trace_dir`` the process writes ``trace.json``/``trace.jsonl``
    there at flush; ``enabled=True`` alone turns on in-memory buffering
    (the bench's rollup mode)."""
    t = get_tracer()
    if trace_dir:
        t.set_trace_dir(trace_dir, basename)
        _register_atexit()
    if enabled is not None:
        t.enabled = bool(enabled)
    return t


def span(name: str, /, **kw):
    return get_tracer().span(name, **kw)


def event(name: str, /, **kw) -> None:
    get_tracer().event(name, **kw)


def count(name: str, /, n: float = 1, **kw) -> None:
    get_tracer().count(name, n, **kw)


def flush() -> Optional[Tuple[str, str]]:
    return get_tracer().flush()
